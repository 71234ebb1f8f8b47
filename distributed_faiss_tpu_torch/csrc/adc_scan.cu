// PQ asymmetric-distance (ADC) scans for Hopper (sm_90a): K2, K3 and K4.
//
// Replaces three TPU kernels of distributed_faiss_tpu/ops/adc_pallas.py.
// K2 and K3 compute one function over per-pair code lists:
//
//   K2  adc_scan_pallas         (adc_pallas.py:139)  any m, ksub <= 256
//   K3  adc_scan_pallas_nibble  (adc_pallas.py:209)  ksub == 256, m % 8 == 0
//
//   out[p, c] = sum_{j < m} lut[p, j, codes[p, c, j]]      fp32 accumulation
//
// K4 (adc_scan_shared_pallas, adc_pallas.py:110) scores one code list that
// every query shares (flat PQ: an IVF-PQ index with one list); it is
// described at its kernel below.
//
// lut (P, m, ksub) f32 or bf16 (a bf16 entry enters the sum as the fp32
// value it represents); codes (P, L, m) u8, row c of pair p holding the m
// sub-quantizer codes of one candidate; out (P, L) f32. A pair p is one
// (query, probed list); L is the list capacity, and the rows past a list's
// size are scored like any other (the caller masks them, as
// distributed_faiss_tpu/models/ivf.py:252 does).
//
// What bounds it. Per pair the kernel must read the pair's LUT once
// (m * ksub * itemsize bytes: 32 KB for m = 64 in bf16, 64 KB in f32), its
// L code rows (L * m bytes) and write L fp32 scores; the work is one
// table lookup and one fp32 add per code byte. That is well under one
// operation per byte read against the card's ~20 fp32 operations per byte
// of HBM bandwidth (67 TFLOP/s over 3.35 TB/s): the kernel is bound by
// bytes, and at the main path's shapes the per-pair LUT is at least as
// large as the code rows. Tensor cores have nothing to do here: the TPU
// kernels built one-hot (or 4-bit hi/lo one-hot) planes only so that its
// matrix unit could do the lookup; a shared-memory gather does it directly.
//
// What the design does about it.
//   * A block owns one pair and up to kBlockRows rows of it; the pair's LUT
//     is staged into shared memory once per block (16-byte loads), in its
//     own dtype, so a bf16 LUT costs half the bytes and half the shared
//     memory. Above 48 KB (the f32 LUT at m = 64) the block takes dynamic
//     shared memory after cudaFuncSetAttribute.
//   * K2 (general m, including m that is no power of two, e.g. 12): a
//     256-row tile of code rows is a contiguous byte range; the block copies
//     it into shared memory with 16-byte loads for the aligned interior and
//     byte loads for the ragged ends, never touching a byte outside
//     (P, L, m). Each thread then sums its row's m lookups in fp32.
//   * K3 (ksub = 256 fixed at compile time, m % 8 == 0): no staging of the
//     codes; each thread reads its row 8 codes at a time as one aligned
//     8-byte word (m % 8 == 0 and an 8-byte aligned base make every word
//     aligned) and unrolls the 8 lookups of a word.
//   * Lookups hit shared memory at data-dependent addresses: random codes
//     spread a warp's 32 lookups over the 32 banks with a few conflicts on
//     average. Nothing is written but the one fp32 score per row.
//   * Blocks carry nothing across each other and run in any order.
//
// Fusing the LUT build (a per-pair residual product with the codebooks)
// into the scan, and gathering the probed lists' code rows inside the
// kernel instead of receiving them gathered, would remove most of the bytes
// above; both are left for a later change.
//
// Built by distributed_faiss_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = kThreads;  // K2: code rows staged per tile, one per thread
constexpr int kBlockRows = 1024;     // rows of one pair a block walks (LUT staged once)
constexpr int kNibbleKsub = 256;     // K3's fixed ksub
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float lut_value(const float* s, int i) { return s[i]; }
__device__ __forceinline__ float lut_value(const __nv_bfloat16* s, int i) {
  return __bfloat162float(s[i]);
}

// Copy `n` LUT entries into shared memory: 16-byte loads when the source
// and the byte count allow it, element loads otherwise.
template <typename T>
__device__ __forceinline__ void stage_lut(const T* __restrict__ src, T* dst, int n) {
  const int bytes = n * static_cast<int>(sizeof(T));
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (bytes & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < bytes / 16; i += kThreads) d[i] = __ldg(s + i);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  }
}

// Copy the bytes [src, src + n) into `dst` (16-byte aligned shared memory)
// at offset `head` = src % 16, so that every 16-byte chunk of global memory
// lands on a 16-byte chunk of shared memory. Chunks wholly inside the range
// move as one 16-byte load; the partial chunks at either end move byte by
// byte, so nothing outside [src, src + n) is read. Returns `head`.
__device__ __forceinline__ int stage_bytes(const uint8_t* __restrict__ src, int n,
                                           uint8_t* dst) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  const int head = static_cast<int>(addr & 15);
  const uintptr_t origin = addr - head;
  const int span = head + n;
  const int nchunks = (span + 15) >> 4;
  for (int c = threadIdx.x; c < nchunks; c += kThreads) {
    const int lo = c * 16;
    const int hi = lo + 16;
    if (lo >= head && hi <= span) {
      *reinterpret_cast<uint4*>(dst + lo) =
          __ldg(reinterpret_cast<const uint4*>(origin + lo));
    } else {
      const int b1 = hi < span ? hi : span;
      for (int b = lo > head ? lo : head; b < b1; ++b) {
        dst[b] = *reinterpret_cast<const uint8_t*>(origin + b);
      }
    }
  }
  return head;
}

// K2: any m, any ksub <= 256.
template <typename T>
__global__ void __launch_bounds__(kThreads)
adc_scan_kernel(const T* __restrict__ lut, const uint8_t* __restrict__ codes,
                float* __restrict__ out, int L, int m, int ksub) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lut_n = m * ksub;
  T* lut_s = reinterpret_cast<T*>(smem);
  uint8_t* tile_s = smem + ((lut_n * static_cast<int>(sizeof(T)) + 15) & ~15);

  const size_t p = blockIdx.x;
  stage_lut(lut + p * lut_n, lut_s, lut_n);
  const uint8_t* pair_codes = codes + p * static_cast<size_t>(L) * m;
  float* pair_out = out + p * static_cast<size_t>(L);

  const int row_begin = blockIdx.y * kBlockRows;
  const int row_end = min(L, row_begin + kBlockRows);
  for (int r0 = row_begin; r0 < row_end; r0 += kTileRows) {
    const int rows = min(kTileRows, row_end - r0);
    __syncthreads();  // the LUT is staged / the previous tile is consumed
    const int head = stage_bytes(pair_codes + static_cast<size_t>(r0) * m, rows * m,
                                 tile_s);
    __syncthreads();
    const int r = threadIdx.x;
    if (r < rows) {
      const uint8_t* row = tile_s + head + r * m;
      float acc = 0.f;
      for (int j = 0; j < m; ++j) acc += lut_value(lut_s, j * ksub + row[j]);
      pair_out[r0 + r] = acc;
    }
  }
}

// K3: ksub == 256, m % 8 == 0; the codes are read as aligned 8-byte words.
template <typename T>
__global__ void __launch_bounds__(kThreads)
adc_scan_nibble_kernel(const T* __restrict__ lut, const uint8_t* __restrict__ codes,
                       float* __restrict__ out, int L, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* lut_s = reinterpret_cast<T*>(smem);

  const size_t p = blockIdx.x;
  stage_lut(lut + p * m * kNibbleKsub, lut_s, m * kNibbleKsub);
  __syncthreads();

  const int words = m >> 3;  // 8-code words per row
  const uint2* pair_codes =
      reinterpret_cast<const uint2*>(codes + p * static_cast<size_t>(L) * m);
  float* pair_out = out + p * static_cast<size_t>(L);
  const int row_end = min(L, static_cast<int>(blockIdx.y + 1) * kBlockRows);
  for (int r = blockIdx.y * kBlockRows + threadIdx.x; r < row_end; r += kThreads) {
    const uint2* row = pair_codes + static_cast<size_t>(r) * words;
    float acc = 0.f;
#pragma unroll 4
    for (int c = 0; c < words; ++c) {
      const uint2 w = __ldg(row + c);
      const T* sub = lut_s + c * 8 * kNibbleKsub;  // subspaces 8c .. 8c+7
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc += lut_value(sub, e * kNibbleKsub + ((w.x >> (8 * e)) & 0xffu));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc += lut_value(sub, (4 + e) * kNibbleKsub + ((w.y >> (8 * e)) & 0xffu));
      }
    }
    pair_out[r] = acc;
  }
}

// K4: one code list (L, m) shared by all nq queries; out (nq, L).
//
//   out[q, c] = sum_{j < m} lut[q, j, codes[c, j]]          fp32 accumulation
//
// What bounds it. Read once, the inputs are small beside the output: at
// the flat-PQ path's shape (nq = 256 queries, a 262,144-row chunk of the
// list, m = 64, f32 LUT) the codes are 16 MB, the LUTs 16 MB and the
// (nq, L) fp32 scores 256 MB, so by bytes the output sets the bound. The
// work is nq * L * m table lookups, each a shared-memory load at a
// data-dependent bank, and one fp32 add each; the lookups, not the bytes,
// are what a simple kernel spends its time on.
//
// What the design does about it.
//   * A block owns a tile of kSharedTile code rows (kSharedRowsPerThread
//     per thread) and a group of up to kSharedQueries queries. The tile is
//     staged into shared memory once, transposed into 32-bit words (word w
//     of every row, then word w + 1, ...) with a one-word pad per word
//     column, so each thread reads its rows' codes 4 at a time without bank
//     conflicts, and the staging's byte stores land on distinct banks. The
//     global reads of the staging are byte loads by consecutive threads of
//     consecutive bytes: coalesced, at any alignment and any m, never
//     outside (L, m).
//   * For each query of the group the block stages that query's LUT into
//     shared memory (16-byte loads, in its own dtype) and every thread sums
//     the m lookups of each of its rows in fp32, in j order (the order of
//     the plain version), writing out[q, row] coalesced along the rows.
//     The code tile is read from global memory once per query group, not
//     once per query; each LUT once per tile.
//   * The LUT buffer and the code tile share the block's shared memory:
//     the wrapper refuses an m whose two do not fit Hopper's 227 KB.
//   * Blocks carry nothing across each other and run in any order.
constexpr int kSharedRowsPerThread = 4;
constexpr int kSharedTile = kThreads * kSharedRowsPerThread;  // code rows a block owns
constexpr int kSharedStride = kSharedTile + 1;  // words per staged word column (+1 pad)
constexpr int kSharedQueries = 32;              // queries a block walks over its tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
adc_scan_shared_kernel(const T* __restrict__ lut, const uint8_t* __restrict__ codes,
                       float* __restrict__ out, int nq, int L, int m, int ksub) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lut_n = m * ksub;
  T* lut_s = reinterpret_cast<T*>(smem);
  uint32_t* words_s = reinterpret_cast<uint32_t*>(
      smem + ((lut_n * static_cast<int>(sizeof(T)) + 15) & ~15));
  uint8_t* word_bytes = reinterpret_cast<uint8_t*>(words_s);

  const int r0 = blockIdx.x * kSharedTile;
  const int rows = min(kSharedTile, L - r0);
  const uint8_t* tile = codes + static_cast<size_t>(r0) * m;
  const int tile_bytes = rows * m;
  for (int i = threadIdx.x; i < tile_bytes; i += kThreads) {
    const int r = i / m;
    const int j = i - r * m;
    word_bytes[((j >> 2) * kSharedStride + r) * 4 + (j & 3)] = __ldg(tile + i);
  }

  const int full_words = m >> 2;
  const int tail = m & 3;
  const int q_end = min(nq, static_cast<int>(blockIdx.y + 1) * kSharedQueries);
  for (int q = blockIdx.y * kSharedQueries; q < q_end; ++q) {
    __syncthreads();  // the code tile is staged / the previous LUT is consumed
    stage_lut(lut + static_cast<size_t>(q) * lut_n, lut_s, lut_n);
    __syncthreads();
    float acc[kSharedRowsPerThread];
#pragma unroll
    for (int i = 0; i < kSharedRowsPerThread; ++i) acc[i] = 0.f;
    for (int w = 0; w < full_words; ++w) {
      const T* sub = lut_s + w * 4 * ksub;  // subspaces 4w .. 4w+3
      const uint32_t* col = words_s + w * kSharedStride + threadIdx.x;
#pragma unroll
      for (int i = 0; i < kSharedRowsPerThread; ++i) {
        const uint32_t word = col[i * kThreads];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i] += lut_value(sub, e * ksub + ((word >> (8 * e)) & 0xffu));
        }
      }
    }
    if (tail) {
      const T* sub = lut_s + full_words * 4 * ksub;
      const uint32_t* col = words_s + full_words * kSharedStride + threadIdx.x;
#pragma unroll
      for (int i = 0; i < kSharedRowsPerThread; ++i) {
        const uint32_t word = col[i * kThreads];
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          if (e < tail) acc[i] += lut_value(sub, e * ksub + ((word >> (8 * e)) & 0xffu));
        }
      }
    }
    float* q_out = out + static_cast<size_t>(q) * L + r0;
#pragma unroll
    for (int i = 0; i < kSharedRowsPerThread; ++i) {
      const int r = threadIdx.x + i * kThreads;
      if (r < rows) q_out[r] = acc[i];
    }
  }
}

// Launch `kernel` on `grid` with `smem` bytes of dynamic shared memory,
// opting in above the default 48 KB. Returns the launch's
// cudaGetLastError().
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// K2/K3's grid: one block per (pair, kBlockRows rows).
dim3 pair_grid(int P, int L) {
  return dim3(static_cast<unsigned>(P),
              static_cast<unsigned>((L + kBlockRows - 1) / kBlockRows));
}

}  // namespace

// Plain-C entries (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: lut (P, m, ksub) f32 (lut_bf16 = 0) or bf16
// (lut_bf16 = 1); codes (P, L, m) u8; out (P, L) f32 (K4: lut (nq, m,
// ksub), codes (L, m), out (nq, L)). Each launches on
// `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a geometry it does not take; it never
// synchronises.

// K2.
extern "C" int dft_adc_scan(const void* lut, const void* codes, void* out, int P,
                            int L, int m, int ksub, int lut_bf16, void* stream) {
  if (P <= 0 || L <= 0) return 0;
  if (m <= 0 || ksub <= 0 || ksub > 256) return static_cast<int>(cudaErrorInvalidValue);
  const size_t item = lut_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const size_t smem = ((static_cast<size_t>(m) * ksub * item + 15) & ~size_t{15}) +
                      static_cast<size_t>(kTileRows) * m + 16;
  const auto* c = static_cast<const uint8_t*>(codes);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (lut_bf16) {
    err = launch(adc_scan_kernel<__nv_bfloat16>, pair_grid(P, L), smem, st,
                 static_cast<const __nv_bfloat16*>(lut), c, o, L, m, ksub);
  } else {
    err = launch(adc_scan_kernel<float>, pair_grid(P, L), smem, st,
                 static_cast<const float*>(lut), c, o, L, m, ksub);
  }
  return static_cast<int>(err);
}

// K3: ksub is 256; m % 8 == 0 and `codes` 8-byte aligned.
extern "C" int dft_adc_scan_nibble(const void* lut, const void* codes, void* out,
                                   int P, int L, int m, int lut_bf16, void* stream) {
  if (P <= 0 || L <= 0) return 0;
  if (m <= 0 || m % 8 != 0 || (reinterpret_cast<uintptr_t>(codes) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t item = lut_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const size_t smem = static_cast<size_t>(m) * kNibbleKsub * item;
  const auto* c = static_cast<const uint8_t*>(codes);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (lut_bf16) {
    err = launch(adc_scan_nibble_kernel<__nv_bfloat16>, pair_grid(P, L), smem, st,
                 static_cast<const __nv_bfloat16*>(lut), c, o, L, m);
  } else {
    err = launch(adc_scan_nibble_kernel<float>, pair_grid(P, L), smem, st,
                 static_cast<const float*>(lut), c, o, L, m);
  }
  return static_cast<int>(err);
}

// K4: codes (L, m) shared by the nq queries, at any byte offset.
extern "C" int dft_adc_scan_shared(const void* lut, const void* codes, void* out, int nq,
                                   int L, int m, int ksub, int lut_bf16, void* stream) {
  if (nq <= 0 || L <= 0) return 0;
  if (m <= 0 || ksub <= 0 || ksub > 256) return static_cast<int>(cudaErrorInvalidValue);
  const size_t item = lut_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const size_t smem = ((static_cast<size_t>(m) * ksub * item + 15) & ~size_t{15}) +
                      static_cast<size_t>((m + 3) / 4) * kSharedStride * 4;
  const dim3 grid(static_cast<unsigned>((L + kSharedTile - 1) / kSharedTile),
                  static_cast<unsigned>((nq + kSharedQueries - 1) / kSharedQueries));
  const auto* c = static_cast<const uint8_t*>(codes);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (lut_bf16) {
    err = launch(adc_scan_shared_kernel<__nv_bfloat16>, grid, smem, st,
                 static_cast<const __nv_bfloat16*>(lut), c, o, nq, L, m, ksub);
  } else {
    err = launch(adc_scan_shared_kernel<float>, grid, smem, st,
                 static_cast<const float*>(lut), c, o, nq, L, m, ksub);
  }
  return static_cast<int>(err);
}
