// PQ asymmetric-distance (ADC) scans for Hopper (sm_90a): K2 and K3.
//
// Replaces two TPU kernels of distributed_faiss_tpu/ops/adc_pallas.py that
// compute one function:
//
//   K2  adc_scan_pallas         (adc_pallas.py:139)  any m, ksub <= 256
//   K3  adc_scan_pallas_nibble  (adc_pallas.py:209)  ksub == 256, m % 8 == 0
//
//   out[p, c] = sum_{j < m} lut[p, j, codes[p, c, j]]      fp32 accumulation
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

// Launch `kernel` with `smem` bytes of dynamic shared memory, opting in
// above the default 48 KB. Returns the launch's cudaGetLastError().
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int P, int L, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(P),
                  static_cast<unsigned>((L + kBlockRows - 1) / kBlockRows));
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// Plain-C entries (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: lut (P, m, ksub) f32 (lut_bf16 = 0) or bf16
// (lut_bf16 = 1); codes (P, L, m) u8; out (P, L) f32. Each launches on
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
    err = launch(adc_scan_kernel<__nv_bfloat16>, P, L, smem, st,
                 static_cast<const __nv_bfloat16*>(lut), c, o, L, m, ksub);
  } else {
    err = launch(adc_scan_kernel<float>, P, L, smem, st, static_cast<const float*>(lut),
                 c, o, L, m, ksub);
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
    err = launch(adc_scan_nibble_kernel<__nv_bfloat16>, P, L, smem, st,
                 static_cast<const __nv_bfloat16*>(lut), c, o, L, m);
  } else {
    err = launch(adc_scan_nibble_kernel<float>, P, L, smem, st,
                 static_cast<const float*>(lut), c, o, L, m);
  }
  return static_cast<int>(err);
}
