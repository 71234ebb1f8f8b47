// PQ asymmetric-distance (ADC) scans for Hopper (sm_90a): K2, K3 and K4.
//
// Replaces three TPU kernels of distributed_faiss_tpu/ops/adc_pallas.py.
// K2 and K3 score per-pair code lists:
//
//   K2  adc_scan_pallas         (adc_pallas.py:139)  any m, ksub <= 256
//   K3  adc_scan_pallas_nibble  (adc_pallas.py:209)  ksub == 256, m % 8 == 0
//
//   out[p, c] = sum_{j < m} lut[p, j, codes[p, c, j]]      fp32 accumulation
//
// lut (P, m, ksub) f32 or bf16 (a bf16 entry enters the sum as the fp32
// value it represents); codes (P, L, m) u8, row c of pair p holding the m
// sub-quantizer codes of one candidate; out (P, L) f32. A pair p is one
// (query, probed list).
//
// K3 also takes the function that the JAX package's probe body computes
// around its nibble kernel (distributed_faiss_tpu/models/ivf.py:225-253):
// pair p = (i, j) reads list li[i, j] of the index's own (nlist, cap, m)
// code lists, never a gathered copy, and
//
//   out[p, c] = sum_j lut[p, j, list_codes[li[p], c, j]]   if c < sizes_g[p]
//                                                          and ids[li[p], c] >= 0
//             = -inf                                       otherwise
//
// The gathered entry is the case of one list per pair, no size cut and no
// id plane, on the same kernel.
//
// K4 (adc_scan_shared_pallas, adc_pallas.py:110) scores one code list that
// every query shares (flat PQ: an IVF-PQ index with one list); it is
// described at its kernel below.
//
// What bounds K2 and K3. Per pair the kernel must read the pair's LUT once
// (m * ksub * itemsize bytes: 32 KB for m = 64 in bf16, 64 KB in f32), its
// live code rows (m bytes each, with a 4-byte id for K3 over the lists) and
// write one fp32 score per row of capacity; the work is one table lookup
// and one fp32 add per code byte. That is well under one operation per
// byte read against the card's ~20 fp32 operations per byte of HBM
// bandwidth (67 TFLOP/s over 3.35 TB/s): the kernels are bound by bytes.
// Since K3 stops at each list's size, the per-pair LUTs are most of its
// bytes (8.4 of about 14 MB at the knnlm shard's shape, where a probed
// list holds a tenth of its capacity). Tensor cores have nothing to do
// here: the TPU kernels built one-hot (or 4-bit hi/lo one-hot) planes only
// so that its matrix unit could do the lookup; a shared-memory gather does
// it directly.
//
// What the design does about it.
//   * A block owns one pair and up to kBlockRows rows of it; the pair's LUT
//     is staged into shared memory once per block, in its own dtype, so a
//     bf16 LUT costs half the bytes and half the shared memory. Above 48 KB
//     (the f32 LUT at m = 64) the block takes dynamic shared memory after
//     cudaFuncSetAttribute.
//   * K2 (general m, including m that is no power of two, e.g. 12): a
//     256-row tile of code rows is a contiguous byte range; the block copies
//     it into shared memory with 16-byte loads for the aligned interior and
//     byte loads for the ragged ends, never touching a byte outside
//     (P, L, m). Each thread then sums its row's m lookups in fp32.
//   * K3 (ksub = 256 fixed at compile time, m % 8 == 0): the block reads
//     li and the list's size itself. A block whose rows all lie at or past
//     the size writes their -inf with 16-byte stores and returns before it
//     stages the LUT; otherwise it writes the -inf of its dead rows, starts
//     16-byte cp.async copies of the LUT and, while they fly, loads the
//     first 64 codes and the id of its threads' first rows. Each thread
//     reads its live rows straight from the list in 16-byte words (8-byte
//     where the row pitch or the slice offset is no multiple of 16), ids
//     only for live rows, and loads the next row's first words before it
//     sums the current one. A pair with at most kBlockRows live rows stages
//     its LUT once.
//   * Lookups hit shared memory at data-dependent addresses: random codes
//     spread a warp's 32 lookups over the 32 banks with a few conflicts on
//     average. Nothing is written but the one fp32 score per row.
//   * Blocks carry nothing across each other and run in any order.
//
// Left for later: fusing the LUT build (a per-pair residual product with
// the codebooks) into K3, so that the LUT, now most of its bytes, is never
// written to device memory; and a per-group top-k inside the kernel.
//
// Built by distributed_faiss_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

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
    for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) d[i] = __ldg(s + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Start the 16-byte asynchronous copies of `bytes` (a multiple of 16, both
// ends 16-byte aligned) from `src` into shared `dst`, as one commit group.
__device__ __forceinline__ void stage_lut_async(const void* src, void* dst, int bytes) {
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16) cp_async16(d + i, s + i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
                float* __restrict__ out, int L, int m, int ksub, int accumulate) {
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
      float acc = accumulate ? pair_out[r0 + r] : 0.f;
      for (int j = 0; j < m; ++j) acc += lut_value(lut_s, j * ksub + row[j]);
      pair_out[r0 + r] = acc;
    }
  }
}

// The lookups of 4 codes packed in u (subspaces j0 .. j0 + 3), and of one
// code word (8 or 16 codes from subspace j0), added to acc in subspace
// order.
template <typename T>
__device__ __forceinline__ float add4(const T* lut_s, uint32_t u, int j0, float acc) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc += lut_value(lut_s, (j0 + e) * kNibbleKsub + ((u >> (8 * e)) & 0xffu));
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ float add_word(const T* lut_s, const uint2& w, int j0, float acc) {
  return add4(lut_s, w.y, j0 + 4, add4(lut_s, w.x, j0, acc));
}

template <typename T>
__device__ __forceinline__ float add_word(const T* lut_s, const uint4& w, int j0, float acc) {
  acc = add4(lut_s, w.y, j0 + 4, add4(lut_s, w.x, j0, acc));
  return add4(lut_s, w.w, j0 + 12, add4(lut_s, w.z, j0 + 8, acc));
}

// K3: ksub == 256, m % 8 == 0; codes read as words W (uint4 or uint2).
// Pair p's rows are list li[p] of `codes` (nlist, cap) with row pitch
// `pitch`, live below sizes[p] and masked where ids < 0; li, sizes and ids
// null: pair p's own list, every row live, no mask. With `accumulate` the
// launch adds this slice's sums to the live rows' scores and writes
// nothing else (masked rows stay -inf).
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
adc_scan_lists_kernel(const T* __restrict__ lut, const uint8_t* __restrict__ codes,
                      const int32_t* __restrict__ li, const int32_t* __restrict__ sizes,
                      const int32_t* __restrict__ ids, float* __restrict__ out, int cap,
                      int m, int pitch, int accumulate) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* lut_s = reinterpret_cast<T*>(smem);
  constexpr int kCodes = static_cast<int>(sizeof(W));  // codes a word
  constexpr int kHead = 64 / kCodes;  // words of a row loaded ahead: 64 codes

  const int p = blockIdx.x;
  const int r0 = blockIdx.y * kBlockRows;
  const int r1 = min(cap, r0 + kBlockRows);
  const int size = sizes ? max(0, min(sizes[p], cap)) : cap;
  const int live_end = min(r1, size);
  float* pair_out = out + static_cast<size_t>(p) * cap;
  if (!accumulate) {
    const int dead0 = max(r0, live_end);
    fill_neg_inf(pair_out + dead0, r1 - dead0);
  }
  if (live_end <= r0) return;  // no live row: the LUT is never staged

  const int lut_n = m * kNibbleKsub;
  const T* pair_lut = lut + static_cast<size_t>(p) * lut_n;
  const bool async = (reinterpret_cast<uintptr_t>(pair_lut) & 15) == 0;
  if (async) {
    stage_lut_async(pair_lut, lut_s, lut_n * static_cast<int>(sizeof(T)));
  } else {
    stage_lut(pair_lut, lut_s, lut_n);
  }

  const size_t list_row0 = static_cast<size_t>(li ? li[p] : p) * cap;
  const W* list_words = reinterpret_cast<const W*>(codes + list_row0 * pitch);
  const int32_t* list_ids = (ids && !accumulate) ? ids + list_row0 : nullptr;
  const int words = m / kCodes;
  const int row_words = pitch / kCodes;
  // a row's first kHead words and its id, loaded ahead of its sum
  auto load_head = [&](int r, W* head, int& id) {
    if (r < live_end) {
      const W* row = list_words + static_cast<size_t>(r) * row_words;
#pragma unroll
      for (int k = 0; k < kHead; ++k) {
        if (k < words) head[k] = __ldg(row + k);
      }
      id = list_ids ? list_ids[r] : 0;
    }
  };

  int r = r0 + threadIdx.x;
  W head[kHead];
  int id = 0;
  load_head(r, head, id);  // in flight with the LUT copy
  if (async) cp_async_wait_all();
  __syncthreads();
  for (; r < live_end; r += kThreads) {
    W next[kHead];
    int next_id = 0;
    load_head(r + kThreads, next, next_id);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kHead; ++k) {
      if (k < words) acc = add_word(lut_s, head[k], k * kCodes, acc);
    }
    const W* row = list_words + static_cast<size_t>(r) * row_words;
    for (int c = kHead; c < words; ++c) acc = add_word(lut_s, __ldg(row + c), c * kCodes, acc);
    if (accumulate) {
      const float prev = pair_out[r];
      if (prev != neg_inf()) pair_out[r] = prev + acc;
    } else {
      pair_out[r] = id < 0 ? neg_inf() : acc;
    }
#pragma unroll
    for (int k = 0; k < kHead; ++k) head[k] = next[k];
    id = next_id;
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
// are what the kernel spends its time on. Random 8-bit codes put a warp's
// 32 lookups on about 3.5 wavefronts of the 32 banks on average.
//
// What the design does about it.
//   * A block of kSharedThreads threads owns a tile of kSharedTile code
//     rows (kSharedRowsPerThread per thread) and a group of up to
//     kSharedQueries queries. The tile is staged into shared memory once,
//     transposed into 32-bit words (word w of every row, then word w + 1,
//     ...) with a one-word pad per word column, so each thread reads its
//     rows' codes 4 at a time without bank conflicts. Rows that start on a
//     16-byte boundary are staged with 16-byte loads, each split into four
//     word columns; other rows (an odd byte offset, a pitch that is no
//     multiple of 16) byte by byte, never outside the rows' m bytes.
//   * The queries' LUTs stream through two shared-memory buffers: while
//     the block scans its tile for query q, 16-byte cp.async copies bring
//     query q + 1's LUT into the other buffer, so the copy from L2 is
//     hidden behind the lookups and each query costs one block barrier.
//     (A LUT that is not 16-byte aligned is staged with plain loads.)
//   * 16 warps a block keep enough independent lookups in flight to cover
//     the shared-memory latency of data-dependent addresses; every thread
//     sums the m lookups of each of its rows in fp32, in j order (the
//     order of the plain version), starting from 0 or, with `accumulate`,
//     from the score already in `out`, and writes out[q, row] coalesced.
//   * Two LUT buffers and the code tile share the block's 227 KB: the
//     wrapper hands the kernel subspace slices that fit
//     (shared_smem_bytes in ops/adc_scan.py).
//   * Blocks carry nothing across each other and run in any order.
constexpr int kSharedThreads = 512;
constexpr int kSharedRowsPerThread = 2;
constexpr int kSharedTile = kSharedThreads * kSharedRowsPerThread;  // code rows a block owns
constexpr int kSharedStride = kSharedTile + 1;  // words per staged word column (+1 pad)
constexpr int kSharedQueries = 32;              // queries a block walks over its tile

// Stage `rows` code rows of m bytes, row r at tile + r * pitch, as the
// transposed word columns of `words` (kSharedStride words each).
__device__ __forceinline__ void stage_code_tile(const uint8_t* __restrict__ tile, int rows,
                                                int m, int pitch, uint32_t* words) {
  uint8_t* word_bytes = reinterpret_cast<uint8_t*>(words);
  const int chunks = (m + 15) >> 4;  // 16-byte chunks a row
  const bool vec = ((reinterpret_cast<uintptr_t>(tile) | static_cast<uintptr_t>(pitch)) & 15) == 0;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kSharedThreads) {
    const int r = idx / chunks;
    const int c = idx - r * chunks;
    const uint8_t* src = tile + static_cast<size_t>(r) * pitch + c * 16;
    const int n = min(16, m - c * 16);
    if (vec && n == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
      uint32_t* dst = words + c * 4 * kSharedStride + r;
      dst[0] = v.x;
      dst[kSharedStride] = v.y;
      dst[2 * kSharedStride] = v.z;
      dst[3 * kSharedStride] = v.w;
    } else {
      for (int e = 0; e < n; ++e) {
        const int j = c * 16 + e;
        word_bytes[((j >> 2) * kSharedStride + r) * 4 + (j & 3)] = __ldg(src + e);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kSharedThreads, 1)
adc_scan_shared_kernel(const T* __restrict__ lut, const uint8_t* __restrict__ codes,
                       float* __restrict__ out, int nq, int L, int m, int ksub, int pitch,
                       int accumulate) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lut_n = m * ksub;
  const int lut_bytes = lut_n * static_cast<int>(sizeof(T));
  const int buf_bytes = (lut_bytes + 15) & ~15;
  T* bufs[2] = {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem + buf_bytes)};
  uint32_t* words_s = reinterpret_cast<uint32_t*>(smem + 2 * buf_bytes);

  const int r0 = blockIdx.x * kSharedTile;
  const int rows = min(kSharedTile, L - r0);
  const int q_begin = blockIdx.y * kSharedQueries;
  const int q_end = min(nq, q_begin + kSharedQueries);
  const bool async =
      ((reinterpret_cast<uintptr_t>(lut) | static_cast<uintptr_t>(lut_bytes)) & 15) == 0;

  // the first LUT is in flight while the code tile is staged
  if (async) stage_lut_async(lut + static_cast<size_t>(q_begin) * lut_n, bufs[0], lut_bytes);
  stage_code_tile(codes + static_cast<size_t>(r0) * pitch, rows, m, pitch, words_s);

  const int full_words = m >> 2;
  const int tail = m & 3;
  for (int q = q_begin; q < q_end; ++q) {
    const T* lut_s = bufs[(q - q_begin) & 1];
    if (async) {
      cp_async_wait_all();
      // query q's LUT and the code tile are in place; every thread is done
      // with query q - 1's buffer, which now takes query q + 1's LUT
      __syncthreads();
      if (q + 1 < q_end) {
        stage_lut_async(lut + static_cast<size_t>(q + 1) * lut_n, bufs[(q + 1 - q_begin) & 1],
                        lut_bytes);
      }
    } else {
      __syncthreads();  // this buffer's previous query (q - 2) is consumed
      stage_lut(lut + static_cast<size_t>(q) * lut_n, bufs[(q - q_begin) & 1], lut_n);
      __syncthreads();
    }
    float* q_out = out + static_cast<size_t>(q) * L + r0;
    float acc[kSharedRowsPerThread];
#pragma unroll
    for (int i = 0; i < kSharedRowsPerThread; ++i) {
      const int r = threadIdx.x + i * kSharedThreads;
      acc[i] = (accumulate && r < rows) ? q_out[r] : 0.f;
    }
#pragma unroll 4
    for (int w = 0; w < full_words; ++w) {
      const T* sub = lut_s + w * 4 * ksub;  // subspaces 4w .. 4w+3
      const uint32_t* col = words_s + w * kSharedStride + threadIdx.x;
#pragma unroll
      for (int i = 0; i < kSharedRowsPerThread; ++i) {
        const uint32_t word = col[i * kSharedThreads];
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
        const uint32_t word = col[i * kSharedThreads];
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          if (e < tail) acc[i] += lut_value(sub, e * ksub + ((word >> (8 * e)) & 0xffu));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kSharedRowsPerThread; ++i) {
      const int r = threadIdx.x + i * kSharedThreads;
      if (r < rows) q_out[r] = acc[i];
    }
  }
}

// Launch `kernel` on `grid` with `smem` bytes of dynamic shared memory,
// opting in above the default 48 KB. Returns the launch's
// cudaGetLastError().
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// K2/K3's grid: one block per (pair, kBlockRows rows).
dim3 pair_grid(int P, int L) {
  return dim3(static_cast<unsigned>(P),
              static_cast<unsigned>((L + kBlockRows - 1) / kBlockRows));
}

}  // namespace

// Plain-C entries (loaded with ctypes). Pointers are device pointers:
// lut (P, m, ksub) f32 (lut_bf16 = 0) or bf16 (lut_bf16 = 1), contiguous;
// codes (P, L, m) u8, code row c of pair p at byte (p * L + c) * pitch (K2:
// pitch = m); out (P, L) f32 (K4: lut (nq, m, ksub), codes (L, m) with
// row c at byte c * pitch, out (nq, L)). A subspace slice [s, s + m) of a
// wider list is `codes` advanced by s bytes with the list's row pitch.
// With accumulate = 0 each score is this call's sum; with accumulate = 1
// it starts from the value already in `out` and adds this call's m
// lookups in subspace order, so a wrapper that launches the slices of a
// wide m in turn gets the sum of the whole row in subspace order. Each
// launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a geometry it does not take; it never
// synchronises.

// K2: codes contiguous (pitch = m).
extern "C" int dft_adc_scan(const void* lut, const void* codes, void* out, int P, int L,
                            int m, int ksub, int lut_bf16, int accumulate, void* stream) {
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
    err = launch(adc_scan_kernel<__nv_bfloat16>, pair_grid(P, L), kThreads, smem, st,
                 static_cast<const __nv_bfloat16*>(lut), c, o, L, m, ksub, accumulate);
  } else {
    err = launch(adc_scan_kernel<float>, pair_grid(P, L), kThreads, smem, st,
                 static_cast<const float*>(lut), c, o, L, m, ksub, accumulate);
  }
  return static_cast<int>(err);
}

namespace {

// K3's launch: one block per (pair, kBlockRows rows of capacity).
int launch_lists(const void* lut, const void* codes, const void* li, const void* sizes,
                 const void* ids, void* out, int P, int cap, int m, int pitch, int lut_bf16,
                 int accumulate, void* stream) {
  if (P <= 0 || cap <= 0) return 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(codes);
  if (m <= 0 || m % 8 != 0 || pitch < m || pitch % 8 != 0 || (addr & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = ((addr | static_cast<uintptr_t>(pitch) | static_cast<uintptr_t>(m)) & 15) == 0;
  const size_t item = lut_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const size_t smem = static_cast<size_t>(m) * kNibbleKsub * item;
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* lip = static_cast<const int32_t*>(li);
  const auto* szp = static_cast<const int32_t*>(sizes);
  const auto* idp = static_cast<const int32_t*>(ids);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid = pair_grid(P, cap);
  cudaError_t err;
  if (lut_bf16) {
    const auto* t = static_cast<const __nv_bfloat16*>(lut);
    err = wide ? launch(adc_scan_lists_kernel<__nv_bfloat16, uint4>, grid, kThreads, smem, st,
                        t, c, lip, szp, idp, o, cap, m, pitch, accumulate)
               : launch(adc_scan_lists_kernel<__nv_bfloat16, uint2>, grid, kThreads, smem, st,
                        t, c, lip, szp, idp, o, cap, m, pitch, accumulate);
  } else {
    const auto* t = static_cast<const float*>(lut);
    err = wide ? launch(adc_scan_lists_kernel<float, uint4>, grid, kThreads, smem, st,
                        t, c, lip, szp, idp, o, cap, m, pitch, accumulate)
               : launch(adc_scan_lists_kernel<float, uint2>, grid, kThreads, smem, st,
                        t, c, lip, szp, idp, o, cap, m, pitch, accumulate);
  }
  return static_cast<int>(err);
}

}  // namespace

// K3 over gathered code lists: ksub is 256; m and pitch multiples of 8 and
// `codes` 8-byte aligned. Pair p's rows are its own (L, m) list.
extern "C" int dft_adc_scan_nibble(const void* lut, const void* codes, void* out, int P,
                                   int L, int m, int pitch, int lut_bf16, int accumulate,
                                   void* stream) {
  return launch_lists(lut, codes, nullptr, nullptr, nullptr, out, P, L, m, pitch, lut_bf16,
                      accumulate, stream);
}

// K3 over the probed lists: codes (nlist, cap, m) with row c of list l at
// byte (l * cap + c) * pitch; li, sizes (P,) i32, the pair's list and its
// fill count; ids (nlist, cap) i32; out (P, cap) f32, -inf at rows past the
// size or with id < 0 (an accumulating launch leaves those as they are).
extern "C" int dft_adc_scan_lists(const void* lut, const void* codes, const void* li,
                                  const void* sizes, const void* ids, void* out, int P,
                                  int cap, int m, int pitch, int lut_bf16, int accumulate,
                                  void* stream) {
  return launch_lists(lut, codes, li, sizes, ids, out, P, cap, m, pitch, lut_bf16, accumulate,
                      stream);
}

// K4: codes (L, m) shared by the nq queries, at any byte offset and pitch.
extern "C" int dft_adc_scan_shared(const void* lut, const void* codes, void* out, int nq,
                                   int L, int m, int ksub, int pitch, int lut_bf16,
                                   int accumulate, void* stream) {
  if (nq <= 0 || L <= 0) return 0;
  if (m <= 0 || ksub <= 0 || ksub > 256 || pitch < m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t item = lut_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const size_t smem = 2 * ((static_cast<size_t>(m) * ksub * item + 15) & ~size_t{15}) +
                      static_cast<size_t>((m + 3) / 4) * kSharedStride * 4;
  const dim3 grid(static_cast<unsigned>((L + kSharedTile - 1) / kSharedTile),
                  static_cast<unsigned>((nq + kSharedQueries - 1) / kSharedQueries));
  const auto* c = static_cast<const uint8_t*>(codes);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (lut_bf16) {
    err = launch(adc_scan_shared_kernel<__nv_bfloat16>, grid, kSharedThreads, smem, st,
                 static_cast<const __nv_bfloat16*>(lut), c, o, nq, L, m, ksub, pitch,
                 accumulate);
  } else {
    err = launch(adc_scan_shared_kernel<float>, grid, kSharedThreads, smem, st,
                 static_cast<const float*>(lut), c, o, nq, L, m, ksub, pitch, accumulate);
  }
  return static_cast<int>(err);
}
