// IVF-Flat/SQ8 probe-group list scan for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_faiss_tpu/ops/flat_pallas.py::
// flat_list_scan_pallas (body _flat_kernel). Same function:
//
//   for each (query i, probe j, row pos) of list l = li[i, j]:
//     x     = decode(list_data[l, pos])     f32 as is | f16 -> f32 |
//                                           u8 -> fma(c, span * (1/255), vmin)
//                                           (the bits XLA gives the JAX
//                                           package's vmin + c * (span / 255))
//     ip    = <q_i, x>                      fp32 accumulation; with
//                                           scan_bf16 both operands are
//                                           rounded to bf16 first
//     score = ip                            (dot)
//           | -(|q_i|^2 - 2 ip + |x|^2)     (l2; |x|^2 from the stored
//                                           norms, or recomputed from x)
//     out[i, j, pos] = score if pos < sizes_g[i, j] and ids[l, pos] >= 0
//                      else -inf
//
// What bounds it. Each gathered row is used by exactly one (query, probe)
// pair and meets one query vector: about 2 flops per element read, i.e.
// ~1 flop/byte for fp16 rows and ~0.25 for fp32. The card does ~20 fp32
// flops per byte of HBM bandwidth (67 TFLOP/s over 3.35 TB/s), so the
// kernel is bound by the bytes it moves, not by arithmetic, and tensor
// cores would not help at this arithmetic intensity.
//
// What the design does about it.
//   * Only live rows are read: a row at pos >= sizes_g[i, j] (the padded
//     tail of a pow2-capacity list) is never loaded, only written as -inf.
//   * Rows are read with coalesced 16-byte loads (uint4): a row of d
//     elements is split into 16-byte chunks, and a segment of
//     `lanes_per_row` neighbouring lanes (a power of two, <= 32) walks the
//     chunks of one row, so a warp covers 32 / lanes_per_row rows at once
//     and every lane has a load in flight even for narrow rows (fp16 d=128
//     is 16 chunks: two rows per warp; u8 d=128 is 8 chunks: four rows).
//   * Decode happens in registers; the query (and the sq8 vmin and
//     span/255 planes) sit in shared memory, loaded once per block.
//   * Dot products accumulate in fp32 per lane and are reduced with xor
//     shuffles inside each segment; ||x||^2 for the recomputed-norm mode
//     rides the same pass, so a row is read once.
//   * The validity mask is applied before the single fp32 store per row.
// A block owns one (query, probe) pair and a tile of rows; it reads
// li[i, j] and sizes_g[i, j] itself (the TPU kernel had them as scalar
// prefetch). Blocks run in any order: nothing carries across them.
//
// Fusing the per-group top-k, or grouping the queries that share a list
// into one tensor-core GEMM (which would lift the arithmetic intensity),
// is left for a later change; this version is the simple, right one.
//
// Built by distributed_faiss_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded through ctypes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 256;  // rows of one (query, probe) pair per block tile

enum Codec { kF32 = 0, kF16 = 1, kU8 = 2 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A 16-byte chunk of a stored row, decoded to N fp32 values (before the
// sq8 affine step, which needs the dimension index).
template <typename T> struct Chunk;

template <> struct Chunk<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void decode(const uint4& c, float* v) {
    v[0] = __uint_as_float(c.x);
    v[1] = __uint_as_float(c.y);
    v[2] = __uint_as_float(c.z);
    v[3] = __uint_as_float(c.w);
  }
  __device__ __forceinline__ static float scalar(const float* p) { return *p; }
};

template <> struct Chunk<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void decode(const uint4& c, float* v) {
    const __half2* h = reinterpret_cast<const __half2*>(&c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __half22float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float scalar(const __half* p) {
    return __half2float(*p);
  }
};

template <> struct Chunk<uint8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void decode(const uint4& c, float* v) {
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        v[4 * e + b] = static_cast<float>((w[e] >> (8 * b)) & 0xffu);
      }
    }
  }
  __device__ __forceinline__ static float scalar(const uint8_t* p) {
    return static_cast<float>(*p);
  }
};

// One element's contribution: sq8 affine decode, then the (optionally
// bf16-rounded) product into ip and the fp32 square into xn.
template <bool SQ8>
__device__ __forceinline__ void accumulate(float x, int k, const float* qs,
                                           const float* vmin_s,
                                           const float* scale_s, bool bf16,
                                           float& ip, float& xn) {
  if (SQ8) x = fmaf(x, scale_s[k], vmin_s[k]);
  xn += x * x;
  const float qv = qs[k];
  ip += bf16 ? bf16_round(qv) * bf16_round(x) : qv * x;
}

// VEC: rows are read as 16-byte chunks (d * sizeof(T) % 16 == 0 and a
// 16-byte aligned base); otherwise element by element.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
flat_scan_kernel(const float* __restrict__ q, const T* __restrict__ data,
                 const int32_t* __restrict__ ids,
                 const int32_t* __restrict__ li,
                 const int32_t* __restrict__ sizes_g,
                 const float* __restrict__ norms,
                 const float* __restrict__ vmin,
                 const float* __restrict__ span, float* __restrict__ out,
                 int g, int cap, int d, int metric_l2, int scan_bf16,
                 int lanes_per_row) {
  constexpr bool kSq8 = sizeof(T) == 1;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // (d,) the query
  float* vmin_s = smem + d;     // (d,) sq8 only
  float* scale_s = smem + 2 * d;  // (d,) sq8 only: span * (1/255)

  const int pair = blockIdx.x;  // i * g + j
  const int i = pair / g;
  const int list = li[pair];
  const int size = min(sizes_g[pair], cap);
  const bool bf16 = scan_bf16 != 0;

  for (int k = threadIdx.x; k < d; k += kThreads) {
    qs[k] = q[static_cast<size_t>(i) * d + k];
    if (kSq8) {
      vmin_s[k] = vmin[k];
      scale_s[k] = span[k] * (1.0f / 255.0f);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // ||q||^2, reduced over the whole warp (every warp holds the same value)
  float qn = 0.f;
  if (metric_l2) {
    for (int k = lane; k < d; k += 32) qn += qs[k] * qs[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      qn += __shfl_xor_sync(0xffffffffu, qn, off);
    }
  }

  const int lpr = lanes_per_row;
  const int rows_per_iter = 32 / lpr;
  const int sub = lane / lpr;  // which row of this warp iteration
  const int sl = lane % lpr;   // lane within the row's segment
  const size_t list_base = static_cast<size_t>(list) * cap;
  const bool recompute = metric_l2 && norms == nullptr;

  for (int tile = blockIdx.y * kTileRows; tile < cap;
       tile += gridDim.y * kTileRows) {
    for (int r0 = tile + warp * rows_per_iter; r0 < tile + kTileRows;
         r0 += kWarps * rows_per_iter) {
      const int pos = r0 + sub;
      const bool in_range = pos < cap;
      const bool live = pos < size;  // size <= cap
      float ip = 0.f, xn = 0.f;
      int id = -1;
      if (live) {
        if (sl == 0) id = ids[list_base + pos];
        const T* row = data + (list_base + pos) * static_cast<size_t>(d);
        if (VEC) {
          constexpr int N = Chunk<T>::N;
          const uint4* rowv = reinterpret_cast<const uint4*>(row);
          const int nchunk = d / N;
          for (int c = sl; c < nchunk; c += lpr) {
            const uint4 raw = __ldg(rowv + c);
            float v[N];
            Chunk<T>::decode(raw, v);
#pragma unroll
            for (int e = 0; e < N; ++e) {
              accumulate<kSq8>(v[e], c * N + e, qs, vmin_s, scale_s, bf16, ip, xn);
            }
          }
        } else {
          for (int k = sl; k < d; k += lpr) {
            accumulate<kSq8>(Chunk<T>::scalar(row + k), k, qs, vmin_s, scale_s,
                             bf16, ip, xn);
          }
        }
      }
      // segment reduction: xor offsets below lpr stay inside the segment;
      // every lane of the warp takes part (the loop bounds are warp-uniform)
      for (int off = lpr >> 1; off > 0; off >>= 1) {
        ip += __shfl_xor_sync(0xffffffffu, ip, off);
        xn += __shfl_xor_sync(0xffffffffu, xn, off);
      }
      if (in_range && sl == 0) {
        float s;
        if (!live || id < 0) {
          s = __int_as_float(0xff800000);  // -inf
        } else if (!metric_l2) {
          s = ip;
        } else {
          const float bn = recompute ? xn : norms[list_base + pos];
          s = -(qn - 2.0f * ip + bn);
        }
        out[static_cast<size_t>(pair) * cap + pos] = s;
      }
    }
  }
}

template <typename T>
cudaError_t launch_codec(const float* q, const void* data, const int32_t* ids,
                         const int32_t* li, const int32_t* sizes_g,
                         const float* norms, const float* vmin,
                         const float* span, float* out, int nq, int g, int cap,
                         int d, int metric_l2, int scan_bf16,
                         cudaStream_t stream) {
  constexpr int N = Chunk<T>::N;
  const bool vec = (d % N == 0) &&
                   (reinterpret_cast<uintptr_t>(data) % 16 == 0);
  const int units = vec ? d / N : d;
  int lpr = 1;
  while (lpr * 2 <= units && lpr * 2 <= 32) lpr *= 2;
  const size_t smem = (sizeof(T) == 1 ? 3 : 1) * static_cast<size_t>(d) * sizeof(float);
  const int tiles = (cap + kTileRows - 1) / kTileRows;
  const dim3 grid(static_cast<unsigned>(nq) * static_cast<unsigned>(g),
                  static_cast<unsigned>(tiles < 65535 ? tiles : 65535));
  const T* typed = static_cast<const T*>(data);
  if (vec) {
    flat_scan_kernel<T, true><<<grid, kThreads, smem, stream>>>(
        q, typed, ids, li, sizes_g, norms, vmin, span, out, g, cap, d,
        metric_l2, scan_bf16, lpr);
  } else {
    flat_scan_kernel<T, false><<<grid, kThreads, smem, stream>>>(
        q, typed, ids, li, sizes_g, norms, vmin, span, out, g, cap, d,
        metric_l2, scan_bf16, lpr);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain-C entry (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: q (nq, d) f32; data (nlist, cap, d) f32/f16/u8 by
// `codec` (0/1/2); ids (nlist, cap) i32; li, sizes_g (nq, g) i32; norms
// (nlist, cap) f32 or NULL (recompute); vmin, span (d,) f32 (codec 2);
// out (nq, g, cap) f32. Launches on `stream` and returns cudaGetLastError()
// (0 on success); never synchronises.
extern "C" int dft_flat_scan(const void* q, const void* data, const void* ids,
                             const void* li, const void* sizes_g,
                             const void* norms, const void* vmin,
                             const void* span, void* out, int nq, int g,
                             int cap, int d, int codec, int metric_l2,
                             int scan_bf16, void* stream) {
  if (nq <= 0 || g <= 0 || cap <= 0) return 0;
  if (d <= 0 || 3 * static_cast<size_t>(d) * sizeof(float) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qf = static_cast<const float*>(q);
  const auto* idsp = static_cast<const int32_t*>(ids);
  const auto* lip = static_cast<const int32_t*>(li);
  const auto* szp = static_cast<const int32_t*>(sizes_g);
  const auto* nrm = static_cast<const float*>(norms);
  const auto* vm = static_cast<const float*>(vmin);
  const auto* sp = static_cast<const float*>(span);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (codec) {
    case kF32:
      err = launch_codec<float>(qf, data, idsp, lip, szp, nrm, vm, sp, o, nq, g,
                                cap, d, metric_l2, scan_bf16, st);
      break;
    case kF16:
      err = launch_codec<__half>(qf, data, idsp, lip, szp, nrm, vm, sp, o, nq,
                                 g, cap, d, metric_l2, scan_bf16, st);
      break;
    case kU8:
      err = launch_codec<uint8_t>(qf, data, idsp, lip, szp, nrm, vm, sp, o, nq,
                                  g, cap, d, metric_l2, scan_bf16, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
