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
// With k (1..256), the select epilogue: out[i, j, :k] and out_ids[i, j, :k]
// are instead the pair's best k valid rows, by score and then by lower
// id, with ids[l, pos]; slots past the valid rows are (-inf, -1). The IVF
// search takes this form (models/ivf.py), the mesh the first.
//
// What bounds it. Each gathered row is used by exactly one (query, probe)
// pair and meets one query vector: about 2 flops per element read, i.e.
// ~1 flop/byte for fp16 rows and ~0.25 for fp32. The card does ~20 fp32
// flops per byte of HBM bandwidth (67 TFLOP/s over 3.35 TB/s), so the
// kernel is bound by the bytes it moves, not by arithmetic, and tensor
// cores would not help at this arithmetic intensity. The bytes are the
// live rows of the probed lists (with their ids and stored norms) and the
// (nq, g, cap) fp32 scores; on the ivfsq shard a probed list holds about
// an eighth of its capacity, so most of the output is the -inf padding.
//
// What the design does about it.
//   * A block owns one (query, probe) pair and one 256-row tile of its
//     capacity (past 65,535 tiles a pair, each block walks the tiles
//     y, y + 65535, ...). The block reads the pair's list and size
//     first and writes its share of the pair's dead rows [size, cap) as
//     -inf with 16-byte stores from all threads. A tile at or past the
//     size returns there, before it touches q, so the padded tail of a
//     pow2-capacity list costs only its -inf stores.
//   * Rows are read with coalesced 16-byte loads (uint4): a row of d
//     elements is split into 16-byte chunks, and a segment of
//     `lanes_per_row` neighbouring lanes (a power of two, <= 32) walks the
//     chunks of one row, so a warp covers 32 / lanes_per_row rows at once.
//   * Loads in flight: each lane issues the loads of R rows (its C chunks
//     of each; R * C = 4, so 64 bytes a lane) and their ids and stored
//     norms before it decodes any of them; one segment reduction (xor
//     shuffles) then covers the batch. The kernels are held to 85
//     registers a thread (sq8 rows read in 16-byte chunks excepted), so
//     that 24 warps an SM keep their loads in flight: the time per row
//     follows the memory's latency, not its bandwidth, when fewer warps
//     fit. The row loads skip L1 (each byte is used once).
//   * A lane always touches the same chunk indices of every row, so its
//     slice of q (and of the sq8 vmin and span/255 planes) sits in
//     registers, loaded once per block, and ||q||^2 is the segment's sum
//     of those registers; rows wider than C chunks a lane are walked in
//     column groups, reloading the slice per group. ||x||^2 for the
//     recomputed-norm mode rides the same pass, so a row is read once.
//     scan_bf16 and the recomputed norm are fixed at compile time inside
//     the batch, so the common case pays for neither.
//   * The validity mask is applied before the single fp32 store per row.
//   * Rows whose width is no multiple of 16 bytes, or lists at an
//     unaligned address, take the same loop with element loads.
// Blocks run in any order: nothing carries across them.
//
// The select epilogue. Without it a pair's (cap,) scores go to device
// memory, mostly -inf padding (a probed ivfsq list holds about an
// eighth of its capacity), and a library top-k reads them back group by
// group: at the ivfsq shape that chain took 2.4x the scan's device time
// and about 15 graph nodes a probe group. What bounds the select: each
// pair's rows arrive in 256-row tiles over the block's lifetime, and
// the block has 8 warps and a few KB of shared memory to keep its best
// k. What the design does about it:
//   * One block owns a pair and walks its live tiles only (grid.y 1); no
//     row past the size is visited and nothing is stored for it.
//   * Each tile's 256 (score, id) pairs go to shared memory, not to
//     device memory; the block merges them into the pair's running top-k
//     there (block_topk.cuh): a compare against the current k-th score
//     rejects most rows after the first tile, and only the survivors are
//     sorted and merged. The merge runs after the tile's scan loop, so
//     its few registers sit beside the q slice and not beside the loads.
//   * A pair of at most 32 rows (kShortSelect: most pairs of the sq8
//     tiers, 4-8 live rows a list on average, one block an SM) skips the
//     merge: after its one tile, warp 0 sorts the rows in registers with
//     shuffles behind one barrier (topk_store_short). The merge's dozen
//     barriers over a few rows made the epilogue cost as much as the
//     scan there, with no other block on the SM to hide them.
//   * k is a run-time argument up to 256; the shared buffers are sized
//     for 256 (6.2 KB a block, no limit on 3 blocks an SM). A template
//     parameter per power-of-two bucket of k multiplied the kernel's
//     instantiations by five and the kernels' build on an H100 from 28 s
//     to 52-57 s, for no register or occupancy the card counts.
//   * The ids are read in the scan (they mask tombstones anyway) and
//     written with the scores: (nq, g, k) of each, no gather after it.
// The merge of a block's (nq, g * k) candidates into its final (nq, k)
// is a second kernel (topk_select.cu). Left for later: grouping the
// queries that share a list into one tensor-core GEMM (which would lift
// the arithmetic intensity and read each list once a request).
//
// Built by distributed_faiss_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded through ctypes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "block_topk.cuh"
#include "scan_common.cuh"

namespace {

constexpr int kThreads = kSelectThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 256;    // live rows a block scans: one tile
static_assert(kTileRows == kSelectTile, "the select merges one scanned tile at a time");
constexpr int kLoadsPerLane = 4;  // R * C: loads a lane issues before decoding
constexpr unsigned kFull = 0xffffffffu;

enum Codec { kF32 = 0, kF16 = 1, kU8 = 2 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(uint8_t v) { return static_cast<float>(v); }

// A load unit of a stored row: VEC, a 16-byte chunk of N elements;
// otherwise one element. decode gives fp32 values before the sq8 affine
// step, which needs the element index.
template <typename T, bool VEC> struct Unit;

template <typename T> struct Unit<T, true> {
  using Raw = uint4;
  static constexpr int N = 16 / static_cast<int>(sizeof(T));
  // read-only and used once: not kept in L1
  __device__ __forceinline__ static Raw load(const T* row, int c) {
    uint4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(reinterpret_cast<const uint4*>(row) + c));
    return v;
  }
  __device__ __forceinline__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ static void decode(const Raw& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = __uint_as_float(w[e]);
    } else if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[e]));
        v[2 * e] = f.x;
        v[2 * e + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int b = 0; b < 4; ++b) v[4 * e + b] = static_cast<float>((w[e] >> (8 * b)) & 0xffu);
      }
    }
  }
};

template <typename T> struct Unit<T, false> {
  using Raw = float;  // converted as it is loaded
  static constexpr int N = 1;
  __device__ __forceinline__ static Raw load(const T* row, int c) { return to_float(row[c]); }
  __device__ __forceinline__ static Raw zero() { return 0.f; }
  __device__ __forceinline__ static void decode(const Raw& r, float* v) { v[0] = r; }
};

// The widest C (units a lane holds in registers per row) a kernel is
// built for: at most 32 fp32 values of each q plane (the sq8 planes
// triple that).
template <typename T, bool VEC>
constexpr int max_units_per_lane() {
  return VEC ? (Unit<T, true>::N >= 8 ? 32 / Unit<T, true>::N : 8) : 8;
}

struct ScanArgs {
  const float* q;         // (nq, d)
  const void* data;       // (nlist, cap, d) of the codec's type
  const int32_t* ids;     // (nlist, cap)
  const int32_t* li;      // (nq, g)
  const int32_t* sizes_g; // (nq, g)
  const float* norms;     // (nlist, cap), or null: recompute
  const float* vmin;      // (d,) sq8
  const float* span;      // (d,) sq8
  float* out;             // (nq, g, cap), or (nq, g, k) with k
  int32_t* out_ids;       // (nq, g, k) with k
  int g, cap, d;
  int k;                  // 0, or the select's k (1..kSelectMaxK)
  int units;              // load units a row: d / N (VEC) or d
  int lanes_per_row;      // power of two <= 32
  int metric_l2, scan_bf16;
};

// The register budget is cut for 3 blocks an SM (at most 85 registers a
// thread, 24 warps to hide the loads' latency), except for sq8 rows read
// in 16-byte chunks, whose three q planes need the registers and spill
// under it. kSelect: the select epilogue (one block a pair, grid.y 1)
// keeps the pair's best k of every tile in shared memory (block_topk.cuh).
template <typename T, bool VEC, int C, int R, bool kSelect>
__global__ void __launch_bounds__(kThreads, (VEC && sizeof(T) == 1) ? 1 : 3)
flat_scan_kernel(const ScanArgs a) {
  using U = Unit<T, VEC>;
  constexpr int N = U::N;
  constexpr bool kSq8 = sizeof(T) == 1;
  const int pair = blockIdx.x;  // i * g + j
  const int cap = a.cap;
  const int size = max(0, min(a.sizes_g[pair], cap));
  const size_t list_base = static_cast<size_t>(a.li[pair]) * cap;
  float* pair_out = a.out + static_cast<size_t>(pair) * cap;
  __shared__ std::conditional_t<kSelect, TopKShared, char> top;

  const int first = blockIdx.y * kTileRows;
  // a pair of at most kShortSelect rows is sorted by one warp at the end
  const bool short_pair = kSelect && size <= kShortSelect;
  if constexpr (kSelect) {
    if (!short_pair) topk_init(top, a.k, nullptr, nullptr);
  } else {
    // this block's share of the dead rows [size, cap), a multiple of 4
    // rows so that every share but the first starts as aligned as the first
    const int share = ((cap - size + static_cast<int>(gridDim.y) - 1) / gridDim.y + 3) & ~3;
    const int dead0 = min(cap, size + static_cast<int>(blockIdx.y) * share);
    fill_neg_inf(pair_out + dead0, min(cap - dead0, share));
    if (first >= size) return;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lpr = a.lanes_per_row;
  const int rpi = 32 / lpr;         // rows a warp covers per batch slot
  const int sub = lane / lpr;       // which of those rows
  const int sl = lane & (lpr - 1);  // lane within the row's segment
  const int units = a.units;
  const int groups = (units + lpr * C - 1) / (lpr * C);  // column groups a row
  const float* qi = a.q + static_cast<size_t>(pair / a.g) * a.d;
  const bool bf16 = a.scan_bf16 != 0;
  const bool l2 = a.metric_l2 != 0;
  const bool recompute = l2 && a.norms == nullptr;

  // sum over the lanes of a row's segment (xor offsets below lpr stay in it)
  auto segment_sum = [&](float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < lpr) v += __shfl_xor_sync(kFull, v, off);
    }
    return v;
  };

  // this lane's slice of q (bf16-rounded under scan_bf16) and of the sq8
  // planes for column group gi: units sl + lpr * (gi * C + k), k < C.
  // Returns the slice's share of ||q||^2.
  float qr[C * N];
  float vr[kSq8 ? C * N : 1];
  float sr[kSq8 ? C * N : 1];
  auto load_slice = [&](int gi) {
    float qn = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = sl + lpr * (gi * C + k);
      const bool ok = c < units;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int i = c * N + e;
        const float qv = ok ? qi[i] : 0.f;
        qn = fmaf(qv, qv, qn);
        qr[k * N + e] = bf16 ? bf16_round(qv) : qv;
        if constexpr (kSq8) {
          vr[k * N + e] = ok ? a.vmin[i] : 0.f;
          sr[k * N + e] = ok ? a.span[i] * (1.0f / 255.0f) : 0.f;
        }
      }
    }
    return qn;
  };
  // ||q||^2 over every group; group 0's slice stays loaded
  float qn = 0.f;
  for (int gi = groups - 1; gi >= 0; --gi) qn += load_slice(gi);
  qn = segment_sum(qn);

  const T* rows = static_cast<const T*>(a.data) + list_base * a.d;
  const int batch = R * rpi;  // rows a warp scans per step
  for (int t0 = first; t0 < size; t0 += gridDim.y * kTileRows) {
    const int t1 = min(size, t0 + kTileRows);
    // b is warp-uniform, so every lane takes part in the shuffles below
    for (int b = t0 + warp * batch; b < t1; b += kWarps * batch) {
      float ip[R], xn[R], bn[R];
      int id[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ip[r] = 0.f;
        xn[r] = 0.f;
        bn[r] = 0.f;
        id[r] = -1;
        const int row = b + r * rpi + sub;
        if (row < t1 && sl == (r & (lpr - 1))) {  // the lane that stores row r
          id[r] = a.ids[list_base + row];
          if (l2 && !recompute) bn[r] = a.norms[list_base + row];
        }
      }
      for (int gi = 0; gi < groups; ++gi) {
        if (groups > 1) load_slice(gi);
        typename U::Raw raw[R][C];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = b + r * rpi + sub;
          const T* rp = rows + static_cast<size_t>(row) * a.d;
#pragma unroll
          for (int k = 0; k < C; ++k) {
            const int c = sl + lpr * (gi * C + k);
            raw[r][k] = (row < t1 && c < units) ? U::load(rp, c) : U::zero();
          }
        }
        // decode and accumulate, with scan_bf16 and the recomputed norm
        // fixed at compile time
        auto accumulate = [&](auto round_bf16, auto with_norm) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int k = 0; k < C; ++k) {
              float v[N];
              U::decode(raw[r][k], v);
#pragma unroll
              for (int e = 0; e < N; ++e) {
                const int j = k * N + e;
                float x = v[e];
                if constexpr (kSq8) x = fmaf(x, sr[j], vr[j]);
                if constexpr (decltype(with_norm)::value) xn[r] = fmaf(x, x, xn[r]);
                if constexpr (decltype(round_bf16)::value) x = bf16_round(x);
                ip[r] = fmaf(qr[j], x, ip[r]);
              }
            }
          }
        };
        if (bf16) {
          if (recompute) {
            accumulate(std::true_type{}, std::true_type{});
          } else {
            accumulate(std::true_type{}, std::false_type{});
          }
        } else if (recompute) {
          accumulate(std::false_type{}, std::true_type{});
        } else {
          accumulate(std::false_type{}, std::false_type{});
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ip[r] = segment_sum(ip[r]);
        if (recompute) xn[r] = segment_sum(xn[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = b + r * rpi + sub;
        if (row < t1 && sl == (r & (lpr - 1))) {
          float s;
          if (id[r] < 0) {
            s = neg_inf();
          } else if (!l2) {
            s = ip[r];
          } else {
            s = -(qn - 2.0f * ip[r] + (recompute ? xn[r] : bn[r]));
          }
          if constexpr (kSelect) {
            top.tile_s[row - t0] = s;
            top.tile_i[row - t0] = id[r];
          } else {
            pair_out[row] = s;
          }
        }
      }
    }
    if constexpr (kSelect) {
      if (!short_pair) topk_merge_tile(top, a.k, t1 - t0);
    }
  }
  if constexpr (kSelect) {
    const size_t at = static_cast<size_t>(pair) * a.k;
    if (short_pair) {
      topk_store_short(top, a.k, size, a.out + at, a.out_ids + at);
    } else {
      topk_store(top, a.k, a.out + at, a.out_ids + at);
    }
  }
}

template <typename T, bool VEC, int C>
void launch_one(const ScanArgs& a, dim3 grid, cudaStream_t stream) {
  constexpr int R = kLoadsPerLane / C > 0 ? kLoadsPerLane / C : 1;
  if (a.k > 0) {
    flat_scan_kernel<T, VEC, C, R, true><<<grid, kThreads, 0, stream>>>(a);
  } else {
    flat_scan_kernel<T, VEC, C, R, false><<<grid, kThreads, 0, stream>>>(a);
  }
}

// c: a power of two <= max_units_per_lane<T, VEC>()
template <typename T, bool VEC>
void launch_width(int c, const ScanArgs& a, dim3 grid, cudaStream_t stream) {
  constexpr int kMax = max_units_per_lane<T, VEC>();
  if (c <= 1) {
    launch_one<T, VEC, 1>(a, grid, stream);
  } else if (c == 2) {
    if constexpr (kMax >= 2) launch_one<T, VEC, 2>(a, grid, stream);
  } else if (c == 4) {
    if constexpr (kMax >= 4) launch_one<T, VEC, 4>(a, grid, stream);
  } else {
    if constexpr (kMax >= 8) launch_one<T, VEC, 8>(a, grid, stream);
  }
}

template <typename T>
cudaError_t launch_codec(ScanArgs a, int nq, cudaStream_t stream) {
  constexpr int N = Unit<T, true>::N;
  const bool vec = (a.d % N == 0) && (reinterpret_cast<uintptr_t>(a.data) % 16 == 0);
  a.units = vec ? a.d / N : a.d;
  int lpr = 1;
  while (lpr * 2 <= a.units && lpr * 2 <= 32) lpr *= 2;
  a.lanes_per_row = lpr;
  const int per_lane = (a.units + lpr - 1) / lpr;
  const int max_c = vec ? max_units_per_lane<T, true>() : max_units_per_lane<T, false>();
  int c = 1;
  while (c < per_lane && c < max_c) c *= 2;
  const int pairs = nq * a.g;
  const int tiles = (a.cap + kTileRows - 1) / kTileRows;
  const int y = a.k > 0 ? 1 : std::min(tiles, 65535);
  const dim3 grid(static_cast<unsigned>(pairs), static_cast<unsigned>(y));
  if (vec) {
    launch_width<T, true>(c, a, grid, stream);
  } else {
    launch_width<T, false>(c, a, grid, stream);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain-C entry (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: q (nq, d) f32; data (nlist, cap, d) f32/f16/u8 by
// `codec` (0/1/2); ids (nlist, cap) i32; li, sizes_g (nq, g) i32; norms
// (nlist, cap) f32 or NULL (recompute); vmin, span (d,) f32 (codec 2).
// k 0: out (nq, g, cap) f32 scores, out_ids unused. k in [1, 256]: out
// (nq, g, k) f32 and out_ids (nq, g, k) i32, each pair's best k rows by
// score, ties to the lower id, then (-inf, -1). Launches on `stream` and
// returns cudaGetLastError() (0 on success); never synchronises.
extern "C" int dft_flat_scan(const void* q, const void* data, const void* ids,
                             const void* li, const void* sizes_g,
                             const void* norms, const void* vmin,
                             const void* span, void* out, void* out_ids, int nq,
                             int g, int cap, int d, int k, int codec,
                             int metric_l2, int scan_bf16, void* stream) {
  if (nq <= 0 || g <= 0 || (cap <= 0 && k == 0)) return 0;
  if (d <= 0 || k < 0 || k > kSelectMaxK || cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ScanArgs a;
  a.q = static_cast<const float*>(q);
  a.data = data;
  a.ids = static_cast<const int32_t*>(ids);
  a.li = static_cast<const int32_t*>(li);
  a.sizes_g = static_cast<const int32_t*>(sizes_g);
  a.norms = static_cast<const float*>(norms);
  a.vmin = static_cast<const float*>(vmin);
  a.span = static_cast<const float*>(span);
  a.out = static_cast<float*>(out);
  a.out_ids = static_cast<int32_t*>(out_ids);
  a.k = k;
  a.g = g;
  a.cap = cap;
  a.d = d;
  a.units = 0;
  a.lanes_per_row = 1;
  a.metric_l2 = metric_l2;
  a.scan_bf16 = scan_bf16;
  auto st = static_cast<cudaStream_t>(stream);
  switch (codec) {
    case kF32:
      return static_cast<int>(launch_codec<float>(a, nq, st));
    case kF16:
      return static_cast<int>(launch_codec<__half>(a, nq, st));
    case kU8:
      return static_cast<int>(launch_codec<uint8_t>(a, nq, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
