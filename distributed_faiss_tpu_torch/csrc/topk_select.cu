// The final top-k of an IVF-Flat probe group for Hopper (sm_90a): each
// query's (w,) candidates, the (query, probe) pairs' best k that K1's
// select epilogue wrote ((nq, g * k) scores and ids), merged into its
// best k, optionally on top of a carried (nq, k) from earlier groups:
//
//   out[i] = the best k of carry[i] ++ cand[i], by score and then by the
//            lower id, (-inf, -1) past the valid entries; sorted
//
// Replaces no TPU kernel. The JAX package selects with lax.top_k over
// each group's (nq, g * cap) score block and merges with another; the port
// did the same with torch.topk until K1 selected its own rows. This
// kernel takes the place of that second library top-k and its gathers.
//
// What bounds it. Its input is small: at the ivfsq shape 256 queries x
// 128 probes x 10 candidates, 2.6 MB of scores and ids, read once (under
// 1 us of HBM time). What costs is the select itself, and a library
// top-k's many passes and launches over a (nq, w) block. What the design
// does about it: one 256-thread block a query walks its candidates in
// 256-entry tiles with K1's select (block_topk.cuh): a compare against the
// current k-th entry rejects most candidates after the first tile, and only
// the survivors are sorted and merged in shared memory. One launch a
// group; the carry, when there is one, seeds the running top-k (it is this
// kernel's earlier output, already in order). k is a run-time argument,
// as in K1.
//
// Built by distributed_faiss_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_topk.cuh"

namespace {

__global__ void __launch_bounds__(kSelectThreads)
topk_select_kernel(const float* s, const int32_t* ids, const float* carry_s,
                   const int32_t* carry_i, float* out_s, int32_t* out_i, int w, int k) {
  __shared__ TopKShared top;
  const size_t row = blockIdx.x;
  if (carry_s != nullptr) {
    topk_init(top, k, carry_s + row * k, carry_i + row * k);
  } else {
    topk_init(top, k, nullptr, nullptr);
  }
  const float* rs = s + row * w;
  const int32_t* ri = ids + row * w;
  const int t = threadIdx.x;
  for (int t0 = 0; t0 < w; t0 += kSelectTile) {
    const int n = min(kSelectTile, w - t0);
    if (t < n) {
      top.tile_s[t] = rs[t0 + t];
      top.tile_i[t] = ri[t0 + t];
    }
    topk_merge_tile(top, k, n);
  }
  topk_store(top, k, out_s + row * k, out_i + row * k);
}

}  // namespace

// Plain-C entry (loaded with ctypes). Device pointers of contiguous
// tensors: s, ids (nq, w) f32 / i32; carry_s, carry_i (nq, k) f32 / i32,
// sorted as this kernel sorts, or both NULL; out_s, out_i (nq, k) f32 /
// i32. k in [1, 256]. Launches on `stream` and returns cudaGetLastError()
// (0 on success); never synchronises.
extern "C" int dft_topk_select(const void* s, const void* ids, const void* carry_s,
                               const void* carry_i, void* out_s, void* out_i, int nq, int w,
                               int k, void* stream) {
  if (nq <= 0) return 0;
  if (w < 0 || k < 1 || k > kSelectMaxK || (carry_s == nullptr) != (carry_i == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  topk_select_kernel<<<nq, kSelectThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const int32_t*>(ids),
      static_cast<const float*>(carry_s), static_cast<const int32_t*>(carry_i),
      static_cast<float*>(out_s), static_cast<int32_t*>(out_i), w, k);
  return static_cast<int>(cudaGetLastError());
}
