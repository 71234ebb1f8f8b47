// Device helpers shared by the list scans (flat_scan.cu, adc_scan.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Write -inf to p[0, n) with every thread of the block: 16-byte stores for
// the aligned body, 4-byte stores for the up to 3 floats on either side.
__device__ __forceinline__ void fill_neg_inf(float* p, int n) {
  if (n <= 0) return;
  const float ni = neg_inf();
  const int head =
      min(n, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2));
  const int nv = (n - head) >> 2;
  float4* body = reinterpret_cast<float4*>(p + head);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) body[i] = make_float4(ni, ni, ni, ni);
  const int tail = head + 4 * nv;
  for (int i = threadIdx.x; i < head + (n - tail); i += blockDim.x) {
    p[i < head ? i : tail + (i - head)] = ni;
  }
}

}  // namespace
