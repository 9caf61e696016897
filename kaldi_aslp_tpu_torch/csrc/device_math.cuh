// Device helpers shared by the LSTMP kernels (lstmp_forward.cu,
// bilstmp_train.cu, lstmp_train.cu).  Each source includes this header and
// is built into its own library, so the helpers are inlined per library.

#pragma once

#include <cuda_bf16.h>

#include <type_traits>

namespace aslp_cuda {

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// x rounded to the nearest bf16 (ties to even), back in float32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// the sum of v over the 32 lanes of the warp, in every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// a stored value (float or bf16) read as float32, and written back
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename St>
__device__ __forceinline__ St from_f32(float v) {
  if constexpr (std::is_same_v<St, __nv_bfloat16>)
    return __float2bfloat16(v);
  else
    return v;
}

}  // namespace aslp_cuda
