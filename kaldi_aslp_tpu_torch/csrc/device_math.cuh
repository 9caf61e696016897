// Device helpers shared by the LSTMP kernels (lstmp_forward.cu,
// bilstmp_train.cu, lstmp_train.cu, bilstmp_xg_train.cu).  Each source
// includes this header and is built into its own library, so the helpers
// are inlined per library.

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

// a product operand: rounded to bf16 when the products take bf16
// operands (Wt = bf16), as it is in float32 (Wt = float)
template <typename Wt>
__device__ __forceinline__ float operand(float v) {
  if constexpr (std::is_same_v<Wt, __nv_bfloat16>)
    return round_bf16(v);
  else
    return v;
}

// The LSTMP cell, forward: from the pre-activations lin = (g, i, f, o)
// of one (stream, cell), c_prev and the peepholes, the activated gates,
// the clipped c and m = o tanh(c) (before the mask blends the state).
struct CellForward {
  float g, i, f, o, c, m;
};

__device__ __forceinline__ CellForward cell_forward(const float (&lin)[4],
                                                    float cp, float peep_i,
                                                    float peep_f,
                                                    float peep_o,
                                                    float cell_clip) {
  CellForward r;
  r.g = tanhf(lin[0]);
  r.i = sigmoid_f32(lin[1] + peep_i * cp);
  r.f = sigmoid_f32(lin[2] + peep_f * cp);
  r.c = r.f * cp + r.i * r.g;
  if (cell_clip > 0.0f) r.c = fminf(fmaxf(r.c, -cell_clip), cell_clip);
  r.o = sigmoid_f32(lin[3] + peep_o * r.c);
  r.m = r.o * tanhf(r.c);
  return r;
}

// The LSTMP cell, backward: c recomputed from the activated gates and
// c_prev, then from dm (the cotangent of m), the carried dc_after and the
// mask the pre-activation cotangents dg, di, df, do and the dc carried to
// the previous frame; c and tanh(c) are returned for dpeep and m.
struct CellBackward {
  float dg, di, df, d_o, dc_prev, c, tc;
};

__device__ __forceinline__ CellBackward cell_backward(
    float g, float i, float f, float o, float cp, float dm, float dc_after,
    float mk, float peep_i, float peep_f, float peep_o, float cell_clip) {
  CellBackward r;
  const float cu = f * cp + i * g;
  r.c = cell_clip > 0.0f ? fminf(fmaxf(cu, -cell_clip), cell_clip) : cu;
  r.tc = tanhf(r.c);
  float dc = mk * dc_after + dm * o * (1.0f - r.tc * r.tc);
  r.d_o = dm * r.tc * o * (1.0f - o);
  dc = dc + r.d_o * peep_o;
  const float dcu =
      (cell_clip > 0.0f && !(fabsf(cu) < cell_clip)) ? 0.0f : dc;
  r.di = dcu * g * i * (1.0f - i);
  r.df = dcu * cp * f * (1.0f - f);
  r.dg = dcu * i * (1.0f - g * g);
  r.dc_prev = dcu * f + r.di * peep_i + r.df * peep_f + (1.0f - mk) * dc_after;
  return r;
}

// out[d][k] = sum_s acc[d][s][k] for acc [gridDim.y, S, K]: the dbias /
// dpeep sums over streams, one owner thread each
__global__ void sum_streams_kernel(const float* __restrict__ acc,
                                   float* __restrict__ out, int S, int K) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int d = blockIdx.y;
  if (k >= K) return;
  float v = 0.0f;
  for (int s = 0; s < S; ++s) v += acc[((size_t)d * S + s) * K + k];
  out[(size_t)d * K + k] = v;
}

// Columns of the staged operand per pass of staged_rows_dot: at 16
// streams a tile, 32 KB of shared memory.
constexpr int kStageChunk = 512;

// The per-step product of the LSTMP kernels: one warp per weight row,
// the state operand of the block's ST streams staged in shared memory.
// For the NR rows w + r * row_stride (r < NR), each K long:
//
//   acc[r][s] = sum_k w[r * row_stride + k] * stage(s, k)
//
// summed over the warp's lanes and left in every lane.  stage(s, k) is
// stream s's operand at column k, already rounded as the product takes
// it, and zero past the last stream.  The block stages kStageChunk
// columns at a time in shared memory (declared here, so that the inner
// loop reads it as shared memory and not through a generic pointer), so
// every one of the block's NT threads calls this; a warp with active ==
// false helps stage but reads no weights (w must still be a valid
// pointer).
template <int ST, int NR, int NT, typename W, typename Stage>
__device__ __forceinline__ void staged_rows_dot(float (&acc)[NR][ST],
                                                const W* __restrict__ w,
                                                size_t row_stride, int K,
                                                Stage stage, bool active) {
  __shared__ float sh[ST * kStageChunk];
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int s = 0; s < ST; ++s) acc[r][s] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kStageChunk) {
    const int n = min(kStageChunk, K - k0);
    __syncthreads();
    // NT, the block's thread count, is a compile-time stride here: with
    // blockDim.x the loop neither unrolls nor keeps its index arithmetic
    // cheap, and the staging then costs a third more time per step
    for (int idx = threadIdx.x; idx < ST * n; idx += NT) {
      const int s = idx / n, k = idx - s * n;
      sh[s * kStageChunk + k] = stage(s, k0 + k);
    }
    __syncthreads();
    if (!active) continue;
    for (int k = lane; k < n; k += 32) {
      float wv[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) wv[r] = to_f32(w[r * row_stride + k0 + k]);
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        const float v = sh[s * kStageChunk + k];
#pragma unroll
        for (int r = 0; r < NR; ++r) acc[r][s] = fmaf(wv[r], v, acc[r][s]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int s = 0; s < ST; ++s) acc[r][s] = warp_sum(acc[r][s]);
}

}  // namespace aslp_cuda
