// LSTMP inference recurrence, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel kaldi_aslp_tpu/ops/lstm_pallas.py:_lstmp_kernel
// (reached through lstmp_forward_pallas and
// lstmp_forward_pallas_from_params).  Per time step, for every stream s:
//
//   gates = xg[s, t] + r_prev . W_r^T          (W_r = w_gifo_r [4C, P])
//   g = tanh(gates_g)
//   i = sigmoid(gates_i + peep_i * c_prev)
//   f = sigmoid(gates_f + peep_f * c_prev)
//   c = clip(f * c_prev + i * g)               (only if cell_clip > 0)
//   o = sigmoid(gates_o + peep_o * c)
//   m = o * tanh(c)
//   r = m . W_rm^T                             (W_rm = w_r_m [P, C])
//   c, r = mask * new + (1 - mask) * old;  ys[s, t] = r * mask
//
// Gate order g, i, f, o as in the reference model files
// (kaldi-aslp src/aslp-nnet/nnet-lstm-projected-streams.h:347-432).
//
// Why the TPU design does not carry over: the TPU kernel keeps W_r
// (2048 x 320 f32, 2.6 MB at the flagship's widths) and W_rm (655 KB)
// in one core's VMEM for the whole time loop.  One H100 SM has at most
// 227 KB of shared memory, so the weights cannot stay in one block.
//
// What bounds this kernel on the H100: at S = 1 (one server stream) a
// step does 2 * (4C*P + P*C) = 1.6 MFLOP against 3.3 MB of weights, so it
// is bound by reading the weights, which after the first step come from
// the 50 MB L2 rather than HBM.  The design spreads that read over many
// SMs: each step is two launches on the caller's stream,
//   (A) gates + cell: one warp per cell j reads the four rows
//       W_r[j], W_r[C+j], W_r[2C+j], W_r[3C+j] (coalesced over P) against
//       r_prev staged in shared memory for a tile of ST streams, reduces
//       across the warp, applies the cell and blends c in place;
//   (B) projection: one warp per output column p reduces m . W_rm[p]
//       against m staged in shared memory, blends r in place and stores
//       ys[:, t].
// Each (s, j) and (s, p) is read and written by exactly one thread, and
// stream order separates (A) from (B), so the in-place state updates
// are safe.  A persistent single-launch version with the weights split
// across SMs, wgmma and bf16 operands is later work.

#include <cuda_runtime.h>

#include "device_math.cuh"

namespace {

using namespace aslp_cuda;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr size_t kMaxStaticSmem = 48 * 1024;

// (A) gates + cell for cells [blockIdx.x * kWarps, +kWarps) and streams
// [blockIdx.y * ST, +ST).  xg and mask point at time step t; their
// per-stream strides are T * 4C and T.
template <int ST>
__global__ void __launch_bounds__(kThreads)
gates_cell_kernel(const float* __restrict__ xg, long long xg_stride,
                  const float* __restrict__ mask, long long mask_stride,
                  const float* __restrict__ w_r,
                  const float* __restrict__ peep,
                  const float* __restrict__ r,
                  float* __restrict__ c, float* __restrict__ m,
                  int S, int C, int P, float cell_clip) {
  static_assert(ST >= 1 && ST <= 32, "one lane finishes each stream");
  extern __shared__ float r_sh[];  // [ST, P]
  const int s0 = blockIdx.y * ST;
  for (int idx = threadIdx.x; idx < ST * P; idx += blockDim.x) {
    const int s = idx / P;
    r_sh[idx] = (s0 + s < S) ? r[(size_t)(s0 + s) * P + (idx - s * P)]
                             : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j >= C) return;

  float acc[4][ST];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int s = 0; s < ST; ++s) acc[k][s] = 0.0f;

  const float* w_row = w_r + (size_t)j * P;
  const size_t gate_stride = (size_t)C * P;
  for (int p = lane; p < P; p += 32) {
    float w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __ldg(w_row + k * gate_stride + p);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      const float rv = r_sh[s * P + p];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k][s] = fmaf(w[k], rv, acc[k][s]);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int s = 0; s < ST; ++s) acc[k][s] = warp_sum(acc[k][s]);

#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int sg = s0 + s;
    if (lane != s || sg >= S) continue;
    const float* x = xg + (size_t)sg * xg_stride;
    const size_t cj = (size_t)sg * C + j;
    const float cp = c[cj];
    const float g = tanhf(x[j] + acc[0][s]);
    const float i = sigmoid_f32(x[C + j] + acc[1][s] + peep[j] * cp);
    const float f = sigmoid_f32(x[2 * C + j] + acc[2][s] + peep[C + j] * cp);
    float cn = f * cp + i * g;
    if (cell_clip > 0.0f) cn = fminf(fmaxf(cn, -cell_clip), cell_clip);
    const float o =
        sigmoid_f32(x[3 * C + j] + acc[3][s] + peep[2 * C + j] * cn);
    const float mk = mask[(size_t)sg * mask_stride];
    m[cj] = o * tanhf(cn);
    c[cj] = mk * cn + (1.0f - mk) * cp;
  }
}

// (B) projection for columns [blockIdx.x * kWarps, +kWarps) and streams
// [blockIdx.y * ST, +ST).  ys points at time step t; its per-stream
// stride is T * P.
template <int ST>
__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ m, const float* __restrict__ w_rm,
               const float* __restrict__ mask, long long mask_stride,
               float* __restrict__ r, float* __restrict__ ys,
               long long ys_stride, int S, int C, int P) {
  static_assert(ST >= 1 && ST <= 32, "one lane finishes each stream");
  extern __shared__ float m_sh[];  // [ST, C]
  const int s0 = blockIdx.y * ST;
  for (int idx = threadIdx.x; idx < ST * C; idx += blockDim.x) {
    const int s = idx / C;
    m_sh[idx] = (s0 + s < S) ? m[(size_t)(s0 + s) * C + (idx - s * C)]
                             : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= P) return;

  float acc[ST];
#pragma unroll
  for (int s = 0; s < ST; ++s) acc[s] = 0.0f;
  const float* w_row = w_rm + (size_t)p * C;
  for (int j = lane; j < C; j += 32) {
    const float wv = __ldg(w_row + j);
#pragma unroll
    for (int s = 0; s < ST; ++s) acc[s] = fmaf(wv, m_sh[s * C + j], acc[s]);
  }
#pragma unroll
  for (int s = 0; s < ST; ++s) acc[s] = warp_sum(acc[s]);

#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int sg = s0 + s;
    if (lane != s || sg >= S) continue;
    const float mk = mask[(size_t)sg * mask_stride];
    const size_t rp_idx = (size_t)sg * P + p;
    const float rn = mk * acc[s] + (1.0f - mk) * r[rp_idx];
    r[rp_idx] = rn;
    ys[(size_t)sg * ys_stride + p] = rn * mk;
  }
}

template <int ST>
int run(const float* xg, const float* mask, const float* w_r,
        const float* w_rm, const float* peep, float* c, float* r, float* m,
        float* ys, int S, int T, int C, int P, float cell_clip,
        cudaStream_t stream) {
  const size_t smem_a = (size_t)ST * P * sizeof(float);
  const size_t smem_b = (size_t)ST * C * sizeof(float);
  if (smem_a > kMaxStaticSmem || smem_b > kMaxStaticSmem)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kThreads);
  const dim3 grid_a((C + kWarps - 1) / kWarps, (S + ST - 1) / ST);
  const dim3 grid_b((P + kWarps - 1) / kWarps, (S + ST - 1) / ST);
  const long long xg_stride = (long long)T * 4 * C;
  const long long ys_stride = (long long)T * P;
  for (int t = 0; t < T; ++t) {
    gates_cell_kernel<ST><<<grid_a, block, smem_a, stream>>>(
        xg + (size_t)t * 4 * C, xg_stride, mask + t, T, w_r, peep, r, c, m,
        S, C, P, cell_clip);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    project_kernel<ST><<<grid_b, block, smem_b, stream>>>(
        m, w_rm, mask + t, T, r, ys + (size_t)t * P, ys_stride, S, C, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes.  All arrays are contiguous float32 on the
// current device: xg [S, T, 4C], mask [S, T], w_r [4C, P], w_rm [P, C],
// peep [3, C]; c [S, C] and r [S, P] hold the initial state on entry and
// the final state on return; m [S, C] is scratch; ys [S, T, P] is
// written.  Returns a cudaError_t (0 on success).
extern "C" int lstmp_forward_f32(const float* xg, const float* mask,
                                 const float* w_r, const float* w_rm,
                                 const float* peep, float* c, float* r,
                                 float* m, float* ys, int S, int T, int C,
                                 int P, float cell_clip, void* stream) {
  if (S <= 0 || T < 0 || C <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 1)
    return run<1>(xg, mask, w_r, w_rm, peep, c, r, m, ys, S, T, C, P,
                  cell_clip, st);
  return run<8>(xg, mask, w_r, w_rm, peep, c, r, m, ys, S, T, C, P,
                cell_clip, st);
}
