// Unidirectional LSTMP training forward and backward, written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernels kaldi_aslp_tpu/ops/lstm_pallas.py:
//   _lstmp_fwd_train_kernel  (through _lstmp_train_fwd, _get_lstmp_core
//                             and lstmp_train_core), and
//   _lstmp_bwd_kernel        (through _lstmp_train_bwd, the custom VJP of
//                             _get_lstmp_core).
// Forward, per frame t and stream s (gate order g, i, f, o):
//
//   gates = xg[s, t] + r_prev . W_r^T            (W_r = w_gifo_r [4C, P])
//   g = tanh, i = sigmoid(+ peep_i c_prev), f = sigmoid(+ peep_f c_prev)
//   c = clip(f c_prev + i g);  o = sigmoid(+ peep_o c);  m = o tanh(c)
//   r = m . W_rm^T                               (W_rm = w_r_m [P, C])
//   c, r = mask * new + (1 - mask) * old
//
// and it stores the activated gates, the post-mask c and the post-mask r.
// The backward sweeps the frames in reverse from the final-state
// cotangents, recomputes c from the stored gates and c_prev, and emits
// dgates (= dxg) and dr_new per frame plus the initial-state cotangents;
// the weight gradients are reduced outside, over all frames, as the TPU
// wrapper does (lstm_pallas.py:426-451).
//
// Two template switches pick the TPU kernels' three modes:
//   St, the storage type of xg, the stored gates / c / r, dy, dxg and
//   dr_new: float (store_bf16 = False) or __nv_bfloat16 (True);
//   Wt, the type of the product operands and of the weights: bf16
//   (mxu_bf16 = True, the state operand rounded where it is staged) or
//   float (mxu_bf16 = False).
// The instances are (float, float), (bf16, bf16), which the bf16 attr
// selects, and (bf16, float), which KALDI_ASLP_LSTM_MXU_FP32 selects for
// a bf16 LSTMP (models/recurrent.py:175-188).  Sums and the carried state
// are float32 in every mode.  The dr_prev product stages the float32
// dgates and rounds them as an operand, which with bf16 operands gives
// the stored dxg's value, as lstm_pallas.py:300-303 do.
//
// What bounds it on the H100, and what the design does about it.  The
// TPU kernels keep W_r and W_rm resident in one core's VMEM; at the LSTM
// hybrid's widths (C = 800, P = 512) W_r alone is 6.6 MB in float32,
// while one SM has at most 227 KB of shared memory.  So each frame is two
// launches on the caller's stream, as in lstmp_forward.cu:
//   forward:  (A) gates + cell, one warp per cell row j reading the four
//                 rows W_r[j], W_r[C+j], W_r[2C+j], W_r[3C+j] (contiguous
//                 over P) from L2 against r_prev staged in shared memory
//                 for a tile of kStreamTile streams;
//             (B) projection, one warp per output column p reading
//                 W_rm[p] (contiguous over C) against m staged likewise;
//   backward: (C) dm = dr_new . W_rm and the cell backward, one warp per
//                 cell row j of W_rm^T [C, P];
//             (D) dr_prev = (1 - mask) dR_after + dgates . W_r, one warp
//                 per column p of W_r^T [P, 4C].
// The per-step product is device_math.cuh's staged_rows_dot.  The wrapper
// transposes W_r and W_rm once per call so that every warp reads
// contiguous rows.  Each (s, j) and (s, p) of the state is read and
// written by one thread and stream order separates the launches, so the
// in-place state updates need no atomics and every run repeats exactly.
// A step is bound by reading the weights from L2 once per stream tile and
// by launch latency; wgmma, TMA and a persistent kernel are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_math.cuh"

namespace {

using namespace aslp_cuda;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStreamTile = 16;   // streams per block; one lane ends each

// ---------------------------------------------------------------------------
// Forward, frame t.  Layouts: xg [S, T, 4C] (St, bias included), mask
// [S, T], gates [T, S, 4C], cs [T, S, C], rs [T, S, P] (St); the float32
// state c_state [S, C], r_state [S, P] and m_buf [S, C] are updated in
// place.
// ---------------------------------------------------------------------------

// (A) gates + cell for cells [blockIdx.x * kWarps, +kWarps) and streams
// [blockIdx.y * kStreamTile, +kStreamTile).
template <typename St, typename Wt>
__global__ void __launch_bounds__(kThreads)
fwd_cell_kernel(int t, const St* __restrict__ xg,
                const float* __restrict__ mask,
                const Wt* __restrict__ w_r,
                const float* __restrict__ peep,
                const float* __restrict__ r_state,
                float* __restrict__ c_state, float* __restrict__ m_buf,
                St* __restrict__ gates, St* __restrict__ cs, int S, int T,
                int C, int P, float cell_clip) {
  constexpr int ST = kStreamTile;
  const int s0 = blockIdx.y * ST;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = j < C;
  float acc[4][ST];
  staged_rows_dot<ST, 4, kThreads>(
      acc, w_r + (size_t)(active ? j : 0) * P, (size_t)C * P, P,
      [=](int s, int p) {
        return s0 + s < S ? operand<Wt>(r_state[(size_t)(s0 + s) * P + p])
                          : 0.0f;
      },
      active);
  if (!active) return;

  const int G = 4 * C;
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int sg = s0 + s;
    if (lane != s || sg >= S) continue;
    const St* x = xg + ((size_t)sg * T + t) * G;
    const size_t cj = (size_t)sg * C + j;
    const float cp = c_state[cj];
    const float lin[4] = {to_f32(x[j]) + acc[0][s],
                          to_f32(x[C + j]) + acc[1][s],
                          to_f32(x[2 * C + j]) + acc[2][s],
                          to_f32(x[3 * C + j]) + acc[3][s]};
    const CellForward r =
        cell_forward(lin, cp, peep[j], peep[C + j], peep[2 * C + j],
                     cell_clip);
    const float mk = mask[(size_t)sg * T + t];
    const float cn = mk * r.c + (1.0f - mk) * cp;
    m_buf[cj] = r.m;
    c_state[cj] = cn;
    const size_t row = (size_t)t * S + sg;
    St* gr = gates + row * G;
    gr[j] = from_f32<St>(r.g);
    gr[C + j] = from_f32<St>(r.i);
    gr[2 * C + j] = from_f32<St>(r.f);
    gr[3 * C + j] = from_f32<St>(r.o);
    cs[row * C + j] = from_f32<St>(cn);
  }
}

// (B) projection for columns [blockIdx.x * kWarps, +kWarps) and streams
// [blockIdx.y * kStreamTile, +kStreamTile): r = m . W_rm^T, blended by the
// mask into r_state and stored to rs[t].
template <typename St, typename Wt>
__global__ void __launch_bounds__(kThreads)
fwd_proj_kernel(int t, const float* __restrict__ m_buf,
                const Wt* __restrict__ w_rm,
                const float* __restrict__ mask, float* __restrict__ r_state,
                St* __restrict__ rs, int S, int T, int C, int P) {
  constexpr int ST = kStreamTile;
  const int s0 = blockIdx.y * ST;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = p < P;
  float acc[1][ST];
  staged_rows_dot<ST, 1, kThreads>(
      acc, w_rm + (size_t)(active ? p : 0) * C, 0, C,
      [=](int s, int j) {
        return s0 + s < S ? operand<Wt>(m_buf[(size_t)(s0 + s) * C + j])
                          : 0.0f;
      },
      active);
  if (!active) return;

#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int sg = s0 + s;
    if (lane != s || sg >= S) continue;
    const float mk = mask[(size_t)sg * T + t];
    const size_t rp = (size_t)sg * P + p;
    const float rn = mk * acc[0][s] + (1.0f - mk) * r_state[rp];
    r_state[rp] = rn;
    rs[((size_t)t * S + sg) * P + p] = from_f32<St>(rn);
  }
}

// ---------------------------------------------------------------------------
// Backward, frame t.  Layouts: dy [S, T, P] (St, the dtype of ys), gates,
// cs as the forward stored them, init_c [S, C] f32, dxg [S, T, 4C] and
// drnew [T, S, P] (St); the float32 carries dc_state [S, C] and dr_state
// [S, P] and the frame's float32 dgates dg_buf [S, 4C] are updated in
// place.
// ---------------------------------------------------------------------------

// (C) dm = dr_new . W_rm (one warp per cell row j of W_rm^T), then the
// cell's backward.
template <typename St, typename Wt>
__global__ void __launch_bounds__(kThreads)
bwd_cell_kernel(int t, const St* __restrict__ dy,
                const float* __restrict__ mask, const St* __restrict__ gates,
                const St* __restrict__ cs, const float* __restrict__ init_c,
                const Wt* __restrict__ w_rm_t,
                const float* __restrict__ peep,
                const float* __restrict__ dr_state,
                float* __restrict__ dc_state, float* __restrict__ dg_buf,
                St* __restrict__ dxg, int S, int T, int C, int P,
                float cell_clip) {
  constexpr int ST = kStreamTile;
  const int s0 = blockIdx.y * ST;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = j < C;
  float acc[1][ST];
  staged_rows_dot<ST, 1, kThreads>(
      acc, w_rm_t + (size_t)(active ? j : 0) * P, 0, P,
      [=](int s, int p) {
        const int sg = s0 + s;
        if (sg >= S) return 0.0f;
        // dr_new = mask * (dy * mask + dr)
        const float mk = mask[(size_t)sg * T + t];
        const float dyv = to_f32(dy[((size_t)sg * T + t) * P + p]);
        return operand<Wt>(mk * (dyv * mk + dr_state[(size_t)sg * P + p]));
      },
      active);
  if (!active) return;

  const int G = 4 * C;
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int sg = s0 + s;
    if (lane != s || sg >= S) continue;
    const size_t row = (size_t)t * S + sg;
    // c_prev: the stored c of frame t-1, or init_c in the storage type
    const float cp = t > 0 ? to_f32(cs[(row - S) * C + j])
                           : to_f32(from_f32<St>(init_c[(size_t)sg * C + j]));
    const St* gr = gates + row * G;
    const float g = to_f32(gr[j]);
    const float i = to_f32(gr[C + j]);
    const float f = to_f32(gr[2 * C + j]);
    const float o = to_f32(gr[3 * C + j]);
    const float mk = mask[(size_t)sg * T + t];
    const size_t cj = (size_t)sg * C + j;
    const CellBackward b =
        cell_backward(g, i, f, o, cp, acc[0][s], dc_state[cj], mk, peep[j],
                      peep[C + j], peep[2 * C + j], cell_clip);
    dc_state[cj] = b.dc_prev;
    float* db = dg_buf + (size_t)sg * G;
    db[j] = b.dg;
    db[C + j] = b.di;
    db[2 * C + j] = b.df;
    db[3 * C + j] = b.d_o;
    St* dr = dxg + ((size_t)sg * T + t) * G;
    dr[j] = from_f32<St>(b.dg);
    dr[C + j] = from_f32<St>(b.di);
    dr[2 * C + j] = from_f32<St>(b.df);
    dr[3 * C + j] = from_f32<St>(b.d_o);
  }
}

// (D) dr_prev = (1 - mask) dR_after + dgates . W_r (one warp per column p
// of W_r^T, the frame's float32 dgates staged in chunks); also stores
// dr_new for the dW_rm reduction.
template <typename St, typename Wt>
__global__ void __launch_bounds__(kThreads)
bwd_dr_kernel(int t, const St* __restrict__ dy,
              const float* __restrict__ mask,
              const float* __restrict__ dg_buf,
              const Wt* __restrict__ w_r_t,
              float* __restrict__ dr_state, St* __restrict__ drnew, int S,
              int T, int C, int P) {
  constexpr int ST = kStreamTile;
  const int G = 4 * C;
  const int s0 = blockIdx.y * ST;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = p < P;
  float acc[1][ST];
  staged_rows_dot<ST, 1, kThreads>(
      acc, w_r_t + (size_t)(active ? p : 0) * G, 0, G,
      [=](int s, int g) {
        return s0 + s < S ? operand<Wt>(dg_buf[(size_t)(s0 + s) * G + g])
                          : 0.0f;
      },
      active);
  if (!active) return;

#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int sg = s0 + s;
    if (lane != s || sg >= S) continue;
    const float mk = mask[(size_t)sg * T + t];
    const size_t rp = (size_t)sg * P + p;
    const float dra = to_f32(dy[((size_t)sg * T + t) * P + p]) * mk +
                      dr_state[rp];
    drnew[((size_t)t * S + sg) * P + p] = from_f32<St>(mk * dra);
    dr_state[rp] = (1.0f - mk) * dra + acc[0][s];
  }
}

template <typename St, typename Wt>
int run_fwd(const void* xg, const float* mask, const void* w_r,
            const void* w_rm, const float* peep, float* c_state,
            float* r_state, float* m_buf, void* gates, void* cs, void* rs,
            int S, int T, int C, int P, float cell_clip,
            cudaStream_t stream) {
  const dim3 grid_cell((C + kWarps - 1) / kWarps,
                       (S + kStreamTile - 1) / kStreamTile);
  const dim3 grid_proj((P + kWarps - 1) / kWarps,
                       (S + kStreamTile - 1) / kStreamTile);
  for (int t = 0; t < T; ++t) {
    fwd_cell_kernel<St, Wt><<<grid_cell, kThreads, 0, stream>>>(
        t, static_cast<const St*>(xg), mask, static_cast<const Wt*>(w_r),
        peep, r_state, c_state, m_buf, static_cast<St*>(gates),
        static_cast<St*>(cs), S, T, C, P, cell_clip);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    fwd_proj_kernel<St, Wt><<<grid_proj, kThreads, 0, stream>>>(
        t, m_buf, static_cast<const Wt*>(w_rm), mask, r_state,
        static_cast<St*>(rs), S, T, C, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename St, typename Wt>
int run_bwd(const void* dy, const float* mask, const void* gates,
            const void* cs, const float* init_c, const void* w_rm_t,
            const void* w_r_t, const float* peep, float* dc_state,
            float* dr_state, float* dg_buf, void* dxg, void* drnew, int S,
            int T, int C, int P, float cell_clip, cudaStream_t stream) {
  const dim3 grid_cell((C + kWarps - 1) / kWarps,
                       (S + kStreamTile - 1) / kStreamTile);
  const dim3 grid_dr((P + kWarps - 1) / kWarps,
                     (S + kStreamTile - 1) / kStreamTile);
  for (int t = T - 1; t >= 0; --t) {
    bwd_cell_kernel<St, Wt><<<grid_cell, kThreads, 0, stream>>>(
        t, static_cast<const St*>(dy), mask, static_cast<const St*>(gates),
        static_cast<const St*>(cs), init_c, static_cast<const Wt*>(w_rm_t),
        peep, dr_state, dc_state, dg_buf, static_cast<St*>(dxg), S, T, C, P,
        cell_clip);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    bwd_dr_kernel<St, Wt><<<grid_dr, kThreads, 0, stream>>>(
        t, static_cast<const St*>(dy), mask, dg_buf,
        static_cast<const Wt*>(w_r_t), dr_state, static_cast<St*>(drnew), S,
        T, C, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

bool bad_args(int store_bf16, int mxu_bf16, int S, int T, int C, int P) {
  // bf16 products need bf16 storage: the TPU kernels' fourth mode is not
  // taken by any caller
  return (mxu_bf16 && !store_bf16) || S <= 0 || T <= 0 || C <= 0 || P <= 0;
}

}  // namespace

// C entries, bound with ctypes.  All arrays are contiguous on the current
// device.  store_bf16 picks the type St (float or bf16) of xg, gates, cs,
// rs, dy, dxg and drnew; mxu_bf16 the type Wt (float or bf16) of the
// weights and the product operands.  Each returns a cudaError_t (0 on
// success).

// Forward.  xg [S, T, 4C] St, mask [S, T] f32, w_r [4C, P] and w_rm
// [P, C] Wt, peep [3, C] f32 (i, f, o).  c_state [S, C] and r_state
// [S, P] f32 hold the initial state on entry and the final state on
// return; m_buf [S, C] f32 is scratch.  Writes gates [T, S, 4C],
// cs [T, S, C], rs [T, S, P] (St).
extern "C" int lstmp_train_fwd(int store_bf16, int mxu_bf16, const void* xg,
                               const float* mask, const void* w_r,
                               const void* w_rm, const float* peep,
                               float* c_state, float* r_state, float* m_buf,
                               void* gates, void* cs, void* rs, int S, int T,
                               int C, int P, float cell_clip, void* stream) {
  if (bad_args(store_bf16, mxu_bf16, S, T, C, P))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mxu_bf16)
    return run_fwd<bf16, bf16>(xg, mask, w_r, w_rm, peep, c_state, r_state,
                               m_buf, gates, cs, rs, S, T, C, P, cell_clip,
                               st);
  if (store_bf16)
    return run_fwd<bf16, float>(xg, mask, w_r, w_rm, peep, c_state, r_state,
                                m_buf, gates, cs, rs, S, T, C, P, cell_clip,
                                st);
  return run_fwd<float, float>(xg, mask, w_r, w_rm, peep, c_state, r_state,
                               m_buf, gates, cs, rs, S, T, C, P, cell_clip,
                               st);
}

// Backward.  dy [S, T, P] St; mask, gates, cs as the forward took or wrote
// them; init_c [S, C] f32; w_rm_t [C, P] and w_r_t [P, 4C] Wt (the
// weights transposed); peep [3, C] f32.  dc_state [S, C] and dr_state
// [S, P] f32 hold the final-state cotangents on entry and the
// initial-state cotangents on return; dg_buf [S, 4C] f32 is scratch.
// Writes dxg [S, T, 4C] and drnew [T, S, P] (St).
extern "C" int lstmp_train_bwd(int store_bf16, int mxu_bf16, const void* dy,
                               const float* mask, const void* gates,
                               const void* cs, const float* init_c,
                               const void* w_rm_t, const void* w_r_t,
                               const float* peep, float* dc_state,
                               float* dr_state, float* dg_buf, void* dxg,
                               void* drnew, int S, int T, int C, int P,
                               float cell_clip, void* stream) {
  if (bad_args(store_bf16, mxu_bf16, S, T, C, P))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mxu_bf16)
    return run_bwd<bf16, bf16>(dy, mask, gates, cs, init_c, w_rm_t, w_r_t,
                               peep, dc_state, dr_state, dg_buf, dxg, drnew,
                               S, T, C, P, cell_clip, st);
  if (store_bf16)
    return run_bwd<bf16, float>(dy, mask, gates, cs, init_c, w_rm_t, w_r_t,
                                peep, dc_state, dr_state, dg_buf, dxg, drnew,
                                S, T, C, P, cell_clip, st);
  return run_bwd<float, float>(dy, mask, gates, cs, init_c, w_rm_t, w_r_t,
                               peep, dc_state, dr_state, dg_buf, dxg, drnew,
                               S, T, C, P, cell_clip, st);
}
