// Bidirectional LSTMP training fed the input projections (the xg-fed
// core), forward and backward, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernels kaldi_aslp_tpu/ops/lstm_pallas.py:
//   _bilstmp_fwd_kernel  (:561, through _bilstmp_train_fwd and
//                         bilstmp_train_core), and
//   _bilstmp_bwd_kernel  (:618, through _bilstmp_train_bwd, the custom VJP
//                         of _get_bilstmp_core),
// which the JAX package's bf16 BLSTMP takes under KALDI_ASLP_LSTM_NO_XFUSE
// or KALDI_ASLP_LSTM_MXU_FP32 (models/recurrent.py:474-486).  Both
// directions run in every step: direction f (d = 0) at frame t, direction
// b (d = 1) at frame T-1-t from a zero state.  Per direction:
//
//   gates = (xg + bias) + r_prev . W_r^T    (xg bf16 and bias-free;
//                                            W_r = w_gifo_r [4C, P])
//   g = tanh, i = sigmoid(+ peep_i c_prev), f = sigmoid(+ peep_f c_prev)
//   c = clip(f c_prev + i g);  o = sigmoid(+ peep_o c);  m = o tanh(c)
//   r = m . W_rm^T                          (W_rm = w_r_m [P, C])
//   c, r = mask * new + (1 - mask) * old
//
// The state and the cell math are float32.  The forward stores the
// activated gates, the post-mask c and r in bf16 (r as the r_prev of the
// next step in its direction, with the true initial state at the
// boundary) and writes the layer output bf16(r) * mask.  The backward
// recomputes c from the bf16 gates and c_prev (init_c in float32 at
// direction f's first frame, zero at direction b's last), carries dc and
// dr in float32, and emits per frame the bf16 dgates (the cotangent of
// xg), dr_new and m for the two weight reductions the wrapper does
// (dW_r, dW_rm: lstm_pallas.py:878-894); dbias and dpeep are summed in
// float32 from the unrounded dgates, as the TPU kernel sums them in VMEM.
//
// One template switch, Wt, is the type of the product operands and of the
// weights: bf16 (mxu_bf16: the state operand rounded where it is staged)
// or float (KALDI_ASLP_LSTM_MXU_FP32: the float32 state, m, dr_new and
// dgates meet float32 weights).  Storage is bf16 in both.
//
// What bounds it on the H100, and what the design does about it.  The TPU
// kernel keeps both directions' W_r and W_rm in one core's VMEM: at the
// flagship's widths (C = 512, P = 320) 3.3 MB in bf16, 6.6 MB in float32,
// against 227 KB of shared memory in one SM.  So, as in lstmp_train.cu,
// each step is two launches each way on the caller's stream, both
// directions in one launch (blockIdx.z): one warp per weight row reading
// it from L2 against the state operand of a 16-stream tile staged in
// shared memory (device_math.cuh's staged_rows_dot).  The wrapper
// transposes W_r and W_rm once per backward call so that every warp reads
// contiguous rows.  Each (stream, cell) and (stream, column) of the state,
// and each (stream, cell) of the dbias / dpeep sums, has one owner thread;
// the sum over streams is a second pass.  No atomics, so every run
// repeats exactly.  A step is bound by reading the weights from L2 once
// per stream tile and by launch latency; tensor-core products and a
// persistent kernel are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_math.cuh"

namespace {

using namespace aslp_cuda;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStreamTile = 16;   // streams per block; one lane ends each

// Layouts (d = direction, G = 4C): xgf, xgb [S, T, G] bf16; mask [S, T];
// the stored streams gates [2, S, T, G], cs [2, S, T, C], rprev [2, S, T, P]
// bf16; ys and dy [S, T, 2P] bf16 (direction d in columns [dP, dP + P));
// the float32 state [2, S, C] or [2, S, P], updated in place.

// ---------------------------------------------------------------------------
// Forward, one step: direction f at frame step, direction b at T-1-step.
// ---------------------------------------------------------------------------

// Gates + cell for cells [blockIdx.x * kWarps, +kWarps) and streams
// [blockIdx.y * kStreamTile, +kStreamTile); blockIdx.z is the direction.
// w_r [2, G, P] Wt, peep [2, 3, C], bias [2, G] f32.
template <typename Wt>
__global__ void __launch_bounds__(kThreads)
fwd_cell_kernel(int step, const bf16* __restrict__ xgf,
                const bf16* __restrict__ xgb, const float* __restrict__ mask,
                const Wt* __restrict__ w_r, const float* __restrict__ peep,
                const float* __restrict__ bias,
                const float* __restrict__ r_state,
                float* __restrict__ c_state, float* __restrict__ m_buf,
                bf16* __restrict__ gates, bf16* __restrict__ cs, int S, int T,
                int C, int P, float cell_clip) {
  constexpr int ST = kStreamTile;
  const int d = blockIdx.z;
  const int t = d == 0 ? step : T - 1 - step;
  const int G = 4 * C;
  const int s0 = blockIdx.y * ST;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = j < C;
  const float* r_d = r_state + (size_t)d * S * P;
  float acc[4][ST];
  staged_rows_dot<ST, 4, kThreads>(
      acc, w_r + ((size_t)d * G + (active ? j : 0)) * P, (size_t)C * P, P,
      [=](int s, int p) {
        return s0 + s < S ? operand<Wt>(r_d[(size_t)(s0 + s) * P + p])
                          : 0.0f;
      },
      active);
  if (!active) return;

  const bf16* xg = d == 0 ? xgf : xgb;
  const float* b = bias + (size_t)d * G;
  const float* pp = peep + (size_t)d * 3 * C;
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int sg = s0 + s;
    if (lane != s || sg >= S) continue;
    const bf16* x = xg + ((size_t)sg * T + t) * G;
    const size_t cj = ((size_t)d * S + sg) * C + j;
    const float cp = c_state[cj];
    // (xg + bias) + r_prev . W_r^T, in the TPU kernel's order
    const float lin[4] = {(to_f32(x[j]) + b[j]) + acc[0][s],
                          (to_f32(x[C + j]) + b[C + j]) + acc[1][s],
                          (to_f32(x[2 * C + j]) + b[2 * C + j]) + acc[2][s],
                          (to_f32(x[3 * C + j]) + b[3 * C + j]) + acc[3][s]};
    const CellForward r =
        cell_forward(lin, cp, pp[j], pp[C + j], pp[2 * C + j], cell_clip);
    const float mk = mask[(size_t)sg * T + t];
    const float cn = mk * r.c + (1.0f - mk) * cp;
    c_state[cj] = cn;
    m_buf[cj] = r.m;
    const size_t row = ((size_t)d * S + sg) * T + t;
    bf16* gr = gates + row * G;
    gr[j] = __float2bfloat16(r.g);
    gr[C + j] = __float2bfloat16(r.i);
    gr[2 * C + j] = __float2bfloat16(r.f);
    gr[3 * C + j] = __float2bfloat16(r.o);
    cs[row * C + j] = __float2bfloat16(cn);
  }
}

// Projection for columns [blockIdx.x * kWarps, +kWarps): r = m . W_rm^T,
// blended by the mask; the bf16 r goes to the next step's r_prev slot
// and, times the mask, to ys.  w_rm [2, P, C] Wt.
template <typename Wt>
__global__ void __launch_bounds__(kThreads)
fwd_proj_kernel(int step, const float* __restrict__ m_buf,
                const Wt* __restrict__ w_rm, const float* __restrict__ mask,
                float* __restrict__ r_state, bf16* __restrict__ rprev,
                bf16* __restrict__ ys, int S, int T, int C, int P) {
  constexpr int ST = kStreamTile;
  const int d = blockIdx.z;
  const int t = d == 0 ? step : T - 1 - step;
  const int s0 = blockIdx.y * ST;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = p < P;
  const float* m_d = m_buf + (size_t)d * S * C;
  float acc[1][ST];
  staged_rows_dot<ST, 1, kThreads>(
      acc, w_rm + ((size_t)d * P + (active ? p : 0)) * C, 0, C,
      [=](int s, int j) {
        return s0 + s < S ? operand<Wt>(m_d[(size_t)(s0 + s) * C + j])
                          : 0.0f;
      },
      active);
  if (!active) return;

#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int sg = s0 + s;
    if (lane != s || sg >= S) continue;
    const float mk = mask[(size_t)sg * T + t];
    const size_t rp = ((size_t)d * S + sg) * P + p;
    const float rn = mk * acc[0][s] + (1.0f - mk) * r_state[rp];
    r_state[rp] = rn;
    const bf16 rb = __float2bfloat16(rn);
    const size_t row = ((size_t)d * S + sg) * T;
    if (d == 0 && t + 1 < T) rprev[(row + t + 1) * P + p] = rb;
    if (d == 1 && t >= 1) rprev[(row + t - 1) * P + p] = rb;
    ys[((size_t)sg * T + t) * 2 * P + (size_t)d * P + p] =
        __float2bfloat16(__bfloat162float(rb) * round_bf16(mk));
  }
}

// ---------------------------------------------------------------------------
// Backward, one step of the reverse sweep: direction f at frame
// T-1-step, direction b at frame step.
// ---------------------------------------------------------------------------

// dm = dr_new . W_rm (one warp per cell j, rows of w_rm_t [2, C, P] Wt),
// then the cell's backward: writes the frame's dgates (float32 into
// dg_buf [2, S, G] for the dr kernel, bf16 into dxg [2, S, T, G]) and m
// (bf16, m_out [2, S, T, C]), carries dc, and sums dbias and dpeep per
// (stream, cell) into acc [2, S, 7C].
template <typename Wt>
__global__ void __launch_bounds__(kThreads)
bwd_cell_kernel(int step, const bf16* __restrict__ dy,
                const float* __restrict__ mask, const bf16* __restrict__ gates,
                const bf16* __restrict__ cs, const float* __restrict__ init_c,
                const Wt* __restrict__ w_rm_t,
                const float* __restrict__ peep,
                const float* __restrict__ dr_state,
                float* __restrict__ dc_state, float* __restrict__ acc_sum,
                float* __restrict__ dg_buf, bf16* __restrict__ dxg,
                bf16* __restrict__ m_out, int S, int T, int C, int P,
                float cell_clip) {
  constexpr int ST = kStreamTile;
  const int d = blockIdx.z;
  const int t = d == 0 ? T - 1 - step : step;
  const int s0 = blockIdx.y * ST;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = j < C;
  const float* dr_d = dr_state + (size_t)d * S * P;
  float acc[1][ST];
  staged_rows_dot<ST, 1, kThreads>(
      acc, w_rm_t + ((size_t)d * C + (active ? j : 0)) * P, 0, P,
      [=](int s, int p) {
        const int sg = s0 + s;
        if (sg >= S) return 0.0f;
        // dr_new = mask * (dy * mask + dr)
        const float mk = mask[(size_t)sg * T + t];
        const float dyv = __bfloat162float(
            dy[((size_t)sg * T + t) * 2 * P + (size_t)d * P + p]);
        return operand<Wt>(mk * (dyv * mk + dr_d[(size_t)sg * P + p]));
      },
      active);
  if (!active) return;

  const int G = 4 * C;
  const float* pp = peep + (size_t)d * 3 * C;
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int sg = s0 + s;
    if (lane != s || sg >= S) continue;
    const size_t row = ((size_t)d * S + sg) * T + t;
    // c_prev: the stored c of the previous frame in the direction's
    // order, or its initial state (init_c for f, zero for b)
    float cp;
    if (d == 0)
      cp = t > 0 ? __bfloat162float(cs[(row - 1) * C + j])
                 : init_c[(size_t)sg * C + j];
    else
      cp = t < T - 1 ? __bfloat162float(cs[(row + 1) * C + j]) : 0.0f;
    const bf16* gr = gates + row * G;
    const float g = __bfloat162float(gr[j]);
    const float i = __bfloat162float(gr[C + j]);
    const float f = __bfloat162float(gr[2 * C + j]);
    const float o = __bfloat162float(gr[3 * C + j]);
    const float mk = mask[(size_t)sg * T + t];
    const size_t cj = ((size_t)d * S + sg) * C + j;
    const CellBackward b =
        cell_backward(g, i, f, o, cp, acc[0][s], dc_state[cj], mk, pp[j],
                      pp[C + j], pp[2 * C + j], cell_clip);
    m_out[row * C + j] = __float2bfloat16(o * b.tc);
    dc_state[cj] = b.dc_prev;
    float* db = dg_buf + ((size_t)d * S + sg) * G;
    db[j] = b.dg;
    db[C + j] = b.di;
    db[2 * C + j] = b.df;
    db[3 * C + j] = b.d_o;
    bf16* dgr = dxg + row * G;
    dgr[j] = __float2bfloat16(b.dg);
    dgr[C + j] = __float2bfloat16(b.di);
    dgr[2 * C + j] = __float2bfloat16(b.df);
    dgr[3 * C + j] = __float2bfloat16(b.d_o);
    float* a = acc_sum + ((size_t)d * S + sg) * 7 * C;
    a[j] += b.dg;
    a[C + j] += b.di;
    a[2 * C + j] += b.df;
    a[3 * C + j] += b.d_o;
    a[4 * C + j] += b.di * cp;
    a[5 * C + j] += b.df * cp;
    a[6 * C + j] += b.d_o * b.c;
  }
}

// dr_prev = (1 - mask) dR_after + dgates . W_r (one warp per column p,
// rows of w_r_t [2, P, G] Wt, the step's float32 dgates staged as
// operands); also stores bf16(dr_new) [2, S, T, P] for the dW_rm
// reduction.
template <typename Wt>
__global__ void __launch_bounds__(kThreads)
bwd_dr_kernel(int step, const bf16* __restrict__ dy,
              const float* __restrict__ mask,
              const float* __restrict__ dg_buf, const Wt* __restrict__ w_r_t,
              float* __restrict__ dr_state, bf16* __restrict__ drn, int S,
              int T, int C, int P) {
  constexpr int ST = kStreamTile;
  const int d = blockIdx.z;
  const int t = d == 0 ? T - 1 - step : step;
  const int G = 4 * C;
  const int s0 = blockIdx.y * ST;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = p < P;
  const float* dg_d = dg_buf + (size_t)d * S * G;
  float acc[1][ST];
  staged_rows_dot<ST, 1, kThreads>(
      acc, w_r_t + ((size_t)d * P + (active ? p : 0)) * G, 0, G,
      [=](int s, int g) {
        return s0 + s < S ? operand<Wt>(dg_d[(size_t)(s0 + s) * G + g])
                          : 0.0f;
      },
      active);
  if (!active) return;

#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int sg = s0 + s;
    if (lane != s || sg >= S) continue;
    const float mk = mask[(size_t)sg * T + t];
    const float dyv = __bfloat162float(
        dy[((size_t)sg * T + t) * 2 * P + (size_t)d * P + p]);
    const size_t rp = ((size_t)d * S + sg) * P + p;
    const float dra = dyv * mk + dr_state[rp];
    drn[(((size_t)d * S + sg) * T + t) * P + p] = __float2bfloat16(mk * dra);
    dr_state[rp] = (1.0f - mk) * dra + acc[0][s];
  }
}

template <typename Wt>
int run_fwd(const bf16* xgf, const bf16* xgb, const float* mask,
            const void* w_r, const void* w_rm, const float* peep,
            const float* bias, float* c_state, float* r_state, float* m_buf,
            bf16* gates, bf16* cs, bf16* rprev, bf16* ys, int S, int T,
            int C, int P, float cell_clip, cudaStream_t stream) {
  constexpr int ST = kStreamTile;
  const dim3 grid_cell((C + kWarps - 1) / kWarps, (S + ST - 1) / ST, 2);
  const dim3 grid_proj((P + kWarps - 1) / kWarps, (S + ST - 1) / ST, 2);
  for (int step = 0; step < T; ++step) {
    fwd_cell_kernel<Wt><<<grid_cell, kThreads, 0, stream>>>(
        step, xgf, xgb, mask, static_cast<const Wt*>(w_r), peep, bias,
        r_state, c_state, m_buf, gates, cs, S, T, C, P, cell_clip);
    int err = (int)cudaGetLastError();
    if (err) return err;
    fwd_proj_kernel<Wt><<<grid_proj, kThreads, 0, stream>>>(
        step, m_buf, static_cast<const Wt*>(w_rm), mask, r_state, rprev, ys,
        S, T, C, P);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

template <typename Wt>
int run_bwd(const bf16* dy, const float* mask, const bf16* gates,
            const bf16* cs, const float* init_c, const void* w_rm_t,
            const void* w_r_t, const float* peep, float* dc_state,
            float* dr_state, float* acc, float* dg_buf, bf16* dxg,
            bf16* m_out, bf16* drn, float* dbp, int S, int T, int C, int P,
            float cell_clip, cudaStream_t stream) {
  constexpr int ST = kStreamTile;
  const dim3 grid_cell((C + kWarps - 1) / kWarps, (S + ST - 1) / ST, 2);
  const dim3 grid_dr((P + kWarps - 1) / kWarps, (S + ST - 1) / ST, 2);
  for (int step = 0; step < T; ++step) {
    bwd_cell_kernel<Wt><<<grid_cell, kThreads, 0, stream>>>(
        step, dy, mask, gates, cs, init_c, static_cast<const Wt*>(w_rm_t),
        peep, dr_state, dc_state, acc, dg_buf, dxg, m_out, S, T, C, P,
        cell_clip);
    int err = (int)cudaGetLastError();
    if (err) return err;
    bwd_dr_kernel<Wt><<<grid_dr, kThreads, 0, stream>>>(
        step, dy, mask, dg_buf, static_cast<const Wt*>(w_r_t), dr_state, drn,
        S, T, C, P);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int K = 7 * C;
  sum_streams_kernel<<<dim3((K + 127) / 128, 2), 128, 0, stream>>>(acc, dbp,
                                                                   S, K);
  return (int)cudaGetLastError();
}

bool bad_dims(int S, int T, int C, int P) {
  return S <= 0 || T <= 0 || C <= 0 || P <= 0;
}

}  // namespace

// C entries, bound with ctypes.  All arrays are contiguous on the current
// device; the layouts are those above.  mxu_bf16 picks Wt: the weights
// are bf16 (1) or float32 (0).  Each returns a cudaError_t (0 on success).

// Forward.  w_r [2, G, P] and w_rm [2, P, C] Wt (the parameters' own
// layouts), peep [2, 3, C] (i, f, o) and bias [2, G] f32.  c_state
// [2, S, C] and r_state [2, S, P] f32 hold the initial state on entry
// (direction b's zero) and the final state on return; m_buf [2, S, C] f32
// is scratch.  Writes gates, cs, rprev (but for the boundary rows,
// direction f's t = 0 and direction b's t = T-1, which are the caller's)
// and ys.
extern "C" int bilstmp_xg_train_fwd(
    int mxu_bf16, const bf16* xgf, const bf16* xgb, const float* mask,
    const void* w_r, const void* w_rm, const float* peep, const float* bias,
    float* c_state, float* r_state, float* m_buf, bf16* gates, bf16* cs,
    bf16* rprev, bf16* ys, int S, int T, int C, int P, float cell_clip,
    void* stream) {
  if (bad_dims(S, T, C, P)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mxu_bf16)
    return run_fwd<bf16>(xgf, xgb, mask, w_r, w_rm, peep, bias, c_state,
                         r_state, m_buf, gates, cs, rprev, ys, S, T, C, P,
                         cell_clip, st);
  return run_fwd<float>(xgf, xgb, mask, w_r, w_rm, peep, bias, c_state,
                        r_state, m_buf, gates, cs, rprev, ys, S, T, C, P,
                        cell_clip, st);
}

// Backward (the reverse sweep and the dbias / dpeep sums).  dy [S, T, 2P]
// bf16; gates, cs as the forward wrote them; init_c [S, C] f32; w_rm_t
// [2, C, P] and w_r_t [2, P, G] Wt (the weights transposed).  dc_state
// [2, S, C] and dr_state [2, S, P] f32 hold the final-state cotangents on
// entry (direction b's zero) and the initial-state cotangents on return.
// Scratch: acc [2, S, 7C] f32 zeroed by the caller, dg_buf [2, S, G] f32.
// Writes dxg [2, S, T, G], m_out [2, S, T, C], drn [2, S, T, P] bf16 and
// dbp [2, 7C] f32 (dbias, then dpeep i, f, o).
extern "C" int bilstmp_xg_train_bwd(
    int mxu_bf16, const bf16* dy, const float* mask, const bf16* gates,
    const bf16* cs, const float* init_c, const void* w_rm_t,
    const void* w_r_t, const float* peep, float* dc_state, float* dr_state,
    float* acc, float* dg_buf, bf16* dxg, bf16* m_out, bf16* drn, float* dbp,
    int S, int T, int C, int P, float cell_clip, void* stream) {
  if (bad_dims(S, T, C, P)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mxu_bf16)
    return run_bwd<bf16>(dy, mask, gates, cs, init_c, w_rm_t, w_r_t, peep,
                         dc_state, dr_state, acc, dg_buf, dxg, m_out, drn,
                         dbp, S, T, C, P, cell_clip, st);
  return run_bwd<float>(dy, mask, gates, cs, init_c, w_rm_t, w_r_t, peep,
                        dc_state, dr_state, acc, dg_buf, dxg, m_out, drn,
                        dbp, S, T, C, P, cell_clip, st);
}
