// Bidirectional LSTMP training fed the input projections (the xg-fed
// core), forward and backward, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernels kaldi_aslp_tpu/ops/lstm_pallas.py:
//   _bilstmp_fwd_kernel  (:561, through _bilstmp_train_fwd and
//                         bilstmp_train_core), and
//   _bilstmp_bwd_kernel  (:618, through _bilstmp_train_bwd, the custom VJP
//                         of _get_bilstmp_core),
// which the JAX package's bf16 BLSTMP takes under KALDI_ASLP_LSTM_NO_XFUSE
// (bf16 products) or KALDI_ASLP_LSTM_MXU_FP32 (float32 products;
// models/recurrent.py:474-486).  Both directions run in every step:
// direction f (d = 0) at frame t, direction b (d = 1) at frame T-1-t from
// a zero state.  Per direction:
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
// xg), dr_new and m for the two weight reductions the wrapper does (dW_r,
// dW_rm: lstm_pallas.py:878-894, on the hand GEMM of bilstmp_train.cu);
// dbias and dpeep are summed in float32 from the unrounded dgates, as the
// TPU kernel sums them in VMEM.  Storage is bf16 in both product modes.
//
// Design.  The TPU kernel keeps both directions' W_r and W_rm in one
// core's VMEM: at the flagship's widths (C = 512, P = 320) 3.3 MB in bf16,
// 6.6 MB in float32, against 227 KB of shared memory in one SM.  The card
// has 132 SMs, so each sweep is one cooperative, persistent kernel over
// all T frames and both directions, every block resident, one an SM:
// blocks [0, nb) run direction f, [nb, 2 nb) direction b (walking
// t = T-1 ... 0 in the forward, 0 ... T-1 in the backward, into the
// batch-major streams [2, S, T, .] and columns [dP, dP + P) of ys and dy;
// no flips, no copies).  Each block keeps its slices of one direction's
// weights in shared memory for the whole sweep; per product mode:
//   - bf16 products (mxu_bf16): the x-fused pair's tensor-core sweeps,
//     bilstmp_sweep.cuh's fwd_sweep_kernel<true> (fed the bf16 xgf / xgb,
//     summed (xg + bias) + acc) and bwd_sweep_kernel as they stand: a
//     block owns 8-16 cells and a group of 8 projection columns, its bf16
//     slices feed mma.sync m16n8k16 with float32 sums, the state rows go
//     between the steps' two phases as bf16 rows behind a grid barrier;
//   - float32 products: the unidirectional pair's FMA sweep
//     (lstmp_sweep.cuh: its plan and layout, its two products and the sum
//     over the blocks' partial slabs) for two directions, in the kernels
//     below: a block owns 4-16 cells (their gate rows of W_r and columns
//     of W_rm, float32), the second product's K is split across the cell
//     owners into partial [S, P] slabs added in block order (no block
//     reads the step's whole dgates row), each direction's blocks meet at
//     a counter barrier of their own (sweep.cuh), and the bias is added to
//     the bf16 xg as it is staged, so the order stays (xg + bias) + acc.
//     The backward keeps the seven per-(stream, cell) dbias / dpeep sums
//     in shared memory, one owner each, and adds them over the streams in
//     order at the end.
// Every sum has one owner and a fixed order, with no atomics, so two runs
// give the same bits.  The weight gradients dW_r = dgates^T . r_prev and
// dW_rm = dr_new^T . m are two GEMMs after the sweep (bilstmp_train.cu's
// TMA + wgmma kernel, called by the wrapper), on the stored bf16 streams
// with float32 sums in both modes, as lstm_pallas.py:880-894's mm2.
//
// Rounding against the TPU kernel, line by line (lstm_pallas.py):
//   :581-582  gates = xg + bias2[d] + _mm_k(r_prev, W_r): both sweeps sum
//             (float(xg) + bias) + acc, acc over r_prev rounded to bf16
//             (the r row is stored bf16) or float32 (stored float32);
//   :592      r = _mm_k(m, W_rm): m rounded to bf16 (the m row) or not;
//   :593-594  the mask blend in float32, then the bf16 stores :605-610;
//   :658-660  dR_after = dy * mask + dr_carry, dr_new = mask * dR_after:
//             the same float32 expressions;
//   :663      dm = _mm_k(dr_new, W_rm^T): the dr_new row rounded to bf16
//             (bf16 products) or float32;
//   :664-678  the cell backward in float32 (device_math.cuh's
//             cell_backward, the same expressions);
//   :679      dr_prev += _mm_k(dgates, W_r^T): the dgates row rounded to
//             bf16, or the float32 dgates;
//   :683-686  dbias / dpeep summed from the unrounded float32 dgates, c_prev
//             and c, per (stream, cell) over the frames, then over the
//             streams (the TPU sums the streams first, a frame at a time:
//             another order, float32 either way);
//   :710-715  dxg, dr_new and m emitted in bf16.
//
// Capacity.  bf16 products: the x-fused sweeps' (ops/sweep_plan.py:
// sweep_plan with the bf16 prefetch): C <= 16 floor(SMs / 2) (1056 on 132
// SMs), P <= 64 columns a block, and the shared memory: every C <= 1024,
// P <= 512 at S <= 128.  Float32 products: at most 16 cells a block over
// floor(SMs / 2) blocks a direction (C <= 1056 on 132 SMs), each sweep
// within 232,448 bytes with a ring of at least 2 chunks: every C <= 1024,
// P <= 512 at S <= 48; at S = 128 every C <= 656 at P <= 512 and every
// C <= 1024 at P <= 224 (the flagship's C = 512, P = 320 fits, with a
// 5-deep ring forward and a 3-deep one backward, whose float32 weight
// slices, dgates operand and sums take 96,256 of its 200,704 bytes).  Past
// either capacity the plan selects the per-step kernels below, from the
// shapes alone: two launches a frame each way on the caller's stream, both
// directions in one launch (blockIdx.z), one warp per weight row reading it
// from L2 against the state operand of a 16-stream tile staged in shared
// memory (device_math.cuh's staged_rows_dot).
//
// What bounds it (an H100 80GB HBM3 at 700 W, S = 128, C = 512, P = 320):
// the per-step kernels spend 138 us a frame forward and 271-275 backward,
// reading every weight row from L2 once per 16-stream tile and launching
// twice a frame; the sweeps 27 us forward and 57 backward with bf16
// products, 35 and 48 with float32 ones.  A sweep's step is bound by its
// two hand-offs (a grid or counter barrier, then the state row fetched
// through L2) and the products' chunk loops, not by FLOPs or HBM bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bilstmp_sweep.cuh"
#include "device_math.cuh"
#include "lstmp_sweep.cuh"
#include "sweep.cuh"

namespace {

using namespace aslp_cuda;
using bf16 = __nv_bfloat16;

constexpr int kStepWarps = 4;
constexpr int kStepThreads = kStepWarps * 32;
constexpr int kStreamTile = 16;   // streams per block; one lane ends each

// Layouts (d = direction, G = 4C): xgf, xgb [S, T, G] bf16; mask [S, T];
// the stored streams gates [2, S, T, G], cs [2, S, T, C], rprev [2, S, T, P]
// bf16; ys and dy [S, T, 2P] bf16 (direction d in columns [dP, dP + P));
// the float32 state [2, S, C] or [2, S, P], updated in place.

// ---------------------------------------------------------------------------
// The per-step kernels (past the sweeps' capacity).  Forward, one step:
// direction f at frame step, direction b at T-1-step.
// ---------------------------------------------------------------------------

// Gates + cell for cells [blockIdx.x * kStepWarps, +kStepWarps) and streams
// [blockIdx.y * kStreamTile, +kStreamTile); blockIdx.z is the direction.
// w_r [2, G, P] Wt, peep [2, 3, C], bias [2, G] f32.
template <typename Wt>
__global__ void __launch_bounds__(kStepThreads)
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
  const int j = blockIdx.x * kStepWarps + (threadIdx.x >> 5);
  const bool active = j < C;
  const float* r_d = r_state + (size_t)d * S * P;
  float acc[4][ST];
  staged_rows_dot<ST, 4, kStepThreads>(
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

// Projection for columns [blockIdx.x * kStepWarps, +kStepWarps):
// r = m . W_rm^T, blended by the mask; the bf16 r goes to the next step's
// r_prev slot and, times the mask, to ys.  w_rm [2, P, C] Wt.
template <typename Wt>
__global__ void __launch_bounds__(kStepThreads)
fwd_proj_kernel(int step, const float* __restrict__ m_buf,
                const Wt* __restrict__ w_rm, const float* __restrict__ mask,
                float* __restrict__ r_state, bf16* __restrict__ rprev,
                bf16* __restrict__ ys, int S, int T, int C, int P) {
  constexpr int ST = kStreamTile;
  const int d = blockIdx.z;
  const int t = d == 0 ? step : T - 1 - step;
  const int s0 = blockIdx.y * ST;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kStepWarps + (threadIdx.x >> 5);
  const bool active = p < P;
  const float* m_d = m_buf + (size_t)d * S * C;
  float acc[1][ST];
  staged_rows_dot<ST, 1, kStepThreads>(
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
__global__ void __launch_bounds__(kStepThreads)
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
  const int j = blockIdx.x * kStepWarps + (threadIdx.x >> 5);
  const bool active = j < C;
  const float* dr_d = dr_state + (size_t)d * S * P;
  float acc[1][ST];
  staged_rows_dot<ST, 1, kStepThreads>(
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
__global__ void __launch_bounds__(kStepThreads)
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
  const int p = blockIdx.x * kStepWarps + (threadIdx.x >> 5);
  const bool active = p < P;
  const float* dg_d = dg_buf + (size_t)d * S * G;
  float acc[1][ST];
  staged_rows_dot<ST, 1, kStepThreads>(
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
  const dim3 grid_cell((C + kStepWarps - 1) / kStepWarps, (S + ST - 1) / ST, 2);
  const dim3 grid_proj((P + kStepWarps - 1) / kStepWarps, (S + ST - 1) / ST, 2);
  for (int step = 0; step < T; ++step) {
    fwd_cell_kernel<Wt><<<grid_cell, kStepThreads, 0, stream>>>(
        step, xgf, xgb, mask, static_cast<const Wt*>(w_r), peep, bias,
        r_state, c_state, m_buf, gates, cs, S, T, C, P, cell_clip);
    int err = (int)cudaGetLastError();
    if (err) return err;
    fwd_proj_kernel<Wt><<<grid_proj, kStepThreads, 0, stream>>>(
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
  const dim3 grid_cell((C + kStepWarps - 1) / kStepWarps, (S + ST - 1) / ST, 2);
  const dim3 grid_dr((P + kStepWarps - 1) / kStepWarps, (S + ST - 1) / ST, 2);
  for (int step = 0; step < T; ++step) {
    bwd_cell_kernel<Wt><<<grid_cell, kStepThreads, 0, stream>>>(
        step, dy, mask, gates, cs, init_c, static_cast<const Wt*>(w_rm_t),
        peep, dr_state, dc_state, acc, dg_buf, dxg, m_out, S, T, C, P,
        cell_clip);
    int err = (int)cudaGetLastError();
    if (err) return err;
    bwd_dr_kernel<Wt><<<grid_dr, kStepThreads, 0, stream>>>(
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


// ---------------------------------------------------------------------------
// Float32 products: the FMA sweeps, both directions in one cooperative
// launch.  The plan, the layout, the two products and the slab sum are
// lstmp_sweep.cuh's; ops/sweep_plan.py:bilstmp_xg_plan computes the plan.
// ---------------------------------------------------------------------------

// Bytes of an FMA sweep block's dynamic shared memory: uni_layout's
// regions, and in the backward the seven per-(stream, cell) sums
// [7][S][cpb] after them (dbias g, i, f, o; dpeep i, f, o).
__host__ __device__ inline size_t fma_smem_bytes(const UniPlan& p, int S,
                                           bool backward) {
  return uni_layout(p, backward).total +
         (backward ? align16((size_t)7 * S * p.cpb * sizeof(float)) : 0);
}

bool fma_plan_ok(const UniPlan& p, int S, int C, long long smem,
                 bool backward) {
  if (p.nb <= 0 || p.cpb <= 0 || p.cpb > kUniMaxCells || p.nstage < 2 ||
      p.nstage > kUniMaxStages)
    return false;
  if ((long long)p.nb * p.cpb < C || (long long)(p.nb - 1) * p.cpb >= C)
    return false;
  const size_t total = fma_smem_bytes(p, S, backward);
  return (long long)total == smem && total <= kSmemLimit;
}

// Direction d's barrier counter is bar[kBarStride * d]; the C entries
// clear kBarWords words before each launch.
constexpr int kBarStride = 32, kBarWords = 64;

struct FmaFwdArgs {
  const bf16* xgf;     // [S, T, G] bf16, bias-free
  const bf16* xgb;
  const float* mask;   // [S, T]
  const float* w_r;    // [2, G, P]
  const float* w_rm;   // [2, P, C]
  const float* peep;   // [2, 3, C]
  const float* bias;   // [2, G]
  float* c_state;      // [2, S, C]: the initial state in, the final out
  float* r_state;      // [2, S, P]
  float* row;          // [2, S, pp]: the step's r_prev (pad columns 0)
  float* slab;         // [2, nb, S, pp]: the blocks' partial projections
  unsigned* bar;
  bf16* gates;         // [2, S, T, G]
  bf16* cs;            // [2, S, T, C]
  bf16* rprev;         // [2, S, T, P], but for the caller's boundary rows
  bf16* ys;            // [S, T, 2P]
  int S, T, C, P;
  float cell_clip;
  UniPlan p;
};

// Block blk of direction d owns cells [blk cpb, +cpb).  A step is two
// phases, each ending at the direction's barrier: (1) gates + cell of the
// owned cells for every stream, then their share of the projection as the
// block's partial slab; (2) r summed over the slabs in block order,
// blended by the mask, stored and published as the next step's row.
__global__ void __launch_bounds__(kUniThreads, 1)
xg_fma_fwd_sweep_kernel(FmaFwdArgs a) {
  extern __shared__ __align__(16) unsigned char xg_smem[];
  const UniPlan& p = a.p;
  const int S = a.S, T = a.T, C = a.C, P = a.P, G = 4 * C, pp = p.pp;
  const int cpb = p.cpb, cpb4 = p.cpb4;
  const UniLayout L = uni_layout(p, false);
  float* b1 = reinterpret_cast<float*>(xg_smem + L.b1);   // [pp][4 cpb]
  float* b2 = reinterpret_cast<float*>(xg_smem + L.b2);   // [cpb4][pp]
  float* ring = reinterpret_cast<float*>(xg_smem + L.ring);
  float* a2 = reinterpret_cast<float*>(xg_smem + L.a2);   // [mg][cpb4]
  const int tid = threadIdx.x;
  const int d = blockIdx.x / p.nb, blk = blockIdx.x - d * p.nb;
  const int j0 = blk * cpb, nj = max(0, min(C - j0, cpb));
  const float* w_r = a.w_r + (size_t)d * G * P;
  const float* w_rm = a.w_rm + (size_t)d * P * C;
  for (int i = tid; i < pp * 4 * cpb; i += kUniThreads) {
    const int k = i / (4 * cpb), n = i - k * 4 * cpb, jj = n >> 2;
    b1[i] = k < P && jj < nj ? w_r[(size_t)((n & 3) * C + j0 + jj) * P + k]
                             : 0.0f;
  }
  for (int i = tid; i < cpb4 * pp; i += kUniThreads) {
    const int jj = i / pp, k = i - jj * pp;
    b2[i] = k < P && jj < nj ? w_rm[(size_t)k * C + j0 + jj] : 0.0f;
  }
  // m's columns past the owned cells stay zero
  for (int i = tid; i < p.mg * cpb4; i += kUniThreads) a2[i] = 0.0f;
  __syncthreads();

  const bf16* xg = d == 0 ? a.xgf : a.xgb;
  const float* bias = a.bias + (size_t)d * G;
  const float* peep = a.peep + (size_t)d * 3 * C;
  float* c_state = a.c_state + (size_t)d * S * C;
  float* r_state = a.r_state + (size_t)d * S * P;
  float* row = a.row + (size_t)d * S * pp;
  const size_t slab_floats = (size_t)S * pp;
  float* slab = a.slab + (size_t)d * p.nb * slab_floats;
  unsigned* bar = a.bar + kBarStride * d;
  const int gtid = blk * kUniThreads + tid, gthreads = p.nb * kUniThreads;
  const int units = S * (pp >> 2);
  unsigned arrivals = 0;
  auto barrier = [&]() {
    arrivals += p.nb;
    counter_barrier(bar, arrivals);
  };
  // the first step's state row: r_0 (direction b's zero), pad columns 0
  for (int i = gtid; i < S * pp; i += gthreads) {
    const int s = i / pp, pc = i - s * pp;
    row[i] = pc < P ? r_state[(size_t)s * P + pc] : 0.0f;
  }
  barrier();
  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? step : T - 1 - step;
    // (1) gates + cell of the owned cells, then their share of the
    // projection
    for (int s0 = 0; nj > 0 && s0 < S; s0 += p.mg) {
      const int rows = min(p.mg, S - s0), nsg = (rows + 3) >> 2;
      // this thread's tiles' xg + bias, c_prev and mask, in flight during
      // the product
      float xr[2][4][4], cpv[2][4], mkv[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = tid + kUniThreads * i, jj = q % cpb;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int s = q / cpb + ii * nsg;
          const bool ok = q < nsg * cpb && s < rows && jj < nj;
          const size_t sg = s0 + (ok ? s : 0), j = j0 + (ok ? jj : 0);
          cpv[i][ii] = ok ? c_state[sg * C + j] : 0.0f;
          mkv[i][ii] = ok ? a.mask[sg * T + t] : 0.0f;
#pragma unroll
          for (int g = 0; g < 4; ++g)
            xr[i][ii][g] = ok ? __bfloat162float(
                                    xg[(sg * T + t) * G + g * C + j]) +
                                    bias[g * C + j]
                              : 0.0f;
        }
      }
      float acc[2][4][4];
      uni_product1<2>(row + (size_t)s0 * pp, rows, pp, b1, 4 * cpb, cpb,
                      ring, p.mg * kUniLd, p.nstage, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = tid + kUniThreads * i, jj = q % cpb;
        if (q >= nsg * cpb || jj >= nj) continue;
        const int j = j0 + jj;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int s = q / cpb + ii * nsg;
          if (s >= rows) continue;
          const size_t sg = s0 + s;
          // (xg + bias) + r_prev . W_r^T, in the TPU kernel's order
          float lin[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) lin[g] = xr[i][ii][g] + acc[i][ii][g];
          const float cp = cpv[i][ii];
          const CellForward cf = cell_forward(lin, cp, peep[j], peep[C + j],
                                              peep[2 * C + j], a.cell_clip);
          const float mk = mkv[i][ii];
          const float cn = mk * cf.c + (1.0f - mk) * cp;
          c_state[sg * C + j] = cn;
          a2[s * cpb4 + jj] = cf.m;
          const size_t rw = ((size_t)d * S + sg) * T + t;
          bf16* gr = a.gates + rw * G;
          gr[j] = __float2bfloat16(cf.g);
          gr[C + j] = __float2bfloat16(cf.i);
          gr[2 * C + j] = __float2bfloat16(cf.f);
          gr[3 * C + j] = __float2bfloat16(cf.o);
          a.cs[rw * C + j] = __float2bfloat16(cn);
        }
      }
      __syncthreads();
      uni_product2(a2, cpb4, rows, b2, pp,
                   slab + blk * slab_floats + (size_t)s0 * pp);
      __syncthreads();
    }
    barrier();
    // (2) r = the projection summed over the slabs, blended by the mask;
    // bf16(r) to the next frame's r_prev slot of the direction and, times
    // the mask, to ys
    for_each_slab_sum(slab, slab_floats, p.nb, blk, units, [&](int u,
                                                               float4 v) {
      const int s = u / (pp >> 2), pc0 = (u - s * (pp >> 2)) << 2;
      const float sum[4] = {v.x, v.y, v.z, v.w};
      const float mk = a.mask[(size_t)s * T + t];
      const size_t base = ((size_t)d * S + s) * T;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pc = pc0 + e;
        if (pc >= P) continue;
        const size_t sp = (size_t)s * P + pc;
        const float rn = mk * sum[e] + (1.0f - mk) * r_state[sp];
        r_state[sp] = rn;
        const bf16 rb = __float2bfloat16(rn);
        if (d == 0 && t + 1 < T) a.rprev[(base + t + 1) * P + pc] = rb;
        if (d == 1 && t >= 1) a.rprev[(base + t - 1) * P + pc] = rb;
        a.ys[((size_t)s * T + t) * 2 * P + (size_t)d * P + pc] =
            __float2bfloat16(__bfloat162float(rb) * round_bf16(mk));
        row[(size_t)s * pp + pc] = rn;
      }
    });
    barrier();
  }
}

struct FmaBwdArgs {
  const bf16* dy;        // [S, T, 2P]
  const float* mask;     // [S, T]
  const bf16* gates;     // [2, S, T, G]
  const bf16* cs;        // [2, S, T, C]
  const float* init_c;   // [S, C]
  const float* w_r;      // [2, G, P]
  const float* w_rm;     // [2, P, C]
  const float* peep;     // [2, 3, C]
  float* dc_state;       // [2, S, C]: the final-state cotangents in, the
  float* dr_state;       // [2, S, P]  initial-state cotangents out
  float* row;            // [2, S, pp]: the step's dr_new (pad columns 0)
  float* slab;           // [2, nb, S, pp]: partial dgates . W_r products
  unsigned* bar;
  bf16* dxg;             // [2, S, T, G]
  bf16* m_out;           // [2, S, T, C]
  bf16* drn;             // [2, S, T, P]
  float* dbp;            // [2, 7C]: dbias, then dpeep i, f, o
  int S, T, C, P;
  float cell_clip;
  UniPlan p;
};

// The reverse sweep: direction f at frame T-1-step, direction b at frame
// step.  (1) dm = dr_new . W_rm[:, cells] and the cell backward of the
// owned cells for every stream, then their share of dr_prev, dgates[:,
// cells] . W_r[cells], as the block's partial slab; (2) dr_prev summed
// over the slabs in block order, dr_new of this frame stored and of the
// next published as the row.
__global__ void __launch_bounds__(kUniThreads, 1)
xg_fma_bwd_sweep_kernel(FmaBwdArgs a) {
  extern __shared__ __align__(16) unsigned char xg_smem[];
  const UniPlan& p = a.p;
  const int S = a.S, T = a.T, C = a.C, P = a.P, G = 4 * C, pp = p.pp;
  const int cpb = p.cpb, cpb4 = p.cpb4, k2 = 4 * cpb;
  const UniLayout L = uni_layout(p, true);
  float* b1 = reinterpret_cast<float*>(xg_smem + L.b1);   // [pp][cpb4]
  float* b2 = reinterpret_cast<float*>(xg_smem + L.b2);   // [4 cpb][pp]
  float* ring = reinterpret_cast<float*>(xg_smem + L.ring);
  float* a2 = reinterpret_cast<float*>(xg_smem + L.a2);   // [mg][4 cpb]
  float* sums = reinterpret_cast<float*>(xg_smem + L.total);   // [7][S][cpb]
  const int tid = threadIdx.x;
  const int d = blockIdx.x / p.nb, blk = blockIdx.x - d * p.nb;
  const int j0 = blk * cpb, nj = max(0, min(C - j0, cpb));
  const float* w_r = a.w_r + (size_t)d * G * P;
  const float* w_rm = a.w_rm + (size_t)d * P * C;
  for (int i = tid; i < pp * cpb4; i += kUniThreads) {
    const int k = i / cpb4, jj = i - k * cpb4;
    b1[i] = k < P && jj < nj ? w_rm[(size_t)k * C + j0 + jj] : 0.0f;
  }
  for (int i = tid; i < k2 * pp; i += kUniThreads) {
    const int n = i / pp, k = i - n * pp, jj = n >> 2;
    b2[i] = k < P && jj < nj ? w_r[(size_t)((n & 3) * C + j0 + jj) * P + k]
                             : 0.0f;
  }
  // dgates' columns past the owned cells stay zero
  for (int i = tid; i < p.mg * k2; i += kUniThreads) a2[i] = 0.0f;
  const int plane = S * cpb;
  for (int i = tid; i < 7 * plane; i += kUniThreads) sums[i] = 0.0f;
  __syncthreads();

  const float* peep = a.peep + (size_t)d * 3 * C;
  float* dc_state = a.dc_state + (size_t)d * S * C;
  float* dr_state = a.dr_state + (size_t)d * S * P;
  float* row = a.row + (size_t)d * S * pp;
  const size_t slab_floats = (size_t)S * pp;
  float* slab = a.slab + (size_t)d * p.nb * slab_floats;
  unsigned* bar = a.bar + kBarStride * d;
  const bf16* dy = a.dy + (size_t)d * P;   // the direction's columns
  const size_t dys = 2 * (size_t)P;        // dy's row stride
  const int gtid = blk * kUniThreads + tid, gthreads = p.nb * kUniThreads;
  const int units = S * (pp >> 2);
  unsigned arrivals = 0;
  auto barrier = [&]() {
    arrivals += p.nb;
    counter_barrier(bar, arrivals);
  };
  // the first frame's dr_new = mask * (dy * mask + dr_T), pad columns 0
  {
    const int t = d == 0 ? T - 1 : 0;
    for (int i = gtid; i < S * pp; i += gthreads) {
      const int s = i / pp, pc = i - s * pp;
      const size_t f = (size_t)s * T + t;
      const float mk = a.mask[f];
      row[i] = pc < P ? mk * (__bfloat162float(dy[f * dys + pc]) * mk +
                              dr_state[(size_t)s * P + pc])
                      : 0.0f;
    }
  }
  barrier();
  const int ntn = cpb4 >> 2;
  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? T - 1 - step : step;
    // c_prev: c of frame tp, or init_c (f) / zero (b) at the boundary
    const bool has_prev = d == 0 ? t > 0 : t < T - 1;
    const int tp = d == 0 ? t - 1 : t + 1;
    // (1) dm and the cell backward of the owned cells, then their share
    // of dgates . W_r
    for (int s0 = 0; nj > 0 && s0 < S; s0 += p.mg) {
      const int rows = min(p.mg, S - s0), nsg = (rows + 3) >> 2;
      const int q = tid, jb = 4 * (q % ntn);
      const bool tile = q < nsg * ntn;
      // this thread's tile's gates, c_prev, dc and mask, in flight during
      // the product
      float gv[4][4][4], cpv[4][4], dcv[4][4], mkv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int s = q / ntn + ii * nsg;
        mkv[ii] = tile && s < rows ? a.mask[(size_t)(s0 + s) * T + t] : 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = tile && s < rows && jb + e < nj;
          const size_t sg = s0 + (ok ? s : 0), j = j0 + (ok ? jb + e : 0);
          const size_t rw = ((size_t)d * S + sg) * T;
          const bf16* gr = a.gates + (rw + t) * G;
#pragma unroll
          for (int g = 0; g < 4; ++g)
            gv[ii][e][g] = ok ? __bfloat162float(gr[g * C + j]) : 0.0f;
          dcv[ii][e] = ok ? dc_state[sg * C + j] : 0.0f;
          cpv[ii][e] = !ok ? 0.0f
                       : has_prev ? __bfloat162float(a.cs[(rw + tp) * C + j])
                       : d == 0   ? a.init_c[sg * C + j]
                                  : 0.0f;
        }
      }
      float acc[1][4][4];
      uni_product1<1>(row + (size_t)s0 * pp, rows, pp, b1, cpb4, ntn, ring,
                      p.mg * kUniLd, p.nstage, acc);
      if (tile) {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int s = q / ntn + ii * nsg;
          if (s >= rows) continue;
          const size_t sg = s0 + s;
          const size_t rw = ((size_t)d * S + sg) * T + t;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = jb + e;
            if (jj >= nj) continue;
            const int j = j0 + jj;
            const float cp = cpv[ii][e];
            const CellBackward cb = cell_backward(
                gv[ii][e][0], gv[ii][e][1], gv[ii][e][2], gv[ii][e][3], cp,
                acc[0][ii][e], dcv[ii][e], mkv[ii], peep[j], peep[C + j],
                peep[2 * C + j], a.cell_clip);
            dc_state[sg * C + j] = cb.dc_prev;
            a.m_out[rw * C + j] = __float2bfloat16(gv[ii][e][3] * cb.tc);
            const float dg[4] = {cb.dg, cb.di, cb.df, cb.d_o};
            bf16* dr = a.dxg + rw * G;
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              dr[g * C + j] = __float2bfloat16(dg[g]);
              a2[s * k2 + jj * 4 + g] = dg[g];
            }
            // dbias, dpeep: this (stream, cell)'s sums over the frames
            float* sm = sums + sg * cpb + jj;
            sm[0] += cb.dg;
            sm[plane] += cb.di;
            sm[2 * plane] += cb.df;
            sm[3 * plane] += cb.d_o;
            sm[4 * plane] += cb.di * cp;
            sm[5 * plane] += cb.df * cp;
            sm[6 * plane] += cb.d_o * cb.c;
          }
        }
      }
      __syncthreads();
      uni_product2(a2, k2, rows, b2, pp,
                   slab + blk * slab_floats + (size_t)s0 * pp);
      __syncthreads();
    }
    barrier();
    // (2) dr_prev = (1 - mask) dr_after + the slabs' sum; dr_new of this
    // frame to the stream, of the next to the row
    const bool has_next = step + 1 < T;
    const int tn = d == 0 ? t - 1 : t + 1;
    for_each_slab_sum(slab, slab_floats, p.nb, blk, units, [&](int u,
                                                               float4 v) {
      const int s = u / (pp >> 2), pc0 = (u - s * (pp >> 2)) << 2;
      const float sum[4] = {v.x, v.y, v.z, v.w};
      const size_t f = (size_t)s * T + t, fn = (size_t)s * T + tn;
      const float mk = a.mask[f];
      const float mkn = has_next ? a.mask[fn] : 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pc = pc0 + e;
        if (pc >= P) continue;
        const size_t sp = (size_t)s * P + pc;
        const float dra = __bfloat162float(dy[f * dys + pc]) * mk +
                          dr_state[sp];
        a.drn[(((size_t)d * S + s) * T + t) * P + pc] =
            __float2bfloat16(mk * dra);
        const float drs = (1.0f - mk) * dra + sum[e];
        dr_state[sp] = drs;
        if (has_next)
          row[(size_t)s * pp + pc] =
              mkn * (__bfloat162float(dy[fn * dys + pc]) * mkn + drs);
      }
    });
    barrier();
  }
  // dbias, dpeep of the owned cells: the per-(stream, cell) sums added
  // over the streams in order
  for (int i = tid; i < 7 * nj; i += kUniThreads) {
    const int k = i / nj, jj = i - k * nj;
    const float* src = sums + (size_t)k * plane + jj;
    float v = 0.0f;
    for (int s = 0; s < S; ++s) v += src[(size_t)s * cpb];
    a.dbp[(size_t)d * 7 * C + (size_t)k * C + j0 + jj] = v;
  }
}

}  // namespace

// C entries, bound with ctypes.  All arrays are contiguous on the current
// device; the layouts are those above.  mxu_bf16 picks the products: bf16
// (1) or float32 (0).  Each returns a cudaError_t (0 on success).
//
// The persistent sweeps take their plan (nbd blocks a direction, cpb cells
// and, with bf16 products, ppb projection columns a block, an nstage-deep
// ring, smem bytes of dynamic shared memory) from ops/sweep_plan.py:
// bilstmp_xg_plan, and return cudaErrorInvalidValue if it does not give the
// kernel's layout.  Scratch, by mode (pp = P rounded up to 16 with bf16
// products, to 4 with float32 ones; cp = C rounded up to 16):
//   bf16:    row [2, S, pp] bf16 (the forward's: bf16(init_r) for
//            direction f, else zeros; the backward's: zeros), part (the
//            forward's m rows [2, S, cp], the backward's dgates rows
//            [2, S, 4 cp]) bf16 zeros; bar unused;
//   float32: row [2, S, pp] and part [2, nbd, S, pp] f32, bar kBarWords
//            words (cleared here).

// Forward sweep.  w_r [2, G, P] and w_rm [2, P, C] in the products' type
// (the parameters' own layouts); peep [2, 3, C], bias [2, G] f32; c_state
// [2, S, C] and r_state [2, S, P] f32 hold the initial state on entry
// (direction b's zero) and the final state on return.  Writes gates, cs,
// rprev (but for the boundary rows, direction f's t = 0 and direction b's
// t = T-1, which are the caller's) and ys.
extern "C" int bilstmp_xg_sweep_fwd(
    int mxu_bf16, const bf16* xgf, const bf16* xgb, const float* mask,
    const void* w_r, const void* w_rm, const float* peep, const float* bias,
    float* c_state, float* r_state, bf16* gates, bf16* cs, bf16* rprev,
    bf16* ys, int S, int T, int C, int P, float cell_clip, int nbd, int cpb,
    int ppb, int nstage, long long smem, void* row, void* part,
    unsigned* bar, void* stream) {
  if (bad_dims(S, T, C, P)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mxu_bf16) {
    const Plan plan = make_plan(nbd, cpb, ppb, nstage, S, C, P);
    if (!plan_ok(plan, S, C, P, (size_t)smem, false, true))
      return (int)cudaErrorInvalidValue;
    FwdArgs a;
    a.xg = nullptr;
    a.xgf = xgf;
    a.xgb = xgb;
    a.mask = mask;
    a.wr = static_cast<const bf16*>(w_r);
    a.wrm = static_cast<const bf16*>(w_rm);
    a.peep = peep;
    a.bias = bias;
    a.c_state = c_state;
    a.r_state = r_state;
    a.rb = static_cast<bf16*>(row);
    a.mb = static_cast<bf16*>(part);
    a.gates = gates;
    a.cs = cs;
    a.rprev = rprev;
    a.ys = ys;
    a.S = S;
    a.T = T;
    a.C = C;
    a.P = P;
    a.cell_clip = cell_clip;
    a.p = plan;
    return launch_sweep(fwd_sweep_kernel<true>, a, 2 * nbd, kThreads,
                        (size_t)smem, st);
  }
  const UniPlan plan = uni_plan(nbd, cpb, nstage, S, P);
  if (!fma_plan_ok(plan, S, C, smem, false)) return (int)cudaErrorInvalidValue;
  int err = (int)cudaMemsetAsync(bar, 0, kBarWords * sizeof(unsigned), st);
  if (err) return err;
  FmaFwdArgs a;
  a.xgf = xgf;
  a.xgb = xgb;
  a.mask = mask;
  a.w_r = static_cast<const float*>(w_r);
  a.w_rm = static_cast<const float*>(w_rm);
  a.peep = peep;
  a.bias = bias;
  a.c_state = c_state;
  a.r_state = r_state;
  a.row = static_cast<float*>(row);
  a.slab = static_cast<float*>(part);
  a.bar = bar;
  a.gates = gates;
  a.cs = cs;
  a.rprev = rprev;
  a.ys = ys;
  a.S = S;
  a.T = T;
  a.C = C;
  a.P = P;
  a.cell_clip = cell_clip;
  a.p = plan;
  return launch_sweep(xg_fma_fwd_sweep_kernel, a, 2 * nbd, kUniThreads,
                      (size_t)smem, st);
}

// Backward sweep (the dbias / dpeep sums included; the wrapper reduces
// dW_r and dW_rm).  dy [S, T, 2P] bf16; gates, cs as the forward wrote
// them; init_c [S, C] f32; w_a, w_b the weights: with bf16 products
// transposed, w_r_t [2, P, G] and w_rm_t [2, C, P] bf16; with float32
// products in their own layouts, w_r [2, G, P] and w_rm [2, P, C] f32.
// dc_state [2, S, C] and dr_state [2, S, P] f32 hold the final-state
// cotangents on entry (direction b's zero) and the initial-state
// cotangents on return.  Writes dxg [2, S, T, G], m_out [2, S, T, C], drn
// [2, S, T, P] bf16 and dbp [2, 7C] f32 (dbias, then dpeep i, f, o).
extern "C" int bilstmp_xg_sweep_bwd(
    int mxu_bf16, const bf16* dy, const float* mask, const bf16* gates,
    const bf16* cs, const float* init_c, const void* w_a, const void* w_b,
    const float* peep, float* dc_state, float* dr_state, bf16* dxg,
    bf16* m_out, bf16* drn, float* dbp, int S, int T, int C, int P,
    float cell_clip, int nbd, int cpb, int ppb, int nstage, long long smem,
    void* row, void* part, unsigned* bar, void* stream) {
  if (bad_dims(S, T, C, P)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mxu_bf16) {
    const Plan plan = make_plan(nbd, cpb, ppb, nstage, S, C, P);
    if (!plan_ok(plan, S, C, P, (size_t)smem, true))
      return (int)cudaErrorInvalidValue;
    BwdArgs a;
    a.d0 = 0;
    a.dy = dy;
    a.mask = mask;
    a.gates = gates;
    a.cs = cs;
    a.init_c = init_c;
    a.wr_t = static_cast<const bf16*>(w_a);
    a.wrm_t = static_cast<const bf16*>(w_b);
    a.peep = peep;
    a.dc_state = dc_state;
    a.dr_state = dr_state;
    a.dnb = static_cast<bf16*>(row);
    a.dgb = static_cast<bf16*>(part);
    a.dgates = dxg;
    a.m_out = m_out;
    a.drn = drn;
    a.dbp = dbp;
    a.S = S;
    a.T = T;
    a.C = C;
    a.P = P;
    a.cell_clip = cell_clip;
    a.p = plan;
    return launch_sweep(bwd_sweep_kernel, a, 2 * nbd, kThreads,
                        (size_t)smem, st);
  }
  const UniPlan plan = uni_plan(nbd, cpb, nstage, S, P);
  if (!fma_plan_ok(plan, S, C, smem, true)) return (int)cudaErrorInvalidValue;
  int err = (int)cudaMemsetAsync(bar, 0, kBarWords * sizeof(unsigned), st);
  if (err) return err;
  FmaBwdArgs a;
  a.dy = dy;
  a.mask = mask;
  a.gates = gates;
  a.cs = cs;
  a.init_c = init_c;
  a.w_r = static_cast<const float*>(w_a);
  a.w_rm = static_cast<const float*>(w_b);
  a.peep = peep;
  a.dc_state = dc_state;
  a.dr_state = dr_state;
  a.row = static_cast<float*>(row);
  a.slab = static_cast<float*>(part);
  a.bar = bar;
  a.dxg = dxg;
  a.m_out = m_out;
  a.drn = drn;
  a.dbp = dbp;
  a.S = S;
  a.T = T;
  a.C = C;
  a.P = P;
  a.cell_clip = cell_clip;
  a.p = plan;
  return launch_sweep(xg_fma_bwd_sweep_kernel, a, 2 * nbd, kUniThreads,
                      (size_t)smem, st);
}

// The per-step kernels, which the plan selects past the sweeps' capacity.
// mxu_bf16 picks Wt: the weights are bf16 (1) or float32 (0).

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
