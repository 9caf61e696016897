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
// hybrid's widths (C = 800, P = 512) they are 8.2 MB in float32, while
// one SM has at most 227 KB of shared memory.  The card has 132 SMs, so
// each sweep is one cooperative, persistent kernel over all T frames
// (lstmp_fwd_sweep_kernel, lstmp_bwd_sweep_kernel), every block resident,
// one an SM.  Block b owns a group of cpb cells: their four gate rows of
// W_r [4C, P] and their columns of W_rm [P, C], which it keeps in shared
// memory as float32 for the whole sweep (5 cpb P floats: 72 KB at cpb 7,
// P 512).  A step is two phases with a grid-wide barrier after each:
//   forward:  (1) gates + cell of the owned cells for every stream, from
//                 the step's state row r_prev [S, P] (read through L2 by
//                 cp.async.cg into a ring of 64-column chunks), then the
//                 owned cells' share of the projection, m[:, cells] .
//                 W_rm[:, cells]^T, written as the block's partial sum
//                 [S, P] to a scratch slab;
//             (2) the projection summed over the blocks' slabs in block
//                 order, blended by the mask into r, and published as the
//                 next step's state row; each float4 of [S, P] has one
//                 owner thread in the whole grid;
//   backward: (1) dm = dr_new . W_rm[:, cells] and the cell backward of
//                 the owned cells, then their share of dr_prev, dgates[:,
//                 cells] . W_r[cells], as a partial slab: the dr product's
//                 K (4C) is split across the cell owners, so no block
//                 reads the step's whole dgates row;
//             (2) dr_prev summed over the slabs in block order, dr_new of
//                 this frame stored, and the next frame's dr_new published
//                 as the state row.
// The products are float32 FMA from shared memory in every mode (exact
// float32 products; TF32 would not hold float32's tolerance): a thread
// takes 4 streams x 4 columns a tile in the first product (threads split
// K where the tiles leave some idle) and 8 streams x 4 columns in the
// second, loading float4s of the staged rows and of the weight slices, so
// a warp's loads are broadcasts or conflict-free.  With bf16 products the
// operands are rounded to bf16 as they are staged (the weights once, the
// state and dgates as the phase that makes them writes them), and bf16 x
// bf16 is exact in float32, so the float32 path gives bf16 products with
// float32 sums.  Every sum has one owner and a fixed order (K in a fixed
// order within a block, the slabs in block order), with no atomics, so
// two runs give the same bits.
// What bounds it on the H100 (PERF.md section 6): a step at S = 100 takes
// about 44 us forward and 49 us backward, neither FLOPs (1.8 M FMA a
// block, about 7 us at the SMs' float32 rate) nor HBM bytes.  It grows by
// about 0.27 us a stream over a part that does not grow with the streams
// (the grid barriers, the ring's first chunk, the epilogues).  The
// per-stream part is L2 traffic: every block reads the whole state row
// [S, P] each step (23.5 MB a step at S = 100 over 115 blocks), and the
// partial slabs are written and read back (23.5 MB each way).  Sharing
// the state row among a cluster's SMs (TMA multicast) and reducing the
// slabs within a cluster first would cut both.
//
// The launch plan (blocks, cells a block, the ring's depth, the dynamic
// shared memory) is computed by the wrapper (ops/sweep_plan.py:
// lstmp_sweep_plan) and checked here against the layout the kernels use.
// Capacity: at most 16 cells a block over one block an SM (C <= 2112 on
// 132 SMs) and both sweeps' layouts, with a ring of at least 2 chunks,
// within 232,448 bytes; at P = 512 that is every C <= 2112 at S <= 64,
// C <= 1848 at S = 100 and C <= 1584 at S = 128 (so C = 2048, P = 512
// fits at 64 streams but not at 100).  Past it the plan selects the
// per-step kernels below, from the shapes alone: two launches a frame
// each way on the caller's stream, as in lstmp_forward.cu:
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
// Their per-step product is device_math.cuh's staged_rows_dot; each (s, j)
// and (s, p) of the state is read and written by one thread and stream
// order separates the launches, so they too repeat exactly.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_math.cuh"
#include "lstmp_sweep.cuh"
#include "sweep.cuh"

namespace {

using namespace aslp_cuda;
using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// The persistent sweeps.  Their plan and layout, the two products, the sum
// over the slabs and the forward sweep's body are lstmp_sweep.cuh's, which
// the inference kernel (lstmp_forward.cu) shares.
// ---------------------------------------------------------------------------

template <typename St, typename Wt>
__global__ void __launch_bounds__(kUniThreads, 1)
lstmp_fwd_sweep_kernel(UniFwdArgs<St, Wt> a) {
  lstmp_fwd_sweep_body<St, Wt, true>(a, blockIdx.x);
}

template <typename St, typename Wt>
struct UniBwdArgs {
  const St* dy;
  const float* mask;
  const St* gates;
  const St* cs;
  const float* init_c;
  const Wt* w_r;     // [4C, P]
  const Wt* w_rm;    // [P, C]
  const float* peep;
  const float* dc_T;
  const float* dr_T;
  float* dc_state;   // [S, C], written from the first (last-frame) step on
  float* dr_state;   // [S, P], likewise
  float* row;        // [S, pp] the step's dr_new, rounded as an operand
  float* slab;       // [nb, S, pp] partial dr_prev products
  St* dxg;
  St* drnew;
  int S, T, C, P;
  float cell_clip;
  UniPlan p;
};

template <typename St, typename Wt>
__global__ void __launch_bounds__(kUniThreads, 1)
lstmp_bwd_sweep_kernel(UniBwdArgs<St, Wt> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const UniPlan& p = a.p;
  const int S = a.S, T = a.T, C = a.C, P = a.P, G = 4 * C, pp = p.pp;
  const int cpb = p.cpb, cpb4 = p.cpb4, k2 = 4 * cpb;
  const UniLayout L = uni_layout(p, true);
  float* b1 = reinterpret_cast<float*>(smem + L.b1);   // [pp][cpb4]
  float* b2 = reinterpret_cast<float*>(smem + L.b2);   // [4 cpb][pp]
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  float* a2 = reinterpret_cast<float*>(smem + L.a2);   // [mg][4 cpb]
  const int blk = blockIdx.x, tid = threadIdx.x;
  const int j0 = blk * cpb, nj = max(0, min(C - j0, cpb));
  for (int i = tid; i < pp * cpb4; i += kUniThreads) {
    const int k = i / cpb4, jj = i - k * cpb4;
    b1[i] = k < P && jj < nj ? to_f32(a.w_rm[(size_t)k * C + j0 + jj])
                             : 0.0f;
  }
  for (int i = tid; i < k2 * pp; i += kUniThreads) {
    const int n = i / pp, k = i - n * pp, jj = n >> 2;
    b2[i] = k < P && jj < nj
                ? to_f32(a.w_r[(size_t)((n & 3) * C + j0 + jj) * P + k])
                : 0.0f;
  }
  // dgates' columns past the owned cells stay zero
  for (int i = tid; i < p.mg * k2; i += kUniThreads) a2[i] = 0.0f;
  __syncthreads();

  const float* peep = a.peep;
  const size_t slab_floats = (size_t)S * pp;
  const int gtid = blk * kUniThreads + tid, gthreads = p.nb * kUniThreads;
  const int units = S * (pp >> 2);
  cg::grid_group grid = cg::this_grid();
  // the first frame's dr_new = mask * (dy * mask + dr_T), pad columns 0
  for (int i = gtid; i < S * pp; i += gthreads) {
    const int s = i / pp, pc = i - s * pp;
    const size_t f = (size_t)s * T + T - 1;
    const float mk = a.mask[f];
    a.row[i] = pc < P ? operand<Wt>(mk * (to_f32(a.dy[f * P + pc]) * mk +
                                          a.dr_T[(size_t)s * P + pc]))
                      : 0.0f;
  }
  grid.sync();
  const int ntn = cpb4 >> 2;
  for (int t = T - 1; t >= 0; --t) {
    const float* dc_after = t == T - 1 ? a.dc_T : a.dc_state;
    const float* dr_after = t == T - 1 ? a.dr_T : a.dr_state;
    // (1) dm = dr_new . W_rm[:, cells] and the cell backward of the owned
    // cells, then their share of dgates . W_r
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
          const St* gr = a.gates + ((size_t)t * S + sg) * G;
#pragma unroll
          for (int g = 0; g < 4; ++g)
            gv[ii][e][g] = ok ? to_f32(gr[g * C + j]) : 0.0f;
          // c_prev: the stored c of frame t-1, or init_c in the storage
          // type
          dcv[ii][e] = ok ? dc_after[sg * C + j] : 0.0f;
          cpv[ii][e] = !ok ? 0.0f
                       : t > 0
                           ? to_f32(a.cs[((size_t)(t - 1) * S + sg) * C + j])
                           : to_f32(from_f32<St>(a.init_c[sg * C + j]));
        }
      }
      float acc[1][4][4];
      uni_product1<1>(a.row + (size_t)s0 * pp, rows, pp, b1, cpb4,
                      ntn, ring, p.mg * kUniLd, p.nstage, acc);
      if (tile) {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int s = q / ntn + ii * nsg;
          if (s >= rows) continue;
          const size_t sg = s0 + s;
          const float mk = mkv[ii];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = jb + e;
            if (jj >= nj) continue;
            const int j = j0 + jj;
            const size_t sj = sg * C + j;
            const CellBackward cb = cell_backward(
                gv[ii][e][0], gv[ii][e][1], gv[ii][e][2], gv[ii][e][3],
                cpv[ii][e], acc[0][ii][e], dcv[ii][e], mk, peep[j],
                peep[C + j], peep[2 * C + j], a.cell_clip);
            a.dc_state[sj] = cb.dc_prev;
            const float dg[4] = {cb.dg, cb.di, cb.df, cb.d_o};
            St* dr = a.dxg + (sg * T + t) * G;
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              dr[g * C + j] = from_f32<St>(dg[g]);
              a2[s * k2 + jj * 4 + g] = operand<Wt>(dg[g]);
            }
          }
        }
      }
      __syncthreads();
      uni_product2(a2, k2, rows, b2, pp,
                   a.slab + blk * slab_floats + (size_t)s0 * pp);
      __syncthreads();
    }
    grid.sync();
    // (2) dr_prev = (1 - mask) dr_after + the slabs' sum; dr_new of this
    // frame to the stream, of the next (t - 1) to the state row
    for_each_slab_sum(a.slab, slab_floats, p.nb, blk, units, [&](int u,
                                                            float4 v) {
      const int s = u / (pp >> 2), pc0 = (u - s * (pp >> 2)) << 2;
      const float sum[4] = {v.x, v.y, v.z, v.w};
      const size_t f = (size_t)s * T + t;
      const float mk = a.mask[f];
      const float mkn = t > 0 ? a.mask[f - 1] : 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pc = pc0 + e;
        if (pc >= P) continue;
        const size_t sp = (size_t)s * P + pc;
        const float dra = to_f32(a.dy[f * P + pc]) * mk + dr_after[sp];
        a.drnew[((size_t)t * S + s) * P + pc] = from_f32<St>(mk * dra);
        const float drs = (1.0f - mk) * dra + sum[e];
        a.dr_state[sp] = drs;
        if (t > 0)
          a.row[(size_t)s * pp + pc] = operand<Wt>(
              mkn * (to_f32(a.dy[(f - 1) * P + pc]) * mkn + drs));
      }
    });
    grid.sync();
  }
}

bool bad_args(int store_bf16, int mxu_bf16, int S, int T, int C, int P) {
  // bf16 products need bf16 storage: the TPU kernels' fourth mode is not
  // taken by any caller
  return (mxu_bf16 && !store_bf16) || S <= 0 || T <= 0 || C <= 0 || P <= 0;
}

// f(St{}, Wt{}) for the mode the flags pick
template <typename F>
int by_mode(int store_bf16, int mxu_bf16, F f) {
  if (mxu_bf16) return f(bf16{}, bf16{});
  if (store_bf16) return f(bf16{}, float{});
  return f(float{}, float{});
}

}  // namespace

// C entries, bound with ctypes.  All arrays are contiguous on the current
// device.  store_bf16 picks the type St (float or bf16) of xg, gates, cs,
// rs, dy, dxg and drnew; mxu_bf16 the type Wt (float or bf16) of the
// weights and the product operands.  The launch plan (nb blocks, cpb cells
// a block, an nstage-deep ring, smem bytes of dynamic shared memory) comes
// from ops/sweep_plan.py:lstmp_sweep_plan: nb = 0 runs the per-step
// kernels, which take the scratch m_buf / dg_buf; otherwise the
// persistent sweep, which takes the scratch row [S, pp] and slab
// [nb, S, pp] f32 (pp = P rounded up to 4), and an entry returns
// cudaErrorInvalidValue if the plan does not give the kernel's layout.
// Each returns a cudaError_t (0 on success).

// Forward.  xg [S, T, 4C] St, mask [S, T] f32, w_r [4C, P] and w_rm
// [P, C] Wt, peep [3, C] f32 (i, f, o), init_c [S, C] and init_r [S, P]
// f32.  Writes the final state c_state [S, C] and r_state [S, P] f32,
// gates [T, S, 4C], cs [T, S, C], rs [T, S, P] (St).
extern "C" int lstmp_train_fwd(int store_bf16, int mxu_bf16, const void* xg,
                               const float* mask, const void* w_r,
                               const void* w_rm, const float* peep,
                               const float* init_c, const float* init_r,
                               float* c_state, float* r_state, float* m_buf,
                               void* gates, void* cs, void* rs, int S, int T,
                               int C, int P, float cell_clip, int nb, int cpb,
                               int nstage, long long smem, float* row,
                               float* slab, void* stream) {
  if (bad_args(store_bf16, mxu_bf16, S, T, C, P))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const UniPlan plan = uni_plan(nb, cpb, nstage, S, P);
  if (nb != 0 && !uni_plan_ok(plan, S, C, smem, false))
    return (int)cudaErrorInvalidValue;
  return by_mode(store_bf16, mxu_bf16, [&](auto st_tag, auto wt_tag) {
    using St = decltype(st_tag);
    using Wt = decltype(wt_tag);
    if (nb == 0) {
      // the per-step kernels carry the state in place
      int err = (int)cudaMemcpyAsync(c_state, init_c, sizeof(float) * S * C,
                                     cudaMemcpyDeviceToDevice, st);
      if (!err)
        err = (int)cudaMemcpyAsync(r_state, init_r, sizeof(float) * S * P,
                                   cudaMemcpyDeviceToDevice, st);
      if (err) return err;
      return run_fwd<St, Wt>(xg, mask, w_r, w_rm, peep, c_state, r_state,
                             m_buf, gates, cs, rs, S, T, C, P, cell_clip,
                             st);
    }
    UniFwdArgs<St, Wt> a;
    a.xg = static_cast<const St*>(xg);
    a.mask = mask;
    a.w_r = static_cast<const Wt*>(w_r);
    a.w_rm = static_cast<const Wt*>(w_rm);
    a.peep = peep;
    a.init_c = init_c;
    a.init_r = init_r;
    a.c_state = c_state;
    a.r_state = r_state;
    a.row = row;
    a.slab = slab;
    a.gates = static_cast<St*>(gates);
    a.cs = static_cast<St*>(cs);
    a.rs = static_cast<St*>(rs);
    a.S = S;
    a.T = T;
    a.C = C;
    a.P = P;
    a.cell_clip = cell_clip;
    a.p = plan;
    a.bar = nullptr;
    a.ys_stride = 0;
    a.reverse = 0;
    return launch_sweep(lstmp_fwd_sweep_kernel<St, Wt>, a, nb, kUniThreads,
                        (size_t)smem, st);
  });
}

// Backward.  dy [S, T, P] St; mask, gates, cs as the forward took or wrote
// them; init_c [S, C] f32; the weights w_r [4C, P] and w_rm [P, C] Wt (the
// persistent sweep's) or transposed, w_rm_t [C, P] and w_r_t [P, 4C] Wt
// (the per-step kernels'; the other pair may be null); peep [3, C] f32;
// the final-state cotangents dc_T [S, C] and dr_T [S, P] f32.  Writes the
// initial-state cotangents dc_state [S, C] and dr_state [S, P] f32, dxg
// [S, T, 4C] and drnew [T, S, P] (St).
extern "C" int lstmp_train_bwd(int store_bf16, int mxu_bf16, const void* dy,
                               const float* mask, const void* gates,
                               const void* cs, const float* init_c,
                               const void* w_r, const void* w_rm,
                               const void* w_rm_t, const void* w_r_t,
                               const float* peep, const float* dc_T,
                               const float* dr_T, float* dc_state,
                               float* dr_state, float* dg_buf, void* dxg,
                               void* drnew, int S, int T, int C, int P,
                               float cell_clip, int nb, int cpb, int nstage,
                               long long smem, float* row, float* slab,
                               void* stream) {
  if (bad_args(store_bf16, mxu_bf16, S, T, C, P))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const UniPlan plan = uni_plan(nb, cpb, nstage, S, P);
  if (nb != 0 && !uni_plan_ok(plan, S, C, smem, true))
    return (int)cudaErrorInvalidValue;
  return by_mode(store_bf16, mxu_bf16, [&](auto st_tag, auto wt_tag) {
    using St = decltype(st_tag);
    using Wt = decltype(wt_tag);
    if (nb == 0) {
      int err = (int)cudaMemcpyAsync(dc_state, dc_T, sizeof(float) * S * C,
                                     cudaMemcpyDeviceToDevice, st);
      if (!err)
        err = (int)cudaMemcpyAsync(dr_state, dr_T, sizeof(float) * S * P,
                                   cudaMemcpyDeviceToDevice, st);
      if (err) return err;
      return run_bwd<St, Wt>(dy, mask, gates, cs, init_c, w_rm_t, w_r_t,
                             peep, dc_state, dr_state, dg_buf, dxg, drnew, S,
                             T, C, P, cell_clip, st);
    }
    UniBwdArgs<St, Wt> a;
    a.dy = static_cast<const St*>(dy);
    a.mask = mask;
    a.gates = static_cast<const St*>(gates);
    a.cs = static_cast<const St*>(cs);
    a.init_c = init_c;
    a.w_r = static_cast<const Wt*>(w_r);
    a.w_rm = static_cast<const Wt*>(w_rm);
    a.peep = peep;
    a.dc_T = dc_T;
    a.dr_T = dr_T;
    a.dc_state = dc_state;
    a.dr_state = dr_state;
    a.row = row;
    a.slab = slab;
    a.dxg = static_cast<St*>(dxg);
    a.drnew = static_cast<St*>(drnew);
    a.S = S;
    a.T = T;
    a.C = C;
    a.P = P;
    a.cell_clip = cell_clip;
    a.p = plan;
    return launch_sweep(lstmp_bwd_sweep_kernel<St, Wt>, a, nb, kUniThreads,
                        (size_t)smem, st);
  });
}
