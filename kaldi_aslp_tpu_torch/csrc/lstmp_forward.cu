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
// (kaldi-aslp src/aslp-nnet/nnet-lstm-projected-streams.h:347-432).  All
// float32, float32 FMA products (no TF32: the kernel serves float32 models
// and is held at 1e-4).
//
// Why the TPU design does not carry over: the TPU kernel keeps W_r
// (2048 x 320 f32, 2.6 MB at the flagship's widths) and W_rm (655 KB) in
// one core's VMEM for the whole time loop.  One H100 SM has at most 227 KB
// of shared memory, but the card has 132 SMs.
//
// The design: a call is ONE cooperative, persistent launch over all T
// frames and over one or two directions (a BLSTMP layer's forward and
// backward cells, which share nothing: direction 1 walks the frames
// T-1 .. 0 from a zero state and writes columns [P, 2P) of ys).  Each
// direction has nbd blocks, all resident, one an SM; block b owns cells
// [b cpb, (b + 1) cpb) and keeps its slice of the weights in shared memory
// as float32 for every frame.  The blocks of a direction hand the step's
// state to each other through global memory (read back through L2), and
// never wait for the other direction's.  What bounds a call is neither
// FLOPs nor HBM bytes but the step's latency: two hand-offs a frame (r to
// the cell owners, m to the column owners), each some trips through L2.
// Two regimes, chosen with the rest of the launch plan by
// ops/sweep_plan.py:lstmp_infer_plan from the shapes alone and checked
// here against the layouts below:
//
//   few streams (S <= 16, lstmp_few_sweep_kernel): the served path.  A
//   block holds its cells' four gate rows of W_r [4 cpb][P] and the rows of
//   W_rm of the ppb projection columns it owns [ppb][C] (51,200 bytes at the
//   flagship's widths on 64 blocks of 8 cells), and the state of both in
//   shared memory.  A step: (A) the whole state row r_prev [S, P] fetched,
//   one warp a cell for the four gate sums over all streams, the cell, m
//   of the owned cells published; (B) the whole m row [S, C] fetched, one
//   warp a projection column, r of the owned columns blended, published
//   and stored to ys.  No partial slab, no ring.  The hand-off is one of
//   two exchanges.  Tags (S <= 4, the served chunk): a value is stored
//   with the step's number in one 8-byte word and every reader polls the
//   words it needs, so a hand-off is one trip through L2, with no barrier
//   and no fence; a row's slot is only written again after every block
//   has read it (the writer waited for the next row, which every block
//   only published after reading this one).  Barrier (S <= 16): the
//   direction's counter barrier (sweep.cuh), then one cp.async group:
//   three trips, but no polling of up to 50 words a thread.  Every dot
//   product is summed by one warp in an order that does not depend on the
//   plan, so a two-direction call gives the bits of two one-direction
//   calls, and both exchanges give the same bits.
//
//   many streams (lstmp_infer_sweep_kernel): the training forward's sweep
//   (lstmp_sweep.cuh, lstmp_train.cu's note) without its stores: register
//   tiles over the streams, the second product's K split across the cell
//   owners and summed over their partial slabs in block order.
//
// Past the plan's capacity (more than 16 cells a block, or a layout over
// 232,448 bytes) the plan selects the per-step kernels below: two launches
// a frame on the caller's stream, (A) gates + cell, one warp per cell row,
// (B) projection, one warp per output column, the state in place in global
// memory; their product is device_math.cuh's staged_rows_dot.  In every
// route each sum has one owner and a fixed order (no atomics): two runs
// give the same bits.

#include <cuda_runtime.h>

#include "device_math.cuh"
#include "lstmp_sweep.cuh"
#include "sweep.cuh"

namespace {

using namespace aslp_cuda;

// ---------------------------------------------------------------------------
// The per-step kernels.
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// (A) gates + cell for cells [blockIdx.x * kWarps, +kWarps) and streams
// [blockIdx.y * ST, +ST).  xg and mask point at the frame; their
// per-stream strides are T * 4C and T.
template <int ST>
__global__ void __launch_bounds__(kThreads)
step_cell_kernel(const float* __restrict__ xg, long long xg_stride,
                 const float* __restrict__ mask, long long mask_stride,
                 const float* __restrict__ w_r,
                 const float* __restrict__ peep, const float* __restrict__ r,
                 float* __restrict__ c, float* __restrict__ m, int S, int C,
                 int P, float cell_clip) {
  static_assert(ST >= 1 && ST <= 32, "one lane finishes each stream");
  const int s0 = blockIdx.y * ST;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = j < C;
  float acc[4][ST];
  staged_rows_dot<ST, 4, kThreads>(
      acc, w_r + (size_t)(active ? j : 0) * P, (size_t)C * P, P,
      [=](int s, int p) {
        return s0 + s < S ? r[(size_t)(s0 + s) * P + p] : 0.0f;
      },
      active);
  if (!active) return;
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int sg = s0 + s;
    if (lane != s || sg >= S) continue;
    const float* x = xg + (size_t)sg * xg_stride;
    const size_t cj = (size_t)sg * C + j;
    const float cp = c[cj];
    const float lin[4] = {x[j] + acc[0][s], x[C + j] + acc[1][s],
                          x[2 * C + j] + acc[2][s],
                          x[3 * C + j] + acc[3][s]};
    const CellForward cf = cell_forward(lin, cp, peep[j], peep[C + j],
                                        peep[2 * C + j], cell_clip);
    const float mk = mask[(size_t)sg * mask_stride];
    m[cj] = cf.m;
    c[cj] = mk * cf.c + (1.0f - mk) * cp;
  }
}

// (B) projection for columns [blockIdx.x * kWarps, +kWarps) and streams
// [blockIdx.y * ST, +ST).  ys points at the frame and the direction's
// first column; its per-stream stride is T * ys_width.
template <int ST>
__global__ void __launch_bounds__(kThreads)
step_proj_kernel(const float* __restrict__ m, const float* __restrict__ w_rm,
                 const float* __restrict__ mask, long long mask_stride,
                 float* __restrict__ r, float* __restrict__ ys,
                 long long ys_stride, int S, int C, int P) {
  static_assert(ST >= 1 && ST <= 32, "one lane finishes each stream");
  const int s0 = blockIdx.y * ST;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = p < P;
  float acc[1][ST];
  staged_rows_dot<ST, 1, kThreads>(
      acc, w_rm + (size_t)(active ? p : 0) * C, 0, C,
      [=](int s, int j) {
        return s0 + s < S ? m[(size_t)(s0 + s) * C + j] : 0.0f;
      },
      active);
  if (!active) return;
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int sg = s0 + s;
    if (lane != s || sg >= S) continue;
    const float mk = mask[(size_t)sg * mask_stride];
    const size_t rp = (size_t)sg * P + p;
    const float rn = mk * acc[0][s] + (1.0f - mk) * r[rp];
    r[rp] = rn;
    ys[(size_t)sg * ys_stride + p] = rn * mk;
  }
}

// One direction's frames, two launches each, the state in place in c and r.
template <int ST>
int run_per_step(const float* xg, const float* mask, const float* w_r,
                 const float* w_rm, const float* peep, float* c, float* r,
                 float* m, float* ys, int ys_width, bool reverse, int S, int T,
                 int C, int P, float cell_clip, cudaStream_t stream) {
  const dim3 grid_a((C + kWarps - 1) / kWarps, (S + ST - 1) / ST);
  const dim3 grid_b((P + kWarps - 1) / kWarps, (S + ST - 1) / ST);
  const long long xg_stride = (long long)T * 4 * C;
  const long long ys_stride = (long long)T * ys_width;
  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    step_cell_kernel<ST><<<grid_a, kThreads, 0, stream>>>(
        xg + (size_t)t * 4 * C, xg_stride, mask + t, T, w_r, peep, r, c, m,
        S, C, P, cell_clip);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    step_proj_kernel<ST><<<grid_b, kThreads, 0, stream>>>(
        m, w_rm, mask + t, T, r, ys + (size_t)t * ys_width, ys_stride, S, C,
        P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The few-stream sweep.  The limits are ops/sweep_plan.py's FWD_THREADS,
// FEW_MAX_STREAMS and FWD_MAX_CELLS (tests/test_torch_lstmp_plan.py holds
// them equal).
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFewMaxStreams = 16;  // one pass of register sums
constexpr int kFewTagStreams = 4;   // most streams of the tag exchange
constexpr int kFwdMaxCells = 16;    // cells a block may own
constexpr int kCellsPerWarp = kFwdMaxCells / kFwdWarps;
static_assert(kFwdMaxCells == kUniMaxCells && kFwdThreads == kUniThreads,
              "both regimes share the plan's blocks");

struct FewDir {
  const float* xg;    // [S, T, 4C]
  const float* w_r;   // [4C, P]
  const float* w_rm;  // [P, C]
  const float* peep;  // [3, C]
  const float* c0;    // [S, C], or null: a zero state
  const float* r0;    // [S, P], or null
  float* c_T;         // [S, C] the final state, or null: not returned
  float* r_T;         // [S, P]
  float* m_row;       // the step's m [S, C] from its cell owners: floats
                      // (barrier exchange) or {value, tag} pairs, 0 at launch
  float* r_row;       // the step's r [S, P] from its column owners, likewise
  unsigned* bar;      // the direction's barrier counter, 0 at launch
  float* ys;          // ys + direction * P
  int reverse;        // walk the frames T-1 .. 0
};

struct FewArgs {
  FewDir dir[2];
  const float* mask;  // [S, T]
  int S, T, C, P;
  int nbd, cpb, ppb;  // blocks a direction, cells and columns a block
  int ys_stride;      // floats a frame of ys: directions * P
  float cell_clip;
};

// Byte offsets of a few-stream block's dynamic shared memory, all float32:
// the staged state rows r_prev [ST][P] (phase A) and m [ST][C] (phase B),
// W_r's gate rows of the owned cells [cpb * 4][P] (row jj * 4 + gate),
// W_rm's rows of the owned columns [ppb][C], c of the owned cells
// [ST][cpb], r of the owned columns [ST][ppb], the owned cells' peepholes
// [3][cpb]; each region rounded up to 16 bytes.
struct FewLayout {
  size_t stage_r, stage_m, w_r, w_rm, c, r, peep, total;
};

__host__ __device__ inline FewLayout few_layout(int ST, int C, int P, int cpb,
                                                int ppb) {
  FewLayout L;
  size_t off = 0;
  L.stage_r = off;
  off += align16((size_t)4 * ST * P);
  L.stage_m = off;
  off += align16((size_t)4 * ST * C);
  L.w_r = off;
  off += align16((size_t)4 * 4 * cpb * P);
  L.w_rm = off;
  off += align16((size_t)4 * ppb * C);
  L.c = off;
  off += align16((size_t)4 * ST * cpb);
  L.r = off;
  off += align16((size_t)4 * ST * ppb);
  L.peep = off;
  off += align16((size_t)4 * 3 * cpb);
  L.total = off;
  return L;
}

// the register-sum width the plan's S takes: the next power of 2
inline int few_tile(int S) {
  int st = 1;
  while (st < S) st *= 2;
  return st;
}

// The sums over the warp's 32 lanes of N values a lane, KEEP of them kept:
// while more than KEEP remain, each lane hands half of its values to the
// lane `off` away and adds the half it is handed (off = 16, 8, ...), then
// the KEEP left are summed over the remaining offsets by butterflies.
// With v[s * KEEP + e] on entry (s < N / KEEP, a power of 2 up to 16), lane
// l leaves with the sums of stream s = l / (32 KEEP / N) in v[0 .. KEEP).
// The order of every sum is fixed by the lane numbers alone.
template <int M, int N, int KEEP, int OFF>
__device__ __forceinline__ void warp_sums(float (&v)[M], int lane) {
  if constexpr (N > KEEP) {
    const bool up = lane & OFF;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float mine = up ? v[i + N / 2] : v[i];
      const float theirs = up ? v[i] : v[i + N / 2];
      v[i] = mine + __shfl_xor_sync(0xffffffffu, theirs, OFF);
    }
    warp_sums<M, N / 2, KEEP, OFF / 2>(v, lane);
  } else if constexpr (OFF > 0) {
#pragma unroll
    for (int i = 0; i < KEEP; ++i)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], OFF);
    warp_sums<M, N, KEEP, OFF / 2>(v, lane);
  }
}

// Stage floats [0, n) of src (global, 16-byte aligned, written by other
// blocks before the last barrier: read through L2) into stage, and zeros
// up to n_pad, as one cp.async group's worth of 16-byte pieces.
__device__ __forceinline__ void few_stage(float* stage, const float* src,
                                          int n, int n_pad) {
  for (int i = 4 * threadIdx.x; i < n_pad; i += 4 * kFwdThreads) {
    const int bytes = max(0, min(16, 4 * (n - i)));
    cp_async16(stage + i, bytes ? src + i : src, bytes);
  }
}

// The tag exchange: a value travels with the step's tag in one 8-byte
// store, which the memory system performs whole, so a reader that sees the
// tag has the value, with no barrier and no fence (the hand-off costs one
// trip through L2 instead of three: the arrival, the poll, the fetch).
__device__ __forceinline__ void store_tagged(float* row, size_t i, float v,
                                             unsigned tag) {
  asm volatile("st.volatile.global.v2.b32 [%0], {%1, %2};\n" ::"l"(
                   __cvta_generic_to_global(reinterpret_cast<float2*>(row) +
                                            i)),
               "r"(__float_as_uint(v)), "r"(tag)
               : "memory");
}

constexpr int kTagBatch = 8;  // a thread's loads in flight per poll

// Stage values [0, n) of the tagged row src into stage once each carries
// `tag`, and zeros up to n_pad: every thread polls its own elements, a
// batch of loads in flight at a time.
__device__ __forceinline__ void few_fetch_tagged(float* stage,
                                                 const float* src, int n,
                                                 int n_pad, unsigned tag) {
  const float2* row = reinterpret_cast<const float2*>(src);
  for (int i0 = threadIdx.x; i0 < n_pad; i0 += kTagBatch * kFwdThreads) {
    unsigned v[kTagBatch];
    bool pending;
    unsigned polls = 0;
    do {
      pending = false;
#pragma unroll
      for (int b = 0; b < kTagBatch; ++b) {
        const int i = i0 + b * kFwdThreads;
        unsigned seen = tag;
        v[b] = 0u;  // the bits of 0.0f past the row
        if (i < n)
          asm volatile("ld.volatile.global.v2.b32 {%0, %1}, [%2];\n"
                       : "=r"(v[b]), "=r"(seen)
                       : "l"(__cvta_generic_to_global(row + i))
                       : "memory");
        pending |= seen != tag;
      }
      if (++polls == kBarrierPolls) __trap();
    } while (pending);
#pragma unroll
    for (int b = 0; b < kTagBatch; ++b) {
      const int i = i0 + b * kFwdThreads;
      if (i < n_pad) stage[i] = __uint_as_float(v[b]);
    }
  }
}

// kTags: the tag exchange (few enough values a thread to poll them in one
// batch or a few); otherwise the direction's counter barrier and one
// cp.async group.
template <int ST, bool kTags>
__global__ void __launch_bounds__(kFwdThreads, 1)
lstmp_few_sweep_kernel(FewArgs a) {
  static_assert(ST >= 1 && ST <= kFewMaxStreams && (ST & (ST - 1)) == 0,
                "a power of 2 of streams, one pass");
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S, T = a.T, C = a.C, P = a.P, cpb = a.cpb, ppb = a.ppb;
  const int dirn = blockIdx.x / a.nbd, blk = blockIdx.x - dirn * a.nbd;
  const FewDir d = dirn ? a.dir[1] : a.dir[0];
  const FewLayout L = few_layout(ST, C, P, cpb, ppb);
  float* stage_r = reinterpret_cast<float*>(smem + L.stage_r);
  float* stage_m = reinterpret_cast<float*>(smem + L.stage_m);
  float* w_r_sh = reinterpret_cast<float*>(smem + L.w_r);
  float* w_rm_sh = reinterpret_cast<float*>(smem + L.w_rm);
  float* c_sh = reinterpret_cast<float*>(smem + L.c);
  float* r_sh = reinterpret_cast<float*>(smem + L.r);
  float* peep_sh = reinterpret_cast<float*>(smem + L.peep);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blk * cpb, nj = max(0, min(C - j0, cpb));
  const int p0 = blk * ppb, np = max(0, min(P - p0, ppb));

  // the block's weights, once for all frames: coalesced rows, every copy
  // in flight at once
  for (int i = tid; i < 4 * cpb * P; i += kFwdThreads) {
    const int row = i / P, k = i - row * P, jj = row >> 2;
    if (jj < nj)
      cp_async4(w_r_sh + i,
                d.w_r + ((size_t)(row & 3) * C + j0 + jj) * P + k);
    else
      w_r_sh[i] = 0.0f;
  }
  for (int i = tid; i < ppb * C; i += kFwdThreads) {
    const int pc = i / C, k = i - pc * C;
    if (pc < np)
      cp_async4(w_rm_sh + i, d.w_rm + (size_t)(p0 + pc) * C + k);
    else
      w_rm_sh[i] = 0.0f;
  }
  cp_async_commit();
  for (int i = tid; i < ST * cpb; i += kFwdThreads) {
    const int s = i / cpb, jj = i - s * cpb;
    c_sh[i] = d.c0 && s < S && jj < nj ? d.c0[(size_t)s * C + j0 + jj] : 0.0f;
  }
  for (int i = tid; i < ST * ppb; i += kFwdThreads) {
    const int s = i / ppb, pc = i - s * ppb;
    r_sh[i] = d.r0 && s < S && pc < np ? d.r0[(size_t)s * P + p0 + pc] : 0.0f;
  }
  for (int i = tid; i < 3 * cpb; i += kFwdThreads) {
    const int g = i / cpb, jj = i - g * cpb;
    peep_sh[i] = jj < nj ? d.peep[(size_t)g * C + j0 + jj] : 0.0f;
  }

  // after warp_sums, the lanes of group s_l hold stream s_l's sums; the
  // group's first lane finishes the stream
  constexpr int kGroup = 32 / ST;
  const int s_l = lane / kGroup;
  const bool leader = lane % kGroup == 0 && s_l < S;
  unsigned arrivals = 0;
  // the hand-off of a whole row [S, K] from its owners to every block of
  // the direction
  auto fetch = [&](float* stage, const float* row, int K, unsigned tag) {
    if constexpr (kTags) {
      few_fetch_tagged(stage, row, S * K, ST * K, tag);
    } else {
      arrivals += a.nbd;
      counter_barrier(d.bar, arrivals);
      few_stage(stage, row, S * K, ST * K);
      cp_async_commit();
    }
  };
  for (int step = 0; step < T; ++step) {
    const int t = d.reverse ? T - 1 - step : step;
    // the leaders' xg and mask of this frame, in flight while the row lands
    float xv[kCellsPerWarp][4], mk = 0.0f;
#pragma unroll
    for (int ci = 0; ci < kCellsPerWarp; ++ci) {
      const int jj = warp + ci * kFwdWarps;
      const bool ok = leader && jj < nj;
      const float* x =
          d.xg + ((size_t)(ok ? s_l : 0) * T + t) * 4 * C + j0 + (ok ? jj : 0);
#pragma unroll
      for (int g = 0; g < 4; ++g)
        xv[ci][g] = ok ? __ldg(x + (size_t)g * C) : 0.0f;
    }
    if (leader) mk = __ldg(a.mask + (size_t)s_l * T + t);
    // (A) the state row r_prev [S, P], whole: the caller's r0 (or zeros) at
    // the first step, then what the column owners published
    if (step == 0) {
      for (int i = tid; i < ST * P; i += kFwdThreads)
        stage_r[i] = d.r0 && i < S * P ? d.r0[i] : 0.0f;
    } else {
      fetch(stage_r, d.r_row, P, step);
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ci = 0; ci < kCellsPerWarp; ++ci) {
      const int jj = warp + ci * kFwdWarps;
      if (jj >= nj) continue;  // the whole warp
      float acc[4 * ST];
#pragma unroll
      for (int i = 0; i < 4 * ST; ++i) acc[i] = 0.0f;
      const float* w = w_r_sh + (size_t)jj * 4 * P;
#pragma unroll 2
      for (int k = lane; k < P; k += 32) {
        float wv[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) wv[g] = w[g * P + k];
#pragma unroll
        for (int s = 0; s < ST; ++s) {
          const float rv = stage_r[s * P + k];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            acc[s * 4 + g] = fmaf(wv[g], rv, acc[s * 4 + g]);
        }
      }
      warp_sums<4 * ST, 4 * ST, 4, 16>(acc, lane);
      if (leader) {
        const float lin[4] = {xv[ci][0] + acc[0], xv[ci][1] + acc[1],
                              xv[ci][2] + acc[2], xv[ci][3] + acc[3]};
        const float cp = c_sh[s_l * cpb + jj];
        const CellForward cf =
            cell_forward(lin, cp, peep_sh[jj], peep_sh[cpb + jj],
                         peep_sh[2 * cpb + jj], a.cell_clip);
        c_sh[s_l * cpb + jj] = mk * cf.c + (1.0f - mk) * cp;
        const size_t at = (size_t)s_l * C + j0 + jj;
        if constexpr (kTags)
          store_tagged(d.m_row, at, cf.m, step + 1);
        else
          d.m_row[at] = cf.m;
      }
    }

    // (B) the m row [S, C], whole, against the owned columns' rows of W_rm
    fetch(stage_m, d.m_row, C, step + 1);
    cp_async_wait<0>();
    __syncthreads();
    for (int pc = warp; pc < np; pc += kFwdWarps) {
      float acc[ST];
#pragma unroll
      for (int s = 0; s < ST; ++s) acc[s] = 0.0f;
      const float* w = w_rm_sh + (size_t)pc * C;
#pragma unroll 2
      for (int k = lane; k < C; k += 32) {
        const float wv = w[k];
#pragma unroll
        for (int s = 0; s < ST; ++s)
          acc[s] = fmaf(wv, stage_m[s * C + k], acc[s]);
      }
      warp_sums<ST, ST, 1, 16>(acc, lane);
      if (leader) {
        const float rn = mk * acc[0] + (1.0f - mk) * r_sh[s_l * ppb + pc];
        r_sh[s_l * ppb + pc] = rn;
        const size_t at = (size_t)s_l * P + p0 + pc;
        if constexpr (kTags)
          store_tagged(d.r_row, at, rn, step + 1);
        else
          d.r_row[at] = rn;
        d.ys[((size_t)s_l * T + t) * a.ys_stride + p0 + pc] = rn * mk;
      }
    }
  }
  __syncthreads();
  if (d.c_T != nullptr)
    for (int i = tid; i < ST * cpb; i += kFwdThreads) {
      const int s = i / cpb, jj = i - s * cpb;
      if (s < S && jj < nj) d.c_T[(size_t)s * C + j0 + jj] = c_sh[i];
    }
  if (d.r_T != nullptr)
    for (int i = tid; i < ST * ppb; i += kFwdThreads) {
      const int s = i / ppb, pc = i - s * ppb;
      if (s < S && pc < np) d.r_T[(size_t)s * P + p0 + pc] = r_sh[i];
    }
}

bool few_plan_ok(int S, int C, int P, int nbd, int cpb, int ppb,
                 long long smem, bool tags) {
  if (S > (tags ? kFewTagStreams : kFewMaxStreams) || nbd <= 0 || cpb <= 0 || cpb > kFwdMaxCells ||
      ppb <= 0)
    return false;
  if ((long long)nbd * cpb < C || (long long)(nbd - 1) * cpb >= C ||
      (long long)nbd * ppb < P)
    return false;
  const FewLayout L = few_layout(few_tile(S), C, P, cpb, ppb);
  return (long long)L.total == smem && L.total <= kSmemLimit;
}

template <int ST>
int launch_few(const FewArgs& a, bool tags, int blocks, size_t smem,
               cudaStream_t st) {
  if constexpr (ST <= kFewTagStreams)
    if (tags)
      return launch_sweep(lstmp_few_sweep_kernel<ST, true>, a, blocks,
                          kFwdThreads, smem, st);
  return launch_sweep(lstmp_few_sweep_kernel<ST, false>, a, blocks,
                      kFwdThreads, smem, st);
}

// ---------------------------------------------------------------------------
// The many-stream sweep: lstmp_sweep.cuh's forward body, one or two
// directions of p.nb blocks each.
// ---------------------------------------------------------------------------

struct ManyArgs {
  UniFwdArgs<float, float> dir[2];
};

__global__ void __launch_bounds__(kUniThreads, 1)
lstmp_infer_sweep_kernel(ManyArgs args) {
  const int nb = args.dir[0].p.nb;
  const int dirn = blockIdx.x / nb;
  const UniFwdArgs<float, float> a = dirn ? args.dir[1] : args.dir[0];
  lstmp_fwd_sweep_body<float, float, false>(a, blockIdx.x - dirn * nb);
}

// words (4 bytes) of scratch before the regimes' own: the directions'
// barrier counters, one a 128-byte line
constexpr int kBarWords = 64;

inline long long round4(long long v) { return (v + 3) / 4 * 4; }

}  // namespace

// C entry, bound with ctypes.  All arrays are contiguous float32 on the
// current device.  ndir = 1: one direction, xg_f [S, T, 4C], w_r_f
// [4C, P], w_rm_f [P, C], peep_f [3, C] (the _b pointers are not read),
// ys [S, T, P].  ndir = 2: a BLSTMP layer, direction b with its own xg_b
// and weights walking the frames T-1 .. 0 from a zero state into columns
// [P, 2P) of ys [S, T, 2P].  mask [S, T]; c0 [S, C] and r0 [S, P] are
// direction f's initial state, c_T and r_T its final state (written).
// The launch plan comes from ops/sweep_plan.py:lstmp_infer_plan: regime 1
// the few-stream sweep (nbd blocks a direction, cpb cells and ppb columns
// a block, smem bytes) with the barrier exchange, 3 the same with the tag
// exchange (S <= 4), 2 the many-stream sweep (nbd, cpb, an nstage-deep
// ring, smem), 0 the per-step kernels; a plan that does not give the
// kernel's layout returns cudaErrorInvalidValue.  scratch holds
// scratch_words float32 words, at least what the regime needs (the
// plan's scratch_words), 16-byte aligned.  T >= 1.  Returns a cudaError_t
// (0 on success).
extern "C" int lstmp_forward_f32(
    int ndir, const float* xg_f, const float* xg_b, const float* mask,
    const float* w_r_f, const float* w_rm_f, const float* peep_f,
    const float* w_r_b, const float* w_rm_b, const float* peep_b,
    const float* c0, const float* r0, float* c_T, float* r_T, float* ys,
    float* scratch, long long scratch_words, int S, int T, int C, int P,
    float cell_clip, int regime, int nbd, int cpb, int ppb, int nstage,
    long long smem, void* stream) {
  if (ndir < 1 || ndir > 2 || S <= 0 || T <= 0 || C <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xg[2] = {xg_f, xg_b};
  const float* w_r[2] = {w_r_f, w_r_b};
  const float* w_rm[2] = {w_rm_f, w_rm_b};
  const float* peep[2] = {peep_f, peep_b};
  const long long sc = round4((long long)S * C), sp = round4((long long)S * P);
  int err;

  if (regime == 0) {
    // scratch: m [S, C], then direction b's state c [S, C], r [S, P]
    if (scratch_words < sc + (ndir - 1) * (sc + sp))
      return (int)cudaErrorInvalidValue;
    for (int d = 0; d < ndir; ++d) {
      float* c = d ? scratch + sc : c_T;
      float* r = d ? scratch + 2 * sc : r_T;
      if (d == 0) {
        err = (int)cudaMemcpyAsync(c, c0, sizeof(float) * S * C,
                                   cudaMemcpyDeviceToDevice, st);
        if (!err)
          err = (int)cudaMemcpyAsync(r, r0, sizeof(float) * S * P,
                                     cudaMemcpyDeviceToDevice, st);
      } else {
        err = (int)cudaMemsetAsync(c, 0, sizeof(float) * (sc + sp), st);
      }
      if (err) return err;
      err = S == 1 ? run_per_step<1>(xg[d], mask, w_r[d], w_rm[d], peep[d], c,
                                     r, scratch, ys + d * P, ndir * P, d == 1,
                                     S, T, C, P, cell_clip, st)
                   : run_per_step<8>(xg[d], mask, w_r[d], w_rm[d], peep[d], c,
                                     r, scratch, ys + d * P, ndir * P, d == 1,
                                     S, T, C, P, cell_clip, st);
      if (err) return err;
    }
    return 0;
  }

  // scratch of both sweeps: the barrier counters and, in the many-stream
  // sweep, direction b's state, cleared together on the stream
  unsigned* bar = reinterpret_cast<unsigned*>(scratch);
  float* state_b = scratch + kBarWords;

  if (regime == 1 || regime == 3) {
    // the exchanged rows hold a float or a {value, tag} pair an element;
    // the tags start at 0 as the counters do
    const bool tags = regime == 3;
    const long long words = kBarWords + ndir * 2 * (sc + sp);
    if (!few_plan_ok(S, C, P, nbd, cpb, ppb, smem, tags) ||
        scratch_words < words)
      return (int)cudaErrorInvalidValue;
    if ((err = (int)cudaMemsetAsync(bar, 0, sizeof(float) * words, st)))
      return err;
    FewArgs a;
    for (int d = 0; d < 2; ++d) {
      const int e = d < ndir ? d : 0;  // an unused slot repeats direction f
      FewDir& fd = a.dir[d];
      float* rows = scratch + kBarWords + e * 2 * (sc + sp);
      fd.xg = xg[e];
      fd.w_r = w_r[e];
      fd.w_rm = w_rm[e];
      fd.peep = peep[e];
      fd.c0 = e ? nullptr : c0;
      fd.r0 = e ? nullptr : r0;
      fd.c_T = e ? nullptr : c_T;
      fd.r_T = e ? nullptr : r_T;
      fd.m_row = rows;
      fd.r_row = rows + 2 * sc;
      fd.bar = bar + 32 * e;
      fd.ys = ys + e * P;
      fd.reverse = e;
    }
    a.mask = mask;
    a.S = S;
    a.T = T;
    a.C = C;
    a.P = P;
    a.nbd = nbd;
    a.cpb = cpb;
    a.ppb = ppb;
    a.ys_stride = ndir * P;
    a.cell_clip = cell_clip;
    const int blocks = ndir * nbd;
    switch (few_tile(S)) {
      case 1: return launch_few<1>(a, tags, blocks, (size_t)smem, st);
      case 2: return launch_few<2>(a, tags, blocks, (size_t)smem, st);
      case 4: return launch_few<4>(a, tags, blocks, (size_t)smem, st);
      case 8: return launch_few<8>(a, tags, blocks, (size_t)smem, st);
      default: return launch_few<16>(a, tags, blocks, (size_t)smem, st);
    }
  }

  if (regime != 2) return (int)cudaErrorInvalidValue;
  const UniPlan plan = uni_plan(nbd, cpb, nstage, S, P);
  const long long rows = (long long)(nbd + 1) * S * plan.pp;
  if (!uni_plan_ok(plan, S, C, smem, false) ||
      scratch_words < kBarWords + (ndir - 1) * (sc + sp) + ndir * rows)
    return (int)cudaErrorInvalidValue;
  if ((err = (int)cudaMemsetAsync(
           bar, 0, sizeof(float) * (kBarWords + (ndir - 1) * (sc + sp)), st)))
    return err;
  ManyArgs args;
  for (int d = 0; d < 2; ++d) {
    const int e = d < ndir ? d : 0;
    UniFwdArgs<float, float>& a = args.dir[d];
    float* own = state_b + (ndir - 1) * (sc + sp) + e * rows;
    a.xg = xg[e];
    a.mask = mask;
    a.w_r = w_r[e];
    a.w_rm = w_rm[e];
    a.peep = peep[e];
    // direction b starts from the cleared state it then carries
    a.c_state = e ? state_b : c_T;
    a.r_state = e ? state_b + sc : r_T;
    a.init_c = e ? a.c_state : c0;
    a.init_r = e ? a.r_state : r0;
    a.row = own;
    a.slab = own + (long long)S * plan.pp;
    a.gates = nullptr;
    a.cs = nullptr;
    a.rs = ys + e * P;
    a.S = S;
    a.T = T;
    a.C = C;
    a.P = P;
    a.cell_clip = cell_clip;
    a.p = plan;
    a.bar = bar + 32 * e;
    a.ys_stride = ndir * P;
    a.reverse = e;
  }
  return launch_sweep(lstmp_infer_sweep_kernel, args, ndir * nbd, kUniThreads,
                      (size_t)smem, st);
}
