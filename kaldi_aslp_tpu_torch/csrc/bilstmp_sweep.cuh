// The persistent tensor-core sweeps of a BLSTMP layer's training pair,
// both directions in one cooperative launch: fwd_sweep_kernel and
// bwd_sweep_kernel, their launch plan and the layout of a block's shared
// memory.  Two libraries build them:
//   - bilstmp_train.cu, the x-fused pair, whose note says what the design
//     is and what bounds it: fwd_sweep_kernel<false> reads the hoisted
//     float32 xg [2, S, T, 4C] (x . W_x^T for every frame) and sums
//     lin = bias + (xg + r_prev . W_r^T), as lstm_pallas.py:
//     _bixfused_fwd_kernel does;
//   - bilstmp_xg_train.cu, the xg-fed pair with bf16 products
//     (KALDI_ASLP_LSTM_NO_XFUSE): fwd_sweep_kernel<true> reads the
//     caller's bf16 bias-free xgf and xgb [S, T, 4C] and sums
//     lin = (xg + bias) + r_prev . W_r^T, the order of lstm_pallas.py:
//     _bilstmp_fwd_kernel (:581-582).  Its prefetch region holds the bf16
//     xg, so its layout is smaller by mg * 4 * 8 bytes a cell (the plan's
//     xg_bf16 flag).  The backward sweep serves both pairs as it is: it
//     writes what the xg-fed backward returns (bf16 dgates = dxg, m,
//     dr_new, the dbias / dpeep sums), rounded where the TPU kernels
//     round them (bilstmp_xg_train.cu's note compares them line by line).
// A block owns up to 16 cells and 64 projection columns over
// floor(SMs / 2) blocks a direction, within 232,448 bytes of shared
// memory (ops/sweep_plan.py:sweep_plan and bilstmp_xg_plan); every sum
// has one owner and a fixed order, so two runs give the same bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "device_math.cuh"
#include "sweep.cuh"

namespace aslp_cuda {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// PTX helpers: ldmatrix, mma.sync m16n8k16 bf16 (cp.async: sweep.cuh).
// ---------------------------------------------------------------------------

// ldmatrix of four / two 8x8 b16 matrices at a shared-memory byte address
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(unsigned& r0, unsigned& r1,
                                           unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

// c += a . b for one m16n8k16 tile: a row-major, b column-major fragments
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The persistent sweeps.
// ---------------------------------------------------------------------------

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kRowsMax = 128;   // streams per pass of a product (8 m16 tiles)
constexpr int kKC = 64;         // columns per cp.async chunk of the ring
constexpr int kLdStage = kKC + 8;
constexpr int kPairs = 8;       // (m16, n8) tiles per warp per pass
constexpr int kMaxCells = 16;   // cells a block may own (64 gate rows)
constexpr int kMaxCols = 64;    // projection columns a block may own
constexpr int kMaxStages = 4;   // deepest cp.async ring

// The launch plan: ops/sweep_plan.py:sweep_plan computes it, and the
// layout below must give its byte count.  The limits above are that
// module's ROWS_PER_PASS, K_CHUNK, MAX_CELLS, MAX_COLS and MAX_STAGES, and
// sweep.cuh's kSmemLimit its SMEM_LIMIT (tests/test_torch_bilstmp_plan.py
// holds them equal).
struct Plan {
  int nbd;     // blocks per direction
  int cpb;     // cells per block
  int ppb;     // projection columns per block
  int nstage;  // depth of the cp.async ring (2..4)
  int mg;      // streams per pass, min(128, S rounded up to 16)
  int cp, pp;  // C and P rounded up to 16
};

// Byte offsets of the regions of a sweep's dynamic shared memory.
struct Layout {
  size_t w1, w2, stage, out, st1, st2, sums, pre, total;
  int ld1, ld2, ldo, n1, n2;
};

// Forward: w1 = W_r rows of the owned cells (row jj * 4 + gate), w2 = W_rm
// rows of the owned columns, c and r state of the owned cells / columns.
// Backward: w1 = W_rm^T rows of the owned cells, w2 = W_r^T rows of the
// owned columns (K laid out gate * cp + j), dc / dr state, and the seven
// per-(stream, cell) sums dbias (g, i, f, o) and dpeep (i, f, o).  Last,
// what an epilogue reads, prefetched while the product runs (pre_* below);
// xg_bf16: the forward prefetches bf16 xg (the xg-fed pair), not float32.
__host__ __device__ inline Layout sweep_layout(const Plan& p, int S,
                                                bool backward,
                                                bool xg_bf16 = false) {
  Layout L;
  L.n1 = round_up(backward ? p.cpb : 4 * p.cpb, 8);
  L.n2 = round_up(p.ppb, 8);
  L.ld1 = p.pp + 8;
  L.ld2 = (backward ? 4 * p.cp : p.cp) + 8;
  L.ldo = (L.n1 > L.n2 ? L.n1 : L.n2) + 4;
  size_t off = 0;
  L.w1 = off;
  off += align16((size_t)L.n1 * L.ld1 * sizeof(bf16));
  L.w2 = off;
  off += align16((size_t)L.n2 * L.ld2 * sizeof(bf16));
  L.stage = off;
  off += align16((size_t)p.nstage * p.mg * kLdStage * sizeof(bf16));
  L.out = off;
  off += align16((size_t)p.mg * L.ldo * sizeof(float));
  L.st1 = off;
  off += align16((size_t)S * p.cpb * sizeof(float));
  L.st2 = off;
  off += align16((size_t)S * p.ppb * sizeof(float));
  L.sums = off;
  if (backward) off += align16((size_t)7 * S * p.cpb * sizeof(float));
  L.pre = off;
  const size_t mg = p.mg;
  if (backward) {
    const size_t c8 = round_up(p.cpb, 8);
    off += align16(mg * 4 * c8 * sizeof(bf16)) +
           align16(mg * c8 * sizeof(bf16)) +
           align16(mg * 2 * p.ppb * sizeof(bf16)) +
           align16(mg * 2 * sizeof(float));
  } else if (xg_bf16) {
    off += align16(mg * 4 * round_up(p.cpb, 8) * sizeof(bf16)) +
           align16(mg * sizeof(float));
  } else {
    off += align16(mg * 4 * round_up(p.cpb, 4) * sizeof(float)) +
           align16(mg * sizeof(float));
  }
  L.total = off;
  return L;
}

inline bool plan_ok(const Plan& p, int S, int C, int P, size_t smem,
                    bool backward, bool xg_bf16 = false) {
  if (p.nbd <= 0 || p.cpb <= 0 || p.ppb <= 0 || p.cpb > kMaxCells ||
      p.ppb > kMaxCols || p.ppb % 8 || p.nstage < 2 ||
      p.nstage > kMaxStages)
    return false;
  if ((long long)p.nbd * p.cpb < C || (long long)p.nbd * p.ppb < P)
    return false;
  if (p.mg != (S < kRowsMax ? round_up(S, 16) : kRowsMax)) return false;
  if (p.cp != round_up(C, 16) || p.pp != round_up(P, 16)) return false;
  const Layout L = sweep_layout(p, S, backward, xg_bf16);
  return L.total == smem && smem <= kSmemLimit;
}

// Stage rows [0, rows) of A (row stride lda), columns [k0, k0 + kn), into
// slot ([mg][kLdStage]); rows [rows, 16 * ceil(rows / 16)) are zeros.
__device__ __forceinline__ void stage_chunk(bf16* slot, const bf16* a,
                                            int lda, int rows, int k0,
                                            int kn) {
  const int pieces = kn >> 3, mrows = (rows + 15) & ~15;
  for (int i = threadIdx.x; i < mrows * pieces; i += kThreads) {
    const int r = i / pieces, c = (i - r * pieces) << 3;
    const bool ok = r < rows;
    cp_async16(slot + r * kLdStage + c,
               ok ? a + (size_t)r * lda + k0 + c : a, ok ? 16 : 0);
  }
}

// The block's product for one pass of up to 128 streams:
//   out[r][n] = sum_k A[r][k] * Bt[n][k],  r < rows, n < 8 * nt, k < kp
// A in global memory (bf16, row stride lda, written by other blocks before
// the last grid barrier: read through L2 by cp.async.cg), Bt the block's
// weight slice in shared memory (row stride ldb), kp a multiple of 16.
// Each warp takes the (m16, n8) tiles q = warp + 8 i (m = q % mt,
// n = q / mt), i < nv; every element is summed over K in chunk order.
// A step's loop is short and runs on few warps, so each tile's
// ldmatrix addresses are worked out once, not at every k-step.
__device__ void block_product(const bf16* a, int lda, int rows, int kp,
                              const bf16* bt, int ldb, int nt, bf16* stage,
                              int nstage, int mg, float* out, int ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = (rows + 15) >> 4;
  const int nchunks = (kp + kKC - 1) / kKC;
  const size_t slot = (size_t)mg * kLdStage;
  const int nv =
      warp < mt * nt ? (mt * nt - warp + kWarps - 1) / kWarps : 0;
  // byte addresses at k = 0 of each tile's A rows (chunk slot 0) and Bt
  // rows
  const unsigned a0 = smem_u32(stage), b0 = smem_u32(bt);
  int tm[kPairs], tn[kPairs];
  unsigned sa[kPairs], sb[kPairs];
  float acc[kPairs][4];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int q = warp + kWarps * i;
    tm[i] = q % mt;
    tn[i] = q / mt;
    sa[i] = a0 + 2 * ((tm[i] * 16 + (lane & 15)) * kLdStage +
                      ((lane >> 4) << 3));
    sb[i] = b0 + 2 * ((tn[i] * 8 + (lane & 7)) * ldb +
                      (((lane >> 3) & 1) << 3));
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  }
  for (int c = 0; c < nstage - 1; ++c) {
    if (c < nchunks)
      stage_chunk(stage + c * slot, a, lda, rows, c * kKC,
                  min(kKC, kp - c * kKC));
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_n(nstage - 2);
    __syncthreads();
    const int cn = c + nstage - 1;
    if (cn < nchunks)
      stage_chunk(stage + (cn % nstage) * slot, a, lda, rows, cn * kKC,
                  min(kKC, kp - cn * kKC));
    cp_async_commit();
    const int k0 = c * kKC, ksteps = min(kKC, kp - k0) >> 4;
    const unsigned soff = 2 * (unsigned)((c % nstage) * slot);
    const unsigned koff = 2 * k0;
    for (int ks = 0; ks < ksteps; ++ks) {
      unsigned af[4];
      int cur = -1;
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        if (i >= nv) continue;
        if (tm[i] != cur) {
          ldsm_x4(af, sa[i] + soff + 32 * ks);
          cur = tm[i];
        }
        unsigned bl, bh;
        ldsm_x2(bl, bh, sb[i] + koff + 32 * ks);
        mma_bf16(acc[i], af, bl, bh);
      }
    }
  }
  cp_async_wait<0>();
  const int gid = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    if (i >= nv) continue;
    float* o = out + (tm[i] * 16 + gid) * ldo + tn[i] * 8 + 2 * t4;
    o[0] = acc[i][0];
    o[1] = acc[i][1];
    o[8 * ldo] = acc[i][2];
    o[8 * ldo + 1] = acc[i][3];
  }
  __syncthreads();
}

// Copy rows [0, n) of a bf16 matrix (row stride ld_src, K valid columns,
// column k of row r at src[row(r) * ld_src + col(k)]) into a shared slice
// [n_pad][ld] with zeros elsewhere.
template <typename Row, typename Col>
__device__ void load_slice(bf16* dst, int n_pad, int ld, int n, int kvalid,
                           const bf16* src, Row row, Col col) {
  const bf16 zero = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < n_pad * ld; i += kThreads) {
    const int r = i / ld, k = i - r * ld;
    dst[i] = (r < n && k < kvalid) ? src[row(r) + col(k)] : zero;
  }
}

struct FwdArgs {
  const float* xg;    // x-fused: [2, S, T, G] f32, x . W_x^T
  const bf16* xgf;    // xg-fed: [S, T, G] bf16 each, bias-free
  const bf16* xgb;
  const float* mask;
  const bf16* wr;
  const bf16* wrm;
  const float* peep;
  const float* bias;
  float* c_state;
  float* r_state;
  bf16* rb;   // [2, S, pp] bf16 r_prev of the step (pad columns zero)
  bf16* mb;   // [2, S, cp] bf16 m of the step (pad columns zero)
  bf16* gates;
  bf16* cs;
  bf16* rprev;
  bf16* ys;
  int S, T, C, P;
  float cell_clip;
  Plan p;
};

// Blocks [0, nbd) run direction f, [nbd, 2 nbd) direction b.  kXgFed
// picks the gate input: the x-fused pair's float32 xg, summed
// bias + (xg + acc), or the xg-fed pair's bf16 xgf / xgb, summed
// (xg + bias) + acc.
template <bool kXgFed>
__global__ void __launch_bounds__(kThreads, 1) fwd_sweep_kernel(FwdArgs a) {
  extern __shared__ __align__(128) unsigned char bi_smem[];
  using Xg = std::conditional_t<kXgFed, bf16, float>;
  constexpr int kVec = 16 / sizeof(Xg);   // xg elements a 16-byte piece
  const Plan& p = a.p;
  const int S = a.S, T = a.T, C = a.C, P = a.P, G = 4 * C;
  const Layout L = sweep_layout(p, S, false, kXgFed);
  bf16* w1 = reinterpret_cast<bf16*>(bi_smem + L.w1);
  bf16* w2 = reinterpret_cast<bf16*>(bi_smem + L.w2);
  bf16* stage = reinterpret_cast<bf16*>(bi_smem + L.stage);
  float* out = reinterpret_cast<float*>(bi_smem + L.out);
  float* c_sh = reinterpret_cast<float*>(bi_smem + L.st1);   // [S][cpb]
  float* r_sh = reinterpret_cast<float*>(bi_smem + L.st2);   // [S][ppb]
  const int cx = round_up(p.cpb, kVec);
  Xg* xs = reinterpret_cast<Xg*>(bi_smem + L.pre);           // [mg][4][cx]
  float* mks = reinterpret_cast<float*>(
      bi_smem + L.pre + align16((size_t)p.mg * 4 * cx * sizeof(Xg)));  // [mg]
  const int d = blockIdx.x / p.nbd, blk = blockIdx.x % p.nbd;
  // the direction's xg rows [S][T][G]
  const Xg* xg_d;
  if constexpr (kXgFed)
    xg_d = d == 0 ? a.xgf : a.xgb;
  else
    xg_d = a.xg + (size_t)d * S * T * G;
  // 16-byte pieces of a row's xg need kVec-cell-aligned groups
  const bool xvec = C % kVec == 0 && p.cpb % kVec == 0 &&
                    (reinterpret_cast<uintptr_t>(xg_d) & 15) == 0;
  const int j0 = blk * p.cpb, nj = max(0, min(C - j0, p.cpb));
  const int p0 = blk * p.ppb, np = max(0, min(P - p0, p.ppb));

  // W_r rows gate * C + j0 + jj as slice row jj * 4 + gate
  const bf16* wr_d = a.wr + (size_t)d * G * P;
  load_slice(w1, L.n1, L.ld1, 4 * nj, P, wr_d,
             [=](int r) { return (size_t)((r & 3) * C + j0 + (r >> 2)) * P; },
             [](int k) { return (size_t)k; });
  const bf16* wrm_d = a.wrm + (size_t)d * P * C;
  load_slice(w2, L.n2, L.ld2, np, C, wrm_d,
             [=](int r) { return (size_t)(p0 + r) * C; },
             [](int k) { return (size_t)k; });
  for (int i = threadIdx.x; i < S * nj; i += kThreads) {
    const int s = i / nj, jj = i - s * nj;
    c_sh[s * p.cpb + jj] = a.c_state[((size_t)d * S + s) * C + j0 + jj];
  }
  for (int i = threadIdx.x; i < S * np; i += kThreads) {
    const int s = i / np, pp = i - s * np;
    r_sh[s * p.ppb + pp] = a.r_state[((size_t)d * S + s) * P + p0 + pp];
  }
  __syncthreads();

  const float* bias = a.bias + (size_t)d * G;
  const float* peep = a.peep + (size_t)d * 3 * C;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? step : T - 1 - step;
    // gates + cell of the owned cells: lin = bias + (xg + r_prev . W_r^T)
    // (x-fused) or (xg + bias) + r_prev . W_r^T (xg-fed)
    if (nj > 0) {
      for (int s0 = 0; s0 < S; s0 += p.mg) {
        const int rows = min(p.mg, S - s0);
        // the rows' xg of the owned cells and the mask, in flight while
        // the product runs
        const int qv = (nj + kVec - 1) / kVec;
        for (int i = threadIdx.x; i < rows * 4 * qv; i += kThreads) {
          const int r = i / (4 * qv), k = (i / qv) & 3, q = i % qv;
          const int n = min(kVec, nj - kVec * q);
          const Xg* src = xg_d + ((size_t)(s0 + r) * T + t) * G + k * C +
                          j0 + kVec * q;
          Xg* dst = xs + (r * 4 + k) * cx + kVec * q;
          if (xvec)
            cp_async16(dst, src, (int)sizeof(Xg) * n);
          else
            for (int e = 0; e < n; ++e) dst[e] = src[e];
        }
        for (int r = threadIdx.x; r < rows; r += kThreads)
          cp_async4(mks + r, a.mask + (size_t)(s0 + r) * T + t);
        cp_async_commit();
        block_product(a.rb + ((size_t)d * S + s0) * p.pp, p.pp, rows, p.pp,
                      w1, L.ld1, L.n1 / 8, stage, p.nstage, p.mg, out, L.ldo);
        for (int i = threadIdx.x; i < rows * nj; i += kThreads) {
          const int r = i / nj, jj = i - r * nj, s = s0 + r, j = j0 + jj;
          const size_t row = ((size_t)d * S + s) * T + t;
          const float* acc = out + r * L.ldo + jj * 4;
          float lin[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float x = to_f32(xs[(r * 4 + k) * cx + jj]);
            if constexpr (kXgFed)
              lin[k] = (x + bias[k * C + j]) + acc[k];
            else
              lin[k] = bias[k * C + j] + (x + acc[k]);
          }
          const float cp = c_sh[s * p.cpb + jj];
          const CellForward cf = cell_forward(lin, cp, peep[j], peep[C + j],
                                              peep[2 * C + j], a.cell_clip);
          const float mk = mks[r];
          const float cn = mk * cf.c + (1.0f - mk) * cp;
          c_sh[s * p.cpb + jj] = cn;
          a.mb[((size_t)d * S + s) * p.cp + j] = __float2bfloat16(cf.m);
          bf16* gr = a.gates + row * G;
          gr[j] = __float2bfloat16(cf.g);
          gr[C + j] = __float2bfloat16(cf.i);
          gr[2 * C + j] = __float2bfloat16(cf.f);
          gr[3 * C + j] = __float2bfloat16(cf.o);
          a.cs[row * C + j] = __float2bfloat16(cn);
        }
        __syncthreads();
      }
    }
    grid.sync();
    // projection of the owned columns: r = bf16(m) . W_rm^T, blended
    if (np > 0) {
      for (int s0 = 0; s0 < S; s0 += p.mg) {
        const int rows = min(p.mg, S - s0);
        for (int r = threadIdx.x; r < rows; r += kThreads)
          cp_async4(mks + r, a.mask + (size_t)(s0 + r) * T + t);
        cp_async_commit();
        block_product(a.mb + ((size_t)d * S + s0) * p.cp, p.cp, rows, p.cp,
                      w2, L.ld2, L.n2 / 8, stage, p.nstage, p.mg, out, L.ldo);
        for (int i = threadIdx.x; i < rows * np; i += kThreads) {
          const int r = i / np, pp = i - r * np, s = s0 + r, pc = p0 + pp;
          const float mk = mks[r];
          const float rn =
              mk * out[r * L.ldo + pp] + (1.0f - mk) * r_sh[s * p.ppb + pp];
          r_sh[s * p.ppb + pp] = rn;
          const bf16 rbv = __float2bfloat16(rn);
          a.rb[((size_t)d * S + s) * p.pp + pc] = rbv;
          const size_t base = ((size_t)d * S + s) * T;
          if (d == 0 && t + 1 < T) a.rprev[(base + t + 1) * P + pc] = rbv;
          if (d == 1 && t >= 1) a.rprev[(base + t - 1) * P + pc] = rbv;
          a.ys[((size_t)s * T + t) * 2 * P + (size_t)d * P + pc] =
              __float2bfloat16(__bfloat162float(rbv) * round_bf16(mk));
        }
        __syncthreads();
      }
    }
    grid.sync();
  }
  for (int i = threadIdx.x; i < S * nj; i += kThreads) {
    const int s = i / nj, jj = i - s * nj;
    a.c_state[((size_t)d * S + s) * C + j0 + jj] = c_sh[s * p.cpb + jj];
  }
  for (int i = threadIdx.x; i < S * np; i += kThreads) {
    const int s = i / np, pp = i - s * np;
    a.r_state[((size_t)d * S + s) * P + p0 + pp] = r_sh[s * p.ppb + pp];
  }
}

struct BwdArgs {
  int d0;
  const bf16* dy;
  const float* mask;
  const bf16* gates;
  const bf16* cs;
  const float* init_c;
  const bf16* wr_t;
  const bf16* wrm_t;
  const float* peep;
  float* dc_state;
  float* dr_state;
  bf16* dnb;   // [ndir, S, pp] bf16 dr_new of the step (pad columns zero)
  bf16* dgb;   // [ndir, S, 4 cp] bf16 dgates of the step, gate * cp + j
  bf16* dgates;
  bf16* m_out;
  bf16* drn;
  float* dbp;
  int S, T, C, P;
  float cell_clip;
  Plan p;
};

// Direction d = d0 + z for the blocks [z nbd, (z + 1) nbd); the
// per-direction arrays (all but dy, mask and init_c) hold the launch's
// directions only, so slot z indexes them.  The reverse sweep: direction
// f at frame T-1-step, direction b at frame step.
__global__ void __launch_bounds__(kThreads, 1) bwd_sweep_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char bi_smem[];
  const Plan& p = a.p;
  const int S = a.S, T = a.T, C = a.C, P = a.P, G = 4 * C, G4 = 4 * p.cp;
  const Layout L = sweep_layout(p, S, true);
  bf16* w1 = reinterpret_cast<bf16*>(bi_smem + L.w1);
  bf16* w2 = reinterpret_cast<bf16*>(bi_smem + L.w2);
  bf16* stage = reinterpret_cast<bf16*>(bi_smem + L.stage);
  float* out = reinterpret_cast<float*>(bi_smem + L.out);
  float* dc_sh = reinterpret_cast<float*>(bi_smem + L.st1);   // [S][cpb]
  float* dr_sh = reinterpret_cast<float*>(bi_smem + L.st2);   // [S][ppb]
  float* sums = reinterpret_cast<float*>(bi_smem + L.sums);   // [7][S][cpb]
  // prefetched for the epilogues: the step's gates and c_prev of the owned
  // cells, dy of the owned columns at this frame and the next, the mask
  const int c8 = round_up(p.cpb, 8);
  bf16* gs = reinterpret_cast<bf16*>(bi_smem + L.pre);        // [mg][4][c8]
  bf16* cps = gs + align16((size_t)p.mg * 4 * c8 * sizeof(bf16)) /
                       sizeof(bf16);                       // [mg][c8]
  bf16* dys = cps + align16((size_t)p.mg * c8 * sizeof(bf16)) /
                        sizeof(bf16);                      // [mg][2][ppb]
  float* mk2 = reinterpret_cast<float*>(
      dys + align16((size_t)p.mg * 2 * p.ppb * sizeof(bf16)) /
                sizeof(bf16));                             // [mg][2]
  // 16-byte pieces need 8-element-aligned groups of cells and columns
  const bool gvec = C % 8 == 0 && p.cpb % 8 == 0, dvec = P % 8 == 0;
  const int z = blockIdx.x / p.nbd, blk = blockIdx.x % p.nbd, d = a.d0 + z;
  const int j0 = blk * p.cpb, nj = max(0, min(C - j0, p.cpb));
  const int p0 = blk * p.ppb, np = max(0, min(P - p0, p.ppb));

  // W_rm^T rows of the owned cells; W_r^T rows of the owned columns with
  // K = gate * cp + j
  load_slice(w1, L.n1, L.ld1, nj, P, a.wrm_t + (size_t)z * C * P,
             [=](int r) { return (size_t)(j0 + r) * P; },
             [](int k) { return (size_t)k; });
  const int cpad = p.cp;
  for (int i = threadIdx.x; i < L.n2 * L.ld2; i += kThreads) {
    const int r = i / L.ld2, k = i - r * L.ld2;
    const int gate = k / cpad, j = k - gate * cpad;
    w2[i] = (r < np && gate < 4 && j < C)
                ? a.wr_t[((size_t)z * P + p0 + r) * G + gate * C + j]
                : __float2bfloat16(0.0f);
  }
  for (int i = threadIdx.x; i < S * p.cpb; i += kThreads) {
    const int s = i / p.cpb, jj = i - s * p.cpb;
    dc_sh[i] = jj < nj ? a.dc_state[((size_t)z * S + s) * C + j0 + jj] : 0.0f;
#pragma unroll
    for (int k = 0; k < 7; ++k) sums[(size_t)k * S * p.cpb + i] = 0.0f;
  }
  for (int i = threadIdx.x; i < S * np; i += kThreads) {
    const int s = i / np, pp = i - s * np;
    dr_sh[s * p.ppb + pp] = a.dr_state[((size_t)z * S + s) * P + p0 + pp];
  }
  __syncthreads();

  // bf16(dr_new) of the first frame: mask * (dy * mask + dr_T)
  {
    const int t = d == 0 ? T - 1 : 0;
    for (int i = threadIdx.x; i < S * np; i += kThreads) {
      const int s = i / np, pp = i - s * np, pc = p0 + pp;
      const float mk = a.mask[(size_t)s * T + t];
      const float dyv = __bfloat162float(
          a.dy[((size_t)s * T + t) * 2 * P + (size_t)d * P + pc]);
      a.dnb[((size_t)z * S + s) * p.pp + pc] =
          __float2bfloat16(mk * (dyv * mk + dr_sh[s * p.ppb + pp]));
    }
  }
  const float* peep = a.peep + (size_t)z * 3 * C;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  grid.sync();
  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? T - 1 - step : step;
    // c_prev: c of frame tp, or init_c (f) / zero (b) at the boundary
    const bool has_prev = d == 0 ? t > 0 : t < T - 1;
    const int tp = d == 0 ? t - 1 : t + 1;
    // dm = bf16(dr_new) . W_rm for the owned cells, then the cell backward
    if (nj > 0) {
      for (int s0 = 0; s0 < S; s0 += p.mg) {
        const int rows = min(p.mg, S - s0);
        const int q8 = (nj + 7) >> 3;
        for (int i = threadIdx.x; i < rows * 5 * q8; i += kThreads) {
          const int r = i / (5 * q8), k = (i / q8) % 5, q = i % q8;
          const int n = min(8, nj - 8 * q);
          const size_t row = ((size_t)z * S + s0 + r) * T;
          const bf16* src;
          bf16* dst;
          if (k < 4) {
            src = a.gates + (row + t) * G + k * C + j0 + 8 * q;
            dst = gs + (r * 4 + k) * c8 + 8 * q;
          } else {
            if (!has_prev) continue;
            src = a.cs + (row + tp) * C + j0 + 8 * q;
            dst = cps + r * c8 + 8 * q;
          }
          if (gvec)
            cp_async16(dst, src, 2 * n);
          else
            for (int e = 0; e < n; ++e) dst[e] = src[e];
        }
        for (int r = threadIdx.x; r < rows; r += kThreads)
          cp_async4(mk2 + 2 * r, a.mask + (size_t)(s0 + r) * T + t);
        cp_async_commit();
        block_product(a.dnb + ((size_t)z * S + s0) * p.pp, p.pp, rows, p.pp,
                      w1, L.ld1, L.n1 / 8, stage, p.nstage, p.mg, out, L.ldo);
        for (int i = threadIdx.x; i < rows * nj; i += kThreads) {
          const int r = i / nj, jj = i - r * nj, s = s0 + r, j = j0 + jj;
          const size_t row = ((size_t)z * S + s) * T + t;
          const float cp =
              has_prev ? __bfloat162float(cps[r * c8 + jj])
                       : (d == 0 ? a.init_c[(size_t)s * C + j] : 0.0f);
          const bf16* gr = gs + r * 4 * c8 + jj;
          const float g = __bfloat162float(gr[0]);
          const float ig = __bfloat162float(gr[c8]);
          const float f = __bfloat162float(gr[2 * c8]);
          const float o = __bfloat162float(gr[3 * c8]);
          const float mk = mk2[2 * r];
          const int si = s * p.cpb + jj;
          const CellBackward cb =
              cell_backward(g, ig, f, o, cp, out[r * L.ldo + jj], dc_sh[si],
                            mk, peep[j], peep[C + j], peep[2 * C + j],
                            a.cell_clip);
          a.m_out[row * C + j] = __float2bfloat16(o * cb.tc);
          dc_sh[si] = cb.dc_prev;
          const bf16 dgv[4] = {
              __float2bfloat16(cb.dg), __float2bfloat16(cb.di),
              __float2bfloat16(cb.df), __float2bfloat16(cb.d_o)};
          bf16* dgr = a.dgates + row * G;
          bf16* dgs = a.dgb + ((size_t)z * S + s) * G4;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            dgr[k * C + j] = dgv[k];
            dgs[k * p.cp + j] = dgv[k];
          }
          const size_t plane = (size_t)S * p.cpb;
          sums[si] += cb.dg;
          sums[plane + si] += cb.di;
          sums[2 * plane + si] += cb.df;
          sums[3 * plane + si] += cb.d_o;
          sums[4 * plane + si] += cb.di * cp;
          sums[5 * plane + si] += cb.df * cp;
          sums[6 * plane + si] += cb.d_o * cb.c;
        }
        __syncthreads();
      }
    }
    grid.sync();
    // dr_prev = (1 - mask) dr_after + bf16(dgates) . W_r for the owned
    // columns; bf16(dr_new) of this frame to the stream, of the next to
    // the scratch row
    const bool has_next = step + 1 < T;
    const int tn = d == 0 ? t - 1 : t + 1;
    if (np > 0) {
      for (int s0 = 0; s0 < S; s0 += p.mg) {
        const int rows = min(p.mg, S - s0);
        const int q8 = (np + 7) >> 3;
        for (int i = threadIdx.x; i < rows * 2 * q8; i += kThreads) {
          const int r = i / (2 * q8), f = (i / q8) & 1, q = i % q8;
          if (f == 1 && !has_next) continue;
          const int n = min(8, np - 8 * q);
          const bf16* src = a.dy +
                            ((size_t)(s0 + r) * T + (f ? tn : t)) * 2 * P +
                            (size_t)d * P + p0 + 8 * q;
          bf16* dst = dys + (r * 2 + f) * p.ppb + 8 * q;
          if (dvec)
            cp_async16(dst, src, 2 * n);
          else
            for (int e = 0; e < n; ++e) dst[e] = src[e];
        }
        for (int i = threadIdx.x; i < rows * 2; i += kThreads) {
          const int r = i >> 1, f = i & 1;
          if (f == 0 || has_next)
            cp_async4(mk2 + i, a.mask + (size_t)(s0 + r) * T + (f ? tn : t));
        }
        cp_async_commit();
        block_product(a.dgb + ((size_t)z * S + s0) * G4, G4, rows, G4, w2,
                      L.ld2, L.n2 / 8, stage, p.nstage, p.mg, out, L.ldo);
        for (int i = threadIdx.x; i < rows * np; i += kThreads) {
          const int r = i / np, pp = i - r * np, s = s0 + r, pc = p0 + pp;
          const float mk = mk2[2 * r];
          const float dyv = __bfloat162float(dys[r * 2 * p.ppb + pp]);
          const float dra = dyv * mk + dr_sh[s * p.ppb + pp];
          a.drn[(((size_t)z * S + s) * T + t) * P + pc] =
              __float2bfloat16(mk * dra);
          const float drs = (1.0f - mk) * dra + out[r * L.ldo + pp];
          dr_sh[s * p.ppb + pp] = drs;
          if (has_next) {
            const float mkn = mk2[2 * r + 1];
            const float dyn = __bfloat162float(dys[(r * 2 + 1) * p.ppb + pp]);
            a.dnb[((size_t)z * S + s) * p.pp + pc] =
                __float2bfloat16(mkn * (dyn * mkn + drs));
          }
        }
        __syncthreads();
      }
    }
    grid.sync();
  }
  for (int i = threadIdx.x; i < S * nj; i += kThreads) {
    const int s = i / nj, jj = i - s * nj;
    a.dc_state[((size_t)z * S + s) * C + j0 + jj] = dc_sh[s * p.cpb + jj];
  }
  for (int i = threadIdx.x; i < S * np; i += kThreads) {
    const int s = i / np, pp = i - s * np;
    a.dr_state[((size_t)z * S + s) * P + p0 + pp] = dr_sh[s * p.ppb + pp];
  }
  // dbias, dpeep: the per-(stream, cell) sums over the streams, in order
  for (int i = threadIdx.x; i < 7 * nj; i += kThreads) {
    const int k = i / nj, jj = i - k * nj;
    const float* src = sums + (size_t)k * S * p.cpb + jj;
    float v = 0.0f;
    for (int s = 0; s < S; ++s) v += src[s * p.cpb];
    a.dbp[(size_t)z * 7 * C + k * C + j0 + jj] = v;
  }
}

inline Plan make_plan(int nbd, int cpb, int ppb, int nstage, int S, int C,
                      int P) {
  Plan p;
  p.nbd = nbd;
  p.cpb = cpb;
  p.ppb = ppb;
  p.nstage = nstage;
  p.mg = S < kRowsMax ? round_up(S, 16) : kRowsMax;
  p.cp = round_up(C, 16);
  p.pp = round_up(P, 16);
  return p;
}

}  // namespace aslp_cuda
