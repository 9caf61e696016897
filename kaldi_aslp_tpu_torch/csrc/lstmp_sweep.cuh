// The unidirectional LSTMP forward sweep, shared by the training forward
// (lstmp_train.cu, lstmp_fwd_sweep_kernel) and the inference kernel's
// many-stream regime (lstmp_forward.cu, lstmp_infer_sweep_kernel), with what
// the training backward sweep shares with it: the launch plan's layout of a
// block's shared memory, the two float32 FMA products and the sum over the
// blocks' partial slabs.  lstmp_train.cu's note says what the design is; a
// compile-time flag (kTrain) drops the training stores and picks the barrier.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "device_math.cuh"
#include "sweep.cuh"

namespace aslp_cuda {

constexpr int kUniThreads = 256;
constexpr int kUniRows = 128;      // streams per pass of a block's products
constexpr int kUniKC = 64;         // state-row columns per ring chunk
constexpr int kUniLd = kUniKC + 4; // ring row stride (floats): conflict-free
constexpr int kUniMaxCells = 16;   // cells a block may own
constexpr int kUniMaxStages = 8;   // deepest cp.async ring

// The launch plan: ops/sweep_plan.py:lstmp_sweep_plan computes it, and the
// layout below must give its byte count.  The limits above are that
// module's UNI_ROWS_PER_PASS, UNI_K_CHUNK, UNI_MAX_CELLS and UNI_MAX_STAGES
// (tests/test_torch_lstmp_plan.py holds them equal).
struct UniPlan {
  int nb;      // blocks
  int cpb;     // cells a block
  int nstage;  // depth of the cp.async ring (2..kUniMaxStages)
  int mg;      // streams a pass, min(128, S rounded up to 4)
  int pp;      // P rounded up to 4 (the state rows' stride)
  int cpb4;    // cpb rounded up to 4
};

// Byte offsets of the regions of a sweep's dynamic shared memory, all
// float32: b1, the first product's weights [pp][n1] (forward: W_r's gate
// rows of the owned cells, column jj * 4 + gate; backward: W_rm's columns
// of the owned cells, column jj); b2, the second product's [k2][pp]
// (forward: W_rm's columns of the owned cells, row jj; backward: W_r's
// gate rows, row jj * 4 + gate); the ring staging the state row; a2, the
// second product's left operand [mg][k2] (m or dgates of the owned cells).
struct UniLayout {
  size_t b1, b2, ring, a2, total;
  int n1, k2;
};

__host__ __device__ inline UniLayout uni_layout(const UniPlan& p,
                                                bool backward) {
  UniLayout L;
  L.n1 = backward ? p.cpb4 : 4 * p.cpb;
  L.k2 = backward ? 4 * p.cpb : p.cpb4;
  size_t off = 0;
  L.b1 = off;
  off += align16((size_t)4 * p.pp * L.n1);
  L.b2 = off;
  off += align16((size_t)4 * L.k2 * p.pp);
  L.ring = off;
  off += align16((size_t)4 * p.nstage * p.mg * kUniLd);
  L.a2 = off;
  off += align16((size_t)4 * p.mg * L.k2);
  L.total = off;
  return L;
}

inline UniPlan uni_plan(int nb, int cpb, int nstage, int S, int P) {
  UniPlan p;
  p.nb = nb;
  p.cpb = cpb;
  p.nstage = nstage;
  p.mg = S < kUniRows ? round_up(S, 4) : kUniRows;
  p.pp = round_up(P, 4);
  p.cpb4 = round_up(cpb, 4);
  return p;
}

inline bool uni_plan_ok(const UniPlan& p, int S, int C, long long smem,
                 bool backward) {
  if (p.nb <= 0 || p.cpb <= 0 || p.cpb > kUniMaxCells || p.nstage < 2 ||
      p.nstage > kUniMaxStages)
    return false;
  if ((long long)p.nb * p.cpb < C || (long long)(p.nb - 1) * p.cpb >= C)
    return false;
  const UniLayout L = uni_layout(p, backward);
  return (long long)L.total == smem && L.total <= kSmemLimit;
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a,
                                     const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// acc[ii][e] += a[row ii][k .. k+3] . b[k .. k+3][e]: one k4 step of a
// 4 x 4 tile, rows ap + ii * rs, b rows bp + e' * ldb
__device__ __forceinline__ void tile_k4(float (&acc)[4][4], const float* ap,
                                        int rs, const float* bp, int ldb) {
  float4 av[4], bv[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
    av[ii] = *reinterpret_cast<const float4*>(ap + ii * rs);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    bv[e] = *reinterpret_cast<const float4*>(bp + e * ldb);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    fma4(acc[ii], av[ii].x, bv[0]);
    fma4(acc[ii], av[ii].y, bv[1]);
    fma4(acc[ii], av[ii].z, bv[2]);
    fma4(acc[ii], av[ii].w, bv[3]);
  }
}

// Stage rows [0, rows) of a (row stride K floats), columns [k0, k0 + kw),
// into slot ([rows4][kUniLd]); rows [rows, rows4) are zeros.
__device__ __forceinline__ void uni_stage(float* slot, const float* a, int K,
                                          int rows, int rows4, int k0,
                                          int kw) {
  const int pieces = kw >> 2;
  for (int i = threadIdx.x; i < rows4 * pieces; i += kUniThreads) {
    const int r = i / pieces, c = (i - r * pieces) << 2;
    const bool ok = r < rows;
    cp_async16(slot + r * kUniLd + c, ok ? a + (size_t)r * K + k0 + c : a,
               ok ? 16 : 0);
  }
}

// wait until at most n (0..kUniMaxStages - 2) cp.async groups are pending
__device__ __forceinline__ void uni_wait(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// The first product of a pass: acc[i][ii][e] = sum_k a[s][k] * b[k][n] for
// the thread's tiles q = threadIdx.x + kUniThreads * i < nsg * ntn, tile
// q taking streams s = q / ntn + ii * nsg and columns n = 4 (q % ntn) + e
// (neighbouring lanes on neighbouring column groups: their epilogues'
// stores to a row land side by side).
// a: the pass's rows of the step's state row in global memory (written by
// other blocks before the last grid barrier: staged by cp.async.cg through
// an nstage-deep ring of kUniKC-column chunks), K floats a row; b: the
// block's [K][n1] weight slice.
// Where the tiles leave threads idle, ks threads share a tile: thread
// q + part * tiles takes the k4 steps of every chunk whose index is part
// mod ks, and after the last chunk the parts' sums are added to part 0's
// in part order through the ring.  Every element is summed over K in one
// fixed order; only part 0 (q < tiles) holds the sums on return.
template <int TILES>
__device__ __forceinline__ void uni_product1(
    const float* a, int rows, int K, const float* b, int n1, int ntn,
    float* ring, int slot_floats, int nstage, float (&acc)[TILES][4][4]) {
  const int nsg = (rows + 3) >> 2, rows4 = 4 * nsg, tiles = nsg * ntn;
  const int nchunks = (K + kUniKC - 1) / kUniKC;
  const int ks = max(1, min(min(4, kUniThreads / tiles),
                            1 + nstage * slot_floats / (16 * tiles)));
  int tsg[TILES], tng[TILES], part[TILES];
  bool tv[TILES];
#pragma unroll
  for (int i = 0; i < TILES; ++i) {
    const int q = threadIdx.x + kUniThreads * i, tq = q % tiles;
    tv[i] = q < tiles * ks;
    part[i] = q / tiles;
    tsg[i] = tq / ntn;
    tng[i] = tq % ntn;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][ii][e] = 0.0f;
  }
  for (int c = 0; c < nstage - 1; ++c) {
    if (c < nchunks)
      uni_stage(ring + c * slot_floats, a, K, rows, rows4, c * kUniKC,
                min(kUniKC, K - c * kUniKC));
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    uni_wait(nstage - 2);
    // chunk c has landed for every thread; the slot staged next was last
    // read in chunk c - 1, which every thread has finished
    __syncthreads();
    const int cn = c + nstage - 1;
    if (cn < nchunks)
      uni_stage(ring + (cn % nstage) * slot_floats, a, K, rows, rows4,
                cn * kUniKC, min(kUniKC, K - cn * kUniKC));
    cp_async_commit();
    const float* sl = ring + (c % nstage) * slot_floats;
    const int k0 = c * kUniKC, kw = min(kUniKC, K - k0);
#pragma unroll
    for (int i = 0; i < TILES; ++i) {
      if (!tv[i]) continue;
      const float* ap = sl + tsg[i] * kUniLd;
      const float* bp = b + (size_t)k0 * n1 + 4 * tng[i];
      if (kw == kUniKC && ks == 1) {
        // a whole chunk: a loop the compiler can lay out in full
#pragma unroll
        for (int kk = 0; kk < kUniKC; kk += 4)
          tile_k4(acc[i], ap + kk, nsg * kUniLd, bp + (size_t)kk * n1, n1);
      } else {
#pragma unroll 2
        for (int kk = 4 * part[i]; kk < kw; kk += 4 * ks)
          tile_k4(acc[i], ap + kk, nsg * kUniLd, bp + (size_t)kk * n1, n1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (ks > 1) {
    // parts 1.. leave their sums in the ring, part 0 adds them in order
    float* red = ring;
    if (tv[0] && part[0] > 0) {
      float* dst = red + ((size_t)(part[0] - 1) * tiles +
                          threadIdx.x % tiles) * 16;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[ii * 4 + e] = acc[0][ii][e];
    }
    __syncthreads();
    if (tv[0] && part[0] == 0)
      for (int pt = 1; pt < ks; ++pt) {
        const float* src = red + ((size_t)(pt - 1) * tiles + threadIdx.x) * 16;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[0][ii][e] += src[ii * 4 + e];
      }
    __syncthreads();
  }
}

// The second product of a pass: out[s][p] = sum_k a2[s][k] * b2[k][p] for
// s < rows, p < pp, into global memory (row stride pp), each thread an
// 8-stream x 4-column tile at a time (eight broadcast loads of a2 and four
// of b2 a k4 step: shared memory keeps up with the FMA), neighbouring
// threads on neighbouring columns; K (k2) summed in increasing order.
__device__ __forceinline__ void uni_product2(const float* a2, int k2,
                                             int rows, const float* b2,
                                             int pp, float* out) {
  const int ntn = pp >> 2, nsg = (rows + 7) >> 3;
  for (int q = threadIdx.x; q < nsg * ntn; q += kUniThreads) {
    const int ng = q % ntn, s0 = 8 * (q / ntn);
    float acc[8][4];
    const float* ap[8];
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      // rows past the pass repeat its last (their sums are not stored)
      ap[ii] = a2 + (size_t)min(s0 + ii, rows - 1) * k2;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ii][e] = 0.0f;
    }
    const float* bp = b2 + 4 * ng;
#pragma unroll 2
    for (int kk = 0; kk < k2; kk += 4) {
      float4 bv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        bv[e] = *reinterpret_cast<const float4*>(bp + (size_t)(kk + e) * pp);
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const float4 av = *reinterpret_cast<const float4*>(ap[ii] + kk);
        fma4(acc[ii], av.x, bv[0]);
        fma4(acc[ii], av.y, bv[1]);
        fma4(acc[ii], av.z, bv[2]);
        fma4(acc[ii], av.w, bv[3]);
      }
    }
#pragma unroll
    for (int ii = 0; ii < 8; ++ii)
      if (s0 + ii < rows)
        *reinterpret_cast<float4*>(out + (size_t)(s0 + ii) * pp + 4 * ng) =
            make_float4(acc[ii][0], acc[ii][1], acc[ii][2], acc[ii][3]);
  }
}

// The second phase's sums: for every float4 unit u < units of the [S, pp]
// products, the blocks' partial slabs [nb][S][pp] added in a fixed order,
// then f(u, sum).  Where the grid has threads to spare, a group of `lanes`
// lanes (a power of 2 up to 8) takes a unit: lane `sub` adds the slabs
// b = sub, sub + lanes, ... in order (read through L2: other blocks wrote
// them), and a fixed butterfly adds the group's lanes, so a unit's sum
// waits for fewer L2 round trips.  The loop runs over the grid's warps,
// uniform within each warp; `lanes` depends on the shapes alone.  The grid
// here is the sweep's nb blocks, of which this is block blk.
template <typename F>
__device__ __forceinline__ void for_each_slab_sum(const float* slab,
                                                  size_t slab_floats, int nb,
                                                  int blk, int units, F f) {
  const int nthreads = nb * blockDim.x;
  int lanes = 1;
  while (lanes < 8 && (long long)units * lanes * 2 <= nthreads) lanes *= 2;
  const int per_warp = 32 / lanes;
  const int lane = threadIdx.x & 31, sub = lane % lanes;
  const int warp = (blk * blockDim.x + threadIdx.x) >> 5;
  const int nwarps = nthreads >> 5;
  for (int u0 = warp * per_warp; u0 < units; u0 += nwarps * per_warp) {
    const int u = u0 + lane / lanes;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (u < units) {
      const float* src = slab + (size_t)u * 4;
#pragma unroll 8
      for (int b = sub; b < nb; b += lanes) {
        const float4 x =
            __ldcg(reinterpret_cast<const float4*>(src + b * slab_floats));
        v.x += x.x;
        v.y += x.y;
        v.z += x.z;
        v.w += x.w;
      }
    }
    for (int off = lanes / 2; off > 0; off >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
      v.z += __shfl_xor_sync(0xffffffffu, v.z, off);
      v.w += __shfl_xor_sync(0xffffffffu, v.w, off);
    }
    if (sub == 0 && u < units) f(u, v);
  }
}

// One direction's arguments.  Training (kTrain): the kernel's own.
// Inference: one of the launch's directions; gates and cs are not touched,
// rs is the direction's columns of ys [S, T, ys_stride] (ys + dir * P),
// and bar is the direction's barrier counter, 0 at launch.
template <typename St, typename Wt>
struct UniFwdArgs {
  const St* xg;
  const float* mask;
  const Wt* w_r;     // [4C, P]
  const Wt* w_rm;    // [P, C]
  const float* peep;
  const float* init_c;
  const float* init_r;
  float* c_state;    // [S, C], written from the first step on
  float* r_state;    // [S, P], likewise
  float* row;        // [S, pp] the step's r_prev, rounded as an operand
  float* slab;       // [nb, S, pp] partial projections
  St* gates;
  St* cs;
  St* rs;
  int S, T, C, P;
  float cell_clip;
  UniPlan p;
  unsigned* bar;
  int ys_stride;
  int reverse;       // walk the frames T-1 .. 0
};

// The forward sweep of block blk of the direction's p.nb blocks, all T
// frames.  kTrain: the training forward, which stores the activated gates,
// the post-mask c and the post-mask r time-major, and whose barrier is the
// cooperative grid's.  Otherwise the inference sweep: ys = r * mask is the
// only stream stored, the frames may run in reverse, and the barrier is the
// direction's own counter, so two directions in one launch never wait for
// each other.
template <typename St, typename Wt, bool kTrain>
__device__ __forceinline__ void lstmp_fwd_sweep_body(
    const UniFwdArgs<St, Wt>& a, const int blk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const UniPlan& p = a.p;
  const int S = a.S, T = a.T, C = a.C, P = a.P, G = 4 * C, pp = p.pp;
  const int cpb = p.cpb, cpb4 = p.cpb4;
  const UniLayout L = uni_layout(p, false);
  float* b1 = reinterpret_cast<float*>(smem + L.b1);   // [pp][4 cpb]
  float* b2 = reinterpret_cast<float*>(smem + L.b2);   // [cpb4][pp]
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  float* a2 = reinterpret_cast<float*>(smem + L.a2);   // [mg][cpb4]
  const int tid = threadIdx.x;
  const int j0 = blk * cpb, nj = max(0, min(C - j0, cpb));
  for (int i = tid; i < pp * 4 * cpb; i += kUniThreads) {
    const int k = i / (4 * cpb), n = i - k * 4 * cpb, jj = n >> 2;
    b1[i] = k < P && jj < nj
                ? to_f32(a.w_r[(size_t)((n & 3) * C + j0 + jj) * P + k])
                : 0.0f;
  }
  for (int i = tid; i < cpb4 * pp; i += kUniThreads) {
    const int jj = i / pp, k = i - jj * pp;
    b2[i] = k < P && jj < nj ? to_f32(a.w_rm[(size_t)k * C + j0 + jj])
                             : 0.0f;
  }
  // m's columns past the owned cells stay zero
  for (int i = tid; i < p.mg * cpb4; i += kUniThreads) a2[i] = 0.0f;
  __syncthreads();

  const float* peep = a.peep;
  const size_t slab_floats = (size_t)S * pp;
  const int gtid = blk * kUniThreads + tid, gthreads = p.nb * kUniThreads;
  const int units = S * (pp >> 2);
  unsigned arrivals = 0;
  auto barrier = [&]() {
    if constexpr (kTrain) {
      cooperative_groups::this_grid().sync();
    } else {
      arrivals += p.nb;
      counter_barrier(a.bar, arrivals);
    }
  };
  // the first step's state row: r_0 rounded as an operand, pad columns 0
  for (int i = gtid; i < S * pp; i += gthreads) {
    const int s = i / pp, pc = i - s * pp;
    a.row[i] = pc < P ? operand<Wt>(a.init_r[(size_t)s * P + pc]) : 0.0f;
  }
  barrier();
  for (int step = 0; step < T; ++step) {
    // the frame: the training forward walks them in order
    const int t = !kTrain && a.reverse ? T - 1 - step : step;
    const float* c_prev = step == 0 ? a.init_c : a.c_state;
    const float* r_old = step == 0 ? a.init_r : a.r_state;
    // (1) gates + cell of the owned cells, then their share of the
    // projection
    for (int s0 = 0; nj > 0 && s0 < S; s0 += p.mg) {
      const int rows = min(p.mg, S - s0), nsg = (rows + 3) >> 2;
      // this thread's tiles' xg, c_prev and mask, in flight during the
      // product
      float xr[2][4][4], cpv[2][4], mkv[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = tid + kUniThreads * i, jj = q % cpb;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int s = q / cpb + ii * nsg;
          const bool ok = q < nsg * cpb && s < rows && jj < nj;
          const size_t sg = s0 + (ok ? s : 0), j = j0 + (ok ? jj : 0);
          cpv[i][ii] = ok ? c_prev[sg * C + j] : 0.0f;
          mkv[i][ii] = ok ? a.mask[sg * T + t] : 0.0f;
#pragma unroll
          for (int g = 0; g < 4; ++g)
            xr[i][ii][g] =
                ok ? to_f32(a.xg[(sg * T + t) * G + g * C + j]) : 0.0f;
        }
      }
      float acc[2][4][4];
      uni_product1<2>(a.row + (size_t)s0 * pp, rows, pp, b1, 4 * cpb,
                      cpb, ring, p.mg * kUniLd, p.nstage, acc);
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
          float lin[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) lin[g] = xr[i][ii][g] + acc[i][ii][g];
          const float cp = cpv[i][ii];
          const CellForward cf = cell_forward(lin, cp, peep[j], peep[C + j],
                                              peep[2 * C + j], a.cell_clip);
          const float mk = mkv[i][ii];
          const float cn = mk * cf.c + (1.0f - mk) * cp;
          a.c_state[sg * C + j] = cn;
          a2[s * cpb4 + jj] = operand<Wt>(cf.m);
          if constexpr (kTrain) {
            St* gr = a.gates + ((size_t)t * S + sg) * G;
            gr[j] = from_f32<St>(cf.g);
            gr[C + j] = from_f32<St>(cf.i);
            gr[2 * C + j] = from_f32<St>(cf.f);
            gr[3 * C + j] = from_f32<St>(cf.o);
            a.cs[((size_t)t * S + sg) * C + j] = from_f32<St>(cn);
          }
        }
      }
      __syncthreads();
      uni_product2(a2, cpb4, rows, b2, pp,
                   a.slab + blk * slab_floats + (size_t)s0 * pp);
      __syncthreads();
    }
    barrier();
    // (2) r = the projection summed over the slabs, blended by the mask
    for_each_slab_sum(a.slab, slab_floats, p.nb, blk, units, [&](int u,
                                                                 float4 v) {
      const int s = u / (pp >> 2), pc0 = (u - s * (pp >> 2)) << 2;
      const float sum[4] = {v.x, v.y, v.z, v.w};
      const float mk = a.mask[(size_t)s * T + t];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pc = pc0 + e;
        if (pc >= P) continue;
        const size_t sp = (size_t)s * P + pc;
        const float rn = mk * sum[e] + (1.0f - mk) * r_old[sp];
        a.r_state[sp] = rn;
        if constexpr (kTrain)
          a.rs[((size_t)t * S + s) * P + pc] = from_f32<St>(rn);
        else
          a.rs[((size_t)s * T + t) * a.ys_stride + pc] =
              from_f32<St>(rn * mk);
        a.row[(size_t)s * pp + pc] = operand<Wt>(rn);
      }
    });
    barrier();
  }
}

}  // namespace aslp_cuda
