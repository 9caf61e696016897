// CTC forward (alpha) and backward (beta) recursions in log space,
// written by hand for Hopper (sm_90a), both in one launch.
//
// Replaces the TPU kernels kaldi_aslp_tpu/ops/ctc_pallas.py:_alpha_kernel
// and :_beta_kernel (reached through ctc_alpha_beta_pallas).  Over the
// expanded label sequence l' (blanks interleaved, U' = 2U + 1), for each
// stream s:
//
//   alpha[0, u]  = lp[0, u] for u in {0, 1} (u = 1 only if exp_len >= 2)
//   alpha[t, u]  = lse3(alpha[t-1, u], alpha[t-1, u-1],
//                       skip_ok[u] ? alpha[t-1, u-2] : -inf) + lp[t, u]
//                  while t < input_length, else alpha[t-1, u]
//   beta[len-1, u] = lp[len-1, u] on the last two states, -inf elsewhere
//   beta[t, u]   = lse3(beta[t+1, u], beta[t+1, u+1],
//                       skip_ok[u+2] ? beta[t+1, u+2] : -inf) + lp[t, u]
//                  for t < len-1; frames past the length keep -inf
//
// with -inf = NEG_INF = -1e30 and lse3 clamping its maximum at NEG_INF,
// as ops/ctc.py:_lse3 does.
//
// What bounds it on the H100: the T-long chain of dependent steps, not
// bytes (12 floats a state and frame move in 15 us at S=128, T=400,
// U'=81) and not operations.  The TPU design kept the [S, U'] state in
// VMEM with one grid step per frame; carried over as one block per
// stream with the state in shared memory, each step paid a block barrier
// and an L2 round trip for the frame's emission scores on the chain.  So
// here (ctc_warp_kernel) one warp walks one stream's recursion, alpha
// and beta on warps of their own in the same launch, four warps a block
// (one per SM sub-partition, so each has a scheduler to itself):
//   - lane l holds K consecutive states u = l*K .. l*K + K-1 in registers
//     for the whole walk (K = ceil(U'/32), a template parameter up to
//     kRegMaxK); the states a step needs from the neighbouring lane
//     (u-1, u-2 for alpha, u+1, u+2 for beta) come by one or two warp
//     shuffles, so a step has no barrier and touches no memory on its
//     chain;
//   - the emission scores of the next kAhead frames are copied by cp.async
//     into a small ring of the warp's own in shared memory, in the walk's
//     direction, so no load sits on the chain;
//   - the skip flags are read once, as a bit mask per lane;
//   - each frame's K values per lane are stored where nothing waits on
//     them; a warp writes its frame row as one contiguous range;
//   - the log-sum-exp's exponentials and log are the special function
//     unit's (lse3 below): one instruction each, where accurate expf and
//     logf are long dependent chains (range reduction, a polynomial,
//     special cases).
// States past U' stay NEG_INF and are never stored.  Past kRegMaxK * 32
// states the block-per-stream kernel (ctc_wide_kernel) takes over, one
// block per stream and recursion, its state in shared memory, the next
// frame's emission scores loaded before the barrier.  The plan
// (ops/ctc_recursions.py:plan_for) picks the kernel from U' alone.  No
// atomics: two runs give the same bits.

#include <cuda_runtime.h>

#include <cstddef>

#include "sweep.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRegMaxK = 8;          // states a lane: U' <= 256
constexpr int kWarpsPerBlock = 4;    // one per SM sub-partition
// a warp's ring of emission-score frames in shared memory, and the frames
// in flight ahead of the chain (one slot fewer: the slot refilled is the
// one read a step before)
constexpr int kRingSlots = 8;
constexpr int kAhead = kRingSlots - 1;
constexpr int kWideMaxThreads = 1024;
constexpr int kWidePerThread = 6;    // U' <= 6144: 48 KB of state
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2E = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log(exp(a) + exp(b) + exp(c)) with the maximum clamped at NEG_INF.  The
// maximum's own term is exp(0) = 1, so the sum lies in [1, 3]; the other
// two terms and the log are the special function unit's base-2
// approximations (one instruction each, absolute error about 2^-22: below
// half an ulp of any state of magnitude 2 or more, where the plain
// version's own rounding is larger).  When all three lie below NEG_INF the
// sum is 0 and the result -inf, as the plain version gives.
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float hi = fmaxf(a, b);
  const float lo = fminf(a, b);
  const float m = fmaxf(hi, c);
  const float mid = fminf(hi, c);
  const float r = fmaf(
      kLn2, lg2(1.0f + ex2((lo - m) * kLog2E) + ex2((mid - m) * kLog2E)), m);
  return m < kNegInf ? __int_as_float(0xff800000) : r;  // -inf
}

// The states a recursion seeds from the emission scores at its first
// frame (alpha: t = 0; beta: t = len-1).
template <bool kBeta>
__device__ __forceinline__ bool seeded(int u, int elen) {
  return kBeta ? (u == elen - 1 || u == elen - 2)
               : (u == 0 || (u == 1 && elen >= 2));
}

// The skip flag of state u: may u-2 enter u (alpha), u+2 leave into u
// (beta, skip_ok shifted as ctc_pallas.py shifts it).
template <bool kBeta>
__device__ __forceinline__ bool skips(const float* skip, int u, int U) {
  const int v = kBeta ? u + 2 : u;
  return v < U && skip[v] > 0.0f;
}

// 4 bytes from global to shared, or 4 zero bytes without a read where
// ``bytes`` is 0 (a lane's states past U').
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src,
                                                int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   aslp_cuda::smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(bytes)
               : "memory");
}

// One warp's walk over one stream's frames; ``lp`` and ``out`` point at
// the stream's [T, S, U] rows at s = 0, ``row`` = S * U; ``ring`` is the
// warp's kRingSlots * K * 32 floats of shared memory.  The walk visits the
// frames in its own order (step 0 is t = 0 for alpha, t = T-1 for beta)
// in up to four stretches: frames that keep their state (beta's past the
// length), the seed, the recursion, and frames that keep it again
// (alpha's past the length); so the recursion's loop has no branch.
template <int K, bool kBeta>
__device__ __forceinline__ void walk(const float* __restrict__ lp,
                                     const float* __restrict__ skip,
                                     int len, int elen,
                                     float* __restrict__ out, int T,
                                     size_t row, int U, float* ring) {
  const int lane = threadIdx.x & 31;
  const int u0 = lane * K;
  unsigned valid = 0, skip_bits = 0, seed_bits = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int u = u0 + j;
    if (u < U) {
      valid |= 1u << j;
      skip_bits |= (unsigned)skips<kBeta>(skip, u, U) << j;
      seed_bits |= (unsigned)seeded<kBeta>(u, elen) << j;
    }
  }
  // the neighbouring lane's states this lane reads, if they exist
  const bool n1_ok = kBeta ? u0 + K < U : u0 >= 1;
  const bool n2_ok = kBeta ? u0 + K + 1 < U : u0 >= 2;

  // the stretches, as steps: [0, seed_step) keep, seed_step the seed (if
  // it lies in the walk), [rec_begin, rec_end) the recursion, then keep
  int seed_step, rec_begin, rec_end;
  if (kBeta) {
    seed_step = min(max(T - len, 0), T);
    rec_begin = seed_step + (len >= 1 && len <= T);
    rec_end = len >= 1 ? T : rec_begin;
  } else {
    seed_step = 0;
    rec_begin = 1;
    rec_end = max(min(len, T), 1);
  }
  const bool has_seed = kBeta ? (len >= 1 && len <= T) : true;

  const ptrdiff_t stride = kBeta ? -(ptrdiff_t)row : (ptrdiff_t)row;
  const size_t first = kBeta ? (size_t)(T - 1) * row : 0;
  float* out_p = out + first + u0;

  // The emission scores of the frames ahead, copied by cp.async into the
  // warp's ring ([slot][j][lane]: no bank conflicts) off the chain.  Each
  // lane copies and reads only its own states, so a wait_group, and no
  // barrier, makes a frame visible to it.
  const int e_begin = has_seed ? seed_step : rec_begin;
  int copy_step = e_begin;
  const float* copy_from = lp + first + u0 + e_begin * stride;
  int bytes[K];
#pragma unroll
  for (int j = 0; j < K; ++j) bytes[j] = ((valid >> j) & 1u) ? 4 : 0;
  auto copy_next = [&]() {
    if (copy_step < rec_end) {
      float* dst = ring + (copy_step & (kRingSlots - 1)) * K * 32 + lane;
#pragma unroll
      for (int j = 0; j < K; ++j)
        cp_async4_zfill(dst + j * 32, copy_from + j, bytes[j]);
    }
    aslp_cuda::cp_async_commit();   // empty past the end: the count holds
    ++copy_step;
    copy_from += stride;
  };
  auto read_frame = [&](int step, float* e) {
    aslp_cuda::cp_async_wait<kAhead - 1>();
    const float* src = ring + (step & (kRingSlots - 1)) * K * 32 + lane;
#pragma unroll
    for (int j = 0; j < K; ++j) e[j] = src[j * 32];
    copy_next();
  };
  auto store = [&](const float* st) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      if ((valid >> j) & 1u) out_p[j] = st[j];
    out_p += stride;
  };
  for (int i = 0; i < kAhead; ++i) copy_next();

  float st[K];
#pragma unroll
  for (int j = 0; j < K; ++j) st[j] = kNegInf;
  int step = 0;
  for (; step < seed_step; ++step) store(st);
  if (has_seed && step < T) {
    float e[K];
    read_frame(step, e);
#pragma unroll
    for (int j = 0; j < K; ++j)
      st[j] = ((seed_bits >> j) & 1u) ? e[j] : kNegInf;
    store(st);
    ++step;
  }
  for (; step < rec_end; ++step) {
    float e[K];
    read_frame(step, e);
    // the neighbouring lane's two states next to this lane's
    float n1, n2;
    if (kBeta) {
      n1 = __shfl_down_sync(kFull, st[0], 1);
      n2 = K >= 2 ? __shfl_down_sync(kFull, st[K >= 2 ? 1 : 0], 1)
                  : __shfl_down_sync(kFull, st[0], 2);
    } else {
      n1 = __shfl_up_sync(kFull, st[K - 1], 1);
      n2 = K >= 2 ? __shfl_up_sync(kFull, st[K >= 2 ? K - 2 : 0], 1)
                  : __shfl_up_sync(kFull, st[0], 2);
    }
    n1 = n1_ok ? n1 : kNegInf;
    n2 = n2_ok ? n2 : kNegInf;
    float nw[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float b, c;
      if (kBeta) {
        b = j + 1 < K ? st[j + 1 < K ? j + 1 : 0] : n1;
        c = j + 2 < K ? st[j + 2 < K ? j + 2 : 0] : (j + 1 < K ? n1 : n2);
      } else {
        b = j >= 1 ? st[j >= 1 ? j - 1 : 0] : n1;
        c = j >= 2 ? st[j >= 2 ? j - 2 : 0] : (j == 1 ? n1 : n2);
      }
      c = ((skip_bits >> j) & 1u) ? c : kNegInf;
      // computed on every state, then selected: a branch around each
      // state's math would make K blocks the scheduler cannot interleave
      const float v = lse3(st[j], b, c) + e[j];
      nw[j] = ((valid >> j) & 1u) ? v : kNegInf;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) st[j] = nw[j];
    store(st);
  }
  for (; step < T; ++step) store(st);
}

// lp, alphas and betas are [T, S, U]; skip_ok is [S, U].  Warps 0 .. S-1
// walk alpha for streams 0 .. S-1, warps S .. 2S-1 beta.
template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ctc_warp_kernel(const float* __restrict__ lp,
                const float* __restrict__ skip_ok,
                const int* __restrict__ input_lengths,
                const int* __restrict__ exp_lens, float* __restrict__ alphas,
                float* __restrict__ betas, int T, int S, int U) {
  __shared__ float rings[kWarpsPerBlock][kRingSlots * K * 32];
  const int warp = blockIdx.x * kWarpsPerBlock + (int)(threadIdx.x >> 5);
  if (warp >= 2 * S) return;
  float* ring = rings[threadIdx.x >> 5];
  const bool beta = warp >= S;
  const int s = beta ? warp - S : warp;
  const size_t row = (size_t)S * U;
  const float* lp_s = lp + (size_t)s * U;
  const float* skip = skip_ok + (size_t)s * U;
  const int len = input_lengths[s], elen = exp_lens[s];
  if (beta)
    walk<K, true>(lp_s, skip, len, elen, betas + (size_t)s * U, T, row, U,
                  ring);
  else
    walk<K, false>(lp_s, skip, len, elen, alphas + (size_t)s * U, T, row, U,
                   ring);
}

template <bool kBeta>
__device__ __forceinline__ void wide_walk(const float* __restrict__ lp,
                                          const float* __restrict__ skip,
                                          int len, int elen,
                                          float* __restrict__ out, int T,
                                          size_t row, int U, float* buf) {
  const int n = blockDim.x;
  const int per = (U + n - 1) / n;   // states a thread, the same for all
  float* prev = buf;
  float* cur = buf + U;
  unsigned skip_bits = 0, seed_bits = 0;
  // unconditional loads, threads past U' reading the last state, as in
  // walk: no select waits on them
  int col[kWidePerThread];
  float e[kWidePerThread];
#pragma unroll
  for (int i = 0; i < kWidePerThread; ++i) {
    const int u = threadIdx.x + i * n;
    col[i] = min(u, U - 1);
    if (i < per) e[i] = lp[(size_t)(kBeta ? T - 1 : 0) * row + col[i]];
    if (u < U) {
      skip_bits |= (unsigned)skips<kBeta>(skip, u, U) << i;
      seed_bits |= (unsigned)seeded<kBeta>(u, elen) << i;
      prev[u] = kNegInf;
    }
  }
  const int seed_t = kBeta ? len - 1 : 0;
  const int last_step = kBeta ? len - 1 : len;
  __syncthreads();
  for (int step = 0; step < T; ++step) {
    const int t = kBeta ? T - 1 - step : step;
    // the next frame's emission scores, in flight across the barrier
    // (the last step reloads its own frame, unused)
    float next[kWidePerThread];
    const size_t tn = kBeta ? max(t - 1, 0) : min(t + 1, T - 1);
#pragma unroll
    for (int i = 0; i < kWidePerThread; ++i)
      if (i < per) next[i] = lp[tn * row + col[i]];
#pragma unroll
    for (int i = 0; i < kWidePerThread; ++i) {
      const int u = threadIdx.x + i * n;
      if (i >= per || u >= U) continue;
      float v = prev[u];
      if (t == seed_t) {
        v = ((seed_bits >> i) & 1u) ? e[i] : kNegInf;
      } else if (t < last_step) {
        float b, c;
        if (kBeta) {
          b = u + 1 < U ? prev[u + 1] : kNegInf;
          c = u + 2 < U ? prev[u + 2] : kNegInf;
        } else {
          b = u >= 1 ? prev[u - 1] : kNegInf;
          c = u >= 2 ? prev[u - 2] : kNegInf;
        }
        c = ((skip_bits >> i) & 1u) ? c : kNegInf;
        v = lse3(v, b, c) + e[i];
      }
      cur[u] = v;
      out[(size_t)t * row + u] = v;
    }
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
#pragma unroll
    for (int i = 0; i < kWidePerThread; ++i) e[i] = next[i];
  }
}

// One block per (stream, recursion): blockIdx.y = 0 alpha, 1 beta.
__global__ void __launch_bounds__(kWideMaxThreads)
ctc_wide_kernel(const float* __restrict__ lp,
                const float* __restrict__ skip_ok,
                const int* __restrict__ input_lengths,
                const int* __restrict__ exp_lens, float* __restrict__ alphas,
                float* __restrict__ betas, int T, int S, int U) {
  extern __shared__ float buf[];  // [2, U]: the previous and current frame
  const int s = blockIdx.x;
  const size_t row = (size_t)S * U;
  const float* lp_s = lp + (size_t)s * U;
  const float* skip = skip_ok + (size_t)s * U;
  const int len = input_lengths[s], elen = exp_lens[s];
  if (blockIdx.y == 1)
    wide_walk<true>(lp_s, skip, len, elen, betas + (size_t)s * U, T, row, U,
                    buf);
  else
    wide_walk<false>(lp_s, skip, len, elen, alphas + (size_t)s * U, T, row,
                     U, buf);
}

template <int K>
void launch_warps(const float* lp, const float* skip_ok,
                  const int* input_lengths, const int* exp_lens,
                  float* alphas, float* betas, int T, int S, int U,
                  cudaStream_t stream) {
  const int warps = 2 * S;
  const int blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int threads = 32 * (warps < kWarpsPerBlock ? warps : kWarpsPerBlock);
  ctc_warp_kernel<K><<<blocks, threads, 0, stream>>>(
      lp, skip_ok, input_lengths, exp_lens, alphas, betas, T, S, U);
}

}  // namespace

// C entry, bound with ctypes.  lp [T, S, U] float32 (emission scores,
// -1e30 where u is past the stream's expanded length), skip_ok [S, U]
// float32, input_lengths and exp_lens [S] int32, alphas and betas
// [T, S, U] float32 (written), all contiguous on the current device.  The
// plan: states_per_lane K in 1 .. kRegMaxK with 32 K >= U selects
// ctc_warp_kernel<K> (wide_threads 0); states_per_lane 0 selects
// ctc_wide_kernel with wide_threads threads a block (a multiple of 32, at
// most kWideMaxThreads, at most kWidePerThread states a thread).  Returns
// a cudaError_t.
extern "C" int ctc_alpha_beta_f32(const float* lp, const float* skip_ok,
                                  const int* input_lengths,
                                  const int* exp_lens, float* alphas,
                                  float* betas, int T, int S, int U,
                                  int states_per_lane, int wide_threads,
                                  void* stream) {
  if (T <= 0 || S <= 0 || U <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (states_per_lane > 0) {
    if (wide_threads != 0 || states_per_lane > kRegMaxK
        || 32 * states_per_lane < U)
      return (int)cudaErrorInvalidValue;
    switch (states_per_lane) {
#define CTC_CASE(k)                                                        \
  case k:                                                                  \
    launch_warps<k>(lp, skip_ok, input_lengths, exp_lens, alphas, betas,  \
                    T, S, U, st);                                          \
    break;
      CTC_CASE(1) CTC_CASE(2) CTC_CASE(3) CTC_CASE(4)
      CTC_CASE(5) CTC_CASE(6) CTC_CASE(7) CTC_CASE(8)
#undef CTC_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    if (states_per_lane < 0 || wide_threads <= 0 || wide_threads % 32
        || wide_threads > kWideMaxThreads
        || (U + wide_threads - 1) / wide_threads > kWidePerThread)
      return (int)cudaErrorInvalidValue;
    const size_t smem = 2 * (size_t)U * sizeof(float);
    ctc_wide_kernel<<<dim3(S, 2), wide_threads, smem, st>>>(
        lp, skip_ok, input_lengths, exp_lens, alphas, betas, T, S, U);
  }
  return (int)cudaGetLastError();
}
