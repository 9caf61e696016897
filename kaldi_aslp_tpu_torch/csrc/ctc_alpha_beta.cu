// CTC forward (alpha) and backward (beta) recursions in log space,
// written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernels kaldi_aslp_tpu/ops/ctc_pallas.py:_alpha_kernel
// and :_beta_kernel (reached through ctc_alpha_beta_pallas).  Over the
// expanded label sequence l' (blanks interleaved, U' = 2U + 1), for each
// stream s:
//
//   alpha[0, u]  = lp[0, u] for u in {0, 1} (u = 1 only if U' >= 2)
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
// What bounds it on the H100: nothing but the T-long chain of dependent
// steps.  A stream's state is U' floats (81 at the bench's U = 40), so
// the TPU design (the [S, U'] state in VMEM for the whole loop, one grid
// step per frame) becomes one block per stream that keeps its state in
// shared memory and loops over T itself: one launch per recursion,
// where the reference toolkit launched one kernel per frame.  Each step
// is a __syncthreads, the shift-by-1 and shift-by-2 neighbour reads from
// the other half of a double buffer, and the log-sum-exp.  The TPU's
// padding of U' to 128 lanes and S to 8 rows is not needed.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxThreads = 256;
constexpr size_t kMaxSmem = 48 * 1024;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  float m = fmaxf(fmaxf(a, b), c);
  m = fmaxf(m, kNegInf);
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

// lp and out are [T, S, U]; skip_ok is [S, U]; one block per stream.
__global__ void __launch_bounds__(kMaxThreads)
alpha_kernel(const float* __restrict__ lp, const float* __restrict__ skip_ok,
             const int* __restrict__ input_lengths,
             const int* __restrict__ exp_lens, float* __restrict__ out,
             int T, int S, int U) {
  extern __shared__ float buf[];  // [2, U]: previous and current frame
  const int s = blockIdx.x;
  const int len = input_lengths[s];
  const int elen = exp_lens[s];
  const float* skip = skip_ok + (size_t)s * U;
  const size_t t_stride = (size_t)S * U;
  const float* lp_s = lp + (size_t)s * U;
  float* out_s = out + (size_t)s * U;
  float* prev = buf;
  float* cur = buf + U;
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    const float v = (u == 0 || (u == 1 && elen >= 2)) ? lp_s[u] : kNegInf;
    prev[u] = v;
    out_s[u] = v;
  }
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const bool active = t < len;
    const float* lp_t = lp_s + t * t_stride;
    float* out_t = out_s + t * t_stride;
    for (int u = threadIdx.x; u < U; u += blockDim.x) {
      float v = prev[u];
      if (active) {
        const float b = u >= 1 ? prev[u - 1] : kNegInf;
        const float c = (u >= 2 && skip[u] > 0.0f) ? prev[u - 2] : kNegInf;
        v = lse3(v, b, c) + lp_t[u];
      }
      cur[u] = v;
      out_t[u] = v;
    }
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
beta_kernel(const float* __restrict__ lp, const float* __restrict__ skip_ok,
            const int* __restrict__ input_lengths,
            const int* __restrict__ exp_lens, float* __restrict__ out,
            int T, int S, int U) {
  extern __shared__ float buf[];  // [2, U]: next and current frame
  const int s = blockIdx.x;
  const int len = input_lengths[s];
  const int elen = exp_lens[s];
  const float* skip = skip_ok + (size_t)s * U;
  const size_t t_stride = (size_t)S * U;
  const float* lp_s = lp + (size_t)s * U;
  float* out_s = out + (size_t)s * U;
  float* next = buf;
  float* cur = buf + U;
  for (int u = threadIdx.x; u < U; u += blockDim.x) next[u] = kNegInf;
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    const float* lp_t = lp_s + t * t_stride;
    float* out_t = out_s + t * t_stride;
    for (int u = threadIdx.x; u < U; u += blockDim.x) {
      float v = next[u];
      if (t == len - 1) {
        v = (u == elen - 1 || u == elen - 2) ? lp_t[u] : kNegInf;
      } else if (t < len - 1) {
        const float b = u + 1 < U ? next[u + 1] : kNegInf;
        const float c =
            (u + 2 < U && skip[u + 2] > 0.0f) ? next[u + 2] : kNegInf;
        v = lse3(v, b, c) + lp_t[u];
      }
      cur[u] = v;
      out_t[u] = v;
    }
    __syncthreads();
    float* tmp = next;
    next = cur;
    cur = tmp;
  }
}

template <typename Kernel>
int launch(Kernel kernel, const float* lp, const float* skip_ok,
           const int* input_lengths, const int* exp_lens, float* out, int T,
           int S, int U, void* stream) {
  if (T <= 0 || S <= 0 || U <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)U * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int threads = (U + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  kernel<<<S, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      lp, skip_ok, input_lengths, exp_lens, out, T, S, U);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries, bound with ctypes.  lp [T, S, U] float32 (emission scores,
// -1e30 where u is past the stream's expanded length), skip_ok [S, U]
// float32, input_lengths and exp_lens [S] int32, out [T, S, U] float32
// (written), all contiguous on the current device.  Return a cudaError_t.
extern "C" int ctc_alpha_f32(const float* lp, const float* skip_ok,
                             const int* input_lengths, const int* exp_lens,
                             float* out, int T, int S, int U, void* stream) {
  return launch(alpha_kernel, lp, skip_ok, input_lengths, exp_lens, out, T,
                S, U, stream);
}

extern "C" int ctc_beta_f32(const float* lp, const float* skip_ok,
                            const int* input_lengths, const int* exp_lens,
                            float* out, int T, int S, int U, void* stream) {
  return launch(beta_kernel, lp, skip_ok, input_lengths, exp_lens, out, T,
                S, U, stream);
}
