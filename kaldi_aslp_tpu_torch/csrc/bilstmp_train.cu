// Bidirectional LSTMP training forward and backward, written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernels kaldi_aslp_tpu/ops/lstm_pallas.py:
//   _bixfused_fwd_kernel  (through _bixfused_train_fwd and
//                          bilstmp_xfused_train_core),
//   _bixfused_bwd_kernel  (through _bixfused_train_bwd, the custom VJP of
//                          _get_bixfused_core), and
//   _xfused_bwd_kernel    (through _xfused_train_bwd_dir: one direction's
//                          backward, which that custom VJP runs once per
//                          direction under KALDI_ASLP_LSTM_SPLIT_BWD).
// The fused and the per-direction backward share their device code: a
// backward launch covers the directions [d0, d0 + gridDim.z), so the two
// give the same bits for a direction.
// Both directions run in every step: direction f (d = 0) at frame t,
// direction b (d = 1) at frame T-1-t from a zero state.  Per direction,
// with bf16 operands and float32 sums, float32 cell math and state:
//
//   gates = bias + [x | r_prev] . W_xr          (W_xr = [W_x ; W_r])
//   g = tanh, i = sigmoid(+ peep_i c_prev), f = sigmoid(+ peep_f c_prev)
//   c = clip(f c_prev + i g);  o = sigmoid(+ peep_o c);  m = o tanh(c)
//   r = bf16(m) . W_rm^T;  c, r = mask * new + (1 - mask) * old
//
// The forward stores the activated gates, c and r in bf16 (r as the next
// step's r_prev, with the true initial state at the boundary); the layer
// output is bf16(r) * mask.  The backward recomputes c and tanh(c) from
// the bf16 gates and c_prev, carries dc and dr in float32, and rounds dy,
// dgates, dr_new and m to bf16 wherever they meet a product, as the TPU
// kernel does.
//
// What bounds it on the H100, and what the design does about it.  The TPU
// kernels keep both directions' W_xr (2 x 960 x 2048 bf16, 7.9 MB at the
// flagship's widths) and the weight-gradient accumulators in one core's
// VMEM.  One SM has 227 KB of shared memory, so that does not carry over:
//   - the products with no dependence on the recurrence are hoisted out
//     of the time loop into a tiled bf16 GEMM written here (wmma tensor
//     cores, float32 sums): x . W_x for all frames in the forward; dx,
//     dW_x, dW_r and dW_rm in the backward, from bf16 dgates, m and dr_new
//     streams the sweep writes ([2, S, T, 4C] dgates is 420 MB at S = 128,
//     T = 400, C = 512; the card has 80 GB);
//   - the recurrent products stay in the time loop as in
//     lstmp_forward.cu: per step one launch of a gates + cell kernel (one
//     warp per cell reading its four bf16 rows of W_r from L2 against
//     r_prev staged in shared memory) and one of a projection kernel (one
//     warp per output column), each over both directions at once;
//     the backward mirrors them (dm + cell backward, then dr);
//   - dbias and dpeep are summed in float32 per (stream, cell) across the
//     sweep (each owned by one thread, so no atomics), then over streams.
// A step of the recurrence is bound by reading the recurrent weights from
// L2 once per stream tile and by launch latency; wgmma, TMA and a
// persistent kernel that keeps the weights in the SMs are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "device_math.cuh"

namespace {

using namespace aslp_cuda;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStreamTile = 16;      // streams per block, per-step kernels
constexpr int kStreamTileDr = 8;     // streams per block, dr kernel
constexpr size_t kMaxSmem = 48 * 1024;

// ---------------------------------------------------------------------------
// Tiled bf16 GEMM with float32 sums (wmma 16x16x16):
//   Cm[b][m][n] = sum_k A(b, m, k) * B(b, k, n)
// A(b, m, k) = A[b * sab + m * sam + k * sak], B likewise, Cm row-major
// with leading dimension ldc.  Either operand may be transposed through its
// strides; tiles are staged in shared memory, zero-filled at the edges.
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kLdA = kBK + 8, kLdB = kBN + 8, kLdC = kBN + 4;

__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const bf16* __restrict__ A, long long sab, long long sam,
                 long long sak, const bf16* __restrict__ B, long long sbb,
                 long long sbk, long long sbn, float* __restrict__ Cm,
                 long long scb, long long ldc, int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 As[kBM * kLdA];
  __shared__ __align__(32) bf16 Bs[kBK * kLdB];
  __shared__ __align__(32) float Cs[kBM * kLdC];
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  A += b * sab;
  B += b * sbb;
  Cm += b * scb;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const bf16 zero = __float2bfloat16(0.0f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int idx = threadIdx.x; idx < kBM * kBK; idx += kThreads) {
      // neighbouring threads walk the operand's unit-stride dimension
      const int r = sak == 1 ? idx / kBK : idx % kBM;
      const int c = sak == 1 ? idx % kBK : idx / kBM;
      const int m = m0 + r, k = k0 + c;
      As[r * kLdA + c] = (m < M && k < K) ? A[m * sam + k * sak] : zero;
    }
    for (int idx = threadIdx.x; idx < kBK * kBN; idx += kThreads) {
      const int r = sbn == 1 ? idx / kBN : idx % kBK;
      const int c = sbn == 1 ? idx % kBN : idx / kBK;
      const int k = k0 + r, n = n0 + c;
      Bs[r * kLdB + c] = (k < K && n < N) ? B[k * sbk + n * sbn] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * kLdA + kk,
                               kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kLdB + wn * 32 + j * 16,
                               kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
    const int r = idx / kBN, c = idx % kBN;
    if (m0 + r < M && n0 + c < N)
      Cm[(long long)(m0 + r) * ldc + n0 + c] = Cs[r * kLdC + c];
  }
}

int gemm(const bf16* A, long long sab, long long sam, long long sak,
         const bf16* B, long long sbb, long long sbk, long long sbn,
         float* Cm, long long scb, long long ldc, int M, int N, int K,
         int batch, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  gemm_bf16_kernel<<<grid, kThreads, 0, stream>>>(
      A, sab, sam, sak, B, sbb, sbk, sbn, Cm, scb, ldc, M, N, K);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Forward, one step: blockIdx.z is the direction.
// ---------------------------------------------------------------------------

// Gates + cell for cells [blockIdx.x * kWarps, +kWarps) and streams
// [blockIdx.y * ST, +ST).  xg [2, S, T, 4C] holds x . W_x^T (no bias).
template <int ST>
__global__ void __launch_bounds__(kThreads)
fwd_cell_kernel(int step, const float* __restrict__ xg,
                const float* __restrict__ mask, const bf16* __restrict__ wr,
                const float* __restrict__ peep,
                const float* __restrict__ bias,
                const float* __restrict__ r_state,
                float* __restrict__ c_state, float* __restrict__ m_buf,
                bf16* __restrict__ gates, bf16* __restrict__ cs, int S,
                int T, int C, int P, float cell_clip) {
  extern __shared__ float r_sh[];  // [ST, P], r_prev rounded to bf16
  const int d = blockIdx.z;
  const int t = d == 0 ? step : T - 1 - step;
  const int s0 = blockIdx.y * ST;
  const float* r_d = r_state + (size_t)d * S * P;
  for (int idx = threadIdx.x; idx < ST * P; idx += blockDim.x) {
    const int s = idx / P;
    r_sh[idx] = (s0 + s < S)
                    ? round_bf16(r_d[(size_t)(s0 + s) * P + (idx - s * P)])
                    : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j >= C) return;
  const int G = 4 * C;

  float acc[4][ST];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int s = 0; s < ST; ++s) acc[k][s] = 0.0f;
  const bf16* w_row = wr + ((size_t)d * G + j) * P;
  const size_t gate_stride = (size_t)C * P;
  for (int p = lane; p < P; p += 32) {
    float w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = __bfloat162float(w_row[k * gate_stride + p]);
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

  const float* b = bias + (size_t)d * G;
  const float* pp = peep + (size_t)d * 3 * C;
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int sg = s0 + s;
    if (lane != s || sg >= S) continue;
    const size_t row = ((size_t)d * S + sg) * T + t;
    const float* x = xg + row * G;
    const size_t cj = ((size_t)d * S + sg) * C + j;
    const float cp = c_state[cj];
    // bias + (x . W_x^T + r_prev . W_r^T)
    const float lin[4] = {b[j] + (x[j] + acc[0][s]),
                          b[C + j] + (x[C + j] + acc[1][s]),
                          b[2 * C + j] + (x[2 * C + j] + acc[2][s]),
                          b[3 * C + j] + (x[3 * C + j] + acc[3][s])};
    const CellForward r =
        cell_forward(lin, cp, pp[j], pp[C + j], pp[2 * C + j], cell_clip);
    const float mk = mask[(size_t)sg * T + t];
    const float cn = mk * r.c + (1.0f - mk) * cp;
    c_state[cj] = cn;
    m_buf[cj] = round_bf16(r.m);
    bf16* gr = gates + row * G;
    gr[j] = __float2bfloat16(r.g);
    gr[C + j] = __float2bfloat16(r.i);
    gr[2 * C + j] = __float2bfloat16(r.f);
    gr[3 * C + j] = __float2bfloat16(r.o);
    cs[row * C + j] = __float2bfloat16(cn);
  }
}

// Projection for columns [blockIdx.x * kWarps, +kWarps) and streams
// [blockIdx.y * ST, +ST): r = bf16(m) . W_rm^T, blended by the mask; the
// bf16 r goes to the next step's r_prev slot and, times the mask, to ys.
template <int ST>
__global__ void __launch_bounds__(kThreads)
fwd_proj_kernel(int step, const float* __restrict__ m_buf,
                const bf16* __restrict__ wrm, const float* __restrict__ mask,
                float* __restrict__ r_state, bf16* __restrict__ rprev,
                bf16* __restrict__ ys, int S, int T, int C, int P) {
  extern __shared__ float m_sh[];  // [ST, C]
  const int d = blockIdx.z;
  const int t = d == 0 ? step : T - 1 - step;
  const int s0 = blockIdx.y * ST;
  const float* m_d = m_buf + (size_t)d * S * C;
  for (int idx = threadIdx.x; idx < ST * C; idx += blockDim.x) {
    const int s = idx / C;
    m_sh[idx] = (s0 + s < S) ? m_d[(size_t)(s0 + s) * C + (idx - s * C)]
                             : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= P) return;
  float acc[ST];
#pragma unroll
  for (int s = 0; s < ST; ++s) acc[s] = 0.0f;
  const bf16* w_row = wrm + ((size_t)d * P + p) * C;
  for (int j = lane; j < C; j += 32) {
    const float wv = __bfloat162float(w_row[j]);
#pragma unroll
    for (int s = 0; s < ST; ++s) acc[s] = fmaf(wv, m_sh[s * C + j], acc[s]);
  }
#pragma unroll
  for (int s = 0; s < ST; ++s) acc[s] = warp_sum(acc[s]);

#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int sg = s0 + s;
    if (lane != s || sg >= S) continue;
    const float mk = mask[(size_t)sg * T + t];
    const size_t rp = ((size_t)d * S + sg) * P + p;
    const float rn = mk * acc[s] + (1.0f - mk) * r_state[rp];
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
// Backward, one step of the reverse sweep: direction f at frame T-1-step,
// direction b at frame step.  Direction d = d0 + blockIdx.z; the
// per-direction arrays (all but dy, mask and init_c) hold the launch's
// directions only, so slot z = blockIdx.z indexes them.
// ---------------------------------------------------------------------------

// dm = bf16(dr_new) . W_rm (one warp per cell), then the cell's backward.
// Writes dgates and m (bf16) for the step, carries dc, and sums dbias and
// dpeep per (stream, cell) into acc [2, S, 7C].
template <int ST>
__global__ void __launch_bounds__(kThreads)
bwd_cell_kernel(int d0, int step, const bf16* __restrict__ dy,
                const float* __restrict__ mask, const bf16* __restrict__ gates,
                const bf16* __restrict__ cs, const float* __restrict__ init_c,
                const bf16* __restrict__ wrm_t,
                const float* __restrict__ peep,
                const float* __restrict__ dr_state,
                float* __restrict__ dc_state, float* __restrict__ acc_sum,
                bf16* __restrict__ dgates, bf16* __restrict__ m_out, int S,
                int T, int C, int P, float cell_clip) {
  extern __shared__ float drn_sh[];  // [ST, P], bf16(dr_new)
  const int z = blockIdx.z, d = d0 + z;
  const int t = d == 0 ? T - 1 - step : step;
  const int s0 = blockIdx.y * ST;
  for (int idx = threadIdx.x; idx < ST * P; idx += blockDim.x) {
    const int s = idx / P, p = idx - s * P;
    const int sg = s0 + s;
    float v = 0.0f;
    if (sg < S) {
      const float mk = mask[(size_t)sg * T + t];
      const float dyv = __bfloat162float(
          dy[((size_t)sg * T + t) * 2 * P + (size_t)d * P + p]);
      v = round_bf16(mk * (dyv * mk + dr_state[((size_t)z * S + sg) * P + p]));
    }
    drn_sh[idx] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j >= C) return;
  const int G = 4 * C;
  float acc[ST];
#pragma unroll
  for (int s = 0; s < ST; ++s) acc[s] = 0.0f;
  const bf16* w_row = wrm_t + ((size_t)z * C + j) * P;
  for (int p = lane; p < P; p += 32) {
    const float wv = __bfloat162float(w_row[p]);
#pragma unroll
    for (int s = 0; s < ST; ++s) acc[s] = fmaf(wv, drn_sh[s * P + p], acc[s]);
  }
#pragma unroll
  for (int s = 0; s < ST; ++s) acc[s] = warp_sum(acc[s]);

  const float* pp = peep + (size_t)z * 3 * C;
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int sg = s0 + s;
    if (lane != s || sg >= S) continue;
    const size_t row = ((size_t)z * S + sg) * T + t;
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
    const size_t cj = ((size_t)z * S + sg) * C + j;
    const CellBackward b =
        cell_backward(g, i, f, o, cp, acc[s], dc_state[cj], mk, pp[j],
                      pp[C + j], pp[2 * C + j], cell_clip);
    m_out[row * C + j] = __float2bfloat16(o * b.tc);
    dc_state[cj] = b.dc_prev;
    bf16* dgr = dgates + row * G;
    dgr[j] = __float2bfloat16(b.dg);
    dgr[C + j] = __float2bfloat16(b.di);
    dgr[2 * C + j] = __float2bfloat16(b.df);
    dgr[3 * C + j] = __float2bfloat16(b.d_o);
    float* a = acc_sum + ((size_t)z * S + sg) * 7 * C;
    a[j] += b.dg;
    a[C + j] += b.di;
    a[2 * C + j] += b.df;
    a[3 * C + j] += b.d_o;
    a[4 * C + j] += b.di * cp;
    a[5 * C + j] += b.df * cp;
    a[6 * C + j] += b.d_o * b.c;
  }
}

// dr_prev = (1 - mask) dR_after + bf16(dgates) . W_r (one warp per column
// p, the step's dgates rows staged in shared memory); also stores
// bf16(dr_new) for the dW_rm reduction.
template <int ST>
__global__ void __launch_bounds__(kThreads)
bwd_dr_kernel(int d0, int step, const bf16* __restrict__ dy,
              const float* __restrict__ mask,
              const bf16* __restrict__ dgates,
              const bf16* __restrict__ wr_t, float* __restrict__ dr_state,
              bf16* __restrict__ drn, int S, int T, int C, int P) {
  extern __shared__ bf16 dg_sh[];  // [ST, 4C]
  const int z = blockIdx.z, d = d0 + z;
  const int t = d == 0 ? T - 1 - step : step;
  const int s0 = blockIdx.y * ST;
  const int G = 4 * C;
  for (int idx = threadIdx.x; idx < ST * G; idx += blockDim.x) {
    const int s = idx / G;
    const int sg = s0 + s;
    dg_sh[idx] = sg < S ? dgates[(((size_t)z * S + sg) * T + t) * G +
                                 (idx - s * G)]
                        : __float2bfloat16(0.0f);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= P) return;
  float acc[ST];
#pragma unroll
  for (int s = 0; s < ST; ++s) acc[s] = 0.0f;
  const bf16* w_row = wr_t + ((size_t)z * P + p) * G;
  for (int g = lane; g < G; g += 32) {
    const float wv = __bfloat162float(w_row[g]);
#pragma unroll
    for (int s = 0; s < ST; ++s)
      acc[s] = fmaf(wv, __bfloat162float(dg_sh[s * G + g]), acc[s]);
  }
#pragma unroll
  for (int s = 0; s < ST; ++s) acc[s] = warp_sum(acc[s]);

#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int sg = s0 + s;
    if (lane != s || sg >= S) continue;
    const float mk = mask[(size_t)sg * T + t];
    const float dyv = __bfloat162float(
        dy[((size_t)sg * T + t) * 2 * P + (size_t)d * P + p]);
    const size_t rp = ((size_t)z * S + sg) * P + p;
    const float dra = dyv * mk + dr_state[rp];
    drn[(((size_t)z * S + sg) * T + t) * P + p] = __float2bfloat16(mk * dra);
    dr_state[rp] = (1.0f - mk) * dra + acc[s];
  }
}

// dx = bf16(bf16(dx_f) + bf16(dx_b)), each direction's dx rounded first;
// with one direction (ndir = 1), dx = bf16(dx_d).
__global__ void sum_directions_kernel(const float* __restrict__ dx2,
                                      bf16* __restrict__ dx, size_t n,
                                      int ndir) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  dx[i] = ndir == 2
              ? __float2bfloat16(round_bf16(dx2[i]) + round_bf16(dx2[n + i]))
              : __float2bfloat16(dx2[i]);
}

bool smem_ok(size_t bytes) { return bytes <= kMaxSmem; }

// Backward of the directions [d0, d0 + ndir): the reverse sweep, dx
// (summed over the directions in float32 from each one's bf16 dx and
// rounded once, as lstm_pallas.py:1449-1450 and :1633-1634 do) and the
// weight gradients.  The per-direction arrays hold ndir directions.
int run_bwd(int d0, int ndir, const bf16* dy, const float* mask,
            const bf16* x, const bf16* gates, const bf16* cs,
            const bf16* rprev, const bf16* wx, const bf16* wr_t,
            const bf16* wrm_t, const float* peep, const float* init_c,
            float* dc_state, float* dr_state, float* acc, bf16* dgates,
            bf16* m_out, bf16* drn, float* dx2, bf16* dx, float* dwx,
            float* dwr, float* dwrm, float* dbp, int S, int T, int D, int C,
            int P, float cell_clip, cudaStream_t st) {
  if (S <= 0 || T <= 0 || D <= 0 || C <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  constexpr int ST = kStreamTile, STD = kStreamTileDr;
  const size_t smem_cell = (size_t)ST * P * sizeof(float);
  const size_t smem_dr = (size_t)STD * 4 * C * sizeof(bf16);
  if (!smem_ok(smem_cell) || !smem_ok(smem_dr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid_cell((C + kWarps - 1) / kWarps, (S + ST - 1) / ST, ndir);
  const dim3 grid_dr((P + kWarps - 1) / kWarps, (S + STD - 1) / STD, ndir);
  int err;
  for (int step = 0; step < T; ++step) {
    bwd_cell_kernel<ST><<<grid_cell, kThreads, smem_cell, st>>>(
        d0, step, dy, mask, gates, cs, init_c, wrm_t, peep, dr_state,
        dc_state, acc, dgates, m_out, S, T, C, P, cell_clip);
    err = (int)cudaGetLastError();
    if (err) return err;
    bwd_dr_kernel<STD><<<grid_dr, kThreads, smem_dr, st>>>(
        d0, step, dy, mask, dgates, wr_t, dr_state, drn, S, T, C, P);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const long long G = 4LL * C, rows = (long long)S * T;
  // dx[d] = dgates[d] . W_x[d]
  err = gemm(dgates, rows * G, G, 1, wx, G * D, D, 1, dx2, rows * D, D,
             (int)rows, D, (int)G, ndir, st);
  if (err) return err;
  const size_t n = (size_t)rows * D;
  sum_directions_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      dx2, dx, n, ndir);
  err = (int)cudaGetLastError();
  if (err) return err;
  // dW_x[d] = dgates[d]^T . x ;  dW_r[d] = dgates[d]^T . r_prev[d]
  err = gemm(dgates, rows * G, 1, G, x, 0, D, 1, dwx, G * D, D, (int)G, D,
             (int)rows, ndir, st);
  if (err) return err;
  err = gemm(dgates, rows * G, 1, G, rprev, rows * P, P, 1, dwr, G * P, P,
             (int)G, P, (int)rows, ndir, st);
  if (err) return err;
  // dW_rm[d] = dr_new[d]^T . m[d]
  err = gemm(drn, rows * P, 1, P, m_out, rows * C, C, 1, dwrm, (long long)P * C,
             C, P, C, (int)rows, ndir, st);
  if (err) return err;
  const int K = 7 * C;
  sum_streams_kernel<<<dim3((K + 127) / 128, ndir), 128, 0, st>>>(acc, dbp,
                                                                  S, K);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries, bound with ctypes.  All arrays are contiguous on the current
// device.  Shapes (d = direction, G = 4C):
//   x [S, T, D] bf16, mask [S, T] f32,
//   wx [2, G, D], wr [2, G, P], wrm [2, P, C] bf16 (the parameters'
//   own layouts), wr_t [2, P, G], wrm_t [2, C, P] bf16 (transposed),
//   peep [2, 3, C] f32 (i, f, o), bias [2, G] f32.
// Each returns a cudaError_t (0 on success).

// Forward.  Scratch: xg [2, S, T, G] f32, m_buf [2, S, C] f32.  State:
// c_state [2, S, C] and r_state [2, S, P] f32 hold the initial state on
// entry (direction b's zero) and the final state on return.  Writes gates
// [2, S, T, G], cs [2, S, T, C] and rprev [2, S, T, P] bf16 (rprev's
// boundary rows, direction f's t = 0 and direction b's t = T-1, are the
// caller's) and ys [S, T, 2P] bf16.
extern "C" int bilstmp_train_fwd(
    const bf16* x, const float* mask, const bf16* wx, const bf16* wr,
    const bf16* wrm, const float* peep, const float* bias, float* xg,
    float* c_state, float* r_state, float* m_buf, bf16* gates, bf16* cs,
    bf16* rprev, bf16* ys, int S, int T, int D, int C, int P,
    float cell_clip, void* stream) {
  if (S <= 0 || T <= 0 || D <= 0 || C <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  constexpr int ST = kStreamTile;
  const size_t smem_cell = (size_t)ST * P * sizeof(float);
  const size_t smem_proj = (size_t)ST * C * sizeof(float);
  if (!smem_ok(smem_cell) || !smem_ok(smem_proj))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long G = 4LL * C, rows = (long long)S * T;
  // xg[d] = x . W_x[d]^T for every frame
  int err = gemm(x, 0, D, 1, wx, G * D, 1, D, xg, rows * G, G, (int)rows,
                 (int)G, D, 2, st);
  if (err) return err;
  const dim3 grid_cell((C + kWarps - 1) / kWarps, (S + ST - 1) / ST, 2);
  const dim3 grid_proj((P + kWarps - 1) / kWarps, (S + ST - 1) / ST, 2);
  for (int step = 0; step < T; ++step) {
    fwd_cell_kernel<ST><<<grid_cell, kThreads, smem_cell, st>>>(
        step, xg, mask, wr, peep, bias, r_state, c_state, m_buf, gates, cs,
        S, T, C, P, cell_clip);
    err = (int)cudaGetLastError();
    if (err) return err;
    fwd_proj_kernel<ST><<<grid_proj, kThreads, smem_proj, st>>>(
        step, m_buf, wrm, mask, r_state, rprev, ys, S, T, C, P);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// Backward of both directions.  dy [S, T, 2P] bf16; gates, cs, rprev from
// the forward; init_c [S, C] f32.  State: dc_state [2, S, C] and dr_state
// [2, S, P] f32 hold the final-state cotangents on entry (direction b's
// zero) and the initial-state cotangents on return.  Scratch: acc
// [2, S, 7C] f32 zeroed by the caller, dgates [2, S, T, G], m_out
// [2, S, T, C] and drn [2, S, T, P] bf16, dx2 [2, S, T, D] f32.  Writes
// dx [S, T, D] bf16, dwx [2, G, D], dwr [2, G, P], dwrm [2, P, C] and dbp
// [2, 7C] f32 (dbias then dpeep i, f, o).
extern "C" int bilstmp_train_bwd(
    const bf16* dy, const float* mask, const bf16* x, const bf16* gates,
    const bf16* cs, const bf16* rprev, const bf16* wx, const bf16* wr_t,
    const bf16* wrm_t, const float* peep, const float* init_c,
    float* dc_state, float* dr_state, float* acc, bf16* dgates, bf16* m_out,
    bf16* drn, float* dx2, bf16* dx, float* dwx, float* dwr, float* dwrm,
    float* dbp, int S, int T, int D, int C, int P, float cell_clip,
    void* stream) {
  return run_bwd(0, 2, dy, mask, x, gates, cs, rprev, wx, wr_t, wrm_t, peep,
                 init_c, dc_state, dr_state, acc, dgates, m_out, drn, dx2, dx,
                 dwx, dwr, dwrm, dbp, S, T, D, C, P, cell_clip,
                 static_cast<cudaStream_t>(stream));
}

// Backward of direction d alone (d = 0 walks T-1 -> 0 from init_c and the
// final-state cotangents, d = 1 walks 0 -> T-1 from zeros).  The arrays
// are bilstmp_train_bwd's without the leading direction axis (dy, mask, x
// and init_c are shared); dx [S, T, D] is bf16(dx_d), dx2 [S, T, D] f32
// scratch.
extern "C" int bilstmp_train_bwd_dir(
    int d, const bf16* dy, const float* mask, const bf16* x,
    const bf16* gates, const bf16* cs, const bf16* rprev, const bf16* wx,
    const bf16* wr_t, const bf16* wrm_t, const float* peep,
    const float* init_c, float* dc_state, float* dr_state, float* acc,
    bf16* dgates, bf16* m_out, bf16* drn, float* dx2, bf16* dx, float* dwx,
    float* dwr, float* dwrm, float* dbp, int S, int T, int D, int C, int P,
    float cell_clip, void* stream) {
  if (d != 0 && d != 1) return (int)cudaErrorInvalidValue;
  return run_bwd(d, 1, dy, mask, x, gates, cs, rprev, wx, wr_t, wrm_t, peep,
                 init_c, dc_state, dr_state, acc, dgates, m_out, drn, dx2, dx,
                 dwx, dwr, dwrm, dbp, S, T, D, C, P, cell_clip,
                 static_cast<cudaStream_t>(stream));
}
