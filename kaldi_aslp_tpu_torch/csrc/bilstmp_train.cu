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
// kernel does; dx is summed over the directions in float32 from each
// direction's bf16 dx and rounded once.
//
// Design.  The TPU kernels keep both directions' W_xr (7.9 MB bf16 at the
// flagship's C = 512, P = 320) and the weight-gradient accumulators in one
// core's VMEM.  An H100 SM has 227 KB of shared memory, but the card has
// 132 of them, and the recurrent weights (W_r 2.6 MB, W_rm 0.66 MB over
// both directions) spread over them at about 25 KB an SM.  So:
//   - the products with no dependence on the recurrence are hoisted out
//     of the time loop into one bf16 GEMM written here: x . W_x^T for all
//     frames in the forward; dx, dW_x, dW_r and dW_rm in the backward from
//     the bf16 dgates, m and dr_new streams the sweep writes.  Its main
//     kernel is warp-specialised: one producer thread keeps a 4-stage ring
//     of TMA boxes (128-byte swizzled, zero past the edges) full, two
//     consumer warpgroups run wgmma m64nNk16 (N = 256 for outputs 1024 or
//     more wide, else 128) with float32 sums, and mbarriers pass the slots
//     between them; an operand stored the other way (the weight gradients'
//     dgates^T, x, r_prev, dr_new^T, m; dx's W_x) goes in MN-major through
//     wgmma's transpose bit.  The weight gradients' K = S * T is long and
//     their output tiles few, so K is split (ops/bilstmp_train.py:
//     gemm_splits) and a second pass adds the slices in order.  Where a
//     row is not 16-byte aligned (odd widths), a second kernel with the
//     same layouts stages the tiles element by element; aligned operands
//     always take TMA, and a tensor map libcuda cannot encode is an
//     error, not a fall back to that kernel;
//   - the recurrence is one cooperative, persistent kernel per sweep over
//     all T steps and the launch's directions (bilstmp_sweep.cuh, which the
//     xg-fed pair's bf16 path shares).  Block b of direction d
//     owns a group of cells (its rows of W_r and, in the backward, of
//     W_rm^T) and a group of projection columns (its rows of W_rm and, in
//     the backward, of W_r^T), and keeps those weight slices in shared
//     memory for the whole sweep, with its cells' c (dc) and its columns'
//     r (dr) state, and in the backward its cells' dbias / dpeep sums per
//     (stream, cell).  A step is two phases with a grid-wide barrier after
//     each: the forward's gates + cell for the owned cells (writing bf16 m
//     to a scratch row), then the projection for the owned columns (writing
//     bf16 r for the next step); the backward's dm + cell backward for the
//     owned cells (writing the step's bf16 dgates to a scratch row), then
//     dr_prev for the owned columns (writing the next step's bf16 dr_new).
//     The per-step products [S, P] x [P, 4C], [S, C] x [C, P] and their
//     transposes run on the tensor cores (mma.sync m16n8k16, bf16
//     operands, float32 sums): the block stages the step's state rows (all
//     S streams, padded to 16 and taken 128 at a time) through a cp.async
//     ring in 64-column chunks, and prefetches what its epilogue reads (xg;
//     gates, c_prev and dy; the mask) while the product runs.  cp.async.cg
//     reads L2, never a stale L1 line, which is how a block sees what the
//     others wrote before the barrier.  Every sum has one owner and a fixed
//     order: no atomics, two runs give the same bits.
// The launch plan (blocks per direction, the cells and columns each block
// owns, the ring's depth, the dynamic shared memory) is computed by the
// wrapper (ops/sweep_plan.py:sweep_plan) and checked here against the
// layout the kernel uses.  A direction's plan does not depend on how many
// directions a launch covers, and every output element of a sweep product
// is summed over K in the same chunk order by whichever block owns it, so
// bilstmp_train_bwd_dir gives the fused backward's bits for a direction;
// the GEMM's split-K count depends on (M, N, K) and not on the batch, so
// the same holds for the hoisted products.
//
// Capacity.  A block owns at most 16 cells (64 gate rows, eight n8 tiles)
// and at most 64 projection columns (in groups of 8), and its slices, ring
// and state must fit the 232,448 bytes of shared memory a block may use.
// With floor(SMs / 2) blocks a direction that is C <= 16 * floor(SMs / 2)
// (1056 on the H100's 132 SMs), and every C <= 1024, P <= 512 fits at
// S <= 128; the per-stream state takes 4 S (8 cpb + ppb) bytes more, so
// past 128 streams the widths narrow (ops/sweep_plan.py:sweep_plan names
// the most streams that fit).  Past it the wrapper raises ValueError.
//
// What bounds it on the H100.  By the design's arithmetic a forward step
// reads, per SM, the direction's bf16 r_prev and m rows from L2 (80 +
// 128 KB at S = 128), does about 2.5 MFLOP of tensor-core work and
// crosses two grid barriers of a microsecond or two: 5-12 us, and 10-20 us
// for the backward, whose dr phase reads the step's whole bf16 dgates row
// (512 KB at S = 128).  On the card a step takes about 27 us forward and
// 57 us backward at S = 128, and 20 and 43 us at S = 16 (PERF.md): most
// of it does not grow with the streams.  It goes to the products' chunk
// loops, run by a few warps between the ring's barrier-ordered chunks,
// and to the barriers; the backward's dr phase adds every block reading
// the whole dgates row.  A later PR would run the per-step products as
// wgmma on a warpgroup's 64-stream tiles fed by TMA, split the dr phase's
// K across blocks, and share the state rows among a cluster's SMs through
// distributed shared memory, so that each row is read from L2 once per
// cluster.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

#include "bilstmp_sweep.cuh"
#include "device_math.cuh"
#include "sweep.cuh"

namespace {

using namespace aslp_cuda;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// The hoisted GEMM, bf16 operands and float32 sums:
//   Cm[b][m][n] = sum_k A(b, m, k) * B(b, k, n)
// A(b, m, k) = A[b * sab + m * sam + k * sak] with sak == 1 (A_K) or
// sam == 1 (A_M); B(b, k, n) = B[b * sbb + k * sbk + n * sbn] with
// sbk == 1 (B_K) or sbn == 1 (B_N).  Where every row and batch start is
// 16-byte aligned gemm_tma_kernel computes it; otherwise gemm_bf16_kernel,
// which stages its tiles element by element, zero-filled at the edges.
// With splits > 1, blockIdx.z = b * splits + split sums a slice of K into
// its own slab of ws, and splitk_reduce_kernel adds the slabs in order.
// ---------------------------------------------------------------------------

// Both GEMM kernels: 64-deep k-tiles of 128-byte rows.  The element-wise
// kernel: 128 x 128 block tiles, a 3-stage ring, two warpgroups.
constexpr int kGemmBK = 64, kGemmBM = 128, kGemmBN = 128;
constexpr int kGemmStages = 3, kGemmThreads = 256;
constexpr int kGemmTile = 128 * kGemmBK * 2;   // 16 KB, A or B
constexpr size_t kGemmSmem =
    (size_t)kGemmStages * 2 * kGemmTile + 1024;   // + 1 KB alignment

struct GemmArgs {
  const bf16* A;
  long long sab, sam, sak;
  const bf16* B;
  long long sbb, sbk, sbn;
  float* C;
  long long scb, ldc;
  int M, N, K, splits;
};

// The shared tiles take wgmma's canonical 128-byte-swizzled layouts, in
// atoms of 8 rows x 128 bytes (1 KB) whose 16-byte chunk c of row r sits
// at chunk c ^ r:
//   K-major (k_unit): R rows (m or n) x 64 k, row r at (r / 8) KB +
//     (r % 8) * 128 B; the 64-row half of warpgroup w starts at w * 8 KB;
//   MN-major: panels of 64 m (or n) columns, 8 KB apart, each 64 k rows
//     of 128 bytes; warpgroup w's A is panel w.
__device__ __forceinline__ unsigned sw_offset(int row, int chunk) {
  return (unsigned)(((row >> 3) << 10) + ((row & 7) << 7) +
                    (((chunk ^ row) & 7) << 4));
}

// Stage the tile of X(r, k) = X[r * sr + k * sk] at (r0, k0): rows
// [r0, r0 + R_T) and columns [k0, k0 + 64), zero past R and K, element by
// element (the rows are not 16-byte aligned).
template <int R_T, int NT, bool k_unit>
__device__ __forceinline__ void gemm_stage(unsigned char* dst, const bf16* X,
                                           long long sr, long long sk,
                                           int R, int K, int r0, int k0) {
  const bf16 zero = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < R_T * kGemmBK; i += NT) {
    int r, k;
    unsigned off;
    if (k_unit) {
      r = i / kGemmBK;
      k = i % kGemmBK;
      off = sw_offset(r, k >> 3) + ((k & 7) << 1);
    } else {
      k = i / R_T;
      r = i % R_T;
      off = ((r >> 6) << 13) + sw_offset(k, (r & 63) >> 3) + ((r & 7) << 1);
    }
    const int gr = r0 + r, gk = k0 + k;
    *reinterpret_cast<bf16*>(dst + off) =
        (gr < R && gk < K) ? X[gr * sr + gk * sk] : zero;
  }
}

// A wgmma shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ unsigned long long gmma_desc(const void* p,
                                                        unsigned lbo,
                                                        unsigned sbo) {
  const unsigned long long a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((unsigned long long)((lbo >> 4) & 0x3FFF)
                                 << 16) |
         ((unsigned long long)((sbo >> 4) & 0x3FFF) << 32) | (1ULL << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async's writes made visible to the tensor cores' async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += A . B for a 64 x N x 16 warpgroup tile, both from shared memory;
// TA / TB = 1 for an MN-major operand
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[64],
                                             unsigned long long da,
                                             unsigned long long db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[128],
                                             unsigned long long da,
                                             unsigned long long db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// Two warpgroups, each 64 rows x 128 of the tile; a ring of 64-deep
// k-tiles staged element by element, four wgmma k16 steps per k-tile.
// Every thread stages and every warpgroup waits for its wgmmas before the
// next k-tile.
template <bool a_k, bool b_k>
__global__ void __launch_bounds__(kGemmThreads, 2)
gemm_bf16_kernel(GemmArgs g) {
  constexpr int BM = kGemmBM, BN = kGemmBN, NT = kGemmThreads;
  constexpr int STAGES = kGemmStages, AHEAD = STAGES - 1;
  constexpr int kStage = 2 * kGemmTile;
  extern __shared__ unsigned char gemm_smem_raw[];
  unsigned char* const tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gemm_smem_raw) + 1023) & ~uintptr_t(1023));
  const int b = blockIdx.z / g.splits, split = blockIdx.z % g.splits;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bf16* A = g.A + b * g.sab;
  const bf16* B = g.B + b * g.sbb;
  // this split's slice of K, whole k-tiles
  const int ktiles_all = (g.K + kGemmBK - 1) / kGemmBK;
  const int per = (ktiles_all + g.splits - 1) / g.splits;
  const int kt0 = split * per;
  const int ktiles = max(0, min(ktiles_all, kt0 + per) - kt0);
  const int wg = threadIdx.x >> 7;

  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.0f;

  auto load = [&](int kt, int slot) {
    unsigned char* as = tiles + (size_t)slot * kStage;
    unsigned char* bs = as + kGemmTile;
    const int k0 = (kt0 + kt) * kGemmBK;
    if (a_k)
      gemm_stage<BM, NT, true>(as, A, g.sam, 1, g.M, g.K, m0, k0);
    else
      gemm_stage<BM, NT, false>(as, A, 1, g.sak, g.M, g.K, m0, k0);
    if (b_k)
      gemm_stage<BN, NT, true>(bs, B, g.sbn, 1, g.N, g.K, n0, k0);
    else
      gemm_stage<BN, NT, false>(bs, B, 1, g.sbk, g.N, g.K, n0, k0);
  };

#pragma unroll
  for (int s = 0; s < AHEAD; ++s)
    if (s < ktiles) load(s, s);
  for (int kt = 0; kt < ktiles; ++kt) {
    // k-tile kt is staged; the slot staged next was last read by the
    // wgmmas of k-tile kt - 1, which have finished
    fence_proxy_async();
    __syncthreads();
    const int nxt = kt + AHEAD;
    if (nxt < ktiles) load(nxt, nxt % STAGES);
    const unsigned char* as = tiles + (size_t)(kt % STAGES) * kStage;
    const unsigned char* bs = as + kGemmTile;
    // K-major: the warpgroup's 64 rows start 8 KB in, a k16 step is 32 B
    // into the swizzled rows; MN-major: a k16 step is 16 rows (2 KB), the
    // 64-column panels 8 KB apart
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kGemmBK / 16; ++ks) {
      const unsigned long long da =
          a_k ? gmma_desc(as + (wg << 13) + ks * 32, 16, 1024)
              : gmma_desc(as + (wg << 13) + ks * 2048, 8192, 1024);
      const unsigned long long db =
          b_k ? gmma_desc(bs + ks * 32, 16, 1024)
              : gmma_desc(bs + ks * 2048, 8192, 1024);
      wgmma_m64k16<a_k ? 0 : 1, b_k ? 0 : 1>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
  }

  float* Cm = g.C + (size_t)b * g.scb +
              (size_t)split * ((size_t)gridDim.z / g.splits) * g.scb;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int gid = lane >> 2, t4 = lane & 3;
  const bool pairs =
      (g.ldc & 1) == 0 && (reinterpret_cast<uintptr_t>(Cm) & 7) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wg * 64 + warp * 16 + gid + h * 8;
      if (row >= g.M || col >= g.N) continue;
      float* dst = Cm + (size_t)row * g.ldc + col;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs && col + 1 < g.N) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        if (col + 1 < g.N) dst[1] = v1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The GEMM's main kernel on Hopper: the operands come in by TMA (whole
// 128-byte-swizzled boxes, zero past the tensor's edges) into a STAGES-deep
// ring; a producer thread keeps the ring full, two consumer warpgroups
// (64 x BN each) run wgmma on what has landed, and mbarriers hand the
// slots back and forth, so no block-wide barrier sits in the main loop.
// Taken where the strides allow TMA (16-byte-aligned rows); gemm_bf16_kernel
// above takes the rest.
// ---------------------------------------------------------------------------

constexpr int kTmaStages = 4, kTmaThreads = 384;

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of the given parity has completed; a wait that
// lasts past about 2^31 polls traps (a launch error) instead of hanging.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int parity) {
  const unsigned a = smem_u32(bar);
  for (unsigned spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1u << 31)) asm volatile("trap;");
  }
}

// One box of a 3-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

struct TmaArgs {
  float* C;
  long long scb, ldc;
  int M, N, K, splits;
  int a_batched, b_batched;   // 0: the operand is one matrix for all b
};

template <bool a_k, bool b_k, int BN>
__global__ void __launch_bounds__(kTmaThreads, 1)
gemm_tma_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb, TmaArgs g) {
  constexpr int kA = 128 * kGemmBK * 2, kB = BN * kGemmBK * 2;
  constexpr int kStage = kA + kB;
  extern __shared__ unsigned char tma_smem_raw[];
  unsigned char* const tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tma_smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(tiles + kTmaStages * kStage);
  unsigned long long* empty = full + kTmaStages;
  const int b = blockIdx.z / g.splits, split = blockIdx.z % g.splits;
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * BN;
  const int ktiles_all = (g.K + kGemmBK - 1) / kGemmBK;
  const int per = (ktiles_all + g.splits - 1) / g.splits;
  const int kt0 = split * per;
  const int ktiles = max(0, min(ktiles_all, kt0 + per) - kt0);
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTmaStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread issues every load
    if (threadIdx.x != 0) return;
    const int ba = g.a_batched ? b : 0, bb = g.b_batched ? b : 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kTmaStages;
      if (kt >= kTmaStages) mbar_wait(&empty[s], ((kt / kTmaStages) & 1) ^ 1);
      unsigned char* as = tiles + s * kStage;
      unsigned char* bs = as + kA;
      const int k0 = (kt0 + kt) * kGemmBK;
      mbar_expect_tx(&full[s], kStage);
      // K-major: one box of 64 k x rows; MN-major: 64 x 64 panels
      if (a_k) {
        tma_load(as, &ta, k0, m0, ba, &full[s]);
      } else {
        tma_load(as, &ta, m0, k0, ba, &full[s]);
        tma_load(as + 8192, &ta, m0 + 64, k0, ba, &full[s]);
      }
      if (b_k) {
        tma_load(bs, &tb, k0, n0, bb, &full[s]);
      } else {
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          tma_load(bs + q * 8192, &tb, n0 + 64 * q, k0, bb, &full[s]);
      }
    }
    return;
  }

  // the consumers: warpgroup cw takes rows [64 cw, 64 cw + 64) of the tile
  const int cw = wg - 1;
  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.0f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kTmaStages;
    mbar_wait(&full[s], (kt / kTmaStages) & 1);
    const unsigned char* as = tiles + s * kStage;
    const unsigned char* bs = as + kA;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kGemmBK / 16; ++ks) {
      const unsigned long long da =
          a_k ? gmma_desc(as + (cw << 13) + ks * 32, 16, 1024)
              : gmma_desc(as + (cw << 13) + ks * 2048, 8192, 1024);
      const unsigned long long db =
          b_k ? gmma_desc(bs + ks * 32, 16, 1024)
              : gmma_desc(bs + ks * 2048, 8192, 1024);
      wgmma_m64k16<a_k ? 0 : 1, b_k ? 0 : 1>(acc, da, db);
    }
    wgmma_commit();
    // one group left running; the slot of the group before it is free
    wgmma_wait<1>();
    if (kt > 0 && (threadIdx.x & 127) == 0)
      mbar_arrive(&empty[(kt - 1) % kTmaStages]);
  }
  wgmma_wait<0>();

  float* Cm = g.C + (size_t)b * g.scb +
              (size_t)split * ((size_t)gridDim.z / g.splits) * g.scb;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int gid = lane >> 2, t4 = lane & 3;
  const bool pairs =
      (g.ldc & 1) == 0 && (reinterpret_cast<uintptr_t>(Cm) & 7) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + cw * 64 + warp * 16 + gid + h * 8;
      if (row >= g.M || col >= g.N) continue;
      float* dst = Cm + (size_t)row * g.ldc + col;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs && col + 1 < g.N) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        if (col + 1 < g.N) dst[1] = v1;
      }
    }
  }
}

// cuTensorMapEncodeTiled from libcuda, found once at run time (so the
// library links against nothing beyond the CUDA runtime).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return h ? reinterpret_cast<EncodeTiled>(
                   dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// The map of an operand X(r, k) stored with unit stride along k (k_unit)
// or along r, `rows` long along r, batch stride sb (0: one matrix): boxes
// of 64 unit-stride elements by `box` (k_unit: rows of the tile) or 64
// (MN-major: k), 128-byte swizzled.  Returns a cudaError_t.
int make_map(CUtensorMap* map, const bf16* X, bool k_unit,
             long long row_stride, long long sb, int rows, int K, int batch,
             int box) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t inner = k_unit ? K : rows, outer = k_unit ? rows : K;
  const cuuint64_t nb = sb ? batch : 1;
  const cuuint64_t dims[3] = {inner, outer, nb};
  const cuuint64_t strides[2] = {
      (cuuint64_t)row_stride * 2,
      (cuuint64_t)(sb ? sb : row_stride * (long long)outer) * 2};
  const cuuint32_t boxd[3] = {64, (cuuint32_t)(k_unit ? box : 64), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<bf16*>(X), dims, strides, boxd, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

template <bool a_k, bool b_k, int BN>
int launch_tma(const CUtensorMap& ta, const CUtensorMap& tb,
               const TmaArgs& g, int batch, cudaStream_t st) {
  auto kernel = gemm_tma_kernel<a_k, b_k, BN>;
  const size_t smem =
      (size_t)kTmaStages * (128 + BN) * kGemmBK * 2 + 1024 + 16 * kTmaStages;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid((g.N + BN - 1) / BN, (g.M + 127) / 128, batch * g.splits);
  kernel<<<grid, kTmaThreads, smem, st>>>(ta, tb, g);
  return (int)cudaGetLastError();
}

// out[b][m][n] (ldc, scb) = sum over split of ws[split][b][m][n], in order
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     float* __restrict__ out, long long scb,
                                     long long ldc, int M, int N, int batch,
                                     int splits) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn * batch) return;
  const size_t b = i / mn, r = i - b * mn;
  float v = 0.0f;
  for (int s = 0; s < splits; ++s) v += ws[((size_t)s * batch + b) * mn + r];
  out[b * scb + (r / N) * ldc + r % N] = v;
}

template <bool a_k, bool b_k>
int launch_gemm(const GemmArgs& g, int batch, cudaStream_t st) {
  auto kernel = gemm_bf16_kernel<a_k, b_k>;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGemmSmem);
  if (err) return err;
  const dim3 grid((g.N + kGemmBN - 1) / kGemmBN,
                  (g.M + kGemmBM - 1) / kGemmBM, batch * g.splits);
  kernel<<<grid, kGemmThreads, kGemmSmem, st>>>(g);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Cm[b] = A[b] . B[b] as GemmArgs describes (C, scb and ldc the output's),
// with `splits` slices of K summed through ws [splits, batch, M, N] f32.
// The TMA kernel where every row and batch start is 16-byte aligned,
// 128 x 256 tiles for N >= 1024 and 128 x 128 below (less padding on
// narrow outputs), and an error if libcuda cannot encode its tensor maps;
// the element-wise kernel otherwise.
int gemm(const bf16* A, long long sab, long long sam, long long sak,
         const bf16* B, long long sbb, long long sbk, long long sbn,
         float* Cm, long long scb, long long ldc, int M, int N, int K,
         int batch, int splits, float* ws, cudaStream_t st) {
  if (M <= 0 || N <= 0 || K <= 0 || batch <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const bool a_k = sak == 1, b_k = sbk == 1;
  if ((!a_k && sam != 1) || (!b_k && sbn != 1))
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  GemmArgs g;
  g.A = A;
  g.sab = sab;
  g.sam = sam;
  g.sak = sak;
  g.B = B;
  g.sbb = sbb;
  g.sbk = sbk;
  g.sbn = sbn;
  g.M = M;
  g.N = N;
  g.K = K;
  g.splits = splits;
  // TMA needs every row and batch start on 16 bytes
  const long long ra = a_k ? sam : sak, rb = b_k ? sbn : sbk;
  const bool tma = aligned16(A) && ra % 8 == 0 && sab % 8 == 0 &&
                   aligned16(B) && rb % 8 == 0 && sbb % 8 == 0;
  if (splits > 1) {
    g.C = ws;
    g.scb = (long long)M * N;
    g.ldc = N;
  } else {
    g.C = Cm;
    g.scb = scb;
    g.ldc = ldc;
  }
  int err;
  if (tma) {
    // aligned operands take TMA or fail: no quiet fallback to the slower
    // kernel
    CUtensorMap ta, tb;
    const int bn_tma = N >= 1024 ? 256 : 128;
    if ((err = make_map(&ta, A, a_k, ra, sab, M, K, batch, 128)) ||
        (err = make_map(&tb, B, b_k, rb, sbb, N, K, batch, bn_tma)))
      return err;
    TmaArgs t;
    t.C = g.C;
    t.scb = g.scb;
    t.ldc = g.ldc;
    t.M = M;
    t.N = N;
    t.K = K;
    t.splits = splits;
    t.a_batched = sab != 0;
    t.b_batched = sbb != 0;
#define ASLP_TMA(AK, BK)                                          \
  err = bn_tma == 256 ? launch_tma<AK, BK, 256>(ta, tb, t, batch, st) \
                      : launch_tma<AK, BK, 128>(ta, tb, t, batch, st)
    if (a_k && b_k)
      ASLP_TMA(true, true);
    else if (a_k)
      ASLP_TMA(true, false);
    else if (b_k)
      ASLP_TMA(false, true);
    else
      ASLP_TMA(false, false);
#undef ASLP_TMA
  } else if (a_k && b_k)
    err = launch_gemm<true, true>(g, batch, st);
  else if (a_k)
    err = launch_gemm<true, false>(g, batch, st);
  else if (b_k)
    err = launch_gemm<false, true>(g, batch, st);
  else
    err = launch_gemm<false, false>(g, batch, st);
  if (err || splits == 1) return err;
  const size_t n = (size_t)M * N * batch;
  splitk_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      ws, Cm, scb, ldc, M, N, batch, splits);
  return (int)cudaGetLastError();
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

// Backward of the directions [d0, d0 + ndir): the reverse sweep, dx
// (summed over the directions in float32 from each one's bf16 dx and
// rounded once, as lstm_pallas.py:1449-1450 and :1633-1634 do) and the
// weight gradients.  The per-direction arrays hold ndir directions.
int run_bwd(int d0, int ndir, const bf16* dy, const float* mask,
            const bf16* x, const bf16* gates, const bf16* cs,
            const bf16* rprev, const bf16* wx, const bf16* wr_t,
            const bf16* wrm_t, const float* peep, const float* init_c,
            float* dc_state, float* dr_state, float* ws, bf16* dgates,
            bf16* m_out, bf16* drn, float* dx2, bf16* dx, float* dwx,
            float* dwr, float* dwrm, float* dbp, int S, int T, int D, int C,
            int P, float cell_clip, bf16* dnb, bf16* dgb, int nbd, int cpb,
            int ppb, int nstage, long long smem, int split_dwx,
            int split_dwr, int split_dwrm, cudaStream_t st) {
  if (S <= 0 || T <= 0 || D <= 0 || C <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan(nbd, cpb, ppb, nstage, S, C, P);
  if (!plan_ok(plan, S, C, P, (size_t)smem, true))
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.d0 = d0;
  a.dy = dy;
  a.mask = mask;
  a.gates = gates;
  a.cs = cs;
  a.init_c = init_c;
  a.wr_t = wr_t;
  a.wrm_t = wrm_t;
  a.peep = peep;
  a.dc_state = dc_state;
  a.dr_state = dr_state;
  a.dnb = dnb;
  a.dgb = dgb;
  a.dgates = dgates;
  a.m_out = m_out;
  a.drn = drn;
  a.dbp = dbp;
  a.S = S;
  a.T = T;
  a.C = C;
  a.P = P;
  a.cell_clip = cell_clip;
  a.p = plan;
  int err = launch_sweep(bwd_sweep_kernel, a, ndir * nbd, kThreads, (size_t)smem,
                         st);
  if (err) return err;
  const long long G = 4LL * C, rows = (long long)S * T;
  // dx[d] = dgates[d] . W_x[d]
  err = gemm(dgates, rows * G, G, 1, wx, G * D, D, 1, dx2, rows * D, D,
             (int)rows, D, (int)G, ndir, 1, nullptr, st);
  if (err) return err;
  const size_t n = (size_t)rows * D;
  sum_directions_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      dx2, dx, n, ndir);
  err = (int)cudaGetLastError();
  if (err) return err;
  // dW_x[d] = dgates[d]^T . x ;  dW_r[d] = dgates[d]^T . r_prev[d]
  err = gemm(dgates, rows * G, 1, G, x, 0, D, 1, dwx, G * D, D, (int)G, D,
             (int)rows, ndir, split_dwx, ws, st);
  if (err) return err;
  err = gemm(dgates, rows * G, 1, G, rprev, rows * P, P, 1, dwr, G * P, P,
             (int)G, P, (int)rows, ndir, split_dwr, ws, st);
  if (err) return err;
  // dW_rm[d] = dr_new[d]^T . m[d]
  return gemm(drn, rows * P, 1, P, m_out, rows * C, C, 1, dwrm,
              (long long)P * C, C, P, C, (int)rows, ndir, split_dwrm, ws, st);
}

}  // namespace

// C entries, bound with ctypes.  All arrays are contiguous on the current
// device.  Shapes (d = direction, G = 4C, cp / pp = C / P rounded up to
// 16):
//   x [S, T, D] bf16, mask [S, T] f32,
//   wx [2, G, D], wr [2, G, P], wrm [2, P, C] bf16 (the parameters'
//   own layouts), wr_t [2, P, G], wrm_t [2, C, P] bf16 (transposed),
//   peep [2, 3, C] f32 (i, f, o), bias [2, G] f32.
// The launch plan (nbd blocks per direction, cpb cells and ppb projection
// columns per block, an nstage-deep cp.async ring, smem bytes of dynamic
// shared memory) comes from ops/sweep_plan.py:sweep_plan; an entry
// returns cudaErrorInvalidValue if it does not match the kernel's layout.
// Each returns a cudaError_t (0 on success).

// Forward.  Scratch: xg [2, S, T, G] f32, m_buf [2, S, cp] bf16 zeros,
// rb [2, S, pp] bf16 holding bf16(init_r) for direction f and zeros
// (pad columns zero).  State: c_state [2, S, C] and r_state [2, S, P] f32
// hold the initial state on entry (direction b's zero) and the final state
// on return.  Writes gates [2, S, T, G], cs [2, S, T, C] and rprev
// [2, S, T, P] bf16 (rprev's boundary rows, direction f's t = 0 and
// direction b's t = T-1, are the caller's) and ys [S, T, 2P] bf16.
extern "C" int bilstmp_train_fwd(
    const bf16* x, const float* mask, const bf16* wx, const bf16* wr,
    const bf16* wrm, const float* peep, const float* bias, float* xg,
    float* c_state, float* r_state, bf16* m_buf, bf16* gates, bf16* cs,
    bf16* rprev, bf16* ys, int S, int T, int D, int C, int P,
    float cell_clip, bf16* rb, int nbd, int cpb, int ppb, int nstage,
    long long smem, void* stream) {
  if (S <= 0 || T <= 0 || D <= 0 || C <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan(nbd, cpb, ppb, nstage, S, C, P);
  if (!plan_ok(plan, S, C, P, (size_t)smem, false))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long G = 4LL * C, rows = (long long)S * T;
  // xg[d] = x . W_x[d]^T for every frame
  int err = gemm(x, 0, D, 1, wx, G * D, 1, D, xg, rows * G, G, (int)rows,
                 (int)G, D, 2, 1, nullptr, st);
  if (err) return err;
  FwdArgs a;
  a.xg = xg;
  a.xgf = a.xgb = nullptr;
  a.mask = mask;
  a.wr = wr;
  a.wrm = wrm;
  a.peep = peep;
  a.bias = bias;
  a.c_state = c_state;
  a.r_state = r_state;
  a.rb = rb;
  a.mb = m_buf;
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
  return launch_sweep(fwd_sweep_kernel<false>, a, 2 * nbd, kThreads,
                      (size_t)smem, st);
}

// Backward of both directions.  dy [S, T, 2P] bf16; gates, cs, rprev from
// the forward; init_c [S, C] f32.  State: dc_state [2, S, C] and dr_state
// [2, S, P] f32 hold the final-state cotangents on entry (direction b's
// zero) and the initial-state cotangents on return.  Scratch: ws f32, the
// split-K partial sums (splits x 2 x M x N floats for the largest of dW_x
// [G, D], dW_r [G, P] and dW_rm [P, C] split more than once), dgates
// [2, S, T, G], m_out [2, S, T, C] and drn [2, S, T, P] bf16, dx2
// [2, S, T, D] f32, dnb [2, S, pp] and dgb [2, S, 4 cp] bf16 zeros.
// Writes dx [S, T, D] bf16, dwx [2, G, D], dwr [2, G, P], dwrm [2, P, C]
// and dbp [2, 7C] f32 (dbias then dpeep i, f, o).
extern "C" int bilstmp_train_bwd(
    const bf16* dy, const float* mask, const bf16* x, const bf16* gates,
    const bf16* cs, const bf16* rprev, const bf16* wx, const bf16* wr_t,
    const bf16* wrm_t, const float* peep, const float* init_c,
    float* dc_state, float* dr_state, float* ws, bf16* dgates, bf16* m_out,
    bf16* drn, float* dx2, bf16* dx, float* dwx, float* dwr, float* dwrm,
    float* dbp, int S, int T, int D, int C, int P, float cell_clip,
    bf16* dnb, bf16* dgb, int nbd, int cpb, int ppb, int nstage,
    long long smem, int split_dwx, int split_dwr, int split_dwrm,
    void* stream) {
  return run_bwd(0, 2, dy, mask, x, gates, cs, rprev, wx, wr_t, wrm_t, peep,
                 init_c, dc_state, dr_state, ws, dgates, m_out, drn, dx2, dx,
                 dwx, dwr, dwrm, dbp, S, T, D, C, P, cell_clip, dnb, dgb,
                 nbd, cpb, ppb, nstage, smem, split_dwx, split_dwr,
                 split_dwrm, static_cast<cudaStream_t>(stream));
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
    const float* init_c, float* dc_state, float* dr_state, float* ws,
    bf16* dgates, bf16* m_out, bf16* drn, float* dx2, bf16* dx, float* dwx,
    float* dwr, float* dwrm, float* dbp, int S, int T, int D, int C, int P,
    float cell_clip, bf16* dnb, bf16* dgb, int nbd, int cpb, int ppb,
    int nstage, long long smem, int split_dwx, int split_dwr,
    int split_dwrm, void* stream) {
  if (d != 0 && d != 1) return (int)cudaErrorInvalidValue;
  return run_bwd(d, 1, dy, mask, x, gates, cs, rprev, wx, wr_t, wrm_t, peep,
                 init_c, dc_state, dr_state, ws, dgates, m_out, drn, dx2, dx,
                 dwx, dwr, dwrm, dbp, S, T, D, C, P, cell_clip, dnb, dgb,
                 nbd, cpb, ppb, nstage, smem, split_dwx, split_dwr,
                 split_dwrm, static_cast<cudaStream_t>(stream));
}

// The hoisted GEMM alone: Cm[b] = A[b] . B[b] in float32 from bf16
// operands, strides in elements as GemmArgs describes them (A's or B's
// unit stride along K or along M / N), `splits` slices of K summed in
// order through ws [splits, batch, M, N] f32 when splits > 1.
extern "C" int bilstmp_gemm_bf16(const bf16* A, long long sab, long long sam,
                                 long long sak, const bf16* B, long long sbb,
                                 long long sbk, long long sbn, float* Cm,
                                 long long scb, long long ldc, int M, int N,
                                 int K, int batch, int splits, float* ws,
                                 void* stream) {
  return gemm(A, sab, sam, sak, B, sbb, sbk, sbn, Cm, scb, ldc, M, N, K,
              batch, splits, ws, static_cast<cudaStream_t>(stream));
}
