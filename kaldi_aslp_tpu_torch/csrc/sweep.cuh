// What the persistent LSTMP sweeps share (bilstmp_train.cu, the x-fused
// BLSTMP pair; lstmp_train.cu, the unidirectional pair; lstmp_forward.cu,
// the inference kernel): the cp.async PTX they stage the step's state rows
// with, the limit of a block's dynamic shared memory, the cooperative
// launch that keeps every block of a sweep resident, and a barrier over
// some of a launch's blocks.  Their launch plans are ops/sweep_plan.py.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace aslp_cuda {

// dynamic shared memory one block may use (H100); ops/sweep_plan.py's
// SMEM_LIMIT
constexpr size_t kSmemLimit = 232448;

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) / 16 * 16;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared through L2; bytes past src_bytes are 0.
// cp.async.cg reads L2, never a stale L1 line, which is how a block sees
// what the others wrote before a grid barrier.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(src_bytes)
               : "memory");
}

// 4 bytes from global to shared (an input no block writes: through L1)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n (0..2) groups are pending
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<2>();
}

// A barrier over the blocks that share `counter` (in global memory, 0 at
// launch, only ever added to): the block arrives, then waits until
// `arrivals` blocks have, in all of the launch so far.  What the block's
// threads wrote before it is visible after it to every block that passes,
// to loads that read L2 (ld.global.cg, cp.async.cg).  Every block of the
// group must be resident (a cooperative launch) and call it the same
// number of times.  A wait of kBarrierPolls polls (many seconds, where a
// step takes microseconds) can only be a fault in the launch: the kernel
// traps, and the caller sees a launch failure instead of a hung card.
constexpr unsigned kBarrierPolls = 1u << 26;

__device__ __forceinline__ void counter_barrier(unsigned* counter,
                                                unsigned arrivals) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const size_t at = __cvta_generic_to_global(counter);
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(at),
                 "r"(1u)
                 : "memory");
    unsigned seen, polls = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(at)
                   : "memory");
      if (++polls == kBarrierPolls) __trap();
    } while (seen < arrivals);
  }
  __syncthreads();
}

// A cooperative launch of `blocks` blocks of `threads` threads, all
// resident at once: the shared memory attribute set, co-residency
// checked, the error returned if the launch is refused.  The attribute and
// the occupancy query cost more host time than the launch, so each argument
// type keeps the (kernel, device, shared memory) it last set them for and
// the blocks an SM then holds, and repeats them only when that changes.
template <typename Args>
int launch_sweep(void (*kernel)(Args), Args args, int blocks, int threads,
                 size_t smem, cudaStream_t st) {
  static int set_dev = -1, set_threads = 0, per_sm = 0, sms = 0;
  static size_t set_smem = 0;
  static void (*set_kernel)(Args) = nullptr;
  int dev, err;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if (kernel != set_kernel || dev != set_dev || smem != set_smem ||
      threads != set_threads) {
    int coop = 0;
    set_dev = -1;
    if ((err = (int)cudaDeviceGetAttribute(
             &coop, cudaDevAttrCooperativeLaunch, dev)))
      return err;
    if (!coop) return (int)cudaErrorNotSupported;
    if ((err = (int)cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)))
      return err;
    if ((err = (int)cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)))
      return err;
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, threads, smem)))
      return err;
    set_kernel = kernel;
    set_dev = dev;
    set_smem = smem;
    set_threads = threads;
  }
  if ((long long)per_sm * sms < blocks)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&args};
  err = (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                         dim3(threads), params, smem, st);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace aslp_cuda
