// Hopper's asynchronous copy machinery, shared by flash_decode.cu (1-D
// bulk copies) and flash_fwd.cu (TMA tile loads): mbarriers in shared
// memory that count thread arrivals and the bytes of copies still in
// flight, and the two copy instructions that complete on them; on the
// host, the once-per-device raise of a kernel's shared memory limit.
//
// A stage of a ring is guarded by two barriers: `full` (the producer
// arms it with the stage's byte count; the copies' completion flips its
// phase) and `empty` (each consumer arrives when it is done reading; the
// producer waits on it before it refills the stage).  Waits are by phase
// parity: round r of a stage waits on parity r & 1.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace tfm_async {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialization visible to the async proxy (the
// copy engines) before any copy names them.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// One arrival that also expects `bytes` more of copy traffic before the
// phase can complete.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of parity `parity` to complete.  A watchdog traps
// after ~2^34 cycles (about 10 s): a copy that never lands or a ring out
// of step becomes a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  long long start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > (1LL << 34))
      __trap();
  }
}

// 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's earlier ordinary shared-memory writes before later
// asynchronous-proxy accesses (a bulk copy into the same bytes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA load of one box of a 4-D tensor map at element coordinates
// (c0 innermost .. c3), completing on `bar`.  Out-of-bounds elements of
// the box arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* tmap,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(tmap), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// Host side: raise `kernel`'s dynamic shared memory limit to `bytes` on
// the current device, once per device (bit d of `done`, a static of the
// caller's kernel instantiation).  The attribute sticks to the function,
// and setting it again on every launch is host time the decode steps
// pay per layer.
inline cudaError_t smem_limit_once(std::atomic<unsigned>& done,
                                   const void* kernel, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace tfm_async
