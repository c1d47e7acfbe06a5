// Hopper's 1-D bulk copy (global -> shared memory) with completion reported
// to an mbarrier in shared memory.  One thread asks for the whole copy; the
// copy engine moves the bytes and the block's threads spend no instructions
// or registers on it.  Source, destination and size are multiples of 16
// bytes.  Shared by basis_jet.cu (A_jet, one copy) and sampler.cu (the basis
// table, one copy per basis row).
//
// Use, in a block:
//   if (threadIdx.x == 0) { mbar_init(bar); mbar_expect_tx(bar, total);
//                           bulk_copy_g2s(dst, src, bytes, bar); ... }
//   __syncthreads();          // the barrier's init is visible to everyone
//   mbar_wait(bar, 0);        // every thread, before it reads dst

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one arrival expected: the thread that announces the byte count
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(1)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst_smem, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst_smem)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

}  // namespace hopper
