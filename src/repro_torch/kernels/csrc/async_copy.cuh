// Asynchronous copies into shared memory for Hopper (sm_90a): the mbarrier
// helpers of the staged transpose (flashsketch_transpose.cu) and the narrow
// kernels (row_split.cuh, flashsketch_transpose.cu), and the three ways a
// narrow stage is filled.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fs {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// How a narrow stage is filled (kernels/flashsketch.py:_narrow_copy_mode):
// 1-D bulk copies (every span 16-byte aligned, a multiple of 16 bytes), 4-byte
// cp.async (4-byte aligned), or plain loads.
enum NarrowCopy : int { kCopyBulk = 0, kCopyAsync4 = 1, kCopyPlain = 2 };

// One 1-D bulk copy (the TMA unit without a tensor map) of `bytes` from
// global memory into shared memory, counted on `bar`'s transactions; issued
// by one thread after its mbar_expect_tx.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// This thread's share of a copy of `bytes` from global into shared memory,
// kCopyAsync4: 4-byte cp.async (both addresses and `bytes` 4-byte aligned),
// kCopyPlain: byte by byte.  The caller arrives on the stage's barrier once
// it has issued all its shares.
template <int kCopy>
__device__ __forceinline__ void share_copy(void* dst, const void* src,
                                           long long bytes) {
  static_assert(kCopy != kCopyBulk, "bulk copies are one thread's");
  unsigned char* to = static_cast<unsigned char*>(dst);
  const unsigned char* from = static_cast<const unsigned char*>(src);
  constexpr int kStep = kCopy == kCopyAsync4 ? 4 : 1;
  for (long long i = static_cast<long long>(threadIdx.x) * kStep; i < bytes;
       i += static_cast<long long>(blockDim.x) * kStep) {
    if constexpr (kCopy == kCopyAsync4)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       smem_u32(to + i)),
                   "l"(from + i)
                   : "memory");
    else
      to[i] = __ldg(from + i);
  }
}

// After this thread's shares of a stage (share_copy): arrive on its barrier,
// kCopyAsync4 once its cp.async copies have landed.
template <int kCopy>
__device__ __forceinline__ void share_arrive(uint64_t* bar) {
  if constexpr (kCopy == kCopyAsync4)
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                     smem_u32(bar))
                 : "memory");
  else
    mbar_arrive(bar);
}

// 16-byte alignment of a stage's spans (host and device agree on it).
__host__ __device__ constexpr long long align16(long long bytes) {
  return (bytes + 15) & ~15LL;
}

}  // namespace fs
