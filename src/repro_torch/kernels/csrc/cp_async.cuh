// Asynchronous global-to-shared copies (cp.async, sm_80 and later) shared by
// the kernels.  Each copy takes a byte count: the first `bytes` bytes come
// from src and the rest of the destination is zero-filled, so a copy past a
// row's rank reads nothing from device memory and lands as exact zeros.  A
// copy of 0 bytes reads nothing, but src must still be a valid address.
#pragma once

namespace cpasync {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes, cached in L2 only (.cg takes no other size).
__device__ __forceinline__ void copy16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void copy8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void copy4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most `kPending` of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace cpasync
