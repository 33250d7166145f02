// Asynchronous global -> shared copies (cp.async, sm_80 and later) and a
// float4 sum, shared by the ring paths of kernels A and B.

#pragma once

#include <cuda_runtime.h>

namespace {

// 16 bytes, through L2 only (.cg): the weight streams and is not reused.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

}  // namespace
