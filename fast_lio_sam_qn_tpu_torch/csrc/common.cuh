// Shared helpers of the loop-closure kernels (knn.cu, fpfh_*.cu).
//
// Every kernel is fp32 on CUDA cores: no tensor cores, no TF32.  Squared
// distances use the same expansion as the reference and as the plain
// PyTorch twins, d2 = (|q|^2 - 2 q.v) + |v|^2, with |q|^2 and |v|^2 computed
// by the Python wrapper exactly as the twin computes them.  The adds are
// explicitly rounded (__fadd_rn / __fsub_rn) so nvcc cannot contract them
// into an FMA: membership of a pair near d2 == r^2 then differs from the
// twin only where the cross term itself rounds differently.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define FLSQ_API extern "C" __attribute__((visibility("default")))

namespace flsq {

__device__ __forceinline__ float expand_d2(float qq, float cross, float dd) {
  return __fadd_rn(__fsub_rn(qq, __fmul_rn(2.0f, cross)), dd);
}

__device__ __forceinline__ float cross3(float qx, float qy, float qz, float vx, float vy,
                                        float vz) {
  return fmaf(qz, vz, fmaf(qy, vy, __fmul_rn(qx, vx)));
}

// 4-byte asynchronous copies into shared memory (the tiles' double
// buffers): issue, close a group, wait for all groups but the newest.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace flsq
