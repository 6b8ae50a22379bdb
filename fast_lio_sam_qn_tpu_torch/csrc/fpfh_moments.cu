// K3 — radius moments at two radii (count, sum x, sum xx^T).
//
// Replaces: fast_lio_sam_qn_tpu/ops/fpfh_stream.py::_moments_kernel
// (launcher _moments_tpu).  For every point p of the cloud, over the valid
// points v with d2(p, v) <= r2a (columns 0-9) and <= r2b (columns 10-19):
// [count, x, y, z, xx, xy, xz, yy, yz, zz] summed.  Masked points carry a
// +3.4e38 penalty in dd and never qualify.  The self pair counts, as in the
// reference.
//
// Bound on the card: fp32 issue, ~25 flops per pair over all n^2 pairs (no
// spatial prune yet: a pruned tile contributes exactly zero, so a prune is
// later, pure performance work).  Inputs are 16 bytes a point and stay in L2.
//
// Design: one thread per query, the 20 sums in registers; db tiles of 256
// points (x, y, z, dd) staged in shared memory and read as broadcasts.  The
// feature products are rounded before the add, as the twin's matmul adds
// precomputed features; only the summation order differs from the twin.
// Grid-batched (the reference's _stream_caller vmap rule, the lowering at
// fpfh_stream.py:419): blockIdx.y is the cloud and each cloud's operands
// are one contiguous slab, so a lane runs exactly the single-cloud body.
#include "common.cuh"

namespace {

constexpr int kBlock = 64;
constexpr int kTile = 256;

__global__ void moments_kernel(const float* __restrict__ pts, const float* __restrict__ qq,
                               const float* __restrict__ dd, int n, float r2a, float r2b,
                               float* __restrict__ out) {
  const size_t cloud = blockIdx.y;
  pts += cloud * n * 3;
  qq += cloud * n;
  dd += cloud * n;
  out += cloud * n * 20;
  __shared__ float s_x[kTile], s_y[kTile], s_z[kTile], s_dd[kTile];
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = row < n;
  const float px = live ? pts[3 * (size_t)row] : 0.0f;
  const float py = live ? pts[3 * (size_t)row + 1] : 0.0f;
  const float pz = live ? pts[3 * (size_t)row + 2] : 0.0f;
  const float qqv = live ? qq[row] : 0.0f;
  float acc[20];
#pragma unroll
  for (int c = 0; c < 20; ++c) acc[c] = 0.0f;

  for (int base = 0; base < n; base += kTile) {
    const int cnt = min(kTile, n - base);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      s_x[e] = pts[3 * (size_t)(base + e)];
      s_y[e] = pts[3 * (size_t)(base + e) + 1];
      s_z[e] = pts[3 * (size_t)(base + e) + 2];
      s_dd[e] = dd[base + e];
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float vx = s_x[j], vy = s_y[j], vz = s_z[j];
      const float d2 = flsq::expand_d2(qqv, flsq::cross3(px, py, pz, vx, vy, vz), s_dd[j]);
      const bool in_a = d2 <= r2a;
      const bool in_b = d2 <= r2b;
      if (!(in_a || in_b)) continue;
      const float feat[10] = {1.0f,
                              vx,
                              vy,
                              vz,
                              __fmul_rn(vx, vx),
                              __fmul_rn(vx, vy),
                              __fmul_rn(vx, vz),
                              __fmul_rn(vy, vy),
                              __fmul_rn(vy, vz),
                              __fmul_rn(vz, vz)};
#pragma unroll
      for (int c = 0; c < 10; ++c) {
        if (in_a) acc[c] = __fadd_rn(acc[c], feat[c]);
        if (in_b) acc[10 + c] = __fadd_rn(acc[10 + c], feat[c]);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int c = 0; c < 20; ++c) out[(size_t)row * 20 + c] = acc[c];
}

}  // namespace

// b clouds, each: pts (n, 3), qq (n,) = |p|^2, dd (n,) = |p|^2 + mask penalty;
// out (n, 20); every operand (b, ...) contiguous.
FLSQ_API int flsq_fpfh_moments(const float* pts, const float* qq, const float* dd, int b, int n,
                               float r2a, float r2b, float* out, void* stream) {
  if (b < 1 || b > 65535 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(flsq::ceil_div(n, kBlock), b);
  moments_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(pts, qq, dd, n, r2a,
                                                                         r2b, out);
  return flsq::launch_status();
}
