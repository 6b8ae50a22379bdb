// K5 — FPFH neighbour aggregation: sum of SPFH(v) / d(p, v) plus a count.
//
// Replaces: fast_lio_sam_qn_tpu/ops/fpfh_stream.py::_fpfh_agg_kernel
// (launcher _fpfh_agg_tpu).  For every point p, over the valid points v != p
// (by index) with d2(p, v) <= r2: out[:33] += rsqrt(max(d2, 1e-12)) *
// spfh[v], out[33] += 1.  The 1e-12 floor on d2 is the reference's 1e-6 m
// floor on d.  The TPU kernel allowed reduced-precision matmul operands
// here; this kernel accumulates in fp32 FMAs on CUDA cores.
//
// Bound on the card: the distance test on all n^2 pairs plus 33 FMAs per
// in-radius pair (fp32 issue); the (n, 33) SPFH table stays in L2.
//
// Design: one thread per query with its 33 sums and the count in
// registers; db tiles of 64 points (xyz, dd and the 33 SPFH columns) staged
// in shared memory and read as broadcasts.
// Grid-batched (the reference's _stream_caller vmap rule, the lowering at
// fpfh_stream.py:419): blockIdx.y is the cloud and each cloud's operands
// are one contiguous slab, so a lane runs exactly the single-cloud body.
#include "common.cuh"

namespace {

constexpr int kBlock = 64;
constexpr int kTile = 64;
constexpr int kDim = 33;

__global__ void agg_kernel(const float* __restrict__ pts, const float* __restrict__ qq,
                           const float* __restrict__ dd, const float* __restrict__ spfh, int n,
                           float r2, float* __restrict__ out) {
  const size_t cloud = blockIdx.y;
  pts += cloud * n * 3;
  qq += cloud * n;
  dd += cloud * n;
  spfh += cloud * n * kDim;
  out += cloud * n * (kDim + 1);
  __shared__ float s_x[kTile], s_y[kTile], s_z[kTile], s_dd[kTile];
  __shared__ float s_f[kTile * kDim];
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = row < n;
  const float px = live ? pts[3 * (size_t)row] : 0.0f;
  const float py = live ? pts[3 * (size_t)row + 1] : 0.0f;
  const float pz = live ? pts[3 * (size_t)row + 2] : 0.0f;
  const float qqv = live ? qq[row] : 0.0f;
  float acc[kDim];
#pragma unroll
  for (int c = 0; c < kDim; ++c) acc[c] = 0.0f;
  float cnt_in = 0.0f;

  for (int base = 0; base < n; base += kTile) {
    const int cnt = min(kTile, n - base);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      s_x[e] = pts[3 * (size_t)(base + e)];
      s_y[e] = pts[3 * (size_t)(base + e) + 1];
      s_z[e] = pts[3 * (size_t)(base + e) + 2];
      s_dd[e] = dd[base + e];
    }
    for (int e = threadIdx.x; e < cnt * kDim; e += blockDim.x)
      s_f[e] = spfh[(size_t)base * kDim + e];
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float d2 =
          flsq::expand_d2(qqv, flsq::cross3(px, py, pz, s_x[j], s_y[j], s_z[j]), s_dd[j]);
      if (!(d2 <= r2) || base + j == row) continue;
      const float w = rsqrtf(fmaxf(d2, 1e-12f));
      const float* f = s_f + j * kDim;
#pragma unroll
      for (int c = 0; c < kDim; ++c) acc[c] = fmaf(w, f[c], acc[c]);
      cnt_in += 1.0f;
    }
  }
  if (!live) return;
#pragma unroll
  for (int c = 0; c < kDim; ++c) out[(size_t)row * (kDim + 1) + c] = acc[c];
  out[(size_t)row * (kDim + 1) + kDim] = cnt_in;
}

}  // namespace

// pts (n, 3); qq (n,) = |p|^2; dd (n,) = |p|^2 + penalty on points that are
// masked or have no valid normal; spfh (n, 33); out (n, 34).  b clouds of
// these, every operand (b, ...) contiguous.
FLSQ_API int flsq_fpfh_agg(const float* pts, const float* qq, const float* dd,
                           const float* spfh, int b, int n, float r2, float* out,
                           void* stream) {
  if (b < 1 || b > 65535 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(flsq::ceil_div(n, kBlock), b);
  agg_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(pts, qq, dd, spfh, n, r2,
                                                                     out);
  return flsq::launch_status();
}
