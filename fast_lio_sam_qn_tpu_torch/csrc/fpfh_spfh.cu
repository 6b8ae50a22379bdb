// K4 — SPFH: 3 x 11-bin Darboux (alpha, phi, theta) histogram plus a count.
//
// Replaces: fast_lio_sam_qn_tpu/ops/fpfh_stream.py::_spfh_kernel (launcher
// _spfh_tpu; pair math in _angles, binning in _hist33).  For every point p
// with normal u, over the valid points v != p (by index, not by distance)
// with normal n and d2(p, v) <= r2: dn = (v - p) / d, cv = normalize(dn x u),
// cw = u x cv, alpha = cv.n, phi = u.dn, theta bin from (tx, ty) = (u.n,
// cw.n) by the reference's 12 half-plane sign tests (no atan2), with the
// same tx + 1e-20 nudge and the same truncating cast inside the clip.
// Reciprocal square roots use rsqrtf, the function torch.rsqrt calls on
// CUDA; a differing rounding can only move a whole pair across a bin edge.
//
// Bound on the card: fp32 issue, ~75 flops per in-radius pair plus the
// distance test on all n^2 pairs (no spatial prune yet).
//
// Design: one thread per query; db tiles of 128 points (xyz, normal, dd) in
// shared memory, read as broadcasts.  The 34 integer counters of each thread
// live in shared memory laid out [bin][thread], so the data-dependent bin
// index costs no local-memory spill and no bank conflict.  Counts are
// exact integers, as the reference's 0/1-weighted float sums are.
// Compiled with --fmad=false so every product and sum rounds as the twin's
// separate elementwise ops do.
// Grid-batched (the reference's _stream_caller vmap rule, the lowering at
// fpfh_stream.py:419): blockIdx.y is the cloud and each cloud's operands
// are one contiguous slab, so a lane runs exactly the single-cloud body.
#include "common.cuh"

namespace {

constexpr int kBlock = 64;
constexpr int kTile = 128;
constexpr int kBins = 11;
constexpr int kOut = 34;

__global__ void spfh_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                            const float* __restrict__ qq, const float* __restrict__ dd,
                            const float* __restrict__ th_cs, int n, float r2,
                            float* __restrict__ out) {
  const size_t cloud = blockIdx.y;
  pts += cloud * n * 3;
  nrm += cloud * n * 3;
  qq += cloud * n;
  dd += cloud * n;
  out += cloud * n * kOut;
  __shared__ float s_p[6][kTile];  // x y z nx ny nz
  __shared__ float s_dd[kTile];
  __shared__ float s_cos[kBins + 1], s_sin[kBins + 1];
  __shared__ int s_hist[kOut][kBlock];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * blockDim.x + tid;
  const bool live = row < n;
  const float px = live ? pts[3 * (size_t)row] : 0.0f;
  const float py = live ? pts[3 * (size_t)row + 1] : 0.0f;
  const float pz = live ? pts[3 * (size_t)row + 2] : 0.0f;
  const float ux = live ? nrm[3 * (size_t)row] : 0.0f;
  const float uy = live ? nrm[3 * (size_t)row + 1] : 0.0f;
  const float uz = live ? nrm[3 * (size_t)row + 2] : 0.0f;
  const float qqv = live ? qq[row] : 0.0f;
  for (int b = 0; b < kOut; ++b) s_hist[b][tid] = 0;
  if (tid <= kBins) {
    s_cos[tid] = th_cs[tid];
    s_sin[tid] = th_cs[kBins + 1 + tid];
  }

  for (int base = 0; base < n; base += kTile) {
    const int cnt = min(kTile, n - base);
    __syncthreads();
    for (int e = tid; e < cnt; e += blockDim.x) {
      const size_t g = 3 * (size_t)(base + e);
      s_p[0][e] = pts[g];
      s_p[1][e] = pts[g + 1];
      s_p[2][e] = pts[g + 2];
      s_p[3][e] = nrm[g];
      s_p[4][e] = nrm[g + 1];
      s_p[5][e] = nrm[g + 2];
      s_dd[e] = dd[base + e];
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float vx = s_p[0][j], vy = s_p[1][j], vz = s_p[2][j];
      const float d2 = flsq::expand_d2(qqv, flsq::cross3(px, py, pz, vx, vy, vz), s_dd[j]);
      if (!(d2 <= r2) || base + j == row) continue;
      const float nqx = s_p[3][j], nqy = s_p[4][j], nqz = s_p[5][j];
      const float inv_d = rsqrtf(fmaxf(d2, 1e-12f));
      const float dx = (vx - px) * inv_d;
      const float dy = (vy - py) * inv_d;
      const float dz = (vz - pz) * inv_d;
      float cvx = dy * uz - dz * uy;
      float cvy = dz * ux - dx * uz;
      float cvz = dx * uy - dy * ux;
      const float cvn = rsqrtf(fmaxf(cvx * cvx + cvy * cvy + cvz * cvz, 1e-18f));
      cvx = cvx * cvn;
      cvy = cvy * cvn;
      cvz = cvz * cvn;
      const float cwx = uy * cvz - uz * cvy;
      const float cwy = uz * cvx - ux * cvz;
      const float cwz = ux * cvy - uy * cvx;
      const float alpha = cvx * nqx + cvy * nqy + cvz * nqz;
      const float phi = ux * dx + uy * dy + uz * dz;
      const float ty = cwx * nqx + cwy * nqy + cwz * nqz;
      const float tx = (ux * nqx + uy * nqy + uz * nqz) + 1e-20f;
      const int ba = min(max(static_cast<int>((alpha + 1.0f) * 5.5f), 0), kBins - 1);
      const int bp = min(max(static_cast<int>((phi + 1.0f) * 5.5f), 0), kBins - 1);
      s_hist[ba][tid] += 1;
      s_hist[kBins + bp][tid] += 1;
      float sig_lo = ty * s_cos[0] - tx * s_sin[0];
      for (int b = 0; b < kBins; ++b) {
        const float sig_hi = ty * s_cos[b + 1] - tx * s_sin[b + 1];
        if (sig_lo >= 0.0f && sig_hi < 0.0f) s_hist[2 * kBins + b][tid] += 1;
        sig_lo = sig_hi;
      }
      s_hist[3 * kBins][tid] += 1;
    }
  }
  if (!live) return;
  for (int b = 0; b < kOut; ++b) out[(size_t)row * kOut + b] = static_cast<float>(s_hist[b][tid]);
}

}  // namespace

// pts, nrm (n, 3); qq (n,) = |p|^2; dd (n,) = |p|^2 + penalty on points that
// are masked or have no valid normal; th_cs (24,) = cos then sin of the 12
// theta bin edges; out (n, 34).  b clouds of these, every operand but th_cs
// (b, ...) contiguous.
FLSQ_API int flsq_fpfh_spfh(const float* pts, const float* nrm, const float* qq,
                            const float* dd, const float* th_cs, int b, int n, float r2,
                            float* out, void* stream) {
  if (b < 1 || b > 65535 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(flsq::ceil_div(n, kBlock), b);
  spfh_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(pts, nrm, qq, dd, th_cs,
                                                                      n, r2, out);
  return flsq::launch_status();
}
