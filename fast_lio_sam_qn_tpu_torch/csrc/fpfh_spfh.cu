// K4 — SPFH: 3 x 11-bin Darboux (alpha, phi, theta) histogram plus a count.
//
// Replaces: fast_lio_sam_qn_tpu/ops/fpfh_stream.py::_spfh_kernel (launcher
// _spfh_tpu; pair math in _angles, binning in _hist33).  For every valid
// query p (qmask) with normal u, over the points v != p (by index, not by
// distance) in mask & n_valid with normal n and d2(p, v) <= r2: dn = (v -
// p) / d, cv = normalize(dn x u), cw = u x cv, alpha = cv.n, phi = u.dn,
// theta bin from (tx, ty) = (u.n, cw.n) by the reference's 12 half-plane
// sign tests (no atan2), with the same tx + 1e-20 nudge and the same
// truncating cast inside the clip.  Reciprocal square roots use rsqrtf, the
// function torch.rsqrt calls on CUDA; a differing rounding can only move a
// whole pair across a bin edge.  Rows of masked queries are zero.  The
// counts are exact integers, as the reference's 0/1-weighted float sums
// are, and do not depend on the row order of the cloud.
//
// Bound on the card: after the prune, fp32 issue of ~75 flops and an
// 11-step theta loop per in-radius pair; no tensor cores (the pair math is
// elementwise, and TF32 would break the port's strict-fp32 rule).  What
// held the first kernel back: a distance test against all n rows of the
// padded cloud for every query, one thread per query in 64-thread CTAs
// (68 CTAs on 132 SMs at the bench's 4,352 rows), and a warp that ran the
// angle body whenever any of its scattered queries had a hit, a few per
// cent of its pairs.
//
// Design (the CTA layout and the keep rule are tile_prune.cuh's): one CTA
// of 128 threads per (block of 32 query rows, cloud).  A block at or past
// the lane's query extent, or with no valid query, writes zero rows and
// exits.  Otherwise it lists the db tiles of 32 rows, below the lane's db
// extent, that the radius rule keeps, and walks them with the next tile
// copied by cp.async into the other of two buffers.  For each tile:
// (1) warp w takes query rows 8w .. 8w + 7 and lane j db row j; each pair's
// d2 is flsq::expand_d2 on the wrapper's |q|^2, |v|^2, as the unpruned
// kernel had it; a ballot per row marks the hits and counts them.  (2) The
// hits are compacted by a warp-ballot prefix sum into a list in shared
// memory, (query row, db row, d2).  (3) All 128 threads take the listed
// pairs in turn, so every lane computes angles of a real pair, and add
// them to the block's [row][bin] integer histogram with shared-memory
// atomicAdd (an integer sum does not depend on the order).  Compiled with
// --fmad=false so every product and sum rounds as the plain version's
// separate elementwise ops do.
// Grid-batched (the reference's _stream_caller vmap rule, the lowering at
// fpfh_stream.py:419): blockIdx.y is the cloud and each cloud's operands,
// tile boxes and outputs are one contiguous slab, so a lane runs exactly
// the single-cloud body.
#include "tile_prune.cuh"

namespace {

using flsq::kFpBlock;
using flsq::kFpOut;
using flsq::kFpRows;
using flsq::kFpThreads;
using flsq::kFpTile;

constexpr int kBins = 11;

struct SpfhTile {
  float p[6][kFpTile];  // x y z nx ny nz
  float dd[kFpTile];
};

// Async copies of db rows base .. base + kFpTile - 1 below row_end into t;
// rows at or past row_end get zero coordinates and normals and +inf |v|^2.
__device__ __forceinline__ void stage(const float* __restrict__ pts, const float* __restrict__ nrm,
                                      const float* __restrict__ dd, int base, int row_end,
                                      SpfhTile& t) {
  const int rows = min(kFpTile, row_end - base);
  for (int e = threadIdx.x; e < kFpTile * 3; e += kFpThreads) {
    const int r = e / 3, c = e - 3 * r;
    if (r < rows) {
      flsq::cp_async4(&t.p[c][r], pts + 3 * (size_t)base + e);
      flsq::cp_async4(&t.p[3 + c][r], nrm + 3 * (size_t)base + e);
    } else {
      t.p[c][r] = 0.0f;
      t.p[3 + c][r] = 0.0f;
    }
  }
  if (threadIdx.x < kFpTile) {
    const int r = threadIdx.x;
    if (r < rows) {
      flsq::cp_async4(t.dd + r, dd + base + r);
    } else {
      t.dd[r] = INFINITY;
    }
  }
}

__global__ void __launch_bounds__(kFpThreads)
    spfh_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                const float* __restrict__ qq, const float* __restrict__ dd,
                const uint8_t* __restrict__ qmask, const float* __restrict__ th_cs,
                const int* __restrict__ q_end, const int* __restrict__ db_end,
                const float* __restrict__ tbox, int n, int n_tiles, float r2,
                float* __restrict__ out) {
  const size_t cloud = blockIdx.y;
  pts += cloud * n * 3;
  nrm += cloud * n * 3;
  qq += cloud * n;
  dd += cloud * n;
  qmask += cloud * n;
  tbox += cloud * n_tiles * 6;
  out += cloud * n * kFpOut;
  extern __shared__ int s_list[];  // n_tiles
  __shared__ SpfhTile s_t[2];
  __shared__ float s_q[6][kFpBlock];  // the block's query coordinates and normals
  __shared__ float s_cos[kBins + 1], s_sin[kBins + 1];
  __shared__ int s_hist[kFpBlock][kFpOut];
  __shared__ unsigned short s_pair[kFpBlock * kFpTile];  // query row << 5 | db row
  __shared__ float s_pd2[kFpBlock * kFpTile];
  __shared__ int s_hits[kFpThreads / 32];

  const int q0 = blockIdx.x * kFpBlock;
  const int dend = db_end[cloud];
  const int count = flsq::fp_keep_list(pts, qmask, q0, n, q_end[cloud], dend, tbox, r2, s_list);
  if (count <= 0) {
    flsq::fp_store_zero(out, q0, n);
    return;
  }
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const flsq::FpQueries q = flsq::fp_load_queries(pts, qq, qmask, q0, n);
  const int row0 = q0 + warp * kFpRows;  // the distance phase's first row
  int cnt = 0;                           // lane r < kFpRows: the hits of row row0 + r
  for (int e = tid; e < kFpBlock * 3; e += kFpThreads) {
    const int r = e / 3, c = e - 3 * r;
    const bool live = q0 + r < n;
    s_q[c][r] = live ? pts[3 * (size_t)q0 + e] : 0.0f;
    s_q[3 + c][r] = live ? nrm[3 * (size_t)q0 + e] : 0.0f;
  }
  if (tid <= kBins) {
    s_cos[tid] = th_cs[tid];
    s_sin[tid] = th_cs[kBins + 1 + tid];
  }
  for (int e = tid; e < kFpBlock * kFpOut; e += kFpThreads) (&s_hist[0][0])[e] = 0;

  stage(pts, nrm, dd, s_list[0] * kFpTile, dend, s_t[0]);
  flsq::cp_async_commit();
  for (int it = 0; it < count; ++it) {
    const int cur = it & 1;
    if (it + 1 < count) stage(pts, nrm, dd, s_list[it + 1] * kFpTile, dend, s_t[cur ^ 1]);
    flsq::cp_async_commit();  // empty on the last tile: the group count stays uniform
    flsq::cp_async_wait_prior();
    __syncthreads();

    const SpfhTile& t = s_t[cur];
    const int base = s_list[it] * kFpTile;
    const float vx = t.p[0][lane], vy = t.p[1][lane], vz = t.p[2][lane], ddj = t.dd[lane];
    unsigned ballot[kFpRows];
    float d2s[kFpRows];
    int hits = 0;
#pragma unroll
    for (int r = 0; r < kFpRows; ++r) {
      d2s[r] = flsq::expand_d2(q.qq[r], flsq::cross3(q.x[r], q.y[r], q.z[r], vx, vy, vz), ddj);
      const bool in = ((q.ok >> r) & 1u) && d2s[r] <= r2 && base + lane != row0 + r;
      ballot[r] = __ballot_sync(0xffffffffu, in);
      hits += __popc(ballot[r]);
      if (lane == r) cnt += __popc(ballot[r]);
    }
    if (lane == 0) s_hits[warp] = hits;
    __syncthreads();

    int at = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kFpThreads / 32; ++w) {
      at += w < warp ? s_hits[w] : 0;
      total += s_hits[w];
    }
    if (total == 0) continue;  // uniform: no list, no barrier needed before the next tile
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int r = 0; r < kFpRows; ++r) {
      if ((ballot[r] >> lane) & 1u) {
        const int k = at + __popc(ballot[r] & below);
        s_pair[k] = static_cast<unsigned short>(((warp * kFpRows + r) << 5) | lane);
        s_pd2[k] = d2s[r];
      }
      at += __popc(ballot[r]);
    }
    __syncthreads();

    for (int e = tid; e < total; e += kFpThreads) {
      const int i = s_pair[e] >> 5, j = s_pair[e] & 31;
      const float d2 = s_pd2[e];
      const float px = s_q[0][i], py = s_q[1][i], pz = s_q[2][i];
      const float ux = s_q[3][i], uy = s_q[4][i], uz = s_q[5][i];
      const float inv_d = rsqrtf(fmaxf(d2, 1e-12f));
      const float dx = (t.p[0][j] - px) * inv_d;
      const float dy = (t.p[1][j] - py) * inv_d;
      const float dz = (t.p[2][j] - pz) * inv_d;
      const float nqx = t.p[3][j], nqy = t.p[4][j], nqz = t.p[5][j];
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
      atomicAdd(&s_hist[i][ba], 1);
      atomicAdd(&s_hist[i][kBins + bp], 1);
      float sig_lo = ty * s_cos[0] - tx * s_sin[0];
      for (int b = 0; b < kBins; ++b) {
        const float sig_hi = ty * s_cos[b + 1] - tx * s_sin[b + 1];
        if (sig_lo >= 0.0f && sig_hi < 0.0f) atomicAdd(&s_hist[i][2 * kBins + b], 1);
        sig_lo = sig_hi;
      }
    }
    __syncthreads();
  }
  if (lane < kFpRows) s_hist[warp * kFpRows + lane][3 * kBins] = cnt;
  __syncthreads();
  const int rows = min(kFpBlock, n - q0);
  for (int e = tid; e < rows * kFpOut; e += kFpThreads) {
    const int i = e / kFpOut;
    out[(size_t)q0 * kFpOut + e] =
        qmask[q0 + i] ? static_cast<float>((&s_hist[0][0])[e]) : 0.0f;
  }
}

}  // namespace

// The tile boxes (ceil(n / 32), 6) of b clouds, [lo xyz | hi xyz] over the
// points of keep below db_end: the db set of a radius prune (mask for K3;
// mask & n_valid, which K4 and K5 of the same clouds share).  pts (n, 3),
// keep (n,), db_end (b,) int32, every operand (b, ...) contiguous.
FLSQ_API int flsq_fpfh_boxes(const float* pts, const uint8_t* keep, const int* db_end, int b,
                             int n, float* tbox, void* stream) {
  const int n_tiles = flsq::ceil_div(n, kFpTile);
  if (b < 1 || b > 65535 || n < 1 || n_tiles > flsq::kFpMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  flsq::launch_tile_boxes<kFpTile>(pts, keep, db_end, b, n, n_tiles, tbox,
                                   static_cast<cudaStream_t>(stream));
  return flsq::launch_status();
}

// b clouds, each: pts, nrm (n, 3); qq (n,) = |p|^2; dd (n,) = |p|^2 + a
// +3.4e38 penalty on points outside mask & n_valid; qmask (n,) the query
// mask; th_cs (24,) = cos then sin of the 12 theta bin edges (shared by the
// clouds); q_end / db_end (b,) int32 = 1 + the last row of qmask / of
// mask & n_valid (0 if none); tbox (ceil(n / 32), 6) from flsq_fpfh_boxes;
// out (n, 34).  Every operand but th_cs (b, ...) contiguous; 1 <= b <=
// 65535, n <= 32 * 4096.
FLSQ_API int flsq_fpfh_spfh(const float* pts, const float* nrm, const float* qq,
                            const float* dd, const uint8_t* qmask, const float* th_cs,
                            const int* q_end, const int* db_end, const float* tbox, int b, int n,
                            float r2, float* out, void* stream) {
  const int n_tiles = flsq::ceil_div(n, kFpTile);
  if (b < 1 || b > 65535 || n < 1 || n_tiles > flsq::kFpMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(flsq::ceil_div(n, kFpBlock), b);
  spfh_kernel<<<grid, kFpThreads, sizeof(int) * (size_t)n_tiles,
                static_cast<cudaStream_t>(stream)>>>(pts, nrm, qq, dd, qmask, th_cs, q_end,
                                                     db_end, tbox, n, n_tiles, r2, out);
  return flsq::launch_status();
}
