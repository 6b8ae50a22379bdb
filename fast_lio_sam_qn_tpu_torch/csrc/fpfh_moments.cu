// K3 — radius moments at two radii (count, sum x, sum xx^T).
//
// Replaces: fast_lio_sam_qn_tpu/ops/fpfh_stream.py::_moments_kernel
// (launcher _moments_tpu).  For every valid query p (mask), over the points
// v in mask with expanded fp32 d2(p, v) <= r2a (columns 0-9) and <= r2b
// (columns 10-19): [1, x, y, z, xx, xy, xz, yy, yz, zz] summed.  The self
// pair counts, as in the reference.  Masked points carry a +3.4e38 penalty
// in dd and never qualify.
//
// Contract (as K4 / K5, tile_prune.cuh): rows of masked queries are zero,
// blocks past the lane's query extent write zeros and exit, and the db walk
// stops at the lane's db extent.  Nothing downstream reads a masked row's
// moments: moments_to_normals_covs (ops/fpfh_stream.py) zeroes the normal
// unless n_valid = mask & cnt >= 3, gives the identity covariance unless
// n_valid & cnt_c >= 3, and fpfh_radius drops the mean; so every output of
// fpfh_radius is the same as with the unmasked sums.
//
// Bound on the card: after the prune, fp32 issue of the distance tests of
// the kept (block, tile) pairs and 10 adds (up to 6 products) a pair within
// a radius; the operands (x, y, z and |v|^2) are read from L2.  No tensor
// cores: the sums are 0/1-weighted fp32 adds whose chain order is the
// contract below, and TF32 would break the port's strict-fp32 rule.  What
// held the first kernel back: a distance test against all n rows of the
// padded cloud for every query, masked and padding rows included, one
// thread per query in 64-thread CTAs (68 CTAs on 132 SMs at the bench's
// 4,352 rows), and a warp that ran the 20-way accumulate whenever any of
// its scattered queries had a hit.
//
// Design (the CTA layout and the keep rule are tile_prune.cuh's, applied
// at max(r2a, r2b) over the tile boxes of mask): one CTA of 128 threads per
// (block of 32 query rows, cloud).  A block at or past the lane's query
// extent, or with no valid query, writes zero rows and exits.  Otherwise it
// lists the db tiles of 32 rows, below the lane's db extent, that the rule
// keeps, in ascending order, and walks them with the next tile (x, y, z,
// |v|^2) copied by cp.async into the other of two buffers.  For each tile:
// (1) warp w takes query rows 8w .. 8w + 7 and lane j db row j; each pair's
// d2 is flsq::expand_d2 on the wrapper's |q|^2, |v|^2, bit for bit as the
// unpruned kernel had it, and two ballots per row mark the hits at r2a and
// at r2b.  (2) Thread (row i = tid / 4, group g = tid % 4) owns the 5
// accumulators of row i, columns 5g .. 5g + 4, in registers across tiles;
// row i is one of its own warp's rows, so it keeps that row's ballot at
// its radius (g < 2: r2a) in a register and walks its bits in ascending
// order, adding the db row's features with __fadd_rn.  The products are
// formed from the staged coordinates with __fmul_rn, one rounding each, as
// before; the odd groups' five products and the even groups' (1, x, y, z,
// xx) come from one branch-free formula (a factor of 1.0 is exact).
//
// Why the sums keep their order: each (row, column) sum starts at zero and
// adds the same rounded products in ascending db row order, which is the
// chain of the unpruned kernel; a skipped tile holds no hit (the keep
// rule's guarantee) and rows past the db extent are masked.  So on any
// given row order the valid rows equal the unpruned kernel's bit for bit,
// and the result depends on the lane alone.
// Grid-batched (the reference's _stream_caller vmap rule, the lowering at
// fpfh_stream.py:419): blockIdx.y is the cloud and each cloud's operands,
// tile boxes and outputs are one contiguous slab, so a lane runs exactly
// the single-cloud body.
#include "tile_prune.cuh"

namespace {

using flsq::kFpBlock;
using flsq::kFpRows;
using flsq::kFpThreads;
using flsq::kFpTile;

constexpr int kCols = 20;
constexpr int kGroup = 5;  // accumulators a thread owns

struct MomTile {
  float x[kFpTile], y[kFpTile], z[kFpTile], dd[kFpTile];
};

// Async copies of db rows base .. base + kFpTile - 1 below row_end into t;
// rows at or past row_end get zero coordinates and +inf |v|^2.
__device__ __forceinline__ void stage(const float* __restrict__ pts, const float* __restrict__ dd,
                                      int base, int row_end, MomTile& t) {
  const int rows = min(kFpTile, row_end - base);
  for (int e = threadIdx.x; e < kFpTile * 3; e += kFpThreads) {
    const int r = e / 3, c = e - 3 * r;
    float* dst = (c == 0 ? t.x : c == 1 ? t.y : t.z) + r;
    if (r < rows) {
      flsq::cp_async4(dst, pts + 3 * (size_t)base + e);
    } else {
      *dst = 0.0f;
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
    moments_kernel(const float* __restrict__ pts, const float* __restrict__ qq,
                   const float* __restrict__ dd, const uint8_t* __restrict__ qmask,
                   const int* __restrict__ q_end, const int* __restrict__ db_end,
                   const float* __restrict__ tbox, int n, int n_tiles, float r2a, float r2b,
                   float* __restrict__ out) {
  const size_t cloud = blockIdx.y;
  pts += cloud * n * 3;
  qq += cloud * n;
  dd += cloud * n;
  qmask += cloud * n;
  tbox += cloud * n_tiles * 6;
  out += cloud * n * kCols;
  extern __shared__ int s_list[];  // n_tiles
  __shared__ MomTile s_t[2];

  const int q0 = blockIdx.x * kFpBlock;
  const int dend = db_end[cloud];
  const int count = flsq::fp_keep_list(pts, qmask, q0, n, q_end[cloud], dend, tbox,
                                       fmaxf(r2a, r2b), s_list);
  if (count <= 0) {
    flsq::fp_store_zero<kCols>(out, q0, n);
    return;
  }
  const int tid = threadIdx.x, lane = tid % 32;
  const flsq::FpQueries q = flsq::fp_load_queries(pts, qq, qmask, q0, n);
  const int mr = lane / 4;             // the thread's row among its warp's kFpRows
  const int mg = tid % 4;              // its column group: columns 5 mg .. 5 mg + 4
  const bool odd = (mg & 1) != 0;      // xy xz yy yz zz, else 1 x y z xx
  const bool at_b = mg >= 2;           // the cov radius' columns
  float acc[kGroup];
#pragma unroll
  for (int c = 0; c < kGroup; ++c) acc[c] = 0.0f;

  stage(pts, dd, s_list[0] * kFpTile, dend, s_t[0]);
  flsq::cp_async_commit();
  for (int it = 0; it < count; ++it) {
    const int cur = it & 1;
    if (it + 1 < count) stage(pts, dd, s_list[it + 1] * kFpTile, dend, s_t[cur ^ 1]);
    flsq::cp_async_commit();  // empty on the last tile: the group count stays uniform
    flsq::cp_async_wait_prior();
    __syncthreads();

    const MomTile& t = s_t[cur];
    const float vx = t.x[lane], vy = t.y[lane], vz = t.z[lane], ddj = t.dd[lane];
    unsigned hits = 0u;  // the db rows of this tile within the thread's radius of its row
#pragma unroll
    for (int r = 0; r < kFpRows; ++r) {
      const float d2 = flsq::expand_d2(q.qq[r], flsq::cross3(q.x[r], q.y[r], q.z[r], vx, vy, vz),
                                       ddj);
      const bool ok = ((q.ok >> r) & 1u) != 0u;
      const unsigned in_a = __ballot_sync(0xffffffffu, ok && d2 <= r2a);
      const unsigned in_b = __ballot_sync(0xffffffffu, ok && d2 <= r2b);
      if (r == mr) hits = at_b ? in_b : in_a;
    }
    for (; hits != 0u; hits &= hits - 1u) {
      const int j = __ffs(hits) - 1;
      const float x = t.x[j], y = t.y[j], z = t.z[j];
      const float w = odd ? z : x;
      const float f[kGroup] = {__fmul_rn(odd ? x : 1.0f, odd ? y : 1.0f),  // 1  | xy
                               __fmul_rn(x, odd ? z : 1.0f),                // x  | xz
                               __fmul_rn(y, odd ? y : 1.0f),                // y  | yy
                               __fmul_rn(z, odd ? y : 1.0f),                // z  | yz
                               __fmul_rn(w, w)};                            // xx | zz
#pragma unroll
      for (int c = 0; c < kGroup; ++c) acc[c] = __fadd_rn(acc[c], f[c]);
    }
    __syncthreads();
  }
  const int row = q0 + tid / 4;
  if (row >= n) return;
  const bool ok = qmask[row] != 0;
  float* o = out + (size_t)row * kCols + kGroup * mg;
#pragma unroll
  for (int c = 0; c < kGroup; ++c) o[c] = ok ? acc[c] : 0.0f;
}

}  // namespace

// b clouds, each: pts (n, 3); qq (n,) = |p|^2; dd (n,) = |p|^2 + a +3.4e38
// penalty on points outside mask; mask (n,); q_end / db_end (b,) int32 =
// 1 + the last row of mask (0 if none); tbox (ceil(n / 32), 6) the tile
// boxes of mask (flsq_fpfh_boxes); out (n, 20).  Every operand (b, ...)
// contiguous; 1 <= b <= 65535, n <= 32 * 4096.
FLSQ_API int flsq_fpfh_moments(const float* pts, const float* qq, const float* dd,
                               const uint8_t* mask, const int* q_end, const int* db_end,
                               const float* tbox, int b, int n, float r2a, float r2b, float* out,
                               void* stream) {
  const int n_tiles = flsq::ceil_div(n, kFpTile);
  if (b < 1 || b > 65535 || n < 1 || n_tiles > flsq::kFpMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(flsq::ceil_div(n, kFpBlock), b);
  moments_kernel<<<grid, kFpThreads, sizeof(int) * (size_t)n_tiles,
                   static_cast<cudaStream_t>(stream)>>>(pts, qq, dd, mask, q_end, db_end, tbox, n,
                                                        n_tiles, r2a, r2b, out);
  return flsq::launch_status();
}
