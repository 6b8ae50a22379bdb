// K5 — FPFH neighbour aggregation: sum of SPFH(v) / d(p, v) plus a count.
//
// Replaces: fast_lio_sam_qn_tpu/ops/fpfh_stream.py::_fpfh_agg_kernel
// (launcher _fpfh_agg_tpu).  For every valid query p (qmask), over the
// points v != p (by index) in mask & n_valid with d2(p, v) <= r2: out[:33]
// += rsqrt(max(d2, 1e-12)) * spfh[v], out[33] += 1.  The 1e-12 floor on d2
// is the reference's 1e-6 m floor on d.  Rows of masked queries are zero.
// The TPU kernel allowed reduced-precision matmul operands here; this
// kernel accumulates in fp32 FMAs on CUDA cores: TF32 would break the
// port's strict-fp32 rule, and after the prune a cloud's aggregation is
// about 1e8 fp32 flops, microseconds of SIMT FMAs.
//
// Bound on the card: after the prune, fp32 FMA issue and shared-memory
// loads of the kept (block, tile) pairs; the operands (3 + 1 + 33 floats a
// point) are read from L2.  What held the first kernel back: a distance
// test against all n rows of the padded cloud for every query, one thread
// per query in 64-thread CTAs (68 CTAs on 132 SMs at the bench's 4,352
// rows), and a warp that ran the 33-FMA body whenever any of its scattered
// queries had a hit.
//
// Design (the CTA layout and the keep rule are tile_prune.cuh's): one CTA
// of 128 threads per (block of 32 query rows, cloud).  A block at or past
// the lane's query extent, or with no valid query, writes zero rows and
// exits.  Otherwise it lists the db tiles of 32 rows, below the lane's db
// extent, that the radius rule keeps, in ascending order, and walks them
// with the next tile copied by cp.async into the other of two buffers.  For
// each tile: (1) warp w takes query rows 8w .. 8w + 7 and lane j db row j;
// each pair's d2 is flsq::expand_d2 on the wrapper's |q|^2, |v|^2, as the
// unpruned kernel had it, and its weight rsqrt(max(d2, 1e-12)) or 0 goes to
// shared memory; a ballot per row counts the hits exactly, and their union
// marks the db rows that some query of the block hits.  (2) Thread (row i,
// group g) takes the register-tiled product W(32 x 32) @ SPFH(32 x 33) for
// row i and columns 9g .. 9g + 8 over the marked db rows j, ascending, one
// fmaf per (row, column, j).  An unmarked row holds zero weights only, and
// a zero weight adds an exact zero, so every sum is the sparse sum over
// the in-radius pairs in ascending db row order, whatever the block size:
// the result depends on the lane alone (not on B, nor on which warp
// finishes first), and a Morton-sorted cloud, which makes blocks and tiles
// compact, changes it only by that summation order.  A marked row is in
// mask & n_valid, so no row that the plain version never reads enters a
// sum.
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

constexpr int kDim = 33;
constexpr int kGroup = 9;                  // columns a thread of the product
// floats a staged SPFH row: 33, then 3 that feed only group 3's last three
// accumulators, which are never stored
constexpr int kFStride = 4 * kGroup;

struct AggTile {
  float x[kFpTile], y[kFpTile], z[kFpTile], dd[kFpTile];
  float f[kFpTile * kFStride];
};

// Async copies of db rows base .. base + kFpTile - 1 below row_end into t;
// rows at or past row_end get zero coordinates and +inf |v|^2 (no query
// hits them, so their SPFH is never read).
__device__ __forceinline__ void stage(const float* __restrict__ pts, const float* __restrict__ dd,
                                      const float* __restrict__ spfh, int base, int row_end,
                                      AggTile& t) {
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
  for (int e = threadIdx.x; e < rows * kDim; e += kFpThreads) {
    const int r = e / kDim, c = e - kDim * r;
    flsq::cp_async4(t.f + r * kFStride + c, spfh + (size_t)base * kDim + e);
  }
}

__global__ void __launch_bounds__(kFpThreads)
    agg_kernel(const float* __restrict__ pts, const float* __restrict__ qq,
               const float* __restrict__ dd, const uint8_t* __restrict__ qmask,
               const float* __restrict__ spfh, const int* __restrict__ q_end,
               const int* __restrict__ db_end, const float* __restrict__ tbox, int n,
               int n_tiles, float r2, float* __restrict__ out) {
  const size_t cloud = blockIdx.y;
  pts += cloud * n * 3;
  qq += cloud * n;
  dd += cloud * n;
  qmask += cloud * n;
  spfh += cloud * n * kDim;
  tbox += cloud * n_tiles * 6;
  out += cloud * n * kFpOut;
  extern __shared__ int s_list[];  // n_tiles
  __shared__ AggTile s_t[2];
  __shared__ float s_w[kFpTile][kFpBlock + 1];  // [db row j][query row i]
  __shared__ unsigned s_cols[kFpThreads / 32];  // db rows a warp's queries hit
  __shared__ int s_cnt[kFpBlock];

  const int q0 = blockIdx.x * kFpBlock;
  const int dend = db_end[cloud];
  const int count = flsq::fp_keep_list(pts, qmask, q0, n, q_end[cloud], dend, tbox, r2, s_list);
  if (count <= 0) {
    flsq::fp_store_zero(out, q0, n);
    return;
  }
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const flsq::FpQueries q = flsq::fp_load_queries(pts, qq, qmask, q0, n);
  const int row0 = q0 + warp * kFpRows;    // the distance phase's first row
  const int mi = tid / 4, mg = tid % 4;    // the product's row and column group
  float acc[kGroup];
#pragma unroll
  for (int c = 0; c < kGroup; ++c) acc[c] = 0.0f;
  int cnt = 0;  // lane r < kFpRows: the hits of row row0 + r

  stage(pts, dd, spfh, s_list[0] * kFpTile, dend, s_t[0]);
  flsq::cp_async_commit();
  for (int it = 0; it < count; ++it) {
    const int cur = it & 1;
    if (it + 1 < count) stage(pts, dd, spfh, s_list[it + 1] * kFpTile, dend, s_t[cur ^ 1]);
    flsq::cp_async_commit();  // empty on the last tile: the group count stays uniform
    flsq::cp_async_wait_prior();
    __syncthreads();

    AggTile& t = s_t[cur];
    const int base = s_list[it] * kFpTile;
    const float vx = t.x[lane], vy = t.y[lane], vz = t.z[lane], ddj = t.dd[lane];
    unsigned cols = 0u;
#pragma unroll
    for (int r = 0; r < kFpRows; ++r) {
      const float d2 = flsq::expand_d2(q.qq[r], flsq::cross3(q.x[r], q.y[r], q.z[r], vx, vy, vz),
                                       ddj);
      const bool in = ((q.ok >> r) & 1u) && d2 <= r2 && base + lane != row0 + r;
      const unsigned ballot = __ballot_sync(0xffffffffu, in);
      cols |= ballot;
      if (lane == r) cnt += __popc(ballot);
      s_w[lane][warp * kFpRows + r] = in ? rsqrtf(fmaxf(d2, 1e-12f)) : 0.0f;
    }
    if (lane == 0) s_cols[warp] = cols;
    __syncthreads();

    unsigned marked = 0u;  // the same in every thread
#pragma unroll
    for (int w = 0; w < kFpThreads / 32; ++w) marked |= s_cols[w];
    const float* f = t.f + kGroup * mg;
    for (; marked != 0u; marked &= marked - 1u) {
      const int j = __ffs(marked) - 1;
      const float w = s_w[j][mi];
#pragma unroll
      for (int c = 0; c < kGroup; ++c) acc[c] = fmaf(w, f[j * kFStride + c], acc[c]);
    }
    __syncthreads();
  }
  if (lane < kFpRows) s_cnt[warp * kFpRows + lane] = cnt;
  __syncthreads();
  const int row = q0 + mi;
  if (row >= n) return;
  const bool ok = qmask[row] != 0;
  float* o = out + (size_t)row * kFpOut;
#pragma unroll
  for (int c = 0; c < kGroup; ++c) {
    const int col = kGroup * mg + c;
    if (col < kDim) o[col] = ok ? acc[c] : 0.0f;
  }
  if (mg == 3) o[kDim] = ok ? static_cast<float>(s_cnt[mi]) : 0.0f;
}

}  // namespace

// b clouds, each: pts (n, 3); qq (n,) = |p|^2; dd (n,) = |p|^2 + a +3.4e38
// penalty on points outside mask & n_valid; qmask (n,) the query mask; spfh
// (n, 33); q_end / db_end (b,) int32 = 1 + the last row of qmask / of mask &
// n_valid (0 if none); tbox (ceil(n / 32), 6) the tile boxes of mask &
// n_valid (flsq_fpfh_boxes); out (n, 34).  Every operand (b, ...)
// contiguous; 1 <= b <= 65535, n <= 32 * 4096.
FLSQ_API int flsq_fpfh_agg(const float* pts, const float* qq, const float* dd,
                           const uint8_t* qmask, const float* spfh, const int* q_end,
                           const int* db_end, const float* tbox, int b, int n, float r2,
                           float* out, void* stream) {
  const int n_tiles = flsq::ceil_div(n, kFpTile);
  if (b < 1 || b > 65535 || n < 1 || n_tiles > flsq::kFpMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(flsq::ceil_div(n, kFpBlock), b);
  agg_kernel<<<grid, kFpThreads, sizeof(int) * (size_t)n_tiles,
               static_cast<cudaStream_t>(stream)>>>(pts, qq, dd, qmask, spfh, q_end, db_end,
                                                    tbox, n, n_tiles, r2, out);
  return flsq::launch_status();
}
