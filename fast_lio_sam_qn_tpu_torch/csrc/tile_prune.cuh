// The bbox prune that K2 (knn_banded.cu), K3 (fpfh_moments.cu), K4
// (fpfh_spfh.cu) and K5 (fpfh_agg.cu) share: per-tile boxes of the valid db
// points, the box of a query block's valid rows, and the ascending list of
// the tiles a block keeps, compacted with a warp-ballot prefix sum so that
// a skipped tile costs no barrier.  K2 applies its k-th-bound rule to these
// pieces; the FPFH kernels apply the radius rule below and share their CTA
// layout.
//
// Radius keep rule (K3, K4, K5).  For a query block b (the box of its valid
// queries) and a db tile t (the box of its points in the kernel's db set:
// mask for K3, at the larger of its two radii; mask & n_valid for K4, K5):
//
//   keep(b, t) = tile t non-empty and
//                g2(b, t) <= r2 * 1.03 + 2^-19 * (far2(b) + far2(t))
//
// with g2 the smallest squared gap between the two boxes and far2(box) =
// sum_c max(lo_c^2, hi_c^2), the largest |p|^2 of a point in the box.  Every
// pair (q, v) of the block and the tile has a true squared distance >= the
// true g2.  A pair is in radius when its expanded fp32 d2 = (|q|^2 - 2 q.v)
// + |v|^2 (common.cuh expand_d2, with |q|^2 and |v|^2 rounded by the
// wrapper) is <= r2, and that d2 is below the true squared distance by at
// most about 12 u (|q|^2 + |v|^2) (u = 2^-24: the two norms, the
// three-term cross product and the two adds each round once).  The second
// term, 2^-19 = 32 u, bounds that for every pair of the block and the tile;
// the factor 1.03 (K2's PRUNE_SLACK) covers the rounding of g2 itself.  So
// no pair whose d2 passes the radius test is ever skipped, also 500 m from
// the origin where the expansion's error is ~0.5 m^2; the reference's bare
// g2 <= r2 (fpfh_stream.py _tile_overlaps) can drop such a pair.  The Python
// model is ops/fpfh_stream.py radius_tile_keep.
#pragma once

#include "common.cuh"

namespace flsq {

constexpr float kPruneSlack = 1.03f;        // pallas_knn._PRUNE_SLACK
constexpr float kD2Err = 1.9073486328125e-06f;  // 2^-19

// The FPFH kernels' CTA: kFpThreads threads own kFpBlock query rows; warp w
// owns rows kFpRows w .. + kFpRows - 1 in the distance phase, where lane j
// takes db row j of a kFpTile-row tile.
constexpr int kFpBlock = 32;
constexpr int kFpTile = 32;
constexpr int kFpThreads = 128;
constexpr int kFpRows = kFpBlock / (kFpThreads / 32);
constexpr int kFpOut = 34;  // 33 histogram / descriptor columns and a count
constexpr int kFpMaxTiles = 4096;

static __device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static __device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// tbox (n_tiles, 6): [lo x, lo y, lo z, hi x, hi y, hi z] over the valid
// points of each TILE-row tile; +inf / -inf when the tile has none.  Rows
// past db_end are masked and not read.  One warp a tile, grid y the cloud.
template <int TILE>
static __global__ void tile_bbox_kernel(const float* __restrict__ db,
                                        const uint8_t* __restrict__ dbmask,
                                        const int* __restrict__ db_end, int n, int n_tiles,
                                        float* __restrict__ tbox) {
  const size_t lane_b = blockIdx.y;
  db += lane_b * n * 3;
  dbmask += lane_b * n;
  tbox += lane_b * n_tiles * 6;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= n_tiles) return;
  const int end = min(db_end[lane_b], (warp + 1) * TILE);
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int r = warp * TILE + lane; r < end; r += 32) {
    if (!dbmask[r]) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = db[3 * (size_t)r + c];
      lo[c] = fminf(lo[c], v);
      hi[c] = fmaxf(hi[c], v);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lo[c] = warp_min(lo[c]);
    hi[c] = warp_max(hi[c]);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      tbox[6 * (size_t)warp + c] = lo[c];
      tbox[6 * (size_t)warp + 3 + c] = hi[c];
    }
  }
}

// b clouds' tile boxes in one launch (nothing to do without tiles).
template <int TILE>
static inline void launch_tile_boxes(const float* db, const uint8_t* dbmask, const int* db_end,
                                     int b, int n, int n_tiles, float* tbox, cudaStream_t s) {
  if (n_tiles < 1) return;
  const int threads = 256;
  const dim3 grid(ceil_div(n_tiles * 32, threads), b);
  tile_bbox_kernel<TILE><<<grid, threads, 0, s>>>(db, dbmask, db_end, n, n_tiles, tbox);
}

// The bbox of the block's valid queries, held by the threads of warps
// 0 .. ROW_WARPS - 1 (qok: the thread's row is valid), reduced over those
// warps into blo / bhi; returns whether any query is valid.  Every thread
// of the CTA calls it.
template <int ROW_WARPS>
static __device__ bool block_bbox(bool qok, float qx, float qy, float qz, float (&blo)[3],
                                  float (&bhi)[3]) {
  __shared__ float s_red[ROW_WARPS][6];
  __shared__ int s_any;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (threadIdx.x == 0) s_any = 0;
  float b[6] = {qok ? qx : INFINITY,  qok ? qy : INFINITY,  qok ? qz : INFINITY,
                qok ? qx : -INFINITY, qok ? qy : -INFINITY, qok ? qz : -INFINITY};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    b[c] = warp_min(b[c]);
    b[3 + c] = warp_max(b[3 + c]);
  }
  __syncthreads();
  if (lane == 0 && warp < ROW_WARPS) {
#pragma unroll
    for (int c = 0; c < 6; ++c) s_red[warp][c] = b[c];
  }
  if (qok) s_any = 1;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    blo[c] = s_red[0][c];
    bhi[c] = s_red[0][3 + c];
#pragma unroll
    for (int w = 1; w < ROW_WARPS; ++w) {
      blo[c] = fminf(blo[c], s_red[w][c]);
      bhi[c] = fmaxf(bhi[c], s_red[w][3 + c]);
    }
  }
  return s_any != 0;
}

// The units u < units for which keep(u) holds, in ascending order, into
// s_list; returns how many (the same in every thread).  Every thread of a
// CTA of THREADS threads calls it.
template <int THREADS, class Keep>
static __device__ int compact_ascending(int units, Keep keep, int* s_list) {
  constexpr int kWarps = THREADS / 32;
  __shared__ int s_cnt[kWarps];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int count = 0;
  for (int t0 = 0; t0 < units; t0 += THREADS) {
    const int t = t0 + tid;
    const bool k = t < units && keep(t);
    const unsigned ballot = __ballot_sync(0xffffffffu, k);
    __syncthreads();  // s_cnt of the previous round is read
    if (lane == 0) s_cnt[warp] = __popc(ballot);
    __syncthreads();
    int at = count + __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? s_cnt[w] : 0;
      count += s_cnt[w];
    }
    if (k) s_list[at] = t;
  }
  __syncthreads();
  return count;
}

// sum_c max(lo_c^2, hi_c^2): the largest |p|^2 of a point in the box
static __device__ __forceinline__ float box_far2(const float* lo, const float* hi) {
  float f = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    f = __fadd_rn(f, fmaxf(__fmul_rn(lo[c], lo[c]), __fmul_rn(hi[c], hi[c])));
  return f;
}

// The radius keep rule above for tile t of tbox against the block's box
// (blo, bhi), far2_b = box_far2 of the block, r2s = r2 * kPruneSlack.
static __device__ __forceinline__ bool radius_keep(const float* __restrict__ tbox, int t,
                                                   const float (&blo)[3], const float (&bhi)[3],
                                                   float far2_b, float r2s) {
  const float* lo = tbox + 6 * (size_t)t;
  const float* hi = lo + 3;
  if (!(lo[0] <= hi[0])) return false;  // no valid point
  float g2 = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float gap = fmaxf(fmaxf(__fsub_rn(lo[c], bhi[c]), __fsub_rn(blo[c], hi[c])), 0.0f);
    g2 = __fadd_rn(g2, __fmul_rn(gap, gap));
  }
  return g2 <= __fadd_rn(r2s, __fmul_rn(kD2Err, __fadd_rn(far2_b, box_far2(lo, hi))));
}

// The FPFH kernels' prologue for the query block of kFpBlock rows from q0:
// -1 when the block is at or past the lane's query extent or holds no
// valid query (the caller writes zero rows and returns), else the number
// of kept tiles below the db extent, listed ascending in s_list.  Every
// thread of the CTA calls it.
static __device__ int fp_keep_list(const float* __restrict__ pts, const uint8_t* __restrict__ qmask,
                                   int q0, int n, int q_end, int db_end,
                                   const float* __restrict__ tbox, float r2, int* s_list) {
  if (q0 >= q_end) return -1;
  const int row = q0 + threadIdx.x;
  const bool qok = threadIdx.x < kFpBlock && row < n && qmask[row] != 0;
  float blo[3], bhi[3];
  if (!block_bbox<kFpBlock / 32>(qok, qok ? pts[3 * (size_t)row] : 0.0f,
                                 qok ? pts[3 * (size_t)row + 1] : 0.0f,
                                 qok ? pts[3 * (size_t)row + 2] : 0.0f, blo, bhi))
    return -1;
  const float far2_b = box_far2(blo, bhi);
  const float r2s = __fmul_rn(r2, kPruneSlack);
  return compact_ascending<kFpThreads>(
      ceil_div(db_end, kFpTile),
      [&](int t) { return radius_keep(tbox, t, blo, bhi, far2_b, r2s); }, s_list);
}

// Zero rows q0 .. q0 + kFpBlock - 1 (below n) of an (n, COLS) output.
template <int COLS = kFpOut>
static __device__ __forceinline__ void fp_store_zero(float* __restrict__ out, int q0, int n) {
  const int rows = min(kFpBlock, n - q0);
  for (int e = threadIdx.x; e < rows * COLS; e += kFpThreads) out[(size_t)q0 * COLS + e] = 0.0f;
}

// The query rows of this thread's warp in the distance phase: coordinates,
// |q|^2, and a bit per row that is valid (below n and in the mask).
struct FpQueries {
  float x[kFpRows], y[kFpRows], z[kFpRows], qq[kFpRows];
  unsigned ok;
};

static __device__ __forceinline__ FpQueries fp_load_queries(const float* __restrict__ pts,
                                                            const float* __restrict__ qq,
                                                            const uint8_t* __restrict__ qmask,
                                                            int q0, int n) {
  FpQueries q;
  q.ok = 0u;
  const int first = q0 + (threadIdx.x / 32) * kFpRows;
#pragma unroll
  for (int r = 0; r < kFpRows; ++r) {
    const int row = first + r;
    const bool live = row < n;
    q.x[r] = live ? pts[3 * (size_t)row] : 0.0f;
    q.y[r] = live ? pts[3 * (size_t)row + 1] : 0.0f;
    q.z[r] = live ? pts[3 * (size_t)row + 2] : 0.0f;
    q.qq[r] = live ? qq[row] : 0.0f;
    if (live && qmask[row] != 0) q.ok |= 1u << r;
  }
  return q;
}

}  // namespace flsq
