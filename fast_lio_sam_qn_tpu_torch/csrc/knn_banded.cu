// K2 — exact masked kNN with bbox tile pruning, over Morton-sorted clouds.
//
// Replaces: fast_lio_sam_qn_tpu/ops/pallas_knn.py::_knn_kernel_banded
// (launcher _knn_banded_tpu via _banded_caller), together with the keep
// bitmap the reference builds outside its kernel (_tile_bboxes,
// _block_tile_keep).  Returns exactly what K1 (knn.cu) returns on the same
// inputs, for k <= 32 and 3-d points; the prune skips work only when both
// clouds are Morton-sorted, so that query blocks and db tiles are compact.
//
// Keep rule (pallas_knn._block_tile_keep), per query block b of kBlock rows
// and db tile t of kTile rows: md2(b, t) is the largest squared distance
// between the two bboxes, g2(b, t) the smallest; with kth(b) the k-th
// smallest md2(b, .) over the tiles, tile t is searched iff
// g2(b, t) <= kth(b) * 1.03.  Every non-empty tile holds a valid point
// within md2 of every query of the block, so k distinct tiles bound each
// query's k-th neighbour distance, and a skipped tile holds none of the k
// nearest.  Empty tiles carry inverted infinite bounds and are never
// searched (unless fewer than k tiles are non-empty: then kth is infinite
// and every tile is searched, as in the reference).
//
// Bound on the card: at the main path's k = 1, F = 3 the pairs that the
// keep rule admits are a few million, tens of microseconds of fp32 issue.
// What held the first kernel back was latency: one thread per query in
// 64-thread CTAs (68 CTAs on 132 SMs at the bench's 4,352 query rows), each
// walking all of its block's kept tiles alone, one __syncthreads() per
// tile whether kept or not.
//
// Design: two launches on one stream.  (1) tile_bbox_kernel (tile_prune.cuh,
// shared with K4 and K5): one warp per db tile reduces its valid points to
// [lo xyz | hi xyz]; tiles past the lane's db_end are empty and are not
// read.  (2) the search, one CTA per (query block, lane, slice).  A block
// at or past the lane's q_end, or with no valid query, writes (inf, -1)
// and exits.  Otherwise the CTA reduces
// its valid queries to a bbox, takes md2 / g2 against the tile boxes and
// the k-th bound as above.
//
//   k = 1 (knn_tile.cuh nn_block, K1's tiled body at F = 3): 256 threads.
//   Only the tiles below db_end are scored (a tile past it is empty, with
//   md2 = g2 = +inf, so the minimum and the keep flags do not change).  The
//   kept tiles are compacted, in ascending order, into a list in shared
//   memory with a warp-ballot prefix sum (tile_prune.cuh
//   compact_ascending), so a skipped tile costs no barrier.  Grid z
//   splits the list into `splits` slices (split_lo); all 8 warps search
//   each kept tile, and merge_slices takes the lexicographic minimum of
//   the slices' (d2, idx) partials.
//
//   1 < k <= 32: one thread per query as K1's k > 1 path, over every tile
//   box for the k-th bound (the reference's rule as it is), then the kept
//   tiles below db_end in order, with the same sorted insert.
//
// Every surviving pair gives K1's bits, and a skipped tile holds none of
// the nearest, so K2 equals K1 bit for bit.
//
// Grid-batched (the reference's _banded_caller vmap rule, the lowering at
// pallas_knn.py:469): both launches take blockIdx.y as the cloud, and each
// cloud's operands, tile boxes and outputs are one contiguous slab.  A
// lane's keep decisions read that lane's boxes only, so a lane runs
// exactly the single-cloud body and gives its bits.
#include "knn_tile.cuh"
#include "tile_prune.cuh"

namespace {

using flsq::kNnBlock;
using flsq::kNnThreads;
using flsq::kNnTile;
using flsq::warp_min;

constexpr int kMaxTiles = 4096;
constexpr int kMaxWarps = kNnThreads / 32;

// md2: the largest, g2: the smallest squared distance between the block's
// box and tile t's box (pallas_knn._block_tile_keep).
__device__ __forceinline__ void tile_bounds(const float* __restrict__ tbox, int t,
                                            const float (&blo)[3], const float (&bhi)[3],
                                            float& md2, float& g2) {
  md2 = 0.0f;
  g2 = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float tlo = tbox[6 * (size_t)t + c], thi = tbox[6 * (size_t)t + 3 + c];
    const float e = fmaxf(fabsf(__fsub_rn(thi, blo[c])), fabsf(__fsub_rn(bhi[c], tlo)));
    const float gap = fmaxf(fmaxf(__fsub_rn(tlo, bhi[c]), __fsub_rn(blo[c], thi)), 0.0f);
    md2 = __fadd_rn(md2, __fmul_rn(e, e));
    g2 = __fadd_rn(g2, __fmul_rn(gap, gap));
  }
}

// --- k = 1 -------------------------------------------------------------------

__global__ void __launch_bounds__(kNnThreads, 2)
    banded1_kernel(const float* __restrict__ q, const float* __restrict__ qq,
                   const uint8_t* __restrict__ qmask, const float* __restrict__ db,
                   const float* __restrict__ dd, const uint8_t* __restrict__ dbmask,
                   const int* __restrict__ q_end, const int* __restrict__ db_end,
                   const float* __restrict__ tbox, int m, int n, int n_tiles,
                   float* __restrict__ part_d, int* __restrict__ part_i,
                   float* __restrict__ out_d, int* __restrict__ out_i) {
  const size_t cloud = blockIdx.y;
  q += cloud * m * 3;
  qq += cloud * m;
  qmask += cloud * m;
  db += cloud * n * 3;
  dd += cloud * n;
  dbmask += cloud * n;
  tbox += cloud * n_tiles * 6;
  out_d += cloud * m;
  out_i += cloud * m;
  extern __shared__ float smem[];
  int* s_list = reinterpret_cast<int*>(smem + flsq::nn_smem_floats(3));  // n_tiles
  __shared__ float s_min[kMaxWarps];

  const int q0 = blockIdx.x * kNnBlock;
  const int qend = q_end[cloud];
  if (q0 >= qend) {
    flsq::nn_store_empty(q0, m, out_d, out_i);
    return;
  }
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row = q0 + tid;
  const bool qok = tid < kNnBlock && row < m && qmask[row] != 0;
  float blo[3], bhi[3];
  if (!flsq::block_bbox<2>(qok, qok ? q[3 * (size_t)row] : 0.0f,
                           qok ? q[3 * (size_t)row + 1] : 0.0f,
                           qok ? q[3 * (size_t)row + 2] : 0.0f, blo, bhi)) {
    flsq::nn_store_empty(q0, m, out_d, out_i);
    return;
  }
  const int live = flsq::ceil_div(db_end[cloud], kNnTile);

  // kth = the smallest md2 over the tiles
  float local_min = INFINITY;
  for (int t = tid; t < live; t += kNnThreads) {
    float md2, g2;
    tile_bounds(tbox, t, blo, bhi, md2, g2);
    local_min = fminf(local_min, md2);
  }
  local_min = warp_min(local_min);
  if (lane == 0) s_min[warp] = local_min;
  __syncthreads();
  float kth = s_min[0];
#pragma unroll
  for (int w = 1; w < kMaxWarps; ++w) kth = fminf(kth, s_min[w]);
  const float bound = __fmul_rn(kth, flsq::kPruneSlack);

  // the kept tiles, compacted in ascending order
  const int count = flsq::compact_ascending<kNnThreads>(
      live,
      [&](int t) {
        float md2, g2;
        tile_bounds(tbox, t, blo, bhi, md2, g2);
        return g2 <= bound;
      },
      s_list);

  const int i0 = flsq::split_lo(count, gridDim.z, blockIdx.z);
  const int i1 = flsq::split_lo(count, gridDim.z, blockIdx.z + 1);
  float d;
  int i;
  flsq::nn_block<3>(q, qq, db, dd, dbmask, m, 3, q0,
                    [s_list, i0](int t) { return s_list[i0 + t] * kNnTile; }, i1 - i0,
                    db_end[cloud], smem, d, i);
  flsq::nn_store(d, i, q0, m, qend, qmask, out_d, out_i, part_d, part_i);
}

// --- 1 < k <= 32 ----------------------------------------------------------------

template <int KMAX>
__global__ void __launch_bounds__(kNnBlock)
    bandedk_kernel(const float* __restrict__ q, const float* __restrict__ qq,
                   const uint8_t* __restrict__ qmask, const float* __restrict__ db,
                   const float* __restrict__ dd, const uint8_t* __restrict__ dbmask,
                   const int* __restrict__ q_end, const int* __restrict__ db_end,
                   const float* __restrict__ tbox, int m, int n, int n_tiles, int k,
                   float* __restrict__ out_d, int* __restrict__ out_i) {
  const size_t cloud = blockIdx.y;
  q += cloud * m * 3;
  qq += cloud * m;
  qmask += cloud * m;
  db += cloud * n * 3;
  dd += cloud * n;
  dbmask += cloud * n;
  tbox += cloud * n_tiles * 6;
  out_d += cloud * m * k;
  out_i += cloud * m * k;
  extern __shared__ float smem[];
  float* s_db = smem;                  // kNnTile * 3
  float* s_dd = s_db + kNnTile * 3;    // kNnTile, +inf on masked rows
  float* s_md2 = s_dd + kNnTile;       // n_tiles
  float* s_g2 = s_md2 + n_tiles;       // n_tiles, then 1 / 0 = keep
  __shared__ float s_kth;

  const int row = blockIdx.x * kNnBlock + threadIdx.x;
  const bool live = row < m;
  const bool qok = live && qmask[row] != 0;
  const float qx = live ? q[3 * (size_t)row] : 0.0f;
  const float qy = live ? q[3 * (size_t)row + 1] : 0.0f;
  const float qz = live ? q[3 * (size_t)row + 2] : 0.0f;
  const float qqv = live ? qq[row] : 0.0f;

  float blo[3], bhi[3];
  const bool past = static_cast<int>(blockIdx.x) * kNnBlock >= q_end[cloud];
  if (past || !flsq::block_bbox<2>(qok, qx, qy, qz, blo, bhi)) {
    if (live)  // past the extent or no valid query in the block: nothing to search
      for (int s = 0; s < k; ++s) {
        out_d[(size_t)row * k + s] = INFINITY;
        out_i[(size_t)row * k + s] = -1;
      }
    return;
  }

  // md2 / g2 of every tile against the block, and the k-th smallest md2
  for (int t = threadIdx.x; t < n_tiles; t += kNnBlock) tile_bounds(tbox, t, blo, bhi,
                                                                    s_md2[t], s_g2[t]);
  const int kk = min(k, n_tiles);
  __syncthreads();
  // the value at sorted position kk - 1: fewer than kk strictly below it,
  // at least kk at or below it (every thread that finds it writes it)
  for (int t = threadIdx.x; t < n_tiles; t += kNnBlock) {
    const float v = s_md2[t];
    int below = 0, at_or_below = 0;
    for (int u = 0; u < n_tiles; ++u) {
      const float w = s_md2[u];
      below += w < v;
      at_or_below += w <= v;
    }
    if (below <= kk - 1 && kk - 1 < at_or_below) s_kth = v;
  }
  __syncthreads();
  const float bound = __fmul_rn(s_kth, flsq::kPruneSlack);
  for (int t = threadIdx.x; t < n_tiles; t += kNnBlock) s_g2[t] = s_g2[t] <= bound ? 1.0f : 0.0f;

  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    bd[s] = INFINITY;
    bi[s] = -1;
  }
  float worst = INFINITY;

  const int dend = db_end[cloud];
  for (int t = 0; t * kNnTile < dend; ++t) {
    __syncthreads();
    if (s_g2[t] == 0.0f) continue;  // uniform across the CTA
    const int base = t * kNnTile;
    const int cnt = min(kNnTile, dend - base);
    for (int e = threadIdx.x; e < cnt * 3; e += kNnBlock) s_db[e] = db[(size_t)base * 3 + e];
    for (int e = threadIdx.x; e < cnt; e += kNnBlock)
      s_dd[e] = dbmask[base + e] ? dd[base + e] : INFINITY;
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float ddj = s_dd[j];
      if (ddj == INFINITY) continue;
      const float* v = s_db + j * 3;
      const float cross = flsq::cross3(qx, qy, qz, v[0], v[1], v[2]);
      flsq::topk_insert(bd, bi, k, worst, fmaxf(flsq::expand_d2(qqv, cross, ddj), 0.0f),
                        base + j);
    }
  }
  if (!live) return;
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (s < k) {
      const bool ok = qok && bd[s] < INFINITY;
      out_d[(size_t)row * k + s] = ok ? bd[s] : INFINITY;
      out_i[(size_t)row * k + s] = ok ? bi[s] : -1;
    }
  }
}

}  // namespace

// b clouds, each: q (m, 3), qq (m,) = |q|^2, qmask (m,), db (n, 3), dd (n,) = |v|^2,
// dbmask (n,); q_end / db_end (b,) int32: 1 + the last valid row of each lane (0 if
// none); tbox (ceil(n / 128), 6) scratch; out_d (m, k), out_i (m, k); every operand
// (b, ...) contiguous.  At k = 1, splits (1..8) slices of each query block's kept tiles
// run on grid z; with splits > 1, part_d / part_i are (splits, b, m) scratch.  At k > 1,
// splits is 1.  1 <= b <= 65535, 1 <= k <= 32, m >= 1, n <= 128 * 4096.
FLSQ_API int flsq_knn_banded(const float* q, const float* qq, const uint8_t* qmask,
                             const float* db, const float* dd, const uint8_t* dbmask,
                             const int* q_end, const int* db_end, int b, int m, int n, int k,
                             int splits, float* tbox, float* part_d, int* part_i, float* out_d,
                             int* out_i, void* stream) {
  const int n_tiles = flsq::ceil_div(n, kNnTile);
  if (b < 1 || b > 65535 || m < 1 || n < 0 || k < 1 || k > 32 || n_tiles > kMaxTiles ||
      splits < 1 || splits > flsq::kMaxSplits || (k > 1 && splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  flsq::launch_tile_boxes<kNnTile>(db, dbmask, db_end, b, n, n_tiles, tbox, s);
  if (k == 1) {
    const dim3 grid(flsq::ceil_div(m, kNnBlock), b, splits);
    const size_t smem = sizeof(float) * (flsq::nn_smem_floats(3) + (size_t)n_tiles);
    banded1_kernel<<<grid, kNnThreads, smem, s>>>(q, qq, qmask, db, dd, dbmask, q_end, db_end,
                                                  tbox, m, n, n_tiles, part_d, part_i, out_d,
                                                  out_i);
    const int st = flsq::launch_status();
    if (st != 0 || splits == 1) return st;
    return flsq::launch_merge(part_d, part_i, qmask, q_end, b, m, splits, out_d, out_i, s);
  }
  const dim3 grid(flsq::ceil_div(m, kNnBlock), b);
  const size_t smem = sizeof(float) * ((size_t)kNnTile * 4 + 2 * (size_t)n_tiles);
  if (k <= 16) {
    bandedk_kernel<16><<<grid, kNnBlock, smem, s>>>(q, qq, qmask, db, dd, dbmask, q_end, db_end,
                                                    tbox, m, n, n_tiles, k, out_d, out_i);
  } else {
    bandedk_kernel<32><<<grid, kNnBlock, smem, s>>>(q, qq, qmask, db, dd, dbmask, q_end, db_end,
                                                    tbox, m, n, n_tiles, k, out_d, out_i);
  }
  return flsq::launch_status();
}
