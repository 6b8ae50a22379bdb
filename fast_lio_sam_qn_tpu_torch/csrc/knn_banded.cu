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
// Bound on the card: K1 at the slice's shapes (M ~4-16k queries, N ~5-32k
// db rows, k = 1) does fp32 work on every (query, db) pair and fills the
// 132 SMs with only M / 64 CTAs.  After the prune a CTA searches a few
// tiles; what is left is its prologue (a bbox reduction and the k-th bound
// over all n_tiles tile boxes) and the db loads of the kept tiles.
//
// Design: two launches on one stream.  (1) tile_bbox_kernel: one warp per
// db tile reduces its valid points to [lo xyz | hi xyz].  (2)
// knn_banded_kernel: one CTA per query block, one thread per query, as K1.
// The CTA reduces its valid queries to a bbox with warp shuffles, writes
// md2 and g2 against every tile box to shared memory, takes kth (a block
// min for k = 1, a rank count otherwise) and marks the kept tiles.  A block
// with no valid query writes (inf, -1) and exits.  The tile loop is K1's
// (same expansion, same strict-insert top-k, db index order), over the kept
// tiles only, so every surviving pair gives K1's bits.
//
// Grid-batched (the reference's _banded_caller vmap rule, the lowering at
// pallas_knn.py:469): both launches take blockIdx.y as the cloud, and each
// cloud's operands, tile boxes and outputs are one contiguous slab.  A
// lane's keep decisions read that lane's boxes only, so a lane runs
// exactly the single-cloud body and gives its bits.
#include "common.cuh"

namespace {

constexpr int kBlock = 64;   // query rows per CTA = one query block
constexpr int kTile = 128;   // db rows per tile (as K1's shared tile)
constexpr int kMaxTiles = 4096;
constexpr float kSlack = 1.03f;  // pallas_knn._PRUNE_SLACK

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// tbox (n_tiles, 6): [lo x, lo y, lo z, hi x, hi y, hi z] over the tile's
// valid points; +inf / -inf when the tile has none.
__global__ void tile_bbox_kernel(const float* __restrict__ db, const uint8_t* __restrict__ dbmask,
                                 int n, int n_tiles, float* __restrict__ tbox) {
  const size_t lane_b = blockIdx.y;
  db += lane_b * n * 3;
  dbmask += lane_b * n;
  tbox += lane_b * n_tiles * 6;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= n_tiles) return;
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int r = warp * kTile + lane; r < min(n, (warp + 1) * kTile); r += 32) {
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

template <int KMAX>
__global__ void __launch_bounds__(kBlock)
    knn_banded_kernel(const float* __restrict__ q, const float* __restrict__ qq,
                      const uint8_t* __restrict__ qmask, const float* __restrict__ db,
                      const float* __restrict__ dd, const uint8_t* __restrict__ dbmask,
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
  float* s_db = smem;                  // kTile * 3
  float* s_dd = s_db + kTile * 3;      // kTile, +inf on masked rows
  float* s_md2 = s_dd + kTile;         // n_tiles
  float* s_g2 = s_md2 + n_tiles;       // n_tiles, then 1 / 0 = keep
  __shared__ float s_red[2][6];
  __shared__ float s_kth;
  __shared__ int s_any;

  const int row = blockIdx.x * kBlock + threadIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool live = row < m;
  const bool qok = live && qmask[row] != 0;
  const float qx = live ? q[3 * (size_t)row] : 0.0f;
  const float qy = live ? q[3 * (size_t)row + 1] : 0.0f;
  const float qz = live ? q[3 * (size_t)row + 2] : 0.0f;
  const float qqv = live ? qq[row] : 0.0f;

  // the block's bbox over its valid queries
  if (threadIdx.x == 0) s_any = 0;
  float b[6] = {qok ? qx : INFINITY,  qok ? qy : INFINITY,  qok ? qz : INFINITY,
                qok ? qx : -INFINITY, qok ? qy : -INFINITY, qok ? qz : -INFINITY};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    b[c] = warp_min(b[c]);
    b[3 + c] = warp_max(b[3 + c]);
  }
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) s_red[warp][c] = b[c];
  }
  if (qok) s_any = 1;
  __syncthreads();
  if (!s_any) {  // no valid query in the block: nothing to search
    if (live)
      for (int s = 0; s < k; ++s) {
        out_d[(size_t)row * k + s] = INFINITY;
        out_i[(size_t)row * k + s] = -1;
      }
    return;
  }
  float blo[3], bhi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    blo[c] = fminf(s_red[0][c], s_red[1][c]);
    bhi[c] = fmaxf(s_red[0][3 + c], s_red[1][3 + c]);
  }

  // md2 / g2 of every tile against the block, and the k-th smallest md2
  float local_min = INFINITY;
  for (int t = threadIdx.x; t < n_tiles; t += kBlock) {
    float md2 = 0.0f, g2 = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float tlo = tbox[6 * (size_t)t + c], thi = tbox[6 * (size_t)t + 3 + c];
      const float e = fmaxf(fabsf(__fsub_rn(thi, blo[c])), fabsf(__fsub_rn(bhi[c], tlo)));
      const float gap = fmaxf(fmaxf(__fsub_rn(tlo, bhi[c]), __fsub_rn(blo[c], thi)), 0.0f);
      md2 = __fadd_rn(md2, __fmul_rn(e, e));
      g2 = __fadd_rn(g2, __fmul_rn(gap, gap));
    }
    s_md2[t] = md2;
    s_g2[t] = g2;
    local_min = fminf(local_min, md2);
  }
  const int kk = min(k, n_tiles);
  if (kk <= 1) {
    local_min = warp_min(local_min);
    __syncthreads();
    if (lane == 0) s_red[warp][0] = local_min;
    __syncthreads();
    if (threadIdx.x == 0) s_kth = fminf(s_red[0][0], s_red[1][0]);
  } else {
    __syncthreads();
    // the value at sorted position kk - 1: fewer than kk strictly below it,
    // at least kk at or below it (every thread that finds it writes it)
    for (int t = threadIdx.x; t < n_tiles; t += kBlock) {
      const float v = s_md2[t];
      int below = 0, at_or_below = 0;
      for (int u = 0; u < n_tiles; ++u) {
        const float w = s_md2[u];
        below += w < v;
        at_or_below += w <= v;
      }
      if (below <= kk - 1 && kk - 1 < at_or_below) s_kth = v;
    }
  }
  __syncthreads();
  const float bound = __fmul_rn(s_kth, kSlack);
  for (int t = threadIdx.x; t < n_tiles; t += kBlock) s_g2[t] = s_g2[t] <= bound ? 1.0f : 0.0f;

  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    bd[s] = INFINITY;
    bi[s] = -1;
  }
  float worst = INFINITY;

  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    if (s_g2[t] == 0.0f) continue;  // uniform across the CTA
    const int base = t * kTile;
    const int cnt = min(kTile, n - base);
    for (int e = threadIdx.x; e < cnt * 3; e += kBlock) s_db[e] = db[(size_t)base * 3 + e];
    for (int e = threadIdx.x; e < cnt; e += kBlock)
      s_dd[e] = dbmask[base + e] ? dd[base + e] : INFINITY;
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float ddj = s_dd[j];
      if (ddj == INFINITY) continue;
      const float* v = s_db + j * 3;
      const float cross = flsq::cross3(qx, qy, qz, v[0], v[1], v[2]);
      const float d2 = fmaxf(flsq::expand_d2(qqv, cross, ddj), 0.0f);
      if (d2 < worst) {
        float cd = d2;
        int ci = base + j;
        bool shifting = false;
#pragma unroll
        for (int s = 0; s < KMAX; ++s) {
          if (s < k && (shifting || cd < bd[s])) {
            const float td = bd[s];
            const int ti = bi[s];
            bd[s] = cd;
            bi[s] = ci;
            cd = td;
            ci = ti;
            shifting = true;
          }
        }
#pragma unroll
        for (int s = 0; s < KMAX; ++s)
          if (s == k - 1) worst = bd[s];
      }
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
// dbmask (n,); tbox (ceil(n / 128), 6) scratch; out_d (m, k), out_i (m, k); every
// operand (b, ...) contiguous.  1 <= b <= 65535, 1 <= k <= 32, m >= 1, n <= 128 * 4096.
FLSQ_API int flsq_knn_banded(const float* q, const float* qq, const uint8_t* qmask,
                             const float* db, const float* dd, const uint8_t* dbmask, int b,
                             int m, int n, int k, float* tbox, float* out_d, int* out_i,
                             void* stream) {
  const int n_tiles = flsq::ceil_div(n, kTile);
  if (b < 1 || b > 65535 || m < 1 || n < 0 || k < 1 || k > 32 || n_tiles > kMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles > 0) {
    const int threads = 256;
    const dim3 boxes(flsq::ceil_div(n_tiles * 32, threads), b);
    tile_bbox_kernel<<<boxes, threads, 0, s>>>(db, dbmask, n, n_tiles, tbox);
  }
  const dim3 grid(flsq::ceil_div(m, kBlock), b);
  const size_t smem = sizeof(float) * ((size_t)kTile * 4 + 2 * (size_t)n_tiles);
  if (k <= 1) {
    knn_banded_kernel<1><<<grid, kBlock, smem, s>>>(q, qq, qmask, db, dd, dbmask, tbox, m, n,
                                                     n_tiles, k, out_d, out_i);
  } else if (k <= 16) {
    knn_banded_kernel<16><<<grid, kBlock, smem, s>>>(q, qq, qmask, db, dd, dbmask, tbox, m, n,
                                                      n_tiles, k, out_d, out_i);
  } else {
    knn_banded_kernel<32><<<grid, kBlock, smem, s>>>(q, qq, qmask, db, dd, dbmask, tbox, m, n,
                                                      n_tiles, k, out_d, out_i);
  }
  return flsq::launch_status();
}
