// K1 — exact masked brute-force kNN.
//
// Replaces: fast_lio_sam_qn_tpu/ops/pallas_knn.py::_knn_kernel (launcher
// _knn_pallas_tpu), and its batched form (Pallas's vmap rule adds a grid
// axis).  Same result as the reference's XLA path (ops/knn.py::brute_knn):
// d2 = max(|q|^2 - 2 q.v + |v|^2, 0) over valid db rows, the k smallest per
// valid query in ascending order, ties to the lowest db index, (inf, -1) in
// slots without a valid neighbour.  Unlike the Pallas kernel it returns
// exact (d2, idx) pairs: no packed-key quantization, so no cap on the db
// size.
//
// Bound on the card: fp32 FMA issue.  The main path runs k = 1 at F = 33
// (Quatro's mutual-NN descriptor match, both directions): F FMAs per
// (query, db) pair over the valid rows, a few thousand of each, about
// 1.4 GFLOP, with under 2 MB of operands.  What held the first kernel back
// was not the FMA rate: one thread per query in 64-thread CTAs left most of
// the 132 SMs idle at a few thousand queries, each FMA waited on its own
// shared-memory load, and padded rows did full work.
//
// Design, k = 1 (knn_tile.cuh nn_block): 64 query rows per 256-thread CTA,
// register-tiled 4 x 8 per thread, db tiles double-buffered with cp.async.
// Extents: the wrapper passes q_end / db_end, 1 + the last valid row of each
// lane, computed on the device.  A CTA at or past q_end exits; the db walk
// stops at db_end.  Rows past an extent are masked, so this is exact for
// any mask.  When the query grid is small, grid z splits each lane's
// [0, db_end) tiles into `splits` slices (split_lo); each slice writes a
// (d2, idx) partial and merge_slices takes their lexicographic minimum, so
// the result does not depend on the split or on the order CTAs finish.
//
// Design, 1 < k <= 64 (gicp.plane_covariances at k = 15, the kNN FPFH
// backend's shared neighbour search at k = 48 by default, up to 64): one
// thread per query with its sorted top-k in registers (a list of 16, 32
// or 64 slots, the smallest that holds k), db tiles of 128 rows in shared
// memory read as broadcasts, the walk stopped at db_end, blocks past q_end
// skipped.  At 64 slots a thread holds 128 list registers beside qv[FMAX]:
// at F = 3 that is far below the 255-register cap; at F = 33 ptxas may
// spill the list to local memory, which is slower and still exact (the
// build log prints the spill lines).  A candidate is compared with the
// k-th distance first, so after the first tiles almost every pair costs
// F FMAs and one compare; inserts, the list's shifts, are rare.
//
// Grid-batched: blockIdx.y is the cloud; each cloud's operands are one
// contiguous slab, so a lane runs exactly the single-cloud body and gives
// its bits.
#include "knn_tile.cuh"

namespace {

using flsq::kNnBlock;
using flsq::kNnThreads;
using flsq::kNnTile;

// --- k = 1 -------------------------------------------------------------------

template <int FC>
__global__ void __launch_bounds__(kNnThreads, 2)
    knn1_kernel(const float* __restrict__ q, const float* __restrict__ qq,
                const uint8_t* __restrict__ qmask, const float* __restrict__ db,
                const float* __restrict__ dd, const uint8_t* __restrict__ dbmask,
                const int* __restrict__ q_end, const int* __restrict__ db_end, int m, int n,
                int f, float* __restrict__ part_d, int* __restrict__ part_i,
                float* __restrict__ out_d, int* __restrict__ out_i) {
  const size_t lane = blockIdx.y;
  q += lane * m * f;
  qq += lane * m;
  qmask += lane * m;
  db += lane * n * f;
  dd += lane * n;
  dbmask += lane * n;
  out_d += lane * m;
  out_i += lane * m;
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kNnBlock;
  const int qend = q_end[lane];
  if (q0 >= qend) {
    flsq::nn_store_empty(q0, m, out_d, out_i);
    return;
  }
  const int dend = db_end[lane];
  const int tiles = flsq::ceil_div(dend, kNnTile);
  const int t0 = flsq::split_lo(tiles, gridDim.z, blockIdx.z);
  const int t1 = flsq::split_lo(tiles, gridDim.z, blockIdx.z + 1);
  float d;
  int i;
  flsq::nn_block<FC>(q, qq, db, dd, dbmask, m, f, q0, [t0](int t) { return (t0 + t) * kNnTile; },
                     t1 - t0, dend, smem, d, i);
  flsq::nn_store(d, i, q0, m, qend, qmask, out_d, out_i, part_d, part_i);
}

template <int FC>
int launch_k1(const float* q, const float* qq, const uint8_t* qmask, const float* db,
              const float* dd, const uint8_t* dbmask, const int* q_end, const int* db_end,
              int b, int m, int n, int f, int splits, float* part_d, int* part_i,
              float* out_d, int* out_i, cudaStream_t stream) {
  const size_t smem = sizeof(float) * flsq::nn_smem_floats(f);
  static size_t smem_set = 0;
  if (smem > smem_set) {  // above 48 KB only after opting in
    const int st = static_cast<int>(cudaFuncSetAttribute(
        knn1_kernel<FC>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    if (st != 0) return st;
    smem_set = smem;
  }
  const dim3 grid(flsq::ceil_div(m, kNnBlock), b, splits);
  knn1_kernel<FC><<<grid, kNnThreads, smem, stream>>>(q, qq, qmask, db, dd, dbmask, q_end,
                                                      db_end, m, n, f, part_d, part_i, out_d,
                                                      out_i);
  const int st = flsq::launch_status();
  if (st != 0 || splits == 1) return st;
  return flsq::launch_merge(part_d, part_i, qmask, q_end, b, m, splits, out_d, out_i, stream);
}

// --- 1 < k <= 64 ----------------------------------------------------------------

template <int FMAX, int KMAX>
__global__ void knnk_kernel(const float* __restrict__ q, const float* __restrict__ qq,
                            const uint8_t* __restrict__ qmask, const float* __restrict__ db,
                            const float* __restrict__ dd, const uint8_t* __restrict__ dbmask,
                            const int* __restrict__ q_end, const int* __restrict__ db_end, int m,
                            int n, int f, int k, float* __restrict__ out_d,
                            int* __restrict__ out_i) {
  const size_t lane = blockIdx.y;
  q += lane * m * f;
  qq += lane * m;
  qmask += lane * m;
  db += lane * n * f;
  dd += lane * n;
  dbmask += lane * n;
  out_d += lane * m * k;
  out_i += lane * m * k;
  extern __shared__ float smem[];
  float* s_db = smem;                // kNnTile * f
  float* s_dd = smem + kNnTile * f;  // kNnTile, +inf on masked rows
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = row < m;
  const int dend = static_cast<int>(blockIdx.x * blockDim.x) < q_end[lane] ? db_end[lane] : 0;

  float qv[FMAX];
#pragma unroll
  for (int c = 0; c < FMAX; ++c) qv[c] = (live && c < f) ? q[(size_t)row * f + c] : 0.0f;
  const float qqv = live ? qq[row] : 0.0f;

  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    bd[s] = INFINITY;
    bi[s] = -1;
  }
  float worst = INFINITY;

  for (int base = 0; base < dend; base += kNnTile) {
    const int cnt = min(kNnTile, dend - base);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt * f; e += blockDim.x) s_db[e] = db[(size_t)base * f + e];
    for (int e = threadIdx.x; e < cnt; e += blockDim.x)
      s_dd[e] = dbmask[base + e] ? dd[base + e] : INFINITY;
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float ddj = s_dd[j];
      if (ddj == INFINITY) continue;
      const float* v = s_db + j * f;
      float cross = __fmul_rn(qv[0], v[0]);
#pragma unroll
      for (int c = 1; c < FMAX; ++c)
        if (c < f) cross = fmaf(qv[c], v[c], cross);
      flsq::topk_insert(bd, bi, k, worst, fmaxf(flsq::expand_d2(qqv, cross, ddj), 0.0f),
                        base + j);
    }
  }
  if (!live) return;
  const bool qok = qmask[row] != 0;
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (s < k) {
      const bool ok = qok && bd[s] < INFINITY;
      out_d[(size_t)row * k + s] = ok ? bd[s] : INFINITY;
      out_i[(size_t)row * k + s] = ok ? bi[s] : -1;
    }
  }
}

template <int FMAX>
int launch_kn(const float* q, const float* qq, const uint8_t* qmask, const float* db,
              const float* dd, const uint8_t* dbmask, const int* q_end, const int* db_end,
              int b, int m, int n, int f, int k, float* out_d, int* out_i,
              cudaStream_t stream) {
  const dim3 grid(flsq::ceil_div(m, kNnBlock), b);
  const size_t smem = sizeof(float) * (size_t)kNnTile * (f + 1);
  if (k <= 16) {
    knnk_kernel<FMAX, 16><<<grid, kNnBlock, smem, stream>>>(q, qq, qmask, db, dd, dbmask, q_end,
                                                          db_end, m, n, f, k, out_d, out_i);
  } else if (k <= 32) {
    knnk_kernel<FMAX, 32><<<grid, kNnBlock, smem, stream>>>(q, qq, qmask, db, dd, dbmask, q_end,
                                                          db_end, m, n, f, k, out_d, out_i);
  } else {
    knnk_kernel<FMAX, 64><<<grid, kNnBlock, smem, stream>>>(q, qq, qmask, db, dd, dbmask, q_end,
                                                          db_end, m, n, f, k, out_d, out_i);
  }
  return flsq::launch_status();
}

}  // namespace

// b clouds, each: q (m, f), qq (m,) = |q|^2, qmask (m,), db (n, f), dd (n,) = |v|^2,
// dbmask (n,); q_end / db_end (b,) int32: 1 + the last valid row of each lane (0 if
// none); out_d (m, k), out_i (m, k); every operand (b, ...) contiguous.  At k = 1,
// splits (1..8) slices of each lane's db range run on grid z; with splits > 1, part_d /
// part_i are (splits, b, m) scratch.  At k > 1, splits is 1.
// 1 <= b <= 65535, 1 <= f <= 64, 1 <= k <= 64, m >= 1.
FLSQ_API int flsq_knn(const float* q, const float* qq, const uint8_t* qmask, const float* db,
                      const float* dd, const uint8_t* dbmask, const int* q_end,
                      const int* db_end, int b, int m, int n, int f, int k, int splits,
                      float* part_d, int* part_i, float* out_d, int* out_i, void* stream) {
  if (b < 1 || b > 65535 || m < 1 || n < 0 || f < 1 || f > 64 || k < 1 || k > 64 ||
      splits < 1 || splits > flsq::kMaxSplits || (k > 1 && splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1) {
    if (f == 3)
      return launch_k1<3>(q, qq, qmask, db, dd, dbmask, q_end, db_end, b, m, n, f, splits,
                          part_d, part_i, out_d, out_i, s);
    if (f == 33)
      return launch_k1<33>(q, qq, qmask, db, dd, dbmask, q_end, db_end, b, m, n, f, splits,
                           part_d, part_i, out_d, out_i, s);
    return launch_k1<0>(q, qq, qmask, db, dd, dbmask, q_end, db_end, b, m, n, f, splits,
                        part_d, part_i, out_d, out_i, s);
  }
  if (f <= 4)
    return launch_kn<4>(q, qq, qmask, db, dd, dbmask, q_end, db_end, b, m, n, f, k, out_d,
                        out_i, s);
  if (f <= 36)
    return launch_kn<36>(q, qq, qmask, db, dd, dbmask, q_end, db_end, b, m, n, f, k, out_d,
                         out_i, s);
  return launch_kn<64>(q, qq, qmask, db, dd, dbmask, q_end, db_end, b, m, n, f, k, out_d,
                       out_i, s);
}
