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
// 1 < k <= 64 (gicp.plane_covariances at k = 15, the kNN FPFH backend's
// shared neighbour search at k = 48, both self-searches of a voxelized
// cloud, a few thousand valid rows of up to 32,768).  What bounds it:
// chip_smoke.py's knn_bound counts 2F + 2 flops a valid pair and the
// operand and output bytes, about 3-4 us at 5,045 rows and F = 3, by the
// output bytes at k = 48 (M k 8 bytes, the padding included).  Selection
// is work the bound does not count: a candidate that beats the running
// k-th is queued and sorted.  The first kernel ran one thread a query, 64
// to a CTA: at 5,045 queries two warps on 79 of the 132 SMs, each thread
// walking every db row as one dependent chain and shifting a 64-slot list
// in 128 registers (151-255 registers a thread, no room to add warps).
//
// Design, k > 1 (knnk_warp_kernel; knn_tile.cuh sel_*): one warp a query,
// 8 queries a CTA, so 5,045 queries are 5,045 warps.  The CTA stages db
// tiles ([c][row], 1,024 rows at F = 3, 256 at F = 33, 128 otherwise)
// with cp.async, double-buffered, and skips the walk when none of its
// queries is valid; the walk stops at db_end.  Lanes stride over a tile,
// one row each a step, with the pair arithmetic of the other kernels
// (__fmul_rn, fmaf in c order, expand_d2, the clamp at 0).  A candidate
// that beats the list's k-th pair enters its lane's queue of kSelQ; when a
// queue fills, the warp sorts all queues and merges them into its sorted
// list of 32 KL pairs, KL = 1 or 2 registers a lane (WarpSelect).  Every
// comparison is lexicographic on (d2, idx), so the list is the k smallest
// pairs whatever the walk's order and wherever the queues flush: d2 sorted
// ascending, ties to the lower db index, (inf, -1) in slots without a
// valid neighbour and on masked queries, bit for bit the plain version's.
// No atomics: a launch repeats bit for bit.  A row with +inf |v|^2 (masked,
// or past the extent) never enters.  The list and queue take at most 12
// registers a lane where the old list took 128; ptxas spills nothing (chip_smoke.py
// logs each instantiation).
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

using flsq::kSelIdle;
using flsq::kSelQ;

constexpr int kSelWarps = 8;                   // queries (one a warp) per CTA
constexpr int kSelThreads = 32 * kSelWarps;

// db rows per tile: two buffers of F x (rows + 4) floats stay near 70 KB at
// F = 33 and 64, so three CTAs share an SM; F = 3 takes longer tiles (fewer
// barriers)
template <int FC>
__host__ __device__ constexpr int sel_rows() {
  return FC == 3 ? 1024 : FC == 33 ? 256 : 128;
}

template <int FC>
size_t sel_smem_bytes(int f) {
  const int stride = sel_rows<FC>() + 4;
  return sizeof(float) * (2 * (size_t)f * stride + 2 * sel_rows<FC>() +
                          (FC > 0 ? 0 : (size_t)kSelWarps * f));
}

template <int FC, int KL>
__global__ void __launch_bounds__(kSelThreads, FC == 3 ? 3 : 2)
    knnk_warp_kernel(const float* __restrict__ q, const float* __restrict__ qq,
                     const uint8_t* __restrict__ qmask, const float* __restrict__ db,
                     const float* __restrict__ dd, const uint8_t* __restrict__ dbmask,
                     const int* __restrict__ q_end, const int* __restrict__ db_end, int m, int n,
                     int f, int k, float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int ROWS = sel_rows<FC>();
  constexpr int STRIDE = ROWS + 4;
  constexpr int PER = (ROWS + kSelThreads - 1) / kSelThreads;  // |v|^2 rows a thread stages
  const size_t lane = blockIdx.y;
  q += lane * m * f;
  qq += lane * m;
  qmask += lane * m;
  db += lane * n * f;
  dd += lane * n;
  dbmask += lane * n;
  out_d += lane * m * k;
  out_i += lane * m * k;
  const int F = FC > 0 ? FC : f;
  extern __shared__ float smem[];
  float* s_db = smem;                   // [2][F][STRIDE]
  float* s_dd = s_db + 2 * F * STRIDE;  // [2][ROWS], +inf on masked rows
  const int tid = threadIdx.x, ln = tid & 31, w = tid >> 5;
  const int row = blockIdx.x * kSelWarps + w;
  // a warp searches for its query only if it is valid and inside the extent
  const bool live = row < q_end[lane] && qmask[row] != 0;
  const int dend = __syncthreads_or(live) ? db_end[lane] : 0;

  float qv[FC > 0 ? FC : 1];
  float* s_q = s_dd + 2 * ROWS + w * f;  // [kSelWarps][f] when F is not compiled in
  if constexpr (FC > 0) {
#pragma unroll
    for (int c = 0; c < FC; ++c) qv[c] = live ? q[(size_t)row * FC + c] : 0.0f;
  } else {
    for (int c = ln; c < f; c += 32) s_q[c] = live ? q[(size_t)row * f + c] : 0.0f;
    __syncwarp();
  }
  const float qqv = live ? qq[row] : 0.0f;

  float ld[KL], qd[kSelQ];  // the list, the queue
  int li[KL], qi[kSelQ];
#pragma unroll
  for (int r = 0; r < KL; ++r) {
    ld[r] = INFINITY;
    li[r] = kSelIdle;
  }
#pragma unroll
  for (int r = 0; r < kSelQ; ++r) {
    qd[r] = INFINITY;
    qi[r] = kSelIdle;
  }
  int queued = 0;
  float kd = INFINITY;  // the list's k-th pair
  int ki = kSelIdle;
  // the next tile's |v|^2, +inf where masked or out of range: loaded before
  // a tile's search, stored to shared memory after it
  float nxt[PER];
  const int tiles = flsq::ceil_div(dend, ROWS);
  if (tiles > 0) {
    flsq::stage_tile<FC, ROWS, STRIDE, kSelThreads>(db, f, 0, dend, s_db);
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int r = tid + p * kSelThreads;
      if (r < ROWS) s_dd[r] = r < dend && dbmask[r] != 0 ? dd[r] : INFINITY;
    }
  }
  flsq::cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1;
    const int base = t * ROWS;
    const bool more = t + 1 < tiles;
    if (more) {
      flsq::stage_tile<FC, ROWS, STRIDE, kSelThreads>(db, f, base + ROWS, dend,
                                                      s_db + (cur ^ 1) * F * STRIDE);
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int o = tid + p * kSelThreads, r = base + ROWS + o;
        nxt[p] = o < ROWS && r < dend && dbmask[r] != 0 ? dd[r] : INFINITY;
      }
    }
    flsq::cp_async_commit();  // empty when !more: the group count stays uniform
    flsq::cp_async_wait_prior();
    __syncthreads();

    if (live) {
      const float* sd = s_db + cur * F * STRIDE;
      const float* sdd = s_dd + cur * ROWS;
      const int rounds = flsq::ceil_div(min(ROWS, dend - base), 32);
      for (int s = 0; s < rounds; ++s) {
        const int j = s * 32 + ln;
        const float ddj = sdd[j];
        float cross;
        if constexpr (FC > 0) {
          cross = __fmul_rn(qv[0], sd[j]);
#pragma unroll
          for (int c = 1; c < FC; ++c) cross = fmaf(qv[c], sd[c * STRIDE + j], cross);
        } else {
          cross = __fmul_rn(s_q[0], sd[j]);
          for (int c = 1; c < f; ++c) cross = fmaf(s_q[c], sd[c * STRIDE + j], cross);
        }
        const float d2 = fmaxf(flsq::expand_d2(qqv, cross, ddj), 0.0f);
        const int idx = base + j;
        if (ddj != INFINITY && d2 < INFINITY && flsq::lex_less(d2, idx, kd, ki)) {
#pragma unroll
          for (int r = kSelQ - 1; r > 0; --r) {
            qd[r] = qd[r - 1];
            qi[r] = qi[r - 1];
          }
          qd[0] = d2;
          qi[0] = idx;
          ++queued;
        }
        if (__any_sync(0xffffffffu, queued == kSelQ))
          flsq::sel_flush<KL>(ld, li, qd, qi, queued, k, kd, ki);
      }
    }
    if (more) {
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int r = tid + p * kSelThreads;
        if (r < ROWS) s_dd[(cur ^ 1) * ROWS + r] = nxt[p];
      }
    }
    __syncthreads();
  }
  if (live && __any_sync(0xffffffffu, queued > 0))
    flsq::sel_flush<KL>(ld, li, qd, qi, queued, k, kd, ki);

  if (row >= m) return;
#pragma unroll
  for (int r = 0; r < KL; ++r) {
    const int s = 32 * r + ln;
    if (s < k) {
      const bool ok = live && ld[r] < INFINITY;
      out_d[(size_t)row * k + s] = ok ? ld[r] : INFINITY;
      out_i[(size_t)row * k + s] = ok ? li[r] : -1;
    }
  }
}

template <int FC, int KL>
int launch_kw(const float* q, const float* qq, const uint8_t* qmask, const float* db,
              const float* dd, const uint8_t* dbmask, const int* q_end, const int* db_end,
              int b, int m, int n, int f, int k, float* out_d, int* out_i,
              cudaStream_t stream) {
  const size_t smem = sel_smem_bytes<FC>(f);
  static size_t smem_set = 0;
  if (smem > smem_set) {  // above 48 KB only after opting in
    const int st = static_cast<int>(cudaFuncSetAttribute(
        knnk_warp_kernel<FC, KL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (st != 0) return st;
    smem_set = smem;
  }
  const dim3 grid(flsq::ceil_div(m, kSelWarps), b);
  knnk_warp_kernel<FC, KL><<<grid, kSelThreads, smem, stream>>>(
      q, qq, qmask, db, dd, dbmask, q_end, db_end, m, n, f, k, out_d, out_i);
  return flsq::launch_status();
}

template <int FC>
int launch_kn(const float* q, const float* qq, const uint8_t* qmask, const float* db,
              const float* dd, const uint8_t* dbmask, const int* q_end, const int* db_end,
              int b, int m, int n, int f, int k, float* out_d, int* out_i,
              cudaStream_t stream) {
  if (k <= 32)
    return launch_kw<FC, 1>(q, qq, qmask, db, dd, dbmask, q_end, db_end, b, m, n, f, k, out_d,
                            out_i, stream);
  return launch_kw<FC, 2>(q, qq, qmask, db, dd, dbmask, q_end, db_end, b, m, n, f, k, out_d,
                          out_i, stream);
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
  if (f == 3)
    return launch_kn<3>(q, qq, qmask, db, dd, dbmask, q_end, db_end, b, m, n, f, k, out_d,
                        out_i, s);
  if (f == 33)
    return launch_kn<33>(q, qq, qmask, db, dd, dbmask, q_end, db_end, b, m, n, f, k, out_d,
                         out_i, s);
  return launch_kn<0>(q, qq, qmask, db, dd, dbmask, q_end, db_end, b, m, n, f, k, out_d,
                      out_i, s);
}
