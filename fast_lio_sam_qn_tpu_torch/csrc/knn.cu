// K1 — exact masked brute-force kNN.
//
// Replaces: fast_lio_sam_qn_tpu/ops/pallas_knn.py::_knn_kernel (launcher
// _knn_pallas_tpu).  Same result as the reference's XLA path
// (ops/knn.py::brute_knn): d2 = max(|q|^2 - 2 q.v + |v|^2, 0) over valid db
// rows, the k smallest per valid query in ascending order, ties to the
// lowest db index, (inf, -1) in slots without a valid neighbour.  Unlike the
// Pallas kernel it returns exact (d2, idx) pairs: no packed-key
// quantization, so no cap on the db size.
//
// Bound on the card: fp32 FMA issue.  Each (query, db) pair costs F FMAs
// plus a compare; the db is re-read from L2 by every block, which at these
// sizes (db <= 32k rows of <= 33 floats, 4.3 MB) stays in the 50 MB L2.
//
// Design: one thread per query, the query row and its sorted top-k held in
// registers (F and k are template bounds, loops fully unrolled); db tiles
// of 128 rows are staged in shared memory and read as broadcasts (every
// thread of the block reads the same address).  Grid-batched: blockIdx.y
// is the cloud (the counterpart of the reference's batched lowering, which
// Pallas's vmap rule gives a leading grid axis); each cloud's operands are
// one contiguous slab, so a lane runs exactly the single-cloud body and
// gives its bits.  Masked db rows are flagged
// with an infinite |v|^2 in shared memory and skipped.  A candidate enters
// the list only if strictly smaller than the current k-th, and is bubbled
// in front of strictly larger entries only, so equal distances keep db
// index order.
#include "common.cuh"

namespace {

constexpr int kBlock = 64;
constexpr int kTile = 128;

template <int FMAX, int KMAX>
__global__ void knn_kernel(const float* __restrict__ q, const float* __restrict__ qq,
                           const uint8_t* __restrict__ qmask, const float* __restrict__ db,
                           const float* __restrict__ dd, const uint8_t* __restrict__ dbmask,
                           int m, int n, int f, int k, float* __restrict__ out_d,
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
  float* s_db = smem;               // kTile * f
  float* s_dd = smem + kTile * f;   // kTile, +inf on masked rows
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = row < m;

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

  for (int base = 0; base < n; base += kTile) {
    const int cnt = min(kTile, n - base);
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
int launch_f(const float* q, const float* qq, const uint8_t* qmask, const float* db,
             const float* dd, const uint8_t* dbmask, int b, int m, int n, int f, int k,
             float* out_d, int* out_i, cudaStream_t stream) {
  const dim3 grid(flsq::ceil_div(m, kBlock), b);
  const size_t smem = sizeof(float) * (size_t)kTile * (f + 1);
  if (k <= 1) {
    knn_kernel<FMAX, 1><<<grid, kBlock, smem, stream>>>(q, qq, qmask, db, dd, dbmask, m, n, f,
                                                        k, out_d, out_i);
  } else if (k <= 16) {
    knn_kernel<FMAX, 16><<<grid, kBlock, smem, stream>>>(q, qq, qmask, db, dd, dbmask, m, n,
                                                         f, k, out_d, out_i);
  } else {
    knn_kernel<FMAX, 32><<<grid, kBlock, smem, stream>>>(q, qq, qmask, db, dd, dbmask, m, n,
                                                         f, k, out_d, out_i);
  }
  return flsq::launch_status();
}

}  // namespace

// b clouds, each: q (m, f), qq (m,) = |q|^2, qmask (m,), db (n, f), dd (n,) = |v|^2,
// dbmask (n,); out_d (m, k), out_i (m, k); every operand (b, ...) contiguous.
// 1 <= b <= 65535, 1 <= f <= 64, 1 <= k <= 32, m >= 1.
FLSQ_API int flsq_knn(const float* q, const float* qq, const uint8_t* qmask, const float* db,
                      const float* dd, const uint8_t* dbmask, int b, int m, int n, int f, int k,
                      float* out_d, int* out_i, void* stream) {
  if (b < 1 || b > 65535 || m < 1 || n < 0 || f < 1 || f > 64 || k < 1 || k > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f <= 4) return launch_f<4>(q, qq, qmask, db, dd, dbmask, b, m, n, f, k, out_d, out_i, s);
  if (f <= 36)
    return launch_f<36>(q, qq, qmask, db, dd, dbmask, b, m, n, f, k, out_d, out_i, s);
  return launch_f<64>(q, qq, qmask, db, dd, dbmask, b, m, n, f, k, out_d, out_i, s);
}
