// K7 — the IESKF's IMU propagation over one scan.
//
// Replaces: fast_lio_sam_qn_tpu/ops/ieskf.py::propagate (:143), whose per-sample
// step is a lax.scan (ieskf.py:199) that XLA fuses into one loop, and its
// tail to t_end (ieskf.py:202-232).  The port's plain version
// (ops/ieskf.py::propagate_plain) walks the K samples in a Python loop of
// ~33 launches each.
//
// What the wrapper computes in torch, batched and state-free, exactly as
// the plain version does (ops/ieskf.py::_state_free): per sample the step
// dt, the bias-corrected acceleration a_c, the rotation increment rot =
// Exp(w_c dt), the transition's state-free blocks F_free and the process
// noise diagonal q; and the tail's (the last sample's a_c, dt_tail, its
// rotation, F_free and q; the IMU-dropout flag).  The wrapper packs the
// per-sample rows and the tail's into one (K + 1)-row table, the tail as
// row K.  This kernel runs the state-dependent chain, sample after sample,
// in one CTA:
//
//   a_w = R a_c + g        (the tail: 0 under IMU dropout)
//   R' = R rot,  p' = p + v dt + 0.5 a_w dt dt,  v' = v + a_w dt
//   F = F_free with dv/dtheta = -(R hat(a_c)) dt and dv/dba = -R dt
//   P' = F P F^T + diag(q)
//   the masked select (a masked sample keeps the state: it is skipped)
//   the log row (R, p, v) of every sample, masked or not
//
// Arithmetic: the library builds with --fmad=false.  The elementwise steps
// keep the plain version's grouping, one rounding an op, as torch's eager
// kernels.  The products (R @ a, R @ rot, R @ hat(a), and the D x D F @ P
// and (F P) @ F^T) sum in the order of the cuBLAS kernels that torch's @
// runs for them on the H100, read from their outputs (64 or more random
// products of each shape and layout, every entry equal): k in tiles (2
// for R @ a and the 3x3 products, 8 for F @ P, 4 for (F P) @ F^T), each
// tile an ascending chain (its first product rounded, then fmaf), the
// tiles' sums added in order; zeros of hat(a) and of F included (a
// skipped zero term could flip a zero's sign).  diag(q) is added to every
// entry, 0 off the diagonal, as the plain version adds the dense
// diag_embed.  So the kernel equals the plain version bit for bit where
// cuBLAS keeps those kernels; chip_smoke.py reports the largest difference
// and holds it within PROPAGATE_TOL.
//
// Bound on the card: per sample 2 D^3 FMAs (F P F^T: 23,328 at D = 18,
// 55,296 at D = 24) and ~120 ops of nav state; the bytes are the tables
// (K + 1 rows of D^2 + D + 15 floats) and the outputs, read and written
// once.  Both are microseconds' worth spread over the card, but the chain
// is sequential in the samples and one scan is one CTA on one SM, so a
// launch is latency-bound: 3 barriers a sample.  Design: D x D threads,
// one a P entry (rounded up to whole warps); P, F and F P in shared
// memory; the per-sample table staged into shared memory once at the
// start; each thread prefetches its entry of the next sample's F_free into
// a register while the current sample runs; thread 0 updates the nav
// state while the others form F P.
#include "common.cuh"

namespace {

// per-sample table row: [dt, a_c (3), rot (9), q (D)]; mask apart
template <int D>
struct Row {
  static constexpr int kDt = 0, kA = 1, kRot = 4, kQ = 13, kSize = 13 + D;
};

// sum over k < N of a[k sa] b[k sb] in the order of torch's @ on the card:
// k in tiles of T, each tile an ascending chain (its first product rounded,
// then fmaf), the tiles' sums added in order
template <int N, int T>
__device__ __forceinline__ float dot(const float* a, int sa, const float* b, int sb) {
  float total = 0.0f;
#pragma unroll
  for (int t0 = 0; t0 < N; t0 += T) {
    float acc = __fmul_rn(a[t0 * sa], b[t0 * sb]);
#pragma unroll
    for (int k = t0 + 1; k < (t0 + T < N ? t0 + T : N); ++k) acc = fmaf(a[k * sa], b[k * sb], acc);
    total = t0 == 0 ? acc : __fadd_rn(total, acc);
  }
  return total;
}

// the tiles of cuBLAS's kernels for the products of the plain version, read
// from its outputs on the card (chip_smoke.py holds K7 to it bit for bit):
// 3x3 @ (3,) and 3x3 @ 3x3 tiles of 2; D x D @ D x D tiles of 8; D x D @
// (D x D)^T tiles of 4
constexpr int kMv = 2, kMm3 = 2, kMm = 8, kMmT = 4;

// one thread a P entry, rounded up to whole warps
template <int D>
constexpr int kThreadsFor = (D * D + 31) / 32 * 32;

template <int D>
__global__ void __launch_bounds__(kThreadsFor<D>)
    propagate_kernel(const float* __restrict__ R0, const float* __restrict__ p0,
                     const float* __restrict__ v0, const float* __restrict__ grav,
                     const float* __restrict__ P0, const uint8_t* __restrict__ mask,
                     const float* __restrict__ table, const float* __restrict__ F_free,
                     const uint8_t* __restrict__ any_imu, int K, float* __restrict__ out) {
  constexpr int DD = D * D;
  constexpr int kV = 6, kTh = 0, kBa = 12;  // error-state blocks: dv, dtheta, dba
  using RowD = Row<D>;
  extern __shared__ float smem[];
  float* sP = smem;
  float* sF = sP + DD;
  float* sT = sF + DD;
  float* sNav = sT + DD;  // R (9), p (3), v (3), g (3)
  float* sTab = sNav + 18;
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sTab + (K + 1) * RowD::kSize);

  const int tid = threadIdx.x;
  const int r = tid / D, c = tid - (tid / D) * D;
  const bool owner = tid < DD;
  for (int e = tid; e < DD; e += blockDim.x) sP[e] = P0[e];
  for (int e = tid; e < (K + 1) * RowD::kSize; e += blockDim.x) sTab[e] = table[e];
  for (int e = tid; e < K; e += blockDim.x) sMask[e] = mask[e];
  if (tid < 9) sNav[tid] = R0[tid];
  if (tid < 3) {
    sNav[9 + tid] = p0[tid];
    sNav[12 + tid] = v0[tid];
    sNav[15 + tid] = grav[tid];
  }
  const bool dropout = any_imu[0] == 0;
  float ff = owner ? F_free[tid] : 0.0f;
  __syncthreads();

  float* logR = out + 15 + DD;
  float* logp = logR + 9 * K;
  float* logv = logp + 3 * K;
  for (int i = 0; i <= K; ++i) {
    const bool tail = i == K;
    const float f_here = ff;
    if (owner && i < K) ff = F_free[(size_t)(i + 1) * DD + tid];  // the next step's entry
    if (tail || sMask[i]) {
      const float* row = sTab + i * RowD::kSize;
      const float dt = row[RowD::kDt];
      const float* a = row + RowD::kA;
      const float* R = sNav;
      // F: its state-free entry, or one of the two blocks that depend on R
      if (owner) {
        float f = f_here;
        if (r >= kV && r < kV + 3 && c >= kTh && c < kTh + 3) {
          const float hat[9] = {0.0f, -a[2], a[1], a[2], 0.0f, -a[0], -a[1], a[0], 0.0f};
          f = __fmul_rn(-dot<3, kMm3>(R + 3 * (r - kV), 1, hat + (c - kTh), 3), dt);
        } else if (r >= kV && r < kV + 3 && c >= kBa && c < kBa + 3) {
          f = __fmul_rn(-R[3 * (r - kV) + (c - kBa)], dt);
        }
        sF[tid] = f;
      }
      __syncthreads();
      if (tid == 0) {
        // the nav state: every read of the old R above is behind the barrier
        const float* rot = row + RowD::kRot;
        float aw[3], Rn[9];
#pragma unroll
        for (int x = 0; x < 3; ++x)
          aw[x] = (tail && dropout) ? 0.0f
                                    : __fadd_rn(dot<3, kMv>(R + 3 * x, 1, a, 1), sNav[15 + x]);
#pragma unroll
        for (int x = 0; x < 3; ++x)
#pragma unroll
          for (int y = 0; y < 3; ++y) Rn[3 * x + y] = dot<3, kMm3>(R + 3 * x, 1, rot + y, 3);
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          const float p = sNav[9 + x], v = sNav[12 + x];
          sNav[9 + x] = p + v * dt + 0.5f * aw[x] * dt * dt;
          sNav[12 + x] = v + aw[x] * dt;
        }
#pragma unroll
        for (int e = 0; e < 9; ++e) sNav[e] = Rn[e];
      }
      if (owner) sT[tid] = dot<D, kMm>(sF + r * D, 1, sP + c, D);
      __syncthreads();
      if (owner) {
        const float* q = row + RowD::kQ;
        sP[tid] = __fadd_rn(dot<D, kMmT>(sT + r * D, 1, sF + c * D, 1), r == c ? q[r] : 0.0f);
      }
      __syncthreads();
    }
    if (!tail && tid < 15) {
      const float x = sNav[tid];
      if (tid < 9) logR[9 * i + tid] = x;
      else if (tid < 12) logp[3 * i + tid - 9] = x;
      else logv[3 * i + tid - 12] = x;
    }
  }
  if (tid < 15) out[tid] = sNav[tid];
  if (owner) out[15 + tid] = sP[tid];
}

template <int D>
int launch(const float* R0, const float* p0, const float* v0, const float* grav, const float* P0,
           const uint8_t* mask, const float* table, const float* F_free, const uint8_t* any_imu,
           int K, float* out, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (3 * D * D + 18 + (size_t)(K + 1) * Row<D>::kSize) + (size_t)K;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        propagate_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  propagate_kernel<D><<<1, kThreadsFor<D>, smem, stream>>>(R0, p0, v0, grav, P0, mask, table,
                                                            F_free, any_imu, K, out);
  return flsq::launch_status();
}

}  // namespace

// One scan, error-state dimension D = 18 or 24, K >= 1 samples.  R0 (3, 3),
// p0, v0, grav (3,), P0 (D, D); mask (K,) bool; table (K + 1, 13 + D) rows
// [dt, a_c, rot (3x3), q (D)], row K the tail's (a_c the last sample's
// under any IMU); F_free (K + 1, D, D), row K the tail's; any_imu (1,)
// bool.  out: R, p, v at t_end (15), P at t_end (D * D), then the log's R
// (K, 9), p (K, 3), v (K, 3).  Every operand fp32 and contiguous.
FLSQ_API int flsq_propagate(const float* R0, const float* p0, const float* v0, const float* grav,
                            const float* P0, const uint8_t* mask, const float* table,
                            const float* F_free, const uint8_t* any_imu, int K, int dim,
                            float* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dim == 18) return launch<18>(R0, p0, v0, grav, P0, mask, table, F_free, any_imu, K, out, s);
  if (dim == 24) return launch<24>(R0, p0, v0, grav, P0, mask, table, F_free, any_imu, K, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
