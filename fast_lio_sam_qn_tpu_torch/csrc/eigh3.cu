// K6 — cyclic-Jacobi eigendecomposition of symmetric 3x3 matrices.
//
// Replaces: fast_lio_sam_qn_tpu/ops/linalg3.py::eigh3_soa (and eigh3 over
// it), whose six sweeps are a lax.fori_loop of elementwise ops that XLA
// fuses into one loop kernel.  The port's plain version
// (ops/linalg3.py::eigh3_soa_plain) runs the same arithmetic one torch op
// at a time: 6 sweeps x 3 rotations unroll into ~750 elementwise launches
// a solve, which is what the surfel refit, the FPFH normals and the plane
// covariances paid on the card.
//
// Contract: six struct-of-arrays fp32 components a00, a01, a02, a11, a12,
// a22 of n matrices, each read at its own element stride (the refit passes
// column views such as cov[:, 0]); out (12, n) contiguous: rows 0-2 the
// eigenvalues ascending, rows 3 + 3 i + j the component i of eigenvector j.
//
// Arithmetic: op for op the plain version's, so the result equals it bit
// for bit on the card.  The library builds with --fmad=false, so every *
// and + below rounds on its own, as torch's eager elementwise kernels do;
// the expressions keep the plain version's left-to-right grouping; theta,
// c and s come from atan2f, cosf and sinf (CUDA's precise math library, as
// torch's ::atan2 / ::cos / ::sin of a float); the rotation order (0, 1),
// (0, 2), (1, 2) and the stable 3-way rank pick (ties to the lower index,
// later picks overwriting earlier ones, zero where no rank matches) are the
// plain version's.
//
// Bound on the card: 72 bytes a matrix (6 floats in, 12 out) against ~1,000
// fp32 operations (18 rotations of ~53 arithmetic ops plus three precise
// transcendentals, then the rank pick): at the refit's 8,192 rows both
// bounds are well under a microsecond, so a launch is latency-bound.
// Design: one thread per matrix, the 6 + 9 components and all six sweeps
// in registers; one pass over device memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    eigh3_kernel(const float* __restrict__ a00, const float* __restrict__ a01,
                 const float* __restrict__ a02, const float* __restrict__ a11,
                 const float* __restrict__ a12, const float* __restrict__ a22, int s00, int s01,
                 int s02, int s11, int s12, int s22, int n, int sweeps, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s[3][3];
  const long long at = i;
  s[0][0] = a00[at * s00];
  s[0][1] = s[1][0] = a01[at * s01];
  s[0][2] = s[2][0] = a02[at * s02];
  s[1][1] = a11[at * s11];
  s[1][2] = s[2][1] = a12[at * s12];
  s[2][2] = a22[at * s22];
  float v[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 1.0f}};
  for (int sw = 0; sw < sweeps; ++sw) {
#pragma unroll
    for (int rot = 0; rot < 3; ++rot) {
      const int p = rot == 2 ? 1 : 0;
      const int q = rot == 0 ? 1 : 2;
      const int r = 3 - p - q;
      const float app = s[p][p], aqq = s[q][q], apq = s[p][q];
      const float theta = 0.5f * atan2f(2.0f * apq, aqq - app);
      const float c = cosf(theta);
      const float sn = sinf(theta);
      const float apr = s[p][r], aqr = s[q][r];
      const float new_pp = c * c * app - 2.0f * sn * c * apq + sn * sn * aqq;
      const float new_qq = sn * sn * app + 2.0f * sn * c * apq + c * c * aqq;
      const float new_pq = sn * c * (app - aqq) + (c * c - sn * sn) * apq;
      const float new_pr = c * apr - sn * aqr;
      const float new_qr = sn * apr + c * aqr;
      s[p][p] = new_pp;
      s[q][q] = new_qq;
      s[p][q] = s[q][p] = new_pq;
      s[p][r] = s[r][p] = new_pr;
      s[q][r] = s[r][q] = new_qr;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float vkp = v[k][p], vkq = v[k][q];
        v[k][p] = c * vkp - sn * vkq;
        v[k][q] = sn * vkp + c * vkq;
      }
    }
  }
  const float e[3] = {s[0][0], s[1][1], s[2][2]};
  const int rank[3] = {(e[0] > e[1]) + (e[0] > e[2]), (e[1] >= e[0]) + (e[1] > e[2]),
                       (e[2] >= e[0]) + (e[2] >= e[1])};
#pragma unroll
  for (int slot = 0; slot < 3; ++slot) {
    float ev = 0.0f, vec[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (rank[j] == slot) {
        ev = e[j];
#pragma unroll
        for (int k = 0; k < 3; ++k) vec[k] = v[k][j];
      }
    }
    out[(size_t)slot * n + i] = ev;
#pragma unroll
    for (int k = 0; k < 3; ++k) out[(size_t)(3 + 3 * k + slot) * n + i] = vec[k];
  }
}

}  // namespace

// n matrices: a00 .. a22 fp32, component x of matrix i at x[i * s_x]
// (element strides, >= 0); out (12, n) contiguous.  1 <= n < 2^31.
FLSQ_API int flsq_eigh3(const float* a00, const float* a01, const float* a02, const float* a11,
                        const float* a12, const float* a22, int s00, int s01, int s02,
                        int s11, int s12, int s22, int n, int sweeps, float* out,
                        void* stream) {
  if (n < 1 || sweeps < 0 || s00 < 0 || s01 < 0 || s02 < 0 || s11 < 0 || s12 < 0 || s22 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  eigh3_kernel<<<flsq::ceil_div(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a00, a01, a02, a11, a12, a22, s00, s01, s02, s11, s12, s22, n, sweeps, out);
  return flsq::launch_status();
}
