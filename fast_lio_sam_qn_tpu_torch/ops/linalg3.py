"""Small fixed-size linear algebra — port of
fast_lio_sam_qn_tpu/ops/linalg3.py.

The 3x3 eigensolver is the same struct-of-arrays cyclic Jacobi (6 sweeps)
as the reference, not ``torch.linalg.eigh``: eigenvector signs and the
order of equal eigenvalues must follow the reference, because normals and
plane covariances are built from them.  ``eigh3_soa`` is the wrapper of
kernel K6 (csrc/eigh3.cu, one thread a matrix, the sweeps in registers),
the counterpart of the loop that XLA fuses in the reference; on a CPU
tensor it runs ``eigh3_soa_plain``, the same arithmetic one torch op at a
time, which the kernel equals bit for bit on the card.  ``eigh3`` and every
caller of either go through the wrapper.
"""
from __future__ import annotations

import torch

from .. import kernels

_EPS = 1e-12


def eigh3_soa_plain(a00, a01, a02, a11, a12, a22, sweeps: int = 6):
    """Cyclic-Jacobi symmetric 3x3 eigendecomposition in struct-of-arrays
    form: six (...,) component tensors in, ((e0, e1, e2) ascending,
    v[i][j] eigenvector components, column j per eigenvalue j) out."""
    one = torch.ones_like(a00)
    zero = torch.zeros_like(a00)
    s = [[a00, a01, a02], [a01, a11, a12], [a02, a12, a22]]
    v = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
    for _ in range(sweeps):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            r = 3 - p - q
            app, aqq, apq = s[p][p], s[q][q], s[p][q]
            theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
            c = torch.cos(theta)
            sn = torch.sin(theta)
            apr, aqr = s[p][r], s[q][r]
            new_pp = c * c * app - 2.0 * sn * c * apq + sn * sn * aqq
            new_qq = sn * sn * app + 2.0 * sn * c * apq + c * c * aqq
            new_pq = sn * c * (app - aqq) + (c * c - sn * sn) * apq
            new_pr = c * apr - sn * aqr
            new_qr = sn * apr + c * aqr
            s[p][p], s[q][q] = new_pp, new_qq
            s[p][q] = s[q][p] = new_pq
            s[p][r] = s[r][p] = new_pr
            s[q][r] = s[r][q] = new_qr
            for i in range(3):
                vip, viq = v[i][p], v[i][q]
                v[i][p] = c * vip - sn * viq
                v[i][q] = sn * vip + c * viq
    e = [s[0][0], s[1][1], s[2][2]]
    # stable 3-way rank (ties break to the lower index, like a stable sort)
    rank = [
        (e[0] > e[1]).int() + (e[0] > e[2]).int(),
        (e[1] >= e[0]).int() + (e[1] > e[2]).int(),
        (e[2] >= e[0]).int() + (e[2] >= e[1]).int(),
    ]

    def pick(slot, comps):
        out = torch.zeros_like(comps[0])
        for j in range(3):
            out = torch.where(rank[j] == slot, comps[j], out)
        return out

    evals = tuple(pick(k, e) for k in range(3))
    evecs = [[pick(k, v[i]) for k in range(3)] for i in range(3)]
    return evals, evecs


def eigh3_soa(a00, a01, a02, a11, a12, a22, sweeps: int = 6):
    """``eigh3_soa_plain`` — kernel K6 on CUDA tensors.  The six components
    share one shape; each is read at its own stride where its flattening
    is a view (column views such as ``cov[:, 0]``), else made contiguous.
    The outputs are contiguous tensors of that shape."""
    comps = (a00, a01, a02, a11, a12, a22)
    if not kernels.on_cuda("eigh3_soa", a00):
        return eigh3_soa_plain(*comps, sweeps=sweeps)
    shape = a00.shape
    for c in comps:
        kernels.require(c, "eigh3_soa component", torch.float32, shape,
                        a00.device, contiguous=False)
    n = a00.numel()
    if n >= 2 ** 31:
        raise ValueError(f"eigh3_soa: {n} matrices; the kernel takes < 2^31")
    out = torch.empty((12, n), dtype=torch.float32, device=a00.device)
    if n:
        _launch_eigh3([c.reshape(-1) for c in comps], sweeps, out)
        eigh3_soa.launches += 1
    rows = out.view((12,) + shape).unbind(0)
    return tuple(rows[:3]), [list(rows[3 + 3 * i:6 + 3 * i])
                             for i in range(3)]


eigh3_soa.launches = 0


def _launch_eigh3(flat, sweeps: int, out):
    """K6 on six (n,) fp32 views, each read at its stride, into out (12,
    n): the eigenvalues ascending, then component i of eigenvector j in row
    3 + 3 i + j (csrc/eigh3.cu's contract)."""
    strides = [f.stride(0) for f in flat]
    if max(strides) >= 2 ** 31:
        raise ValueError(f"eigh3_soa: strides {strides}; the kernel takes "
                         f"< 2^31")
    lib = kernels.load_library()
    with torch.cuda.device(out.device):
        status = lib.flsq_eigh3(*(f.data_ptr() for f in flat), *strides,
                                out.shape[1], sweeps, out.data_ptr(),
                                kernels.stream(out))
    kernels.check_status(status, "eigh3")


def eigh3(A: torch.Tensor, sweeps: int = 6):
    """Batched symmetric 3x3 eigendecomposition: (eigvals (..., 3)
    ascending, eigvecs (..., 3, 3) as columns)."""
    A = 0.5 * (A + A.transpose(-1, -2))
    evals, evecs = eigh3_soa(
        A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
        A[..., 1, 1], A[..., 1, 2], A[..., 2, 2], sweeps=sweeps)
    vals = torch.stack(evals, dim=-1)
    V = torch.stack([torch.stack(row, dim=-1) for row in evecs], dim=-2)
    return vals, V


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    # clamp the magnitude away from zero, keeping the sign
    det_safe = torch.where(det >= 0, torch.clamp(det, min=_EPS),
                           torch.clamp(det, max=-_EPS))
    inv_det = 1.0 / det_safe
    adj = torch.stack([
        torch.stack([A00, A01, A02], dim=-1),
        torch.stack([A10, A11, A12], dim=-1),
        torch.stack([A20, A21, A22], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def solve6(H: torch.Tensor, b: torch.Tensor, damping: float = 0.0):
    """Solve (H + damping * diag(H)) x = b for 6x6 H (batched LU)."""
    if damping:
        diag = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-6)
        H = H + damping * torch.diag_embed(diag)
    return torch.linalg.solve(H, b[..., None])[..., 0]
