"""Covariance-weighted GICP (Nano-GICP equivalent) — port of
fast_lio_sam_qn_tpu/ops/gicp.py.

Distribution-to-distribution Gauss-Newton with nearest-neighbour
correspondences re-searched every iteration, the PCL-style fitness score and
the translation-degeneracy flag.  As in the reference's default
(``banded=True``), ``align`` Morton-sorts both clouds once and runs every NN
search through the bbox-pruned kernel K2.  The reference's ``lax.while_loop`` is a
Python loop with the same stopping rule and one host read per iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import knn_cuda, linalg3, se3

PLANE_EPS = 1e-3  # plane regularization: eigenvalues replaced by (e, 1, 1)


class GicpResult(NamedTuple):
    transform: torch.Tensor   # (4, 4) src -> dst
    fitness: torch.Tensor     # PCL getFitnessScore (mean sq. NN distance)
    converged: torch.Tensor   # bool
    num_iters: int
    num_corr: torch.Tensor    # correspondences in the final iteration
    degenerate: torch.Tensor  # bool: unconstrained along some direction


def plane_covariances_from_knn(points, mask, nn_pts, nn_valid):
    """Regularized plane covariances from precomputed neighbours nn_pts
    (N, K, 3), nn_valid (N, K).  Returns (covs (N, 3, 3), valid (N,))."""
    w = nn_valid.to(points.dtype)
    cnt = torch.sum(w, dim=-1)
    mean = torch.sum(nn_pts * w[..., None], dim=-2) / torch.clamp(
        cnt, min=1.0)[..., None]
    d = (nn_pts - mean[..., None, :]) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", d, d) / torch.clamp(
        cnt, min=1.0)[..., None, None]
    valid = mask & (cnt >= 3)
    _, vecs = linalg3.eigh3(cov)
    reg = torch.tensor([PLANE_EPS, 1.0, 1.0], dtype=points.dtype,
                       device=points.device)
    cov_reg = torch.einsum("nij,j,nkj->nik", vecs, reg, vecs)
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    return torch.where(valid[:, None, None], cov_reg, eye), valid


def plane_covariances(points, mask, k: int = 15):
    """Plane covariances from the exact k nearest neighbours (the
    reference's ``backend="brute"``), through kernel K1."""
    _, nn_idx, nn_valid = knn_cuda.knn(points, mask, points, mask, k)
    nn_pts = points[torch.clamp(nn_idx, min=0).long()]
    return plane_covariances_from_knn(points, mask, nn_pts, nn_valid)


class _GNState(NamedTuple):
    T: torch.Tensor
    it: int
    delta: torch.Tensor
    num_corr: torch.Tensor
    H: torch.Tensor  # final normal-equation matrix (degeneracy diagnosis)


def _gicp_iterate(src, src_mask, src_cov, dst, dst_mask, dst_cov, init_T,
                  max_corr_dist: float, trans_eps: float,
                  max_iter: int) -> _GNState:
    max_d2 = torch.tensor(max_corr_dist, dtype=torch.float32,
                          device=src.device) ** 2
    st = _GNState(init_T, 0, src.new_tensor(torch.inf),
                  torch.zeros((), dtype=torch.int32, device=src.device),
                  torch.eye(6, dtype=src.dtype, device=src.device))
    while st.it < max_iter:
        R = st.T[:3, :3]
        y = se3.transform_points(src, st.T)
        d2, idx, nn_ok = knn_cuda.nn_banded(y.contiguous(), src_mask, dst,
                                             dst_mask)
        corr = nn_ok & (d2 < max_d2)
        j = torch.clamp(idx, min=0).long()
        dpts = dst[j]
        # M = (C_dst + R C_src R^T)^-1 per correspondence
        RCsRt = torch.einsum("ab,nbc,dc->nad", R, src_cov, R)
        M = linalg3.inv3(dst_cov[j] + RCsRt)
        r = dpts - y
        Jw = se3.hat(y)  # d r / d w; J = [hat(y) | -I], T <- exp(xi) T
        w = corr.to(src.dtype)
        MJw = torch.einsum("nab,nbc->nac", M, Jw)
        Hww = torch.einsum("nba,nbc,n->ac", Jw, MJw, w)
        Hwv = -torch.einsum("nba,nbc,n->ac", Jw, M, w)
        Hvv = torch.einsum("nab,n->ab", M, w)
        Mr = torch.einsum("nab,nb->na", M, r)
        bw = torch.einsum("nba,nb,n->a", Jw, Mr, w)
        bv = -torch.einsum("na,n->a", Mr, w)
        H = torch.cat([torch.cat([Hww, Hwv], 1), torch.cat([Hwv.T, Hvv], 1)])
        b = torch.cat([bw, bv])
        xi = linalg3.solve6(H, -b, damping=1e-6)
        delta = torch.linalg.norm(xi)
        st = _GNState(se3.compose(se3.se3_exp(xi), st.T), st.it + 1, delta,
                      torch.sum(corr).to(torch.int32), H)
        if bool(delta < trans_eps):
            break
    return st


def fitness_score(src, src_mask, dst, dst_mask, T):
    """PCL getFitnessScore: mean squared distance from each valid
    transformed src point to its dst nearest neighbour (through K2, fast
    when both clouds are Morton-sorted)."""
    y = se3.transform_points(src, T).contiguous()
    d2, _, ok = knn_cuda.nn_banded(y, src_mask, dst, dst_mask)
    w = ok & src_mask
    return torch.sum(torch.where(w, d2, 0.0)) / torch.clamp(
        torch.sum(w).to(src.dtype), min=1.0)


def align(src, src_mask, dst, dst_mask, init_T=None, *, src_cov, dst_cov,
          max_iter: int = 32, max_corr_dist: float = 52.5,
          trans_eps: float = 0.01) -> GicpResult:
    """Nano-GICP-equivalent alignment on precomputed covariances
    (``(covs (N, 3, 3), valid (N,))`` pairs for src and dst).  Defaults
    mirror the reference's effective config.

    Both clouds are Morton-sorted once and every NN search runs through K2;
    the sort is rigid-transform friendly, so one src sort keeps query
    blocks compact across all iterations.  The outputs do not depend on the
    point order beyond fp summation order."""
    if init_T is None:
        init_T = torch.eye(4, dtype=src.dtype, device=src.device)
    src_cov, src_ok = src_cov
    dst_cov, dst_ok = dst_cov
    so = knn_cuda.morton_order(src, src_mask)
    do = knn_cuda.morton_order(dst, dst_mask)
    src, src_mask, src_cov, src_ok = (
        src[so], src_mask[so], src_cov[so], src_ok[so])
    dst, dst_mask, dst_cov, dst_ok = (
        dst[do], dst_mask[do], dst_cov[do], dst_ok[do])
    st = _gicp_iterate(src, src_mask & src_ok, src_cov, dst,
                       dst_mask & dst_ok, dst_cov, init_T, max_corr_dist,
                       trans_eps, max_iter)
    fit = fitness_score(src, src_mask, dst, dst_mask, st.T)
    # planar scenes leave translation directions unconstrained: flag an
    # ill-conditioned translation block of the normal equations
    Hvv = st.H[3:, 3:] / torch.clamp(st.num_corr.to(src.dtype), min=1.0)
    tvals, _ = linalg3.eigh3(Hvv[None])
    degenerate = tvals[0, 0] < 1e-5 * tvals[0, 2]
    converged = st.num_corr > 0
    return GicpResult(st.T, fit, converged, st.it, st.num_corr, degenerate)
