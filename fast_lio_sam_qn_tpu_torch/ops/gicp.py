"""Covariance-weighted GICP (Nano-GICP equivalent) — port of
fast_lio_sam_qn_tpu/ops/gicp.py.

Distribution-to-distribution Gauss-Newton with nearest-neighbour
correspondences re-searched every iteration, the PCL-style fitness score and
the translation-degeneracy flag.  As in the reference's default
(``banded=True``), both clouds are Morton-sorted once and every NN search
runs through the bbox-pruned kernel K2.  The reference's
``lax.while_loop`` is a Python loop with the same stopping rule and one
host read per iteration.

The loop is written once, over a leading batch axis of B cloud pairs, as
``jax.vmap`` of the reference's ``align`` runs it: a lane that has stopped
keeps its state bit for bit (vmap of a ``while_loop`` runs while any lane's
predicate holds and selects the finished lanes' carry); its passes go to
the open profiler's ``gicp_iters``.  ``align_batched``
searches all lanes with one batched K2 launch per iteration; ``align`` is
the same loop at B = 1 through the single-cloud K2.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..utils import profiling
from . import hashgrid, knn_cuda, linalg3, se3

PLANE_EPS = 1e-3  # plane regularization: eigenvalues replaced by (e, 1, 1)


class GicpResult(NamedTuple):
    """One registration's result (``align``); ``align_batched`` gives
    every field a leading batch axis."""
    transform: torch.Tensor   # (4, 4) src -> dst
    fitness: torch.Tensor     # PCL getFitnessScore (mean sq. NN distance)
    converged: torch.Tensor   # bool
    num_iters: int            # (B,) int32 tensor when batched
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


GRID_ROWS = 8192  # query rows per windowed hash-grid search


def grid_table_size(n: int) -> int:
    """The grid backend's hash-table size for n points: the smallest power
    of two >= 4n, at least 1024 (the reference's rule)."""
    return max(1024, 1 << (int(n * 4 - 1)).bit_length())


def plane_covariances(points, mask, k: int = 15, backend: str = "brute",
                      res: float = 0.3, window: int = 5,
                      table_size: int | None = None):
    """Per-point plane covariances of one (N, 3) cloud, eigenvalues
    regularized to (eps, 1, 1): (covs (N, 3, 3), valid (N,)).

    ``backend="brute"``: the exact k nearest neighbours, through kernel
    K1.  ``backend="grid"``: the k nearest within a +-(window // 2) voxel
    neighbourhood of a hash grid at ``res`` (``hashgrid.build`` /
    ``query_knn``; the reference's default); a point with fewer than 3
    in-window neighbours is invalid rather than reaching across the
    cloud.  The grid search runs over chunks of GRID_ROWS query rows."""
    if backend == "grid":
        t = table_size or grid_table_size(points.shape[0])
        grid = hashgrid.build(points, mask, res=res, table_size=t)
        found = [hashgrid.query_knn(grid, points[s:s + GRID_ROWS],
                                    mask[s:s + GRID_ROWS], k=k,
                                    window=window)
                 for s in range(0, points.shape[0], GRID_ROWS)]
        nn_pts = torch.cat([f[0] for f in found])
        nn_valid = torch.cat([f[2] for f in found])
    elif backend == "brute":
        _, nn_idx, nn_valid = knn_cuda.knn(points, mask, points, mask, k)
        nn_pts = points[torch.clamp(nn_idx, min=0).long()]
    else:
        raise ValueError(f"unknown covariance backend {backend!r}")
    return plane_covariances_from_knn(points, mask, nn_pts, nn_valid)


def plane_covariances_batched(points, mask, k: int = 15):
    """``plane_covariances`` of B clouds ((B, N, 3)), one batched K1
    launch."""
    b, n, _ = points.shape
    _, nn_idx, nn_valid = knn_cuda.knn_batched(points, mask, points, mask, k)
    nn_pts = knn_cuda.take_rows(points,
                                torch.clamp(nn_idx, min=0).reshape(b, n * k))
    cov, ok = plane_covariances_from_knn(
        points.reshape(b * n, 3), mask.reshape(-1),
        nn_pts.reshape(b * n, k, 3), nn_valid.reshape(b * n, k))
    return cov.reshape(b, n, 3, 3), ok.reshape(b, n)


class _GNState(NamedTuple):
    T: torch.Tensor         # (B, 4, 4)
    it: torch.Tensor        # (B,) int32 iterations taken
    delta: torch.Tensor     # (B,) last step norm
    num_corr: torch.Tensor  # (B,) int32
    H: torch.Tensor  # (B, 6, 6) final normal equations (degeneracy diagnosis)


def nn_lanes(queries, qmask, db, dbmask):
    """K2 nearest neighbours of each lane through the single-cloud kernel,
    one launch per lane: the NN of the single-candidate path."""
    return kernels.per_lane(knn_cuda.nn_banded, queries, qmask, db, dbmask)


def normal_equations(R, y, src_cov, dst, dst_cov, idx, corr):
    """The Gauss-Newton normal equations of B lanes, summed over their
    correspondences: R (B, 3, 3) the current rotation, y (B, N, 3) the
    transformed source, src_cov (B, N, 3, 3), dst / dst_cov the target
    rows, idx (B, N) each point's nearest target row and corr (B, N) the
    correspondences that count.  Returns (H (B, 6, 6), b (B, 6)) in fp32;
    the step solves H xi = -b, tangent (w, v), T <- exp(xi) T.  Shared by
    the GN loop here and the point-sharded one (parallel/spmd.py), which
    all-reduces each rank's (H, b)."""
    j = torch.clamp(idx, min=0)
    # M = (C_dst + R C_src R^T)^-1 per correspondence
    RCsRt = torch.einsum("zab,znbc,zdc->znad", R, src_cov, R)
    M = linalg3.inv3(knn_cuda.take_rows(dst_cov, j) + RCsRt)
    r = knn_cuda.take_rows(dst, j) - y
    Jw = se3.hat(y)  # d r / d w; J = [hat(y) | -I], T <- exp(xi) T
    w = corr.to(y.dtype)
    MJw = torch.einsum("znab,znbc->znac", M, Jw)
    Hww = torch.einsum("znba,znbc,zn->zac", Jw, MJw, w)
    Hwv = -torch.einsum("znba,znbc,zn->zac", Jw, M, w)
    Hvv = torch.einsum("znab,zn->zab", M, w)
    Mr = torch.einsum("znab,znb->zna", M, r)
    bw = torch.einsum("znba,znb,zn->za", Jw, Mr, w)
    bv = -torch.einsum("zna,zn->za", Mr, w)
    H = torch.cat([torch.cat([Hww, Hwv], 2),
                   torch.cat([Hwv.transpose(1, 2), Hvv], 2)], 1)
    return H, torch.cat([bw, bv], -1)


def _gicp_iterate(src, src_mask, src_cov, dst, dst_mask, dst_cov, init_T,
                  max_corr_dist: float, trans_eps: float, max_iter: int,
                  nn) -> _GNState:
    """The Gauss-Newton loop over B lanes, every NN search through ``nn``.
    Runs while any lane is active (one host read per iteration) and freezes
    a lane's whole state once it stops, as vmap of the reference's
    while_loop does; at B = 1 this is the reference's loop itself."""
    b = src.shape[0]
    dev = src.device
    max_d2 = torch.tensor(max_corr_dist, dtype=torch.float32,
                          device=dev) ** 2
    st = _GNState(init_T, torch.zeros(b, dtype=torch.int32, device=dev),
                  torch.full((b,), torch.inf, device=dev),
                  torch.zeros(b, dtype=torch.int32, device=dev),
                  torch.eye(6, dtype=src.dtype, device=dev).repeat(b, 1, 1))
    active = torch.ones(b, dtype=torch.bool, device=dev)
    passes = 0
    for _ in range(max_iter):
        passes += 1
        R = st.T[:, :3, :3]
        y = se3.transform_points(src, st.T)
        d2, idx, nn_ok = nn(y.contiguous(), src_mask, dst, dst_mask)
        corr = nn_ok & (d2 < max_d2)
        H, bvec = normal_equations(R, y, src_cov, dst, dst_cov, idx, corr)
        xi = linalg3.solve6(H, -bvec, damping=1e-6)
        delta = torch.linalg.norm(xi, dim=-1)
        a3 = active[:, None, None]
        st = _GNState(
            torch.where(a3, se3.compose(se3.se3_exp(xi), st.T), st.T),
            st.it + active.to(torch.int32),
            torch.where(active, delta, st.delta),
            torch.where(active, torch.sum(corr, 1).to(torch.int32),
                        st.num_corr),
            torch.where(a3, H, st.H))
        active = active & ~(delta < trans_eps)
        if not bool(active.any()):
            break
    profiling.add("gicp_iters", passes)
    return st


def _fitness(src, src_mask, dst, dst_mask, T, nn):
    """PCL getFitnessScore of B lanes (B,): mean squared distance from each
    valid transformed src point to its dst nearest neighbour, through
    ``nn`` (K2, fast when both clouds are Morton-sorted)."""
    y = se3.transform_points(src, T).contiguous()
    d2, _, ok = nn(y, src_mask, dst, dst_mask)
    w = ok & src_mask
    return torch.sum(torch.where(w, d2, 0.0), 1) / torch.clamp(
        torch.sum(w, 1).to(src.dtype), min=1.0)


def fitness_score(src, src_mask, dst, dst_mask, T):
    """``_fitness`` of one cloud pair (a 0-d tensor)."""
    return _fitness(src[None], src_mask[None], dst[None], dst_mask[None],
                    T[None], nn_lanes)[0]


def _degenerate(H, num_corr):
    """Planar scenes leave translation directions unconstrained: flag an
    ill-conditioned translation block of the normal equations."""
    Hvv = H[..., 3:, 3:] / torch.clamp(num_corr.to(H.dtype),
                                       min=1.0)[..., None, None]
    tvals, _ = linalg3.eigh3(Hvv)
    return tvals[..., 0] < 1e-5 * tvals[..., 2]


def align_batched(src, src_mask, dst, dst_mask, init_T=None, *, src_cov,
                  dst_cov, max_iter: int = 32, max_corr_dist: float = 52.5,
                  trans_eps: float = 0.01,
                  nn=knn_cuda.nn_banded_batched) -> GicpResult:
    """Nano-GICP-equivalent alignment of B cloud pairs of equal padding:
    (B, S, 3) / (B, D, 3) clouds, precomputed ``(covs (B, N, 3, 3), valid
    (B, N))`` covariance pairs, init_T (B, 4, 4) or None.  Defaults mirror
    the reference's effective config.  Every field of the result has a
    leading batch axis.

    Each lane is Morton-sorted once and every NN search, the fitness's
    included, goes through ``nn``: by default batched K2, one launch for
    all lanes.  The sort is rigid-transform friendly, so one src sort keeps
    query blocks compact across all iterations; the outputs do not depend
    on the point order beyond fp summation order."""
    b = src.shape[0]
    if init_T is None:
        init_T = torch.eye(4, dtype=src.dtype, device=src.device).repeat(
            b, 1, 1)
    src_cov, src_ok = src_cov
    dst_cov, dst_ok = dst_cov
    so = knn_cuda.morton_order_batched(src, src_mask)
    do = knn_cuda.morton_order_batched(dst, dst_mask)
    src, src_mask, src_cov, src_ok = (
        knn_cuda.take_rows(x, so)
        for x in (src, src_mask, src_cov, src_ok))
    dst, dst_mask, dst_cov, dst_ok = (
        knn_cuda.take_rows(x, do)
        for x in (dst, dst_mask, dst_cov, dst_ok))
    st = _gicp_iterate(src, src_mask & src_ok, src_cov, dst,
                       dst_mask & dst_ok, dst_cov, init_T, max_corr_dist,
                       trans_eps, max_iter, nn)
    fit = _fitness(src, src_mask, dst, dst_mask, st.T, nn)
    return GicpResult(st.T, fit, st.num_corr > 0, st.it, st.num_corr,
                      _degenerate(st.H, st.num_corr))


def align(src, src_mask, dst, dst_mask, init_T=None, *, k: int = 15,
          cov_backend: str = "grid", voxel_res: float = 0.3, src_cov=None,
          dst_cov=None, **kw) -> GicpResult:
    """``align_batched`` of one cloud pair through the single-cloud K2
    (the reference's ``align``): unbatched inputs and outputs, num_iters an
    int.  ``src_cov`` / ``dst_cov``: precomputed (covs (N, 3, 3), valid
    (N,)) pairs; where one is None, ``plane_covariances`` computes it with
    ``k``, ``cov_backend`` and ``voxel_res``, as the reference does."""
    if src_cov is None:
        src_cov = plane_covariances(src, src_mask, k=k, backend=cov_backend,
                                    res=voxel_res)
    if dst_cov is None:
        dst_cov = plane_covariances(dst, dst_mask, k=k, backend=cov_backend,
                                    res=voxel_res)
    one = align_batched(
        src[None], src_mask[None], dst[None], dst_mask[None],
        None if init_T is None else init_T[None],
        src_cov=tuple(c[None] for c in src_cov),
        dst_cov=tuple(c[None] for c in dst_cov), nn=nn_lanes, **kw)
    return GicpResult(*(f[0] for f in one))._replace(
        num_iters=int(one.num_iters[0]))
