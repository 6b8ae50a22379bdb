"""FPFH (Fast Point Feature Histograms) over k-nearest-neighbour lists —
port of fast_lio_sam_qn_tpu/ops/fpfh.py, the loop closure's ``"knn"``
feature backend (``quatro.fpfh_backend``), and the ``distinctive`` filter
both backends share.

1. One kNN search of the cloud against itself at k = max(k_feat,
   k_normal), through kernel K1 (``knn_cuda.knn``; ``fpfh_batched``: one
   batched K1 launch for B clouds).
2. Normals: PCA over the first k_normal neighbours within normal_radius
   (``linalg3.eigh3``), oriented toward the viewpoint.
3. SPFH: the Darboux-frame triplet (alpha, phi, theta) of each point
   against its first k_feat neighbours within feature_radius, binned into
   3 x 11 bins (theta through ``atan2``, as the reference), normalized by
   the neighbour count.
4. FPFH: SPFH(p) + (1 / K) sum_q SPFH(q) / |p - q| over the same
   neighbours, each 11-bin block scaled to sum 100 (PCL's convention).

The (B, N, K, ...) pair tensors are made over row chunks (``ROW_CHUNK``
rows of every lane at a time), never over K, the summation axis: at
32,768 rows and K = 48 the neighbours' SPFH rows alone would be ~208 MB a
cloud.  Every function takes a leading batch axis; the single-cloud ones
are the batch of one through the single-cloud kernel.
"""
from __future__ import annotations

import torch

from . import knn_cuda, linalg3

FPFH_DIM = 33
_NBINS = 11
ROW_CHUNK = 8192


def distinctive(desc: torch.Tensor, valid: torch.Tensor,
                planarity_threshold: float = 90.0) -> torch.Tensor:
    """Drop degenerate (planar) descriptors before matching: keep points
    whose mean per-block max mass is below the threshold (blocks sum to
    100).  Leading axes are a batch of clouds."""
    mx = torch.stack([torch.max(desc[..., s:s + _NBINS], dim=-1).values
                      for s in range(0, FPFH_DIM, _NBINS)], dim=-1)
    return valid & (torch.mean(mx, dim=-1) < planarity_threshold)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x (B, N, ...) at neighbour lists idx (B, M, K) (-1 read as
    row 0) -> (B, M, K, ...)."""
    b, m, k = idx.shape
    rows = torch.clamp(idx, min=0).reshape(b, m * k)
    return knn_cuda.take_rows(x, rows).reshape((b, m, k) + x.shape[2:])


def _centroids(points, mask):
    """(B, 3) mean of each lane's valid points: the default viewpoint."""
    return torch.sum(points * mask[..., None], 1) / torch.clamp(
        torch.sum(mask, 1).to(points.dtype), min=1.0)[:, None]


def _normals_from_knn(points, mask, nd2, nidx, nvalid, radius: float,
                      viewpoint):
    """PCA normals of (B, N, 3) clouds from their kNN lists (B, N, K),
    radius-masked, oriented toward ``viewpoint`` (B, 3) (each lane's valid
    centroid when None).  Returns (normals (B, N, 3), valid (B, N))."""
    if viewpoint is None:
        viewpoint = _centroids(points, mask)
    in_r = nvalid & (nd2 <= radius * radius)
    npts = _gather(points, nidx)
    w = in_r.to(points.dtype)
    cnt = torch.sum(w, -1)
    mean = torch.sum(npts * w[..., None], -2) / torch.clamp(
        cnt, min=1.0)[..., None]
    d = (npts - mean[..., None, :]) * w[..., None]
    cov = torch.einsum("bnki,bnkj->bnij", d, d)
    _, vecs = linalg3.eigh3(cov)
    n = vecs[..., :, 0]
    to_view = viewpoint[:, None, :] - points
    n = n * torch.where(torch.sum(n * to_view, -1, keepdim=True) < 0, -1.0,
                        1.0)
    valid = mask & (cnt >= 3)
    return torch.where(valid[..., None], n, 0.0), valid


def _knn_lists(points, mask, k: int, batched: bool):
    """K1 of (B, N, 3) clouds against themselves: one batched launch, or
    (``batched`` False, B = 1) the single-cloud kernel."""
    if batched:
        return knn_cuda.knn_batched(points, mask, points, mask, k)
    return tuple(o[None] for o in knn_cuda.knn(points[0], mask[0],
                                               points[0], mask[0], k))


def estimate_normals(points, mask, radius: float, k: int = 32,
                     viewpoint=None):
    """PCA normals of one (N, 3) cloud from its <= k nearest neighbours
    within ``radius`` (one K1 launch), oriented toward ``viewpoint`` (3,)
    (the valid centroid when None).  Returns (normals (N, 3) unit, valid
    (N,))."""
    d2, idx, v = _knn_lists(points[None], mask[None], k, batched=False)
    n, valid = _normals_from_knn(
        points[None], mask[None], d2, idx, v, float(radius),
        None if viewpoint is None else viewpoint[None])
    return n[0], valid[0]


def _pair_features(p, n_p, q, n_q):
    """PFH angle triplet and distance of point pairs p -> q, all (..., 3)."""
    dvec = q - p
    dist = torch.linalg.norm(dvec, dim=-1)
    dn = dvec / torch.clamp(dist[..., None], min=1e-9)
    u = n_p
    v = torch.linalg.cross(dn, u, dim=-1)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-9)
    w = torch.linalg.cross(u, v, dim=-1)
    alpha = torch.sum(v * n_q, -1)                              # [-1, 1]
    phi = torch.sum(u * dn, -1)                                 # [-1, 1]
    theta = torch.atan2(torch.sum(w * n_q, -1), torch.sum(u * n_q, -1))
    return alpha, phi, theta, dist


def _hist11(vals, lo: float, hi: float, w):
    """Weighted 11-bin histogram over the last axis: vals, w (..., K) ->
    (..., 11); the bin is the truncation of (v - lo) / (hi - lo) * 11,
    clipped to 0..10."""
    b = torch.clamp(((vals - lo) / (hi - lo) * _NBINS).to(torch.int64), 0,
                    _NBINS - 1)
    onehot = torch.nn.functional.one_hot(b, _NBINS).to(vals.dtype)
    return torch.sum(onehot * w[..., None], dim=-2)


def _chunks(n: int):
    return [(s, min(s + ROW_CHUNK, n)) for s in range(0, n, ROW_CHUNK)]


def _fpfh(points, mask, normal_radius: float, feature_radius: float,
          k_feat: int, k_normal: int, viewpoint, batched: bool):
    """The descriptor of (B, N, 3) clouds: (desc (B, N, 33), valid (B, N),
    (d2, idx, valid) of the shared kNN, each (B, N, max(k_feat,
    k_normal)))."""
    n = points.shape[1]
    d2_all, idx_all, v_all = _knn_lists(points, mask,
                                        max(k_feat, k_normal), batched)
    normals, n_valid = _normals_from_knn(
        points, mask, d2_all[..., :k_normal], idx_all[..., :k_normal],
        v_all[..., :k_normal], normal_radius, viewpoint)
    m = mask & n_valid
    idx = idx_all[..., :k_feat]
    # a neighbour counts only with a valid normal of its own
    in_r = (v_all[..., :k_feat] & _gather(n_valid, idx) & m[..., None]
            & (d2_all[..., :k_feat] <= feature_radius * feature_radius))
    w, spfh, inv_d = [], [], []
    for s, e in _chunks(n):
        p, q = points[:, s:e, None, :], _gather(points, idx[:, s:e])
        alpha, phi, theta, dist = _pair_features(
            p, normals[:, s:e, None, :], q, _gather(normals, idx[:, s:e]))
        # the point itself (and any duplicate) is no neighbour: tested on
        # the coordinates, where it is exactly 0, not on the expansion's d2
        we = (in_r[:, s:e] & (torch.sum((q - p) ** 2, -1) > 1e-12)).to(
            points.dtype)
        w.append(we)
        spfh.append(torch.cat([_hist11(alpha, -1.0, 1.0, we),
                               _hist11(phi, -1.0, 1.0, we),
                               _hist11(theta, -torch.pi, torch.pi, we)],
                              dim=-1))
        inv_d.append(we / torch.clamp(dist, min=1e-6))
    w = torch.cat(w, 1)
    cnt = torch.clamp(torch.sum(w, -1), min=1.0)
    spfh = torch.cat(spfh, 1) / cnt[..., None]   # normalized SPFH
    inv_d = torch.cat(inv_d, 1)
    # FPFH(p) = SPFH(p) + (1 / K) sum_q SPFH(q) / dist(p, q)
    neigh = torch.cat([torch.sum(_gather(spfh, idx[:, s:e])
                                 * inv_d[:, s:e, :, None], -2)
                       for s, e in _chunks(n)], 1)
    fp = spfh + neigh / cnt[..., None]
    desc = torch.cat([100.0 * fp[..., s:s + _NBINS] / torch.clamp(
        torch.sum(fp[..., s:s + _NBINS], -1, keepdim=True), min=1e-9)
        for s in range(0, FPFH_DIM, _NBINS)], dim=-1)
    valid = m & (torch.sum(w, -1) >= 3)
    return (torch.where(valid[..., None], desc, 0.0), valid,
            (d2_all, idx_all, v_all))


def fpfh(points, mask, normal_radius: float, feature_radius: float,
         k_feat: int = 48, k_normal: int = 32, viewpoint=None,
         return_knn: bool = False):
    """FPFH of one (N, 3) cloud: (desc (N, 33), valid (N,)), and with
    ``return_knn`` the shared kNN triplet (d2, idx, valid), each (N,
    max(k_feat, k_normal)).  ``viewpoint`` (3,) orients the normals (the
    valid centroid when None).  One K1 launch feeds the normals (first
    k_normal neighbours) and the SPFH neighbourhoods (first k_feat)."""
    vp = None if viewpoint is None else viewpoint[None]
    desc, valid, knn = _fpfh(points[None], mask[None], float(normal_radius),
                             float(feature_radius), k_feat, k_normal, vp,
                             batched=False)
    if return_knn:
        return desc[0], valid[0], tuple(x[0] for x in knn)
    return desc[0], valid[0]


def fpfh_batched(points, mask, normal_radius: float, feature_radius: float,
                 k_feat: int = 48, k_normal: int = 32, viewpoint=None,
                 return_knn: bool = False):
    """``fpfh`` of B clouds of equal padding — (B, N, 3) points, (B, N)
    masks, (B, 3) viewpoints or None — with one batched K1 launch for all
    lanes; every output has a leading batch axis."""
    desc, valid, knn = _fpfh(points, mask, float(normal_radius),
                             float(feature_radius), k_feat, k_normal,
                             viewpoint, batched=True)
    if return_knn:
        return desc, valid, knn
    return desc, valid
