"""Streaming radius-FPFH — port of fast_lio_sam_qn_tpu/ops/fpfh_stream.py.

Three dense masked reductions over all (query, point) pairs of one cloud,
with PCL's radius semantics and no neighbour cap:

1. ``moments``  (kernel K3, csrc/fpfh_moments.cu): count / first / second
   moments at the normal radius and at the covariance radius.  Normals and
   the Nano-GICP plane covariances both come from them.
2. ``spfh``     (kernel K4, csrc/fpfh_spfh.cu): the 3 x 11-bin Darboux
   histogram of each point.
3. ``fpfh_agg`` (kernel K5, csrc/fpfh_agg.cu): the 1/d-weighted neighbour
   sum of SPFH histograms.

Each kernel wrapper takes its plain PyTorch version (``*_plain``, a port of
the reference's ``_*_xla`` path) for a CPU tensor and launches its kernel
for a CUDA tensor.  ``*_batched`` run the same kernels over B clouds of
equal padding in one launch, the batch on the grid's y axis (the
reference's grid-batched lowering, fpfh_stream.py:419); their plain
versions apply the single plain version lane by lane.  The plain versions
use the reference's distance expansion d2 = |q|^2 - 2 q.v + |v|^2 in fp32,
query block by query block, over the points that may qualify, so they
track the JAX package on the CPU; the kernels use the same
expansion on the same |q|^2, |v|^2 operands.

K3, K4 and K5 skip the (query block, db tile) pairs that the radius keep
rule (``radius_tile_keep``, csrc/tile_prune.cuh) shows to hold no pair
within the radius (K3 at the larger of its two radii), and stop at each
lane's extents; they write zero rows for masked queries.  The prune skips
work only when the cloud is compact in row order, so on CUDA
``fpfh_radius`` and ``fpfh_radius_batched`` Morton-sort each lane once,
ahead of K3 (``sorted_route``, the reference's ``use_tpu`` route), run
every stage on the sorted rows and return every output in the caller's
row order.  CPU tensors keep the unsorted plain route (the reference's
CPU path does not sort either); ``sorted_route`` runs on them too, with
the plain versions on the sorted rows.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .. import kernels
from . import knn_cuda, linalg3
from .knn import sq_norms

FPFH_DIM = 33
_NBINS = 11
_BIG = 3.4e38
TQ = 128          # query rows per block of the plain versions
PLANE_EPS = 1e-3  # gicp.PLANE_EPS
FP_BLOCK = 32     # query rows a CTA of K3-K5 (csrc/tile_prune.cuh kFpBlock)
FP_TILE = 32      # db rows a tile of their keep rule (kFpTile)
FP_MAX_TILES = 4096
D2_ERR = 2.0 ** -19  # the keep rule's bound on the expansion's error (kD2Err)

# theta bin edges theta_j = -pi + j 2pi/11 as (cos, sin): the angle of
# (tx, ty) lies in bin j iff sigma_j >= 0 > sigma_{j+1}, where sigma_j =
# ty cos(theta_j) - tx sin(theta_j) — the reference's atan2-free binning
_TH_COS = tuple(math.cos(-math.pi + j * 2 * math.pi / _NBINS)
                for j in range(_NBINS + 1))
_TH_SIN = tuple(math.sin(-math.pi + j * 2 * math.pi / _NBINS)
                for j in range(_NBINS + 1))


def _db_norms(points: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """|v|^2 with a +3.4e38 penalty on points that must never qualify."""
    return sq_norms(points) + torch.where(keep, 0.0, _BIG)


def _block_d2(qb: torch.Tensor, points: torch.Tensor, dd: torch.Tensor):
    cross = qb @ points.T
    return sq_norms(qb)[:, None] - 2.0 * cross + dd[None, :]


def _not_self(start: int, rows: int, db_idx: torch.Tensor) -> torch.Tensor:
    """Pairs that are not the query itself, by index: a d2 threshold would
    flip on the expansion's ~1e-5 cancellation residue."""
    qi = torch.arange(start, start + rows, device=db_idx.device)
    return qi[:, None] != db_idx[None, :]


def _kept(points: torch.Tensor, keep: torch.Tensor):
    """The plain versions search only the points that may qualify: (their
    indices, |v|^2 of those).  A dropped point carries the +3.4e38 penalty
    and never qualifies, so every sum loses only exact zeros and every
    kept pair keeps its d2 bits."""
    idx = torch.nonzero(keep).flatten()
    return idx, sq_norms(points)[idx]


def _check_clouds(name: str, points: torch.Tensor, extra=()) -> None:
    """Validate (B, N, 3) points and (B, N, ...) operands for a launch."""
    b, n, _ = points.shape
    kernels.require_batch(b)
    if n < 1:
        raise ValueError(f"{name}: empty cloud")
    dev = points.device
    kernels.require(points, f"{name}: points", torch.float32, (b, n, 3), dev)
    for t, label, dt, cols in extra:
        kernels.require(t, f"{name}: {label}", dt, (b, n) + cols, dev)


# ---------------------------------------------------------------------------
# K3: moments
# ---------------------------------------------------------------------------

def _features(points: torch.Tensor) -> torch.Tensor:
    """(N, 10) rows [1, x, y, z, xx, xy, xz, yy, yz, zz]."""
    return torch.cat([
        torch.ones_like(points[:, :1]), points,
        points[:, 0:1] * points, points[:, 1:2] * points[:, 1:],
        points[:, 2:3] * points[:, 2:]], dim=1)


def moments_plain(points, mask, radius: float, cov_radius: float):
    """(N, 20) radius moments at (radius, cov_radius)."""
    idx, dd = _kept(points, mask)
    db = points[idx]
    feats = _features(db)
    out = []
    for s in range(0, points.shape[0], TQ):
        d2 = _block_d2(points[s:s + TQ], db, dd)
        out.append(torch.cat([(d2 <= r * r).to(points.dtype) @ feats
                              for r in (radius, cov_radius)], dim=-1))
    return torch.cat(out)


def _launch_moments(points, mask, radius: float, cov_radius: float, prune):
    b, n, _ = points.shape
    _check_clouds("moments", points, ((mask, "mask", torch.bool, ()),))
    if prune is None:
        prune = radius_prune(points, mask)
    _require_prune("moments", prune, points)
    out = torch.empty((b, n, 20), dtype=torch.float32, device=points.device)
    lib = kernels.load_library()
    with torch.cuda.device(points.device):
        status = lib.flsq_fpfh_moments(
            points.data_ptr(), prune.qq.data_ptr(), prune.dd.data_ptr(),
            mask.data_ptr(), prune.q_end.data_ptr(), prune.db_end.data_ptr(),
            prune.tbox.data_ptr(), b, n, radius * radius,
            cov_radius * cov_radius, out.data_ptr(), kernels.stream(points))
    kernels.check_status(status, "fpfh moments")
    return out


def moments(points, mask, radius: float, cov_radius: float, prune=None):
    """(N, 20) moments at (radius, cov_radius) — kernel K3 on CUDA, where
    rows of masked queries are zero.  ``prune``: ``radius_prune(points,
    mask)`` with a leading batch axis of 1 (made here when None)."""
    if not kernels.on_cuda("moments", points):
        return moments_plain(points, mask, radius, cov_radius)
    out = _launch_moments(points[None], mask[None], radius, cov_radius,
                          prune)
    moments.launches += 1
    return out[0]


moments.launches = 0


def moments_batched_plain(points, mask, radius: float, cov_radius: float):
    return kernels.per_lane(
        lambda p, m: moments_plain(p, m, radius, cov_radius), points, mask)


def moments_batched(points, mask, radius: float, cov_radius: float,
                    prune=None):
    """(B, N, 20) moments of B clouds — kernel K3 in one launch on CUDA;
    ``prune`` as in ``moments``."""
    if not kernels.on_cuda("moments_batched", points):
        return moments_batched_plain(points, mask, radius, cov_radius)
    out = _launch_moments(points, mask, radius, cov_radius, prune)
    moments_batched.launches += 1
    return out


moments_batched.launches = 0


def _mom_comps(mom10):
    """(N, 10) moment columns -> (cnt, mean (N, 3), 6 covariance component
    tensors (N,)) in struct-of-arrays form."""
    cnt = mom10[:, 0]
    safe = torch.clamp(cnt, min=1.0)
    mean = mom10[:, 1:4] / safe[:, None]
    mx, my, mz = mean[:, 0], mean[:, 1], mean[:, 2]
    c00 = mom10[:, 4] / safe - mx * mx
    c01 = mom10[:, 5] / safe - mx * my
    c02 = mom10[:, 6] / safe - mx * mz
    c11 = mom10[:, 7] / safe - my * my
    c12 = mom10[:, 8] / safe - my * mz
    c22 = mom10[:, 9] / safe - mz * mz
    return cnt, mean, (c00, c01, c02, c11, c12, c22)


def _centroid(points, mask):
    """The mean of the valid points of one (N, 3) cloud: the viewpoint
    when none is given."""
    return torch.sum(points * mask[:, None], 0) / torch.clamp(
        torch.sum(mask).to(points.dtype), min=1.0)


def moments_to_normals_covs(mom, points, mask, viewpoint):
    """(N, 20) radius moments -> (normals, n_valid, cov_reg, mean).

    Normals: smallest eigenvector of the first moment block, oriented
    toward ``viewpoint`` ((3,), or (N, 3) one per point; the valid centroid
    when None).  Every step is elementwise per point, so a batch of clouds
    goes through flattened.  cov_reg: the
    Nano-GICP regularized plane covariance V diag(eps, 1, 1) V^T from the
    second block; identity where the neighbourhood is too small."""
    cnt, mean, comps = _mom_comps(mom[:, :10])
    _, evecs = linalg3.eigh3_soa(*comps)
    n = torch.stack([evecs[0][0], evecs[1][0], evecs[2][0]], dim=-1)
    if viewpoint is None:
        viewpoint = _centroid(points, mask)
    to_view = viewpoint - points  # viewpoint (3,) or one per point (N, 3)
    n = n * torch.where(torch.sum(n * to_view, -1, keepdim=True) < 0,
                        -1.0, 1.0)
    n_valid = mask & (cnt >= 3)
    n = torch.where(n_valid[:, None], n, 0.0)
    cnt_c, _, comps_c = _mom_comps(mom[:, 10:20])
    _, vc = linalg3.eigh3_soa(*comps_c)
    reg = (PLANE_EPS, 1.0, 1.0)
    cov_ok = n_valid & (cnt_c >= 3)
    rows = []
    for i in range(3):
        row = []
        for j in range(3):
            cij = sum(reg[k] * vc[i][k] * vc[j][k] for k in range(3))
            row.append(torch.where(cov_ok, cij, 1.0 if i == j else 0.0))
        rows.append(torch.stack(row, dim=-1))
    cov_reg = torch.stack(rows, dim=-2)
    return n, n_valid, cov_reg, mean


# ---------------------------------------------------------------------------
# the radius prune of K3, K4 and K5
# ---------------------------------------------------------------------------

def radius_tile_keep(points, qmask, dbkeep, radius: float,
                     block: int = FP_BLOCK, tile: int = FP_TILE):
    """(n_blocks, n_tiles) bool: may db tile t (``tile`` rows of the points
    in ``dbkeep``) hold a point within ``radius`` of a query of block b
    (``block`` rows of the points in ``qmask``)?  The model of K3-K5's
    keep rule, csrc/tile_prune.cuh: tile t non-empty and g2(b, t) <= r2 *
    PRUNE_SLACK + D2_ERR * (far2(b) + far2(t)), with g2 the smallest
    squared gap between the two boxes and far2 a box's largest |p|^2.  The
    second term covers the fp32 expansion's error, so no pair whose
    expanded d2 passes the radius test is dropped, far from the origin
    too."""
    qb = knn_cuda.tile_bboxes(points, qmask, block)
    tb = knn_cuda.tile_bboxes(points, dbkeep, tile)
    qlo, qhi = qb[:, None, :3], qb[:, None, 3:]
    tlo, thi = tb[None, :, :3], tb[None, :, 3:]
    gap = torch.clamp(torch.maximum(tlo - qhi, qlo - thi), min=0.0)
    g2 = gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1] \
        + gap[..., 2] * gap[..., 2]

    def far2(lo, hi):
        f = torch.maximum(lo * lo, hi * hi)
        return f[..., 0] + f[..., 1] + f[..., 2]

    r2s = torch.tensor(radius * radius, dtype=torch.float32,
                       device=points.device) * knn_cuda.PRUNE_SLACK
    bound = r2s + D2_ERR * (far2(qlo, qhi) + far2(tlo, thi))
    return (g2 <= bound) & (tlo[..., 0] <= thi[..., 0])


class RadiusPrune(NamedTuple):
    """A radius kernel's view of (B, N) clouds over its db set (K3: mask;
    K4 and K5, which share one: mask & n_valid): |p|^2 (qq), |p|^2 with
    the +3.4e38 penalty outside the db set (dd), each lane's query and db
    extents (``knn_cuda.lane_extents`` of mask and of the db set) and the
    tile boxes of the db set (B, ceil(N / FP_TILE), 6), all on the clouds'
    device."""
    qq: torch.Tensor
    dd: torch.Tensor
    q_end: torch.Tensor
    db_end: torch.Tensor
    tbox: torch.Tensor


def radius_prune(points, mask, n_valid=None) -> RadiusPrune:
    """``RadiusPrune`` of (B, N, 3) CUDA clouds over mask (K3's, when
    ``n_valid`` is None) or mask & n_valid (K4 and K5's): one tile-box
    launch and a few small torch ops, no host read."""
    b, n, _ = points.shape
    n_tiles = -(-n // FP_TILE)
    if n_tiles > FP_MAX_TILES:
        raise ValueError(f"the FPFH kernels take N <= "
                         f"{FP_TILE * FP_MAX_TILES}; got N={n}")
    masks = [(mask, "mask", torch.bool, ())]
    if n_valid is not None:
        masks.append((n_valid, "n_valid", torch.bool, ()))
    _check_clouds("radius_prune", points, masks)
    keep = mask if n_valid is None else mask & n_valid
    qq = sq_norms(points)
    db_end = knn_cuda.lane_extents(keep)
    tbox = torch.empty((b, n_tiles, 6), dtype=torch.float32,
                       device=points.device)
    lib = kernels.load_library()
    with torch.cuda.device(points.device):
        status = lib.flsq_fpfh_boxes(
            points.data_ptr(), keep.data_ptr(), db_end.data_ptr(), b, n,
            tbox.data_ptr(), kernels.stream(points))
    kernels.check_status(status, "fpfh tile boxes")
    return RadiusPrune(qq, qq + torch.where(keep, 0.0, _BIG),
                       knn_cuda.lane_extents(mask), db_end, tbox)


def _require_prune(name, prune: RadiusPrune, points) -> None:
    b, n, _ = points.shape
    dev = points.device
    for t, label, dt, shape in (
            (prune.qq, "qq", torch.float32, (b, n)),
            (prune.dd, "dd", torch.float32, (b, n)),
            (prune.q_end, "q_end", torch.int32, (b,)),
            (prune.db_end, "db_end", torch.int32, (b,)),
            (prune.tbox, "tbox", torch.float32, (b, -(-n // FP_TILE), 6))):
        kernels.require(t, f"{name}: {label}", dt, shape, dev)


@functools.lru_cache(maxsize=None)
def _theta_table(device: torch.device) -> torch.Tensor:
    """cos then sin of the 12 theta bin edges, on ``device`` (made once)."""
    return torch.tensor(_TH_COS + _TH_SIN, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# K4: SPFH
# ---------------------------------------------------------------------------

def _angles(p, u, db, dbn, d2):
    """Darboux (alpha, phi, ty, tx) for a (B, N) pair block; p, u are
    (B, 1) columns of query coords / normals, db, dbn (3, N) rows."""
    px, py, pz = p
    ux, uy, uz = u
    vx_, vy_, vz_ = db[0:1], db[1:2], db[2:3]
    nqx, nqy, nqz = dbn[0:1], dbn[1:2], dbn[2:3]
    inv_d = torch.rsqrt(torch.clamp(d2, min=1e-12))
    dx = (vx_ - px) * inv_d
    dy = (vy_ - py) * inv_d
    dz = (vz_ - pz) * inv_d
    cvx = dy * uz - dz * uy
    cvy = dz * ux - dx * uz
    cvz = dx * uy - dy * ux
    cvn = torch.rsqrt(torch.clamp(cvx * cvx + cvy * cvy + cvz * cvz,
                                  min=1e-18))
    cvx, cvy, cvz = cvx * cvn, cvy * cvn, cvz * cvn
    cwx = uy * cvz - uz * cvy
    cwy = uz * cvx - ux * cvz
    cwz = ux * cvy - uy * cvx
    alpha = cvx * nqx + cvy * nqy + cvz * nqz
    phi = ux * dx + uy * dy + uz * dz
    ty = cwx * nqx + cwy * nqy + cwz * nqz
    tx = ux * nqx + uy * nqy + uz * nqz
    return alpha, phi, ty, tx


def _hist33(alpha, phi, ty, tx, w):
    """(B, 34): 3 x 11 histogram of the pairs selected by the bool ``w``
    plus their count; counts are exact integers in float32."""
    hist = torch.zeros((w.shape[0], 3 * _NBINS), dtype=torch.float32,
                       device=w.device)
    wf = w.to(torch.float32)
    for k, vals in enumerate((alpha, phi)):
        b = torch.clamp(((vals + 1.0) * (_NBINS / 2.0)).to(torch.int64),
                        0, _NBINS - 1)
        hist[:, k * _NBINS:(k + 1) * _NBINS].scatter_add_(1, b, wf)
    # degenerate (0, 0) lands in the theta = 0 bin, like atan2(0, 0) = 0
    tx = tx + 1e-20
    sig = [ty * _TH_COS[j] - tx * _TH_SIN[j] for j in range(_NBINS + 1)]
    for j in range(_NBINS):
        m = (sig[j] >= 0.0) & (sig[j + 1] < 0.0) & w
        hist[:, 2 * _NBINS + j] = torch.sum(m, dim=1)
    return torch.cat([hist, torch.sum(w, dim=1, keepdim=True).to(hist.dtype)],
                     dim=1)


def spfh_plain(points, mask, normals, n_valid, radius: float):
    n = points.shape[0]
    idx, dd = _kept(points, mask & n_valid)
    r2 = radius * radius
    dbT, dbnT = points[idx].T, normals[idx].T
    out = []
    for s in range(0, n, TQ):
        qb, qnb = points[s:s + TQ], normals[s:s + TQ]
        d2 = _block_d2(qb, dbT.T, dd)
        w = (d2 <= r2) & _not_self(s, qb.shape[0], idx)
        alpha, phi, ty, tx = _angles(
            (qb[:, 0:1], qb[:, 1:2], qb[:, 2:3]),
            (qnb[:, 0:1], qnb[:, 1:2], qnb[:, 2:3]), dbT, dbnT, d2)
        out.append(_hist33(alpha, phi, ty, tx, w))
    return torch.cat(out)


def _launch_spfh(points, mask, normals, n_valid, radius: float, prune):
    b, n, _ = points.shape
    _check_clouds("spfh", points, (
        (mask, "mask", torch.bool, ()),
        (normals, "normals", torch.float32, (3,)),
        (n_valid, "n_valid", torch.bool, ())))
    if prune is None:
        prune = radius_prune(points, mask, n_valid)
    _require_prune("spfh", prune, points)
    out = torch.empty((b, n, FPFH_DIM + 1), dtype=torch.float32,
                      device=points.device)
    lib = kernels.load_library()
    with torch.cuda.device(points.device):
        status = lib.flsq_fpfh_spfh(
            points.data_ptr(), normals.data_ptr(), prune.qq.data_ptr(),
            prune.dd.data_ptr(), mask.data_ptr(),
            _theta_table(points.device).data_ptr(), prune.q_end.data_ptr(),
            prune.db_end.data_ptr(), prune.tbox.data_ptr(), b, n,
            radius * radius, out.data_ptr(), kernels.stream(points))
    kernels.check_status(status, "fpfh spfh")
    return out


def spfh(points, mask, normals, n_valid, radius: float, prune=None):
    """(N, 34) raw SPFH counts + neighbour count — kernel K4 on CUDA, where
    rows of masked queries are zero.  ``prune``: ``radius_prune`` of these
    operands with a leading batch axis of 1, shared with K5 (made here when
    None)."""
    if not kernels.on_cuda("spfh", points):
        return spfh_plain(points, mask, normals, n_valid, radius)
    out = _launch_spfh(points[None], mask[None], normals[None], n_valid[None],
                       radius, prune)
    spfh.launches += 1
    return out[0]


spfh.launches = 0


def spfh_batched_plain(points, mask, normals, n_valid, radius: float):
    return kernels.per_lane(lambda *a: spfh_plain(*a, radius), points, mask,
                            normals, n_valid)


def spfh_batched(points, mask, normals, n_valid, radius: float, prune=None):
    """(B, N, 34) SPFH of B clouds — kernel K4 in one launch on CUDA;
    ``prune`` as in ``spfh``."""
    if not kernels.on_cuda("spfh_batched", points):
        return spfh_batched_plain(points, mask, normals, n_valid, radius)
    out = _launch_spfh(points, mask, normals, n_valid, radius, prune)
    spfh_batched.launches += 1
    return out


spfh_batched.launches = 0


# ---------------------------------------------------------------------------
# K5: aggregation
# ---------------------------------------------------------------------------

def fpfh_agg_plain(points, mask, n_valid, spfh_n, radius: float):
    n = points.shape[0]
    idx, dd = _kept(points, mask & n_valid)
    db, spfh_db = points[idx], spfh_n[idx]
    r2 = radius * radius
    out = []
    for s in range(0, n, TQ):
        qb = points[s:s + TQ]
        d2 = _block_d2(qb, db, dd)
        in_r = (d2 <= r2) & _not_self(s, qb.shape[0], idx)
        # 1e-12 floor on d2 = the reference's 1e-6 m floor on d
        w = torch.where(in_r, torch.rsqrt(torch.clamp(d2, min=1e-12)), 0.0)
        out.append(torch.cat([w @ spfh_db,
                              torch.sum(in_r, dim=1, dtype=points.dtype
                                        )[:, None]], dim=-1))
    return torch.cat(out)


def _launch_agg(points, mask, n_valid, spfh_n, radius: float, prune):
    b, n, _ = points.shape
    _check_clouds("fpfh_agg", points, (
        (mask, "mask", torch.bool, ()),
        (n_valid, "n_valid", torch.bool, ()),
        (spfh_n, "spfh", torch.float32, (FPFH_DIM,))))
    if prune is None:
        prune = radius_prune(points, mask, n_valid)
    _require_prune("fpfh_agg", prune, points)
    out = torch.empty((b, n, FPFH_DIM + 1), dtype=torch.float32,
                      device=points.device)
    lib = kernels.load_library()
    with torch.cuda.device(points.device):
        status = lib.flsq_fpfh_agg(
            points.data_ptr(), prune.qq.data_ptr(), prune.dd.data_ptr(),
            mask.data_ptr(), spfh_n.data_ptr(), prune.q_end.data_ptr(),
            prune.db_end.data_ptr(), prune.tbox.data_ptr(), b, n,
            radius * radius, out.data_ptr(), kernels.stream(points))
    kernels.check_status(status, "fpfh aggregation")
    return out


def fpfh_agg(points, mask, n_valid, spfh_n, radius: float, prune=None):
    """(N, 34): sum of SPFH(v) / d(p, v) over neighbours + their count —
    kernel K5 on CUDA, where rows of masked queries are zero; ``prune`` as
    in ``spfh``."""
    if not kernels.on_cuda("fpfh_agg", points):
        return fpfh_agg_plain(points, mask, n_valid, spfh_n, radius)
    out = _launch_agg(points[None], mask[None], n_valid[None], spfh_n[None],
                      radius, prune)
    fpfh_agg.launches += 1
    return out[0]


fpfh_agg.launches = 0


def fpfh_agg_batched_plain(points, mask, n_valid, spfh_n, radius: float):
    return kernels.per_lane(lambda *a: fpfh_agg_plain(*a, radius), points,
                            mask, n_valid, spfh_n)


def fpfh_agg_batched(points, mask, n_valid, spfh_n, radius: float,
                     prune=None):
    """(B, N, 34) aggregation of B clouds — kernel K5 in one launch on
    CUDA; ``prune`` as in ``spfh``."""
    if not kernels.on_cuda("fpfh_agg_batched", points):
        return fpfh_agg_batched_plain(points, mask, n_valid, spfh_n, radius)
    out = _launch_agg(points, mask, n_valid, spfh_n, radius, prune)
    fpfh_agg_batched.launches += 1
    return out


fpfh_agg_batched.launches = 0


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _normalized_spfh(raw):
    cnt = raw[..., FPFH_DIM]
    return (raw[..., :FPFH_DIM] / torch.clamp(cnt, min=1.0)[..., None]
            ).contiguous()


def _descriptor(spfh_n, raw, agg, n_valid):
    """(desc, valid) from the SPFH counts and the aggregation."""
    cnt_f = agg[..., FPFH_DIM]
    fp = spfh_n + agg[..., :FPFH_DIM] / torch.clamp(cnt_f, min=1.0)[..., None]
    blocks = []
    for s in range(0, FPFH_DIM, _NBINS):
        blk = fp[..., s:s + _NBINS]
        blocks.append(100.0 * blk / torch.clamp(
            torch.sum(blk, -1, keepdim=True), min=1e-9))
    desc = torch.cat(blocks, dim=-1)
    valid = n_valid & (raw[..., FPFH_DIM] >= 3)
    return torch.where(valid[..., None], desc, 0.0), valid


def spfh_agg(points, mask, normals, n_valid, radius: float, batched: bool):
    """K4 then K5 of (B, N, ...) clouds on the rows given, with one
    ``radius_prune`` shared by both kernels on CUDA: (raw SPFH (B, N, 34),
    aggregation (B, N, 34)).  ``batched``: one K4b and one K5b launch for
    all lanes; else B = 1 through the single-cloud K4 and K5."""
    prune = radius_prune(points, mask, n_valid) if kernels.on_cuda(
        "spfh_agg", points) else None
    if batched:
        raw = spfh_batched(points, mask, normals, n_valid, radius, prune)
        return raw, fpfh_agg_batched(points, mask, n_valid,
                                     _normalized_spfh(raw), radius, prune)
    raw = spfh(points[0], mask[0], normals[0], n_valid[0], radius, prune)
    agg = fpfh_agg(points[0], mask[0], n_valid[0], _normalized_spfh(raw),
                   radius, prune)
    return raw[None], agg[None]


def surface_stage(points, mask, normal_radius: float, cov_radius: float,
                  viewpoint, batched: bool):
    """K3 (``batched``: K3b; else B = 1 through the single-cloud K3) and
    the normals and plane covariances of (B, N) clouds on the rows given,
    each lane's normals oriented toward its row of ``viewpoint`` (B, 3):
    (normals (B, N, 3), n_valid (B, N), cov_reg (B, N, 3, 3))."""
    b, n, _ = points.shape
    if batched:
        mom = moments_batched(points, mask, normal_radius, cov_radius)
    else:
        mom = moments(points[0], mask[0], normal_radius, cov_radius)[None]
    vp = viewpoint[:, None, :].expand(b, n, 3).reshape(b * n, 3)
    normals, n_valid, cov_reg, _ = moments_to_normals_covs(
        mom.reshape(b * n, 20), points.reshape(b * n, 3), mask.reshape(-1),
        vp)
    return (normals.reshape(b, n, 3).contiguous(), n_valid.reshape(b, n),
            cov_reg.reshape(b, n, 3, 3))


def _stages(points, mask, radii, viewpoint, batched: bool):
    """Every stage of ``fpfh_radius_batched`` on the rows given: (desc,
    valid, normals, n_valid, cov_reg), each (B, N, ...).  ``radii`` =
    (normal, feature, cov)."""
    normal_radius, feature_radius, cov_radius = radii
    normals, n_valid, cov_reg = surface_stage(
        points, mask, normal_radius, cov_radius, viewpoint, batched)
    raw, agg = spfh_agg(points, mask, normals, n_valid, feature_radius,
                        batched)
    desc, valid = _descriptor(_normalized_spfh(raw), raw, agg, n_valid)
    return desc, valid, normals, n_valid, cov_reg


def _viewpoints(points, mask, viewpoint):
    """(B, 3) viewpoints: those given, else each lane's valid centroid on
    the rows given (``_centroid`` on that lane's (N, 3) rows)."""
    if viewpoint is not None:
        return viewpoint
    return torch.stack([_centroid(p, m) for p, m in zip(points, mask)])


def sorted_route(points, mask, radii, viewpoint, batched: bool = True):
    """The card's route, the reference's ``use_tpu`` one
    (fpfh_stream.py:630-663), over (B, N) clouds: one Morton sort per lane
    (one argsort for all lanes) ahead of K3, one gather of the points and
    the mask, every stage on the sorted rows (``_stages``), and one
    scatter back per output: (desc, valid, normals, n_valid, cov_reg) in
    the caller's row order.  ``viewpoint`` None takes each lane's centroid
    on the caller's rows, before the sort, so it keeps its bits.  On CPU
    tensors the plain versions run on the sorted rows."""
    viewpoint = _viewpoints(points, mask, viewpoint)
    order = knn_cuda.morton_order_batched(points, mask)
    outs = _stages(knn_cuda.take_rows(points, order),
                   knn_cuda.take_rows(mask, order), radii, viewpoint,
                   batched)
    return tuple(knn_cuda.put_rows(o, order) for o in outs)


def _route(points, mask, radii, viewpoint, batched: bool):
    """On CUDA the sorted route; on CPU every stage on the caller's rows,
    as the reference's CPU path."""
    if kernels.on_cuda("fpfh_radius", points):
        return sorted_route(points, mask, radii, viewpoint, batched)
    return _stages(points, mask, radii, _viewpoints(points, mask, viewpoint),
                   batched)


def fpfh_radius(points, mask, normal_radius: float, feature_radius: float,
                viewpoint=None, cov_radius: float = 0.6):
    """Full radius-FPFH descriptor plus the shared surface geometry.

    Returns (desc (N, 33), valid (N,), (normals, n_valid, cov_reg)), where
    cov_reg are the Nano-GICP regularized plane covariances at cov_radius
    (see the reference's fpfh_radius for why 0.6 m); normals face
    ``viewpoint`` (3,), the valid centroid when None.  On CUDA every stage
    runs on the Morton-sorted cloud (``sorted_route``)."""
    radii = (float(normal_radius), float(feature_radius), float(cov_radius))
    vp = None if viewpoint is None else viewpoint[None]
    desc, valid, normals, n_valid, cov_reg = (o[0] for o in _route(
        points[None], mask[None], radii, vp, batched=False))
    return desc, valid, (normals, n_valid, cov_reg)


def fpfh_radius_batched(points, mask, normal_radius: float,
                        feature_radius: float, viewpoint,
                        cov_radius: float = 0.6):
    """``fpfh_radius`` of B clouds of equal padding — (B, N, 3) points,
    (B, N) masks, (B, 3) viewpoints — with one K3, one K4 and one K5
    launch for the whole batch (on CUDA on the Morton-sorted lanes).
    Returns the same tuple with a leading batch axis on every tensor."""
    radii = (float(normal_radius), float(feature_radius), float(cov_radius))
    desc, valid, normals, n_valid, cov_reg = _route(points, mask, radii,
                                                    viewpoint, batched=True)
    return desc, valid, (normals, n_valid, cov_reg)
