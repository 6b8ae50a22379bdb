"""Surfel voxel map — port of fast_lio_sam_qn_tpu/ops/surfel_map.py: per-voxel
accumulated moments with cached planes, the LIO's local map.

Each voxel accumulates the count, sum and symmetric outer-product sum of
every point inserted into it (relative to the voxel's center, so that every
stored quantity stays below res/2 and the covariance is platform-stable in
fp32), and caches a plane fitted from its own or its face neighbourhood's
moments.  A query is one probed lookup per point.

Tables (the reference's packed layout):
  - ``key``   (T, 4) int32: voxel coords and occupied 0/1;
  - ``mom``   (T, 10) fp32: [count, psum(3), m2 xx yy zz xy xz yz];
  - ``plane`` (T, 6) fp32: [n(3), d, valid, halo_dirty];
  - ``nbr``   (T, 6) int32: face-neighbour slot hints (-1 = none).

How the port keeps the reference's results:

- Scatter-sets write identical rows wherever an index repeats (the refit
  writes, the halo-source clear, the neighbour-hint maintenance), and the
  halo plane write has unique winners through the reference's score-then-
  rank tie-break.  Rows that the reference drops go to a dump row past the
  table (``_set_rows``).
- Scatter-mins are ``scatter_reduce(..., "amin")``, exact in any order.
- The moment scatter-add sums each voxel's rows in ascending point order
  (a stable sort by slot, then ``segment_reduce``), as the reference's
  scatter does on the CPU; it repeats bit for bit on CUDA, where
  ``index_add_`` with repeated indices does not.
- The reference's ``lax.cond`` tiers come in two kinds.  The caps
  (``hood_cap``, ``halo_cap``) change the result and are ported exactly.
  The others (the probe-0 locate, the compacted claim and hint-maintenance
  batches, the compacted halo claim and write, the skips when there is
  nothing to claim, refit or propagate) give the same map as their full
  form, so the port always runs the full form: no host read picks a
  branch, and an insert never waits on the card.  So its shapes alone fix
  its work, and the LIO replays it as one CUDA graph a scan
  (``models/lio.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import linalg3
from .hashgrid import _INT_MAX, _probe_slots, _scatter_rounds
from .voxel import voxel_coords


class SurfelMap(NamedTuple):
    key: torch.Tensor      # (T, 4) int32 [voxel coords | occupied 0/1]
    mom: torch.Tensor      # (T, 10) packed center-relative moments
    plane: torch.Tensor    # (T, 6) packed cached plane + flags
    nbr: torch.Tensor      # (T, 6) int32 face-neighbour slot hints
    res: float             # voxel edge

    @property
    def table_size(self) -> int:
        return self.key.shape[0]

    @property
    def coords(self) -> torch.Tensor:
        return self.key[:, :3]

    @property
    def occupied(self) -> torch.Tensor:
        return self.key[:, 3] > 0

    @property
    def count(self) -> torch.Tensor:
        return self.mom[:, 0]

    @property
    def psum(self) -> torch.Tensor:
        return self.mom[:, 1:4]

    @property
    def m2(self) -> torch.Tensor:
        return _sym_to_mat(self.mom[:, 4:10])

    @property
    def plane_n(self) -> torch.Tensor:
        return self.plane[:, :3]

    @property
    def plane_d(self) -> torch.Tensor:
        return self.plane[:, 3]

    @property
    def plane_valid(self) -> torch.Tensor:
        return self.plane[:, 4] > 0.5

    @property
    def halo_dirty(self) -> torch.Tensor:
        return self.plane[:, 5] > 0.5


# a refit marks a voxel halo-dirty when its plane moved by more than these
# (normal angle ~3 deg, offset 2 cm)
_HALO_COS_TOL = 0.9986
_HALO_D_TOL = 0.02


def _face(device) -> torch.Tensor:
    """(6, 3) int32 face-neighbour offsets, order [+x -x +y -y +z -z]
    (opposite face = f ^ 1), built on the device (no host copy)."""
    eye = torch.eye(3, dtype=torch.int32, device=device)
    return torch.stack([eye, -eye], dim=1).reshape(6, 3)


def _neighbor_offsets(device) -> torch.Tensor:
    """(27, 3) int32 offsets of the 3^3 neighbourhood, x slowest."""
    r = torch.arange(-1, 2, dtype=torch.int32, device=device)
    ox, oy, oz = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1), oz.reshape(-1)], -1)


def _hood_offsets(window: int, device) -> torch.Tensor:
    """27 = the full 3^3; 7 = center + the six faces (the nbr-hint order)."""
    if window == 27:
        return _neighbor_offsets(device)
    assert window == 7
    return torch.cat([torch.zeros((1, 3), dtype=torch.int32, device=device),
                      _face(device)], dim=0)


def _compact_idx(key: torch.Tensor, cap: int) -> torch.Tensor:
    """Row indices of the first ``cap`` rows by stable ascending-key order
    (boolean callers pass ~wanted so wanted rows come first): the
    reference's counting rank, which equals a stable argsort."""
    assert cap <= key.shape[0]
    return torch.argsort(key.to(torch.int32), stable=True)[:cap]


def _outer_sym(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 6) symmetric outer product [xx yy zz xy xz yz]."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([x * x, y * y, z * z, x * y, x * z, y * z], -1)


def _sym_to_mat(s: torch.Tensor) -> torch.Tensor:
    """(..., 6) [xx yy zz xy xz yz] -> (..., 3, 3) symmetric matrix."""
    xx, yy, zz, xy, xz, yz = (s[..., i] for i in range(6))
    return torch.stack([
        torch.stack([xx, xy, xz], -1),
        torch.stack([xy, yy, yz], -1),
        torch.stack([xz, yz, zz], -1),
    ], dim=-2)


def _cross_sym(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sym(a b^T + b a^T) in packed form."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([
        2 * ax * bx, 2 * ay * by, 2 * az * bz,
        ax * by + ay * bx, ax * bz + az * bx, ay * bz + az * by], -1)


def empty(res: float, table_size: int,
          device: torch.device | str) -> SurfelMap:
    assert table_size & (table_size - 1) == 0
    return SurfelMap(
        key=torch.zeros((table_size, 4), dtype=torch.int32, device=device),
        mom=torch.zeros((table_size, 10), dtype=torch.float32, device=device),
        plane=torch.zeros((table_size, 6), dtype=torch.float32,
                          device=device),
        nbr=torch.full((table_size, 6), -1, dtype=torch.int32, device=device),
        res=res,
    )


def _set_rows(table: torch.Tensor, idx: torch.Tensor,
              rows: torch.Tensor) -> torch.Tensor:
    """table[idx] = rows, rows whose idx is len(table) dropped (they land in
    a dump row past the table)."""
    out = torch.cat([table, table[:1]])
    out[idx] = rows.to(table.dtype)
    return out[:-1]


def _pack_key(coords: torch.Tensor, occupied: torch.Tensor) -> torch.Tensor:
    return torch.cat([coords, occupied.to(torch.int32)[:, None]], dim=1)


def _vox_center(coords: torch.Tensor, res: float) -> torch.Tensor:
    """World-space center of each voxel; the moments are relative to it."""
    return (coords.to(torch.float32) + 0.5) * res


def _locate(m: SurfelMap, coords: torch.Tensor):
    """(..., 3) coords -> (slot (...,) int64, found (...,)) via verified
    probes: the first probe whose occupied row holds these coords."""
    slots = _probe_slots(coords, m.table_size)             # (..., P)
    kv = m.key[slots]                                      # (..., P, 4)
    hit = (kv[..., 3] > 0) & torch.all(kv[..., :3] == coords[..., None, :],
                                       dim=-1)
    first = torch.argmax(hit.to(torch.int32), dim=-1)      # first hit
    found = torch.any(hit, dim=-1)
    slot = torch.gather(slots, -1, first[..., None])[..., 0]
    return torch.where(found, slot, 0), found


def _nbr_lookup(m: SurfelMap, slots: torch.Tensor, coords_s: torch.Tensor):
    """Face-neighbour slots of the voxels at ``slots`` (coords
    ``coords_s``) through the hint table: one verified gather.  The claim-
    time maintenance keeps face-adjacent present voxels pointing at each
    other, so a verified miss means the neighbour is absent.  Returns
    (nslot (..., 6) int64, nfound (..., 6))."""
    t = m.table_size
    ns = m.nbr[slots].to(torch.int64)                      # (..., 6)
    nsc = torch.clamp(ns, 0, t - 1)
    expect = coords_s[..., None, :] + _face(coords_s.device)
    kv = m.key[nsc]
    ok = (ns >= 0) & (kv[..., 3] > 0) & torch.all(kv[..., :3] == expect,
                                                  dim=-1)
    return torch.where(ok, nsc, 0), ok


def _claim_maintain_nbr(m_post: SurfelMap, bcoords: torch.Tensor,
                        point_slot: torch.Tensor) -> torch.Tensor:
    """Restore the face-neighbour invariant after a claim batch: every row
    with point_slot >= 0 won a previously empty slot.  Locate its 6 face
    neighbours on the post-claim map, then write both directions:
      nbr[winner, f]       = neighbour slot (or -1)
      nbr[neighbour, f ^ 1] = winner slot
    Back-pointer cells are unique per (slot, face), and two adjacent
    winners writing each other write identical values."""
    t = m_post.table_size
    dev = bcoords.device
    won = point_slot >= 0
    wslot = torch.where(won, point_slot, t)
    ncoords = bcoords[:, None, :] + _face(dev)[None]       # (B, 6, 3)
    nslot, nfound = _locate(m_post, ncoords)
    eff = won[:, None] & nfound
    fwd = torch.where(eff, nslot, -1)
    nbr = _set_rows(m_post.nbr, wslot, fwd)
    bslot = torch.where(eff, nslot, t)
    opp = (torch.arange(6, device=dev) ^ 1).expand(bslot.shape)
    back = wslot[:, None].expand(bslot.shape)
    out = torch.cat([nbr, nbr[:1]])
    out[bslot, opp] = back.to(torch.int32)
    return out[:-1]


def _plane_from(cnt, psum, m2_sym, center):
    """Fit (n, d, thickness, spread) from center-relative packed moments:
    the normal is the smallest eigenvector of the covariance; thickness and
    spread are the square roots of the smallest and middle eigenvalues."""
    denom = torch.clamp(cnt, min=1.0)
    mean = psum / denom[:, None]
    cov = m2_sym / denom[:, None] - _outer_sym(mean)
    evals, evecs = linalg3.eigh3_soa(
        cov[:, 0], cov[:, 3], cov[:, 4], cov[:, 1], cov[:, 5], cov[:, 2])
    n = torch.stack([evecs[0][0], evecs[1][0], evecs[2][0]], dim=-1)
    d = -torch.sum(n * (center + mean), dim=-1)
    thick = torch.sqrt(torch.clamp(evals[0], min=0.0))
    spread = torch.sqrt(torch.clamp(evals[1], min=0.0))
    return n, d, thick, spread


def _pack_plane(n, d, valid, dirty):
    return torch.cat([n, d[:, None], valid.to(torch.float32)[:, None],
                      dirty.to(torch.float32)[:, None]], dim=-1)


def _plane_changed(n_new, d_new, prev_rows):
    """Did the fit move past the halo tolerances?  Sign-aligned, since
    (n, d) and (-n, -d) are the same plane."""
    n_prev, d_prev = prev_rows[:, :3], prev_rows[:, 3]
    v_prev = prev_rows[:, 4] > 0.5
    dot = torch.sum(n_new * n_prev, dim=-1)
    s = torch.where(dot < 0, -1.0, 1.0)
    return (~v_prev | (torch.abs(dot) < _HALO_COS_TOL)
            | (torch.abs(d_new - s * d_prev) > _HALO_D_TOL))


def _refit_planes(m: SurfelMap, slots: torch.Tensor, slot_valid: torch.Tensor,
                  thickness: float, min_pts: int = 6,
                  hood_cap: int | None = None, hood_window: int = 27):
    """Recompute the cached planes of the given slots: an own-moments fit
    where the voxel is populated (>= 3 min_pts) and its fit passes the
    gates, else a neighbourhood fit, compacted to the first ``hood_cap``
    rows that need it (``None`` = every row).  Returns (map, the pre-refit
    plane rows, the post-refit rows reconstructed per input row,
    recon_exact: whether every hood row made the compacted batch)."""
    t = m.table_size
    dev = slots.device
    s_rows = slots.shape[0]
    min_spread = 0.5 * thickness
    mom_o = m.mom[slots]
    cnt_o = mom_o[:, 0]
    center_o = _vox_center(m.key[slots, :3], m.res)
    n_o, d_o, th_o, sp_o = _plane_from(
        cnt_o, mom_o[:, 1:4], mom_o[:, 4:10], center_o)
    use_own = (cnt_o >= 3 * min_pts) & (th_o < thickness) & (
        sp_o > min_spread)

    prev_o = m.plane[slots]
    own_rows = slot_valid & use_own
    dirty_o = prev_o[:, 5] > 0.5
    new_dirty_o = dirty_o | _plane_changed(n_o, d_o, prev_o)
    rows_o = _pack_plane(n_o, d_o, own_rows, new_dirty_o & own_rows)
    plane = _set_rows(m.plane, torch.where(own_rows, slots, t), rows_o)

    need_hood = slot_valid & ~use_own
    if hood_cap is not None and hood_cap < s_rows:
        h_idx = _compact_idx(~need_hood, hood_cap)
        h_slots = slots[h_idx]
        h_valid = need_hood[h_idx]
        recon_exact = torch.sum(need_hood) <= hood_cap
    else:
        h_idx = None
        h_slots = slots
        h_valid = need_hood
        recon_exact = torch.ones((), dtype=torch.bool, device=dev)
    kv_h = m.key[h_slots]
    coords = kv_h[:, :3]
    offs = _hood_offsets(hood_window, dev)
    if hood_window == 7:
        # self + the 6 hinted neighbours: one verified gather
        ns6, ok6 = _nbr_lookup(m, h_slots, coords)
        nslot = torch.cat([h_slots[:, None], ns6], dim=1)
        nfound = torch.cat([(kv_h[:, 3] > 0)[:, None], ok6], dim=1)
    else:
        nslot, nfound = _locate(m, coords[:, None, :] + offs[None])
    w = (nfound & h_valid[:, None]).to(torch.float32)
    # neighbour moments are relative to their own center: shift them to
    # the central voxel's (delta = offset * res, exact in fp32)
    delta = offs.to(torch.float32) * m.res                # (W, 3)
    mom_j = m.mom[nslot] * w[..., None]                   # (H, W, 10)
    cnt_j = mom_j[..., 0]
    psum_j = mom_j[..., 1:4]
    m2_j = mom_j[..., 4:10]
    dsym = _outer_sym(delta)
    cross = _cross_sym(delta.expand(psum_j.shape), psum_j)
    cnt = torch.sum(cnt_j, dim=1)
    psum = torch.sum(psum_j + cnt_j[..., None] * delta[None], dim=1)
    m2 = torch.sum(m2_j + cross + cnt_j[..., None] * dsym[None], dim=1)
    center_h = _vox_center(coords, m.res)
    n_h, d_h, th_h, sp_h = _plane_from(cnt, psum, m2, center_h)
    h_ok = (cnt >= min_pts) & (th_h < thickness) & (sp_h > min_spread)
    prev_h = m.plane[h_slots]
    valid_new = h_valid & h_ok
    dirty_new = (prev_h[:, 5] > 0.5) | _plane_changed(n_h, d_h, prev_h)
    rows_h = _pack_plane(n_h, d_h, valid_new, dirty_new & valid_new)
    plane = _set_rows(plane, torch.where(h_valid, h_slots, t), rows_h)

    # the post-refit row of every input row, without a table gather
    after_est = torch.where(own_rows[:, None], rows_o, prev_o)
    if h_idx is not None:
        after_est = _set_rows(after_est, torch.where(h_valid, h_idx, s_rows),
                              rows_h)
    else:
        after_est = torch.where(h_valid[:, None], rows_h, after_est)
    return m._replace(plane=plane), prev_o, after_est, recon_exact


def _claim(m: SurfelMap, coords: torch.Tensor, want: torch.Tensor):
    """Claim slots for the ``want`` rows' voxels (full batch), keep the
    neighbour hints, and relocate every row on the new map.  Returns (key,
    nbr, slot, found)."""
    t = m.table_size
    w0 = torch.full((t + 1,), _INT_MAX, dtype=torch.int64,
                    device=coords.device)
    occ1, winner, pslot = _scatter_rounds(m.occupied, w0, coords, want, t)
    winner = winner[:t]
    newly = winner != _INT_MAX
    widx = torch.where(newly, winner, 0)
    new_coords = torch.where(newly[:, None], coords[widx], m.key[:, :3])
    key1 = _pack_key(new_coords, occ1)
    m1 = m._replace(key=key1)
    nbr1 = _claim_maintain_nbr(m1, coords, pslot)
    slot, found = _locate(m1, coords)
    return key1, nbr1, slot, found


def _segment_sum(rows: torch.Tensor, seg: torch.Tensor,
                 num: int) -> torch.Tensor:
    """(num, C) per-segment sums of ``rows``, each segment's rows added in
    ascending row order starting from zero (deterministic on CUDA)."""
    order = torch.argsort(seg, stable=True)
    lengths = torch.zeros(num, dtype=torch.int64, device=seg.device)
    lengths.scatter_add_(0, seg, torch.ones_like(seg))
    return torch.segment_reduce(rows[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)


def insert(m: SurfelMap, points: torch.Tensor, mask: torch.Tensor,
           thickness: float, hood_cap: int | None = None, halo: bool = True,
           halo_cap: int | None = None, hood_window: int = 27) -> SurfelMap:
    """Accumulate points into voxel moments and refresh the touched voxels'
    planes.  hood_cap bounds the neighbourhood refits (None = uncapped) and
    halo_cap the halo sources (0 / None = uncapped); hood_window 27 (3^3)
    or 7 (face hood).
    halo=False skips the halo propagation (ablation / profiling only)."""
    t = m.table_size
    coords = voxel_coords(points, m.res)

    # 1. locate existing voxels and claim slots for new ones
    slot, found = _locate(m, coords)
    key2, nbr, slot2, found2 = _claim(m, coords, mask & ~found)
    m = m._replace(key=key2, nbr=nbr)
    use = mask & found2
    sidx = torch.where(use, slot2, t)                     # t: dump row

    # 2. add the center-relative moments, per voxel in point order
    cnt_before = m.mom[torch.clamp(sidx, 0, t - 1), 0]
    w = use.to(torch.float32)
    rel = points - _vox_center(coords, m.res)
    upd = torch.cat([w[:, None], rel * w[:, None], _outer_sym(rel) * w[:, None]],
                    dim=-1)
    added = _segment_sum(upd, sidx, t + 1)[:t]
    m = m._replace(mom=m.mom + added)

    # 3. refit the planes of the touched voxels
    sclip = torch.clamp(sidx, 0, t - 1)
    m, prev_rows, after_est, recon_exact = _refit_planes(
        m, sclip, use, thickness, hood_cap=hood_cap, hood_window=hood_window)
    valid_before = prev_rows[:, 4] > 0.5
    if not halo:
        return m

    # 4. halo: propagate the planes of the frontier (voxels receiving their
    # first points, planes that just turned valid) and of halo-dirty voxels
    # into their unmapped face neighbours
    n_pts = points.shape[0]
    after_rows = torch.where(recon_exact, after_est, m.plane[sclip])
    valid_after = after_rows[:, 4] > 0.5
    dirty = after_rows[:, 5] > 0.5
    frontier = (cnt_before == 0.0) | (valid_after & ~valid_before)
    src_plane_ok = use & valid_after & (frontier | dirty)
    halo_cap = min(n_pts, (halo_cap or n_pts))
    if halo_cap < n_pts:
        # priority: frontier first, dirty refresh second
        prio = torch.where(use & valid_after & frontier, 0,
                           torch.where(src_plane_ok, 1, 2))
        idx = _compact_idx(prio, halo_cap)
        h_src_coords, h_src_sidx = coords[idx], sidx[idx]
        src_plane_ok = src_plane_ok[idx]
    else:
        h_src_coords, h_src_sidx = coords, sidx

    src_clip = torch.clamp(h_src_sidx, 0, t - 1)
    # propagated sources are in sync with their halos: clear the dirty bit
    cleared = m.plane[src_clip].clone()
    cleared[:, 5] = 0.0
    m = m._replace(plane=_set_rows(
        m.plane, torch.where(src_plane_ok, src_clip, t), cleared))
    hcoords = (h_src_coords[:, None, :] + _face(points.device)[None]).reshape(
        halo_cap * 6, 3)
    hmask = torch.repeat_interleave(src_plane_ok, 6)
    # rows whose target is unmapped bid for slots (the hint table answers
    # the fan's locate; rows outside hmask are never read)
    _, ok6 = _nbr_lookup(m, src_clip, h_src_coords)
    need = hmask & ~ok6.reshape(-1)
    key3, nbr3, hslot, hfound2 = _claim(m, hcoords, need)
    m = m._replace(key=key3, nbr=nbr3)
    # write source planes into halo slots that hold no points; several
    # sources may target one slot: the source whose plane best explains
    # the halo voxel's center wins, exact ties to the lowest fan row
    src_plane6 = torch.repeat_interleave(cleared, 6, dim=0)
    writable = hmask & hfound2 & (m.mom[hslot, 0] == 0.0)
    widx2 = torch.where(writable, hslot, t)
    hcenter = _vox_center(hcoords, m.res)
    score = torch.abs(torch.sum(src_plane6[:, :3] * hcenter, dim=-1)
                      + src_plane6[:, 3])
    score = torch.where(writable, score, torch.inf)
    best = torch.full((t + 1,), torch.inf, dtype=torch.float32,
                      device=points.device).scatter_reduce_(
        0, widx2, score, "amin", include_self=True)
    wclip = torch.clamp(widx2, 0, t - 1)
    is_best = writable & (score <= best[wclip])
    rank = torch.arange(score.shape[0], device=points.device)
    bidx = torch.where(is_best, widx2, t)
    best_rank = torch.full((t + 1,), _INT_MAX, dtype=torch.int64,
                           device=points.device).scatter_reduce_(
        0, bidx, rank, "amin", include_self=True)
    win = is_best & (rank == best_rank[torch.clamp(bidx, 0, t - 1)])
    return m._replace(plane=_set_rows(
        m.plane, torch.where(win, widx2, t), src_plane6))


def query_planes(m: SurfelMap, points: torch.Tensor, mask: torch.Tensor,
                 window: int = 3):
    """Per-point cached plane lookup.  window=1: the point's own voxel;
    window=3: of the 27 neighbouring voxels with a valid plane, the one
    whose centroid is nearest.  Returns (n (N, 3), resid (N,) = n.p + d,
    valid (N,))."""
    coords = voxel_coords(points, m.res)
    if window == 1:
        slot, found = _locate(m, coords)
        rows = m.plane[slot]
        n = rows[:, :3]
        d = rows[:, 3]
        valid = mask & found & (rows[:, 4] > 0.5)
    else:
        assert window == 3
        ncoords = coords[:, None, :] + _neighbor_offsets(points.device)[None]
        slot, found = _locate(m, ncoords)                  # (N, 27)
        rows = m.plane[slot]
        mom = m.mom[slot]
        ok = found & (rows[..., 4] > 0.5) & mask[:, None]
        centroid = _vox_center(m.key[slot, :3], m.res) + (
            mom[..., 1:4] / torch.clamp(mom[..., 0], min=1.0)[..., None])
        c_d2 = torch.sum((centroid - points[:, None, :]) ** 2, dim=-1)
        c_d2 = torch.where(ok, c_d2, torch.inf)
        j = torch.argmin(c_d2, dim=-1)
        rows_b = torch.gather(rows, 1, j[:, None, None].expand(-1, 1, 6))[:, 0]
        valid = torch.isfinite(torch.gather(c_d2, 1, j[:, None])[:, 0])
        n = rows_b[:, :3]
        d = rows_b[:, 3]
    resid = torch.sum(n * points, dim=-1) + d
    return (torch.where(valid[:, None], n, 0.0),
            torch.where(valid, resid, 0.0), valid)


def evict_beyond(m: SurfelMap, center: torch.Tensor,
                 radius: float) -> SurfelMap:
    """Drop voxels whose centroid lies beyond ``radius`` of ``center``
    (moments and planes zeroed, so the slots are reusable).  ``radius``
    should be fp32-exact; its square is taken in fp32, as the
    reference's."""
    r = torch.tensor(radius, dtype=torch.float32)
    r2 = float(r * r)
    mean = _vox_center(m.key[:, :3], m.res) + (
        m.mom[:, 1:4] / torch.clamp(m.mom[:, 0], min=1.0)[:, None])
    d2 = torch.sum((mean - center[None]) ** 2, dim=-1)
    keep = (m.key[:, 3] > 0) & (d2 <= r2)
    kf = keep.to(torch.float32)[:, None]
    return m._replace(
        key=_pack_key(m.key[:, :3], keep),
        mom=m.mom * kf,
        plane=m.plane * kf,
    )
