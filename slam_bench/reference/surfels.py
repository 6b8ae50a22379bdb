"""The LIO's local map as the configurations define it, kept as plain
sorted arrays: per occupied voxel its points' count, sum and second
moments (relative to the voxel's centre), a cached plane, and the slot it
holds in the configured table.

Inserting a scan (``insert``): a new voxel takes the first free one of
its four probe slots, voxels bidding in the order of their first rows,
and is not stored where all four are taken; every point adds to its
stored voxel; each touched voxel refits its plane from its own moments
when it holds 18 or more points and the fit is thin and wide enough, and
otherwise from the moments of itself and its present face neighbours,
for the first ``hood_cap`` rows in row order that need it; then the
voxels that just gained a valid plane or points for the first time, and
those whose plane moved, lend their plane to their empty face neighbours
(created as above), for the first ``halo_cap`` rows by that priority,
where each empty voxel takes the plane that passes nearest its centre.
``evict`` drops the voxels whose centroid lies beyond a radius.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry as G

MIN_PTS = 6              # a neighbourhood fit needs this many points,
OWN_FIT_FACTOR = 3       # an own fit this many times as many
HALO_COS = 0.9986        # a plane that turns by more than ~3 deg,
HALO_D = 0.02            # or moves by more than 2 cm, is lent again

FACES = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], dtype=torch.int64)


class Map(NamedTuple):
    keys: torch.Tensor     # (M,) int64, sorted (geometry.pack)
    mom: torch.Tensor      # (M, 10) [count, sum (3), xx yy zz xy xz yz]
    plane: torch.Tensor    # (M, 6) [normal (3), offset, valid, moved]
    slot: torch.Tensor     # (M,) int64, the table slot the voxel holds
    res: float
    table: int             # the table's slots

    def find(self, keys: torch.Tensor):
        """(index, present) of each key."""
        if self.keys.numel() == 0:
            z = torch.zeros_like(keys)
            return z, torch.zeros_like(keys, dtype=torch.bool)
        i = torch.searchsorted(self.keys, keys).clamp(max=self.keys.numel()
                                                      - 1)
        return i, self.keys[i] == keys

    def centre(self, keys: torch.Tensor) -> torch.Tensor:
        return (G.unpack(keys).to(self.mom.dtype) + 0.5) * self.res

    def take(self, keep: torch.Tensor) -> "Map":
        return self._replace(keys=self.keys[keep], mom=self.mom[keep],
                             plane=self.plane[keep], slot=self.slot[keep])

    def claim(self, keys: torch.Tensor, bids: torch.Tensor) -> "Map":
        """The map with an empty voxel for each absent key that wins a free
        slot: in each probe round every unplaced voxel bids for its next
        probe slot, the lowest bid (a voxel's first row) taking a free one;
        a voxel whose probes are all taken is not stored."""
        _, have = self.find(keys)
        keys, inv = torch.unique(keys[~have], return_inverse=True)
        if keys.numel() == 0:
            return self
        dev, t = keys.device, self.table
        bid = torch.full((keys.numel(),), 1 << 62, dtype=torch.int64,
                         device=dev).scatter_reduce(0, inv, bids[~have],
                                                    "amin")
        slots = G.probe_slots(G.unpack(keys), t)
        taken = torch.zeros(t + 1, dtype=torch.bool, device=dev)
        taken[self.slot] = True
        placed = torch.full_like(bid, -1)
        for p in range(G.PROBES):
            want = torch.where(placed < 0, slots[:, p], t)
            low = torch.full((t + 1,), 1 << 62, dtype=torch.int64,
                             device=dev).scatter_reduce(0, want, bid, "amin")
            won = (want < t) & ~taken[want] & (low[want] == bid)
            placed = torch.where(won, want, placed)
            taken[want[won]] = True
        new = placed >= 0
        keys, order = torch.sort(torch.cat([self.keys, keys[new]]))
        n = int(new.sum())
        pad = lambda x: torch.cat([x, x.new_zeros((n, x.shape[1]))])[order]
        return self._replace(keys=keys, mom=pad(self.mom),
                             plane=pad(self.plane),
                             slot=torch.cat([self.slot, placed[new]])[order])


def from_tables(key, mom, plane, res: float, dtype) -> Map:
    """The map held in a program's tables: rows whose key's fourth column
    is set, with their coordinates, moments, planes and slots."""
    occ = key[:, 3] > 0
    keys, order = torch.sort(G.pack(key[occ, :3].to(torch.int64)))
    slot = torch.nonzero(occ).flatten()[order]
    return Map(keys, mom[occ].to(dtype)[order], plane[occ].to(dtype)[order],
               slot, float(res), key.shape[0])


def evict(m: Map, centre: torch.Tensor, radius: float) -> Map:
    mean = m.centre(m.keys) + m.mom[:, 1:4] / m.mom[:, :1].clamp(min=1)
    return m.take(((mean - centre) ** 2).sum(-1) <= radius * radius)


def _outer(v):
    x, y, z = v.unbind(-1)
    return torch.stack([x * x, y * y, z * z, x * y, x * z, y * z], -1)


def _fit(mom: torch.Tensor, centre: torch.Tensor):
    """(normal, offset, thickness, spread) of the points' covariance: the
    normal its least eigenvector, thickness and spread the square roots of
    its two least eigenvalues."""
    cnt = mom[:, :1].clamp(min=1)
    mean = mom[:, 1:4] / cnt
    s = mom[:, 4:10] / cnt - _outer(mean)
    cov = torch.stack([torch.stack([s[:, 0], s[:, 3], s[:, 4]], -1),
                       torch.stack([s[:, 3], s[:, 1], s[:, 5]], -1),
                       torch.stack([s[:, 4], s[:, 5], s[:, 2]], -1)], -2)
    # on the host: cuSOLVER's batched eigensolver refuses batches this long
    evals, evecs = (t.to(cov.device) for t in torch.linalg.eigh(cov.cpu()))
    n = evecs[:, :, 0]
    d = -(n * (centre + mean)).sum(-1)
    return (n, d, evals[:, 0].clamp(min=0).sqrt(),
            evals[:, 1].clamp(min=0).sqrt())


def _moved(n, d, prev):
    dot = (n * prev[:, :3]).sum(-1)
    sign = torch.where(dot < 0, -1.0, 1.0).to(n.dtype)
    return ((prev[:, 4] < 0.5) | (dot.abs() < HALO_COS)
            | ((d - sign * prev[:, 3]).abs() > HALO_D))


def _first(rows: torch.Tensor, cap: int) -> torch.Tensor:
    """Indices of the first ``cap`` true rows, in row order."""
    return torch.nonzero(rows).flatten()[:cap]


def insert(m: Map, points: torch.Tensor, mask: torch.Tensor,
           thickness: float, hood_cap: int, halo_cap: int) -> Map:
    """The map after inserting the rows of ``points`` that ``mask`` keeps;
    the row order decides which rows the two caps keep."""
    dt, dev = m.mom.dtype, points.device
    faces = FACES.to(dev)
    rows = points.shape[0]
    coords = G.voxel_of(points, m.res)
    keys = G.pack(coords)
    rank = torch.arange(rows, device=dev)
    m = m.claim(keys[mask], rank[mask])
    vi, use = m.find(keys)
    use &= mask

    # 1. moments
    cnt_before = torch.where(use, m.mom[vi, 0], 0)
    rel = points - m.centre(keys)
    add = torch.cat([torch.ones_like(rel[:, :1]), rel, _outer(rel)], -1)
    mom = m.mom.index_add(0, vi[use], add[use])
    m = m._replace(mom=mom)
    prev = m.plane[vi]

    # 2. planes: own fits, then neighbourhood fits for the first rows
    n, d, thick, spread = _fit(mom[vi], m.centre(keys))
    own = (mom[vi, 0] >= OWN_FIT_FACTOR * MIN_PTS) & (thick < thickness) & \
        (spread > 0.5 * thickness)
    plane = m.plane.clone()
    r = use & own
    moved = (prev[:, 5] > 0.5) | _moved(n, d, prev)
    plane[vi[r]] = torch.cat([n, d[:, None], torch.ones_like(d)[:, None],
                              moved.to(dt)[:, None]], -1)[r]
    h = _first(use & ~own, hood_cap or rows)
    if h.numel():
        hk = keys[h]
        hood = torch.cat([hk[:, None], G.pack(coords[h][:, None] + faces)],
                         1)                                   # (H, 7)
        j, present = m.find(hood)
        shift = torch.cat([faces.new_zeros(1, 3), faces]).to(dt) * m.res
        mj = mom[j] * present[..., None].to(dt)
        c, s = mj[..., :1], mj[..., 1:4]
        hm = torch.cat([
            c.sum(1), (s + c * shift).sum(1),
            (mj[..., 4:] + _outer_cross(shift, s) + c * _outer(shift)).sum(1)],
            -1)
        n2, d2, t2, s2 = _fit(hm, m.centre(hk))
        ok = (hm[:, 0] >= MIN_PTS) & (t2 < thickness) & \
            (s2 > 0.5 * thickness)
        moved2 = ((prev[h, 5] > 0.5) | _moved(n2, d2, prev[h])) & ok
        plane[vi[h]] = torch.cat([n2, d2[:, None], ok.to(dt)[:, None],
                                  moved2.to(dt)[:, None]], -1)
    m = m._replace(plane=plane)

    # 3. halo
    after = plane[vi]
    valid_after = after[:, 4] > 0.5
    frontier = (cnt_before == 0) | (valid_after & (prev[:, 4] < 0.5))
    src = use & valid_after & (frontier | (after[:, 5] > 0.5))
    if halo_cap and halo_cap < rows:
        prio = torch.where(use & valid_after & frontier, 0,
                           torch.where(src, 1, 2))
        sel = torch.argsort(prio, stable=True)[:halo_cap]
    else:
        sel = torch.arange(rows, device=dev)
    sel = sel[src[sel]]
    lent = plane[vi[sel]].clone()
    lent[:, 5] = 0
    plane[vi[sel]] = lent
    targets = G.pack(coords[sel][:, None] + faces).reshape(-1)  # fan order
    fan = torch.arange(targets.numel(), device=dev)
    m = m._replace(plane=plane).claim(targets, fan)
    tj, found = m.find(targets)
    src_plane = lent.repeat_interleave(6, 0)
    empty = found & (m.mom[tj, 0] == 0)
    score = (src_plane[:, :3] * m.centre(targets)).sum(-1) + src_plane[:, 3]
    score = torch.where(empty, score.abs(), torch.inf)
    best = torch.full((m.keys.numel(),), torch.inf, dtype=dt, device=dev)
    best = best.scatter_reduce(0, tj, score, "amin")
    first = torch.full_like(best, tj.numel(), dtype=torch.int64)
    win = empty & (score <= best[tj])
    first = first.scatter_reduce(0, tj[win], fan[win], "amin")
    win = win & (fan == first[tj])
    plane = m.plane.clone()
    plane[tj[win]] = src_plane[win]
    return m._replace(plane=plane)


def _outer_cross(a, b):
    """sym(a b^T + b a^T) packed as [xx yy zz xy xz yz]."""
    a = a.expand(b.shape)
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([2 * ax * bx, 2 * ay * by, 2 * az * bz,
                        ax * by + ay * bx, ax * bz + az * bx,
                        ay * bz + az * by], -1)


def query(m: Map, points: torch.Tensor):
    """The cached plane of each point's voxel: (normal, offset, valid)."""
    i, present = m.find(G.pack(G.voxel_of(points, m.res)))
    p = m.plane[i]
    valid = present & (p[:, 4] > 0.5)
    return p[:, :3], p[:, 3], valid


def gap(prog: Map, ref: Map) -> float:
    """Share of the voxels present in either map that differ: present in
    one only, another point count, another plane validity, or valid planes
    more than 1 mm apart somewhere in the voxel (the largest gap between
    the two planes' signed distances over its corners)."""
    keys = torch.unique(torch.cat([prog.keys, ref.keys]))
    if keys.numel() == 0:
        return 0.0
    ia, pa = prog.find(keys)
    ib, pb = ref.find(keys)
    a, b = prog.plane[ia].double(), ref.plane[ib].double()
    va, vb = a[:, 4] > 0.5, b[:, 4] > 0.5
    sign = torch.where((a[:, :3] * b[:, :3]).sum(-1) < 0, -1.0, 1.0).double()
    dn = a[:, :3] - sign[:, None] * b[:, :3]
    dd = a[:, 3] - sign * b[:, 3]
    corner = ((dn * ref.centre(keys).double()).sum(-1) + dd).abs() \
        + 0.5 * ref.res * dn.abs().sum(-1)
    differ = (pa != pb) | (prog.mom[ia, 0].double() != ref.mom[ib, 0].double())
    differ = differ | (va != vb) | (va & vb & (corner > 1e-3))
    return float(differ.sum()) / keys.numel()
