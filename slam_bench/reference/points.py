"""The LIO's point map as the configuration ``kitti-hdl64-point`` defines
it (FAST-LIO2's map with one point per voxel), kept as plain sorted
arrays: per occupied voxel its stored point, the scan row it came from,
and the slot it holds in the configured table.

Inserting a scan (``insert``): the voxels the map holds keep their point;
a new voxel takes the first free one of its four probe slots, voxels
bidding with their first row in probe rounds, and stores that row's point;
a voxel whose four slots are all taken is not stored.  ``evict`` drops the
voxels whose stored point lies beyond a radius.  ``planes`` fits, for each
query point, a plane to the ``k`` nearest stored points of the 3^3 voxels
around its own, by a float64 eigendecomposition of their scatter, valid
where all ``k`` exist and lie within a thickness of the plane.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry as G

WINDOW = 3               # the plane search's voxel window a side


class Map(NamedTuple):
    keys: torch.Tensor     # (M,) int64, sorted (geometry.pack)
    pts: torch.Tensor      # (M, 3) the stored points
    src: torch.Tensor      # (M,) int64, the scan row each point came from
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

    def take(self, keep: torch.Tensor) -> "Map":
        return self._replace(keys=self.keys[keep], pts=self.pts[keep],
                             src=self.src[keep], slot=self.slot[keep])


def from_grid(points, coords, occupied, src_idx, res: float, dtype) -> Map:
    """The map held in a program's table: the occupied slots' voxels with
    their points, source rows and slots."""
    keys, order = torch.sort(G.pack(coords[occupied].to(torch.int64)))
    slot = torch.nonzero(occupied).flatten()[order]
    return Map(keys, points[occupied].to(dtype)[order],
               src_idx[occupied].to(torch.int64)[order], slot, float(res),
               occupied.shape[0])


def evict(m: Map, centre: torch.Tensor, radius: float) -> Map:
    return m.take(((m.pts - centre) ** 2).sum(-1) <= radius * radius)


def claim(m: Map, keys: torch.Tensor, bids: torch.Tensor):
    """(slots, placed) of distinct absent ``keys`` bidding ``bids``: in each
    probe round every unplaced voxel bids for its next probe slot, the
    lowest bid taking a free one; a voxel whose probes are all taken is
    not placed."""
    dev, t = keys.device, m.table
    slots = G.probe_slots(G.unpack(keys), t)
    taken = torch.zeros(t + 1, dtype=torch.bool, device=dev)
    taken[m.slot] = True
    placed = torch.full_like(bids, -1)
    for p in range(G.PROBES):
        want = torch.where(placed < 0, slots[:, p], t)
        low = torch.full((t + 1,), 1 << 62, dtype=torch.int64,
                         device=dev).scatter_reduce(0, want, bids, "amin")
        won = (want < t) & ~taken[want] & (low[want] == bids)
        placed = torch.where(won, want, placed)
        taken[want[won]] = True
    return placed, placed >= 0


def insert(m: Map, points: torch.Tensor, mask: torch.Tensor):
    """(map, new, placed): the map after inserting the rows of ``points``
    that ``mask`` keeps, and how many voxels were new and how many of
    those the table placed.  A new voxel stores its first row's point."""
    dev = points.device
    keys = G.pack(G.voxel_of(points, m.res))
    rows = torch.arange(points.shape[0], device=dev)
    _, have = m.find(keys)
    fresh = mask & ~have
    if not bool(fresh.any()):
        return m, 0, 0
    u, inv = torch.unique(keys[fresh], return_inverse=True)
    first = torch.full((u.numel(),), points.shape[0], dtype=torch.int64,
                       device=dev).scatter_reduce(0, inv, rows[fresh],
                                                  "amin")
    slot, ok = claim(m, u, first)
    keys, order = torch.sort(torch.cat([m.keys, u[ok]]))
    out = m._replace(
        keys=keys, pts=torch.cat([m.pts, points[first[ok]]])[order],
        src=torch.cat([m.src, first[ok]])[order],
        slot=torch.cat([m.slot, slot[ok]])[order])
    return out, u.numel(), int(ok.sum())


def _offsets(device) -> torch.Tensor:
    """(27, 3) voxel offsets of the window, the first axis slowest."""
    r = torch.arange(WINDOW, device=device) - WINDOW // 2
    ox, oy, oz = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1), oz.reshape(-1)], -1)


def planes(m: Map, points: torch.Tensor, mask: torch.Tensor, k: int,
           thickness: float):
    """For each point, the plane fitted to its ``k`` nearest stored points
    in the 3^3 voxels around its own (the window's order breaking ties):
    (normal, n.p + d, valid)."""
    dt = m.pts.dtype
    if m.keys.numel() == 0:
        z = torch.zeros_like(points)
        return z, z[:, 0], torch.zeros_like(mask)
    base = G.voxel_of(points, m.res)
    cand = G.pack(base[:, None] + _offsets(points.device))      # (N, 27)
    j, present = m.find(cand)
    nb = m.pts[j]                                               # (N, 27, 3)
    d2 = ((nb - points[:, None]) ** 2).sum(-1)
    d2 = torch.where(present & mask[:, None], d2, torch.inf)
    d2, order = torch.sort(d2, dim=-1, stable=True)
    nn = torch.gather(nb, 1, order[:, :k, None].expand(-1, -1, 3))
    found = torch.isfinite(d2[:, :k]).all(-1)
    mean = nn.mean(1)
    c = nn - mean[:, None]
    # on the host: cuSOLVER's batched eigensolver refuses batches this long
    _, vecs = torch.linalg.eigh((c.transpose(1, 2) @ c).cpu())
    n = vecs[:, :, 0].to(points.device, dt)
    d = -(n * mean).sum(-1)
    res = ((nn * n[:, None]).sum(-1) + d[:, None]).abs()
    valid = mask & found & (res < thickness).all(-1)
    return n, (n * points).sum(-1) + d, valid


def gap(prog: Map, ref: Map):
    """(share, largest): the share of the voxels present in either map
    that differ (present in one only, stored from another scan row, or
    stored points over 1 mm apart), and the largest distance (m) between
    the points of a voxel both store from the same row."""
    keys = torch.unique(torch.cat([prog.keys, ref.keys]))
    if keys.numel() == 0:
        return 0.0, 0.0
    ia, pa = prog.find(keys)
    ib, pb = ref.find(keys)
    dist = torch.linalg.norm(prog.pts[ia].double() - ref.pts[ib].double(),
                             dim=-1)
    same = pa & pb & (prog.src[ia] == ref.src[ib])
    differ = ~same | (dist > 1e-3)
    largest = float(dist[same].max()) if bool(same.any()) else 0.0
    return float(differ.sum()) / keys.numel(), largest
