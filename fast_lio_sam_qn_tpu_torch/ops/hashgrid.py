"""Voxel hash grid — port of fast_lio_sam_qn_tpu/ops/hashgrid.py: the
double-hashed probe sequence and scatter-min claim rounds that
``ops/surfel_map.py`` uses, and the one-point-per-voxel ``HashGrid`` of the
LIO's ``"point"`` map backend (insert, eviction, windowed candidate
gathers, nearest and k-nearest queries).

Open addressing with NUM_PROBES probe slots per voxel: slot_p = h1 +
p * (h2 | 1) mod T.  A claim runs NUM_PROBES rounds of bidding (each
unplaced point bids for its next probe slot, the lowest point index wins a
free slot), so placement is deterministic and data-parallel.  Queries
gather every probe slot of each neighbouring voxel and verify the stored
coordinates, so hash aliasing never returns a wrong point.

The reference hashes in uint32 arithmetic, which torch lacks on CUDA: the
values are carried in int64, masked to 32 bits (``voxel._mul32``), and the
slots equal the reference's exactly.  The bids are ``scatter_reduce``
minimums, which are exact whatever the order of the writes.  The
reference's ``lax.top_k`` keeps the lower candidate index among equal
distances; ``query_knn`` takes the first k of a stable ascending sort,
which keeps the same ones (``torch.topk`` promises no order among ties).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .voxel import _U32, _mul32, voxel_coords

NUM_PROBES = 4
_INT_MAX = torch.iinfo(torch.int32).max


def _mix(c: torch.Tensor, k0: int, k1: int, k2: int) -> torch.Tensor:
    return (_mul32(c[..., 0], k0) + _mul32(c[..., 1], k1)
            + _mul32(c[..., 2], k2)) & _U32


def _hash2(coords: torch.Tensor):
    """Two independent 32-bit hashes of (..., 3) int voxel coords, as int64
    values in [0, 2^32)."""
    c = coords.to(torch.int64) & _U32
    h1 = _mix(c, 0x8DA6B343, 0xD8163841, 0xCB1AB31F)
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h2 = _mix(c, 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D)
    h2 = h2 ^ (h2 >> 15)
    h2 = _mul32(h2, 0x27D4EB2F)
    h2 = h2 ^ (h2 >> 13)
    return h1, h2


def _probe_slots(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """(..., 3) int coords -> (..., NUM_PROBES) int64 slot indices.  The
    sum stays below 2^35, and its low bits are those of the reference's
    wrapped uint32 sum."""
    h1, h2 = _hash2(coords)
    step = h2 | 1
    p = torch.arange(NUM_PROBES, dtype=torch.int64, device=coords.device)
    return (h1[..., None] + p * step[..., None]) & (table_size - 1)


def _bid_min(size: int, index: torch.Tensor, values: torch.Tensor,
             fill) -> torch.Tensor:
    """(size,) table holding, per index, the minimum of its values (fill
    where none)."""
    out = torch.full((size,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, index, values, "amin", include_self=True)


def _scatter_rounds(occupied, winner, coords, mask, table_size,
                    already_present=None):
    """Run NUM_PROBES rounds of slot bidding.  ``occupied`` (T,) bool,
    ``winner`` (T + 1,) int64 filled with _INT_MAX.  Returns (occupied,
    winner, point_slot) where point_slot[i] is the slot point i won (or
    -1)."""
    n = coords.shape[0]
    t = table_size
    slots = _probe_slots(coords, t)
    idx = torch.arange(n, dtype=torch.int64, device=coords.device)
    unplaced = mask
    if already_present is not None:
        unplaced = unplaced & ~already_present
    point_slot = torch.full((n,), -1, dtype=torch.int64, device=coords.device)
    for p in range(NUM_PROBES):
        cand = torch.where(unplaced, slots[:, p], t)
        bids = _bid_min(t + 1, cand, idx, _INT_MAX)[:t]
        newly = ~occupied & (bids != _INT_MAX)
        slot_c = torch.clamp(cand, 0, t - 1)
        bid_c = bids[slot_c]
        newly_c = newly[slot_c]
        # point i is placed iff it won a newly claimed slot
        won = unplaced & (cand < t) & newly_c & (bid_c == idx)
        point_slot = torch.where(won, cand, point_slot)
        occupied = occupied | newly
        # drop same-voxel siblings of this round's winners: they share the
        # whole probe sequence and would claim a duplicate slot later
        win_at_slot = torch.clamp(bid_c, 0, n - 1)
        lost_to_sibling = (unplaced & ~won & newly_c
                           & torch.all(coords[win_at_slot] == coords, dim=-1))
        unplaced = unplaced & ~won & ~lost_to_sibling
    # one scatter records every winner: a slot is claimed at most once
    placed = point_slot >= 0
    winner = winner.scatter_reduce(
        0, torch.where(placed, point_slot, t),
        torch.where(placed, idx, _INT_MAX), "amin", include_self=True)
    return occupied, winner, point_slot


class HashGrid(NamedTuple):
    """Fixed-shape voxel hash table, one representative point per voxel."""

    points: torch.Tensor    # (T, 3) f32 — representative point per voxel
    coords: torch.Tensor    # (T, 3) i32 — voxel coords for key checks
    occupied: torch.Tensor  # (T,) bool
    src_idx: torch.Tensor   # (T,) i32 — index of the winning source point
    res: float              # voxel edge length

    @property
    def table_size(self) -> int:
        return self.points.shape[0]


def empty(res: float, table_size: int, device: torch.device | str,
          dtype: torch.dtype = torch.float32) -> HashGrid:
    if table_size & (table_size - 1):
        raise ValueError(f"table_size {table_size} is not a power of 2")
    return HashGrid(
        points=torch.zeros((table_size, 3), dtype=dtype, device=device),
        coords=torch.zeros((table_size, 3), dtype=torch.int32, device=device),
        occupied=torch.zeros((table_size,), dtype=torch.bool, device=device),
        src_idx=torch.full((table_size,), -1, dtype=torch.int32,
                           device=device),
        res=res)


def contains(grid: HashGrid, coords: torch.Tensor) -> torch.Tensor:
    """(..., 3) int voxel coords -> bool: is this voxel in the table?"""
    slots = _probe_slots(coords, grid.table_size)           # (..., P)
    keys = grid.coords[slots]                               # (..., P, 3)
    hit = torch.all(keys == coords[..., None, :], dim=-1)
    return torch.any(grid.occupied[slots] & hit, dim=-1)


def insert(grid: HashGrid, points: torch.Tensor,
           mask: torch.Tensor) -> HashGrid:
    """Insert points, keeping existing voxel occupants (add if the voxel is
    empty).  Among new points of one voxel the lowest index whose probe
    round claims the slot first wins; the others are dropped."""
    t = grid.table_size
    coords = voxel_coords(points, grid.res)
    present = contains(grid, coords)
    winner0 = torch.full((t + 1,), _INT_MAX, dtype=torch.int64,
                         device=points.device)
    occupied, winner, _ = _scatter_rounds(
        grid.occupied, winner0, coords, mask, t, already_present=present)
    winner = winner[:t]
    newly = winner != _INT_MAX
    widx = torch.where(newly, winner, 0)
    return HashGrid(
        points=torch.where(newly[:, None], points[widx], grid.points),
        coords=torch.where(newly[:, None], coords[widx], grid.coords),
        occupied=occupied,
        src_idx=torch.where(newly, winner.to(torch.int32), grid.src_idx),
        res=grid.res)


def build(points: torch.Tensor, mask: torch.Tensor, res: float,
          table_size: int) -> HashGrid:
    """A grid of a masked point set; table_size a power of 2, best >= 4x
    the occupied voxels."""
    return insert(empty(res, table_size, points.device, points.dtype),
                  points, mask)


def evict_beyond(grid: HashGrid, center: torch.Tensor,
                 radius: float) -> HashGrid:
    """Drop voxels whose point lies beyond ``radius`` of ``center`` (the
    moving-window map maintenance).  ``radius`` should be fp32-exact; its
    square is taken in fp32, as the reference's."""
    r = torch.tensor(radius, dtype=torch.float32)
    d2 = torch.sum((grid.points - center[None, :]) ** 2, dim=-1)
    keep = grid.occupied & (d2 <= float(r * r))
    return grid._replace(occupied=keep,
                         src_idx=torch.where(keep, grid.src_idx, -1))


def _window_offsets(window: int, device) -> torch.Tensor:
    """(window^3, 3) int32 offsets, the first axis slowest."""
    r = torch.arange(window, dtype=torch.int32, device=device) - window // 2
    ox, oy, oz = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1), oz.reshape(-1)], -1)


def gather_candidates(grid: HashGrid, queries: torch.Tensor,
                      window: int = 3):
    """For each query, every probe slot of the window^3 voxels around it,
    key-verified.  Returns (cand_pts (M, C, 3), cand_valid (M, C),
    cand_src (M, C)) with C = window^3 * NUM_PROBES."""
    base = voxel_coords(queries, grid.res)                       # (M, 3)
    ncoords = base[:, None, :] + _window_offsets(window, queries.device)
    slots = _probe_slots(ncoords, grid.table_size)               # (M, W3, P)
    keys = grid.coords[slots]
    valid = grid.occupied[slots] & torch.all(
        keys == ncoords[:, :, None, :], dim=-1)
    m, c = queries.shape[0], slots.shape[1] * NUM_PROBES
    return (grid.points[slots].reshape(m, c, 3), valid.reshape(m, c),
            grid.src_idx[slots].reshape(m, c))


def query_nn(grid: HashGrid, queries: torch.Tensor, qmask: torch.Tensor,
             window: int = 3):
    """Nearest neighbour within the window (the first candidate among
    equal distances).  Returns (nn_pts (M, 3), nn_dist2 (M,), nn_src (M,),
    found (M,))."""
    pts, valid, src = gather_candidates(grid, queries, window)
    d2 = torch.sum((pts - queries[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(valid, d2, torch.inf)
    j = torch.argmin(d2, dim=-1, keepdim=True)
    best = torch.gather(d2, 1, j)[:, 0]
    found = torch.isfinite(best) & qmask
    nn = torch.gather(pts, 1, j[:, :, None].expand(-1, 1, 3))[:, 0]
    return (nn, torch.where(found, best, torch.inf),
            torch.gather(src, 1, j)[:, 0], found)


def query_knn(grid: HashGrid, queries: torch.Tensor, qmask: torch.Tensor,
              k: int, window: int = 5):
    """k nearest neighbours within the window, the lower candidate index
    first among equal distances.  Returns (knn_pts (M, k, 3), knn_dist2
    (M, k), knn_valid (M, k)); fewer than k in-window neighbours leave
    trailing invalid entries."""
    pts, valid, _ = gather_candidates(grid, queries, window)
    d2 = torch.sum((pts - queries[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(valid & qmask[:, None], d2, torch.inf)
    knn_d2, idx = torch.sort(d2, dim=-1, stable=True)
    knn_d2, idx = knn_d2[:, :k], idx[:, :k]
    knn_valid = torch.isfinite(knn_d2)
    knn_pts = torch.gather(pts, 1, idx[:, :, None].expand(-1, -1, 3))
    return knn_pts, knn_d2, knn_valid
