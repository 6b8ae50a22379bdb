"""The voxel hash of the surfel map — the part of
fast_lio_sam_qn_tpu/ops/hashgrid.py that ``ops/surfel_map.py`` uses: the
double-hashed probe sequence and the scatter-min claim rounds.

Open addressing with NUM_PROBES probe slots per voxel: slot_p = h1 +
p * (h2 | 1) mod T.  A claim runs NUM_PROBES rounds of bidding (each
unplaced point bids for its next probe slot, the lowest point index wins a
free slot), so placement is deterministic and data-parallel.

The reference hashes in uint32 arithmetic, which torch lacks on CUDA: the
values are carried in int64, masked to 32 bits (``voxel._mul32``), and the
slots equal the reference's exactly.  The bids are ``scatter_reduce``
minimums, which are exact whatever the order of the writes.
"""
from __future__ import annotations

import torch

from .voxel import _U32, _mul32

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
