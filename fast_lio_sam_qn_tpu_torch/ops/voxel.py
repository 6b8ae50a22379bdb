"""Fixed-shape voxel-grid downsampling — port of
fast_lio_sam_qn_tpu/ops/voxel.py (centroid per occupied voxel, compacted to
a static output capacity with a mask).

Two things differ in mechanism, not in result:

- torch has no ``lexsort``: the lexicographic (hash, x, y, z) order is built
  from stable sorts, least-significant key first.
- the segment sums are a sequential walk over each sorted segment (one
  vectorized step per position within a voxel), so every centroid is the
  left-to-right fp32 sum the reference's ``segment_sum`` produces on the
  CPU, and the result is deterministic on CUDA, where ``index_add_`` with
  duplicate indices is not.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling

_U32 = 0xFFFFFFFF


def voxel_coords(points: torch.Tensor, res: float) -> torch.Tensor:
    """Integer voxel coordinates, floor(p / res). (..., 3) f32 -> int32.

    Computed as p * fp32(1 / res): XLA rewrites the reference's division by
    a constant into that product under jit, and a true division puts points
    on the other side of a voxel face (35 of 1.2M coordinates at 0.3 m)."""
    inv = float(np.float32(1.0) / np.float32(res))
    return torch.floor(points * inv).to(torch.int32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32) without int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def spatial_hash(coords: torch.Tensor) -> torch.Tensor:
    """31-bit mixing hash of (..., 3) int32 voxel coords — bit-identical to
    the reference's uint32 arithmetic, carried in int64 masked to 32 bits."""
    c = coords.to(torch.int64) & _U32
    h = (_mul32(c[..., 0], 0x8DA6B343) + _mul32(c[..., 1], 0xD8163841)
         + _mul32(c[..., 2], 0xCB1AB31F)) & _U32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 1).to(torch.int32)


def _lexsort(keys) -> torch.Tensor:
    """Indices sorting by keys[-1], then keys[-2], ... (numpy lexsort
    semantics), stable."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        _, o = torch.sort(k[order], stable=True)
        order = order[o]
    return order


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, res: float,
                     out_cap: int | None = None,
                     feats: torch.Tensor | None = None):
    """Centroid-per-voxel downsample.

    points (N, 3) f32 padded, mask (N,) bool; res the voxel edge.  Returns
    (out_points (out_cap, 3), out_mask (out_cap,)).  When more voxels are
    occupied than out_cap, the lowest-hash voxels win (deterministic).
    ``feats`` (N, C), e.g. intensity, are averaged per voxel by the same
    segment walk as the points (pcl::VoxelGrid averages the whole
    PointXYZI) and returned third, (out_cap, C)."""
    n = points.shape[0]
    out_cap = out_cap or n
    data = points if feats is None else torch.cat(
        [points, feats.to(points.dtype)], dim=-1)
    coords = voxel_coords(points, res)
    h = spatial_hash(coords)
    key = torch.where(mask, h, torch.iinfo(torch.int32).max)
    order = _lexsort((coords[:, 2], coords[:, 1], coords[:, 0], key))
    data_s = data[order]
    coords_s = coords[order]
    key_s = key[order]
    mask_s = mask[order]

    prev_key = torch.cat([key_s[:1] - 1, key_s[:-1]])
    prev_coords = torch.cat([coords_s[:1] + 1, coords_s[:-1]])
    is_head = (key_s != prev_key) | torch.any(coords_s != prev_coords, dim=-1)
    is_head = is_head & mask_s

    # segment s spans [start[s], start[s+1]); the last one ends after the
    # last valid point, so the masked tail (weight 0 in the reference's
    # sums) does not lengthen the walk below
    with profiling.sync("voxel"):
        seg_start = torch.nonzero(is_head).flatten()
    n_seg = seg_start.shape[0]
    pos1 = torch.arange(1, n + 1, device=points.device)
    last_end = torch.amax(torch.where(mask_s, pos1, 0)).reshape(1)
    seg_end = torch.cat([seg_start[1:], last_end])
    w = mask_s.to(points.dtype)
    wdata = data_s * w[:, None]
    seg_sum = torch.zeros((n_seg, data.shape[1]), dtype=points.dtype,
                          device=points.device)
    seg_cnt = torch.zeros((n_seg,), dtype=points.dtype, device=points.device)
    with profiling.sync("voxel"):
        longest = int((seg_end - seg_start).max()) if n_seg else 0
    for t in range(longest):
        pos = seg_start + t
        live = pos < seg_end
        pos = torch.clamp(pos, max=n - 1)
        seg_sum = seg_sum + torch.where(live[:, None], wdata[pos], 0.0)
        seg_cnt = seg_cnt + torch.where(live, w[pos], 0.0)
    centroid = seg_sum / torch.clamp(seg_cnt, min=1.0)[:, None]

    out = torch.zeros((out_cap, data.shape[1]), dtype=points.dtype,
                      device=points.device)
    out_mask = torch.zeros((out_cap,), dtype=torch.bool, device=points.device)
    m = min(n_seg, out_cap)
    out[:m] = centroid[:m]
    out_mask[:m] = True
    if feats is None:
        return out, out_mask
    return out[:, :3], out_mask, out[:, 3:]
