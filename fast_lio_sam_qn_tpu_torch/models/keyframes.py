"""Fixed-capacity keyframe store — port of
fast_lio_sam_qn_tpu/models/keyframes.py (``KeyframeStore``, ``empty_store``,
``append``, ``grow``, ``rewrite_corrected``).

Clouds are stored in the body frame, voxelized, padded with a mask.  Unlike
the reference's immutable arrays, ``append`` writes the new keyframe into
the store's tensors in place (one copy of a large store, not two) and
returns the store with its count advanced.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import profiling


class KeyframeStore(NamedTuple):
    clouds: torch.Tensor           # (K, P, 3) body frame, voxelized
    cloud_masks: torch.Tensor      # (K, P) bool
    intensities: torch.Tensor      # (K, P)
    poses: torch.Tensor            # (K, 4, 4) raw odometry poses
    poses_corrected: torch.Tensor  # (K, 4, 4) PGO-corrected poses
    timestamps: torch.Tensor       # (K,)
    count: torch.Tensor            # () int32

    @property
    def capacity(self) -> int:
        return self.clouds.shape[0]

    @property
    def points_per_frame(self) -> int:
        return self.clouds.shape[1]


def empty_store(max_keyframes: int, points_per_frame: int,
                device: torch.device | str,
                dtype: torch.dtype = torch.float32) -> KeyframeStore:
    eye = torch.eye(4, dtype=dtype, device=device).repeat(max_keyframes, 1, 1)
    return KeyframeStore(
        clouds=torch.zeros((max_keyframes, points_per_frame, 3), dtype=dtype,
                           device=device),
        cloud_masks=torch.zeros((max_keyframes, points_per_frame),
                                dtype=torch.bool, device=device),
        intensities=torch.zeros((max_keyframes, points_per_frame),
                                dtype=dtype, device=device),
        poses=eye,
        poses_corrected=eye.clone(),
        timestamps=torch.zeros((max_keyframes,), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def append(store: KeyframeStore, cloud, cloud_mask, pose, pose_corrected,
           timestamp: float, intensity=None) -> KeyframeStore:
    """Write keyframe ``count`` in place and return the store with count+1.
    Raises when the store is full."""
    with profiling.sync("kf_count"):
        i = int(store.count)
    if i >= store.capacity:
        raise ValueError(f"keyframe store is full ({store.capacity})")
    store.clouds[i] = cloud
    store.cloud_masks[i] = cloud_mask
    store.intensities[i] = 0.0 if intensity is None else intensity
    store.poses[i] = pose
    store.poses_corrected[i] = pose_corrected
    with profiling.sync("kf_stamp"):      # a host float written
        store.timestamps[i] = timestamp
    return store._replace(count=store.count + 1)


def grow(store: KeyframeStore, new_capacity: int) -> KeyframeStore:
    """Re-pad the store to a larger capacity (amortized growth on
    overflow); new slots hold zeros, masks off and identity poses."""
    if new_capacity <= store.capacity:
        return store
    pad = new_capacity - store.capacity
    fresh = empty_store(pad, store.points_per_frame, store.clouds.device,
                        store.clouds.dtype)
    return KeyframeStore(*[torch.cat([a, b]) for a, b in zip(
        store[:-1], fresh[:-1])], count=store.count)


def rewrite_corrected(store: KeyframeStore, poses) -> KeyframeStore:
    """Overwrite the corrected poses of the first ``count`` keyframes from
    the pose-graph estimate (the reference's O(N) rewrite after a loop),
    in place."""
    active = (torch.arange(store.capacity, device=store.clouds.device)
              < store.count)[:, None, None]
    store.poses_corrected.copy_(torch.where(
        active, poses[:store.capacity], store.poses_corrected))
    return store
