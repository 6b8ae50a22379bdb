"""Carry state across from numpy: point clouds, masks, poses, the keyframe
store and the pose graph.

The system has no learned weights; its state is clouds, poses and the
keyframe store.  Both packages accept numpy arrays, so a test (or a
session moved from the JAX package) feeds the same numpy state to both.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.keyframes import KeyframeStore
from .ops.pgo import GraphState


def tensors_from_numpy(*arrays, device: torch.device | str):
    """numpy arrays -> tensors on ``device``: floats become float32, bools
    stay bool, integers become int32 (the JAX package's dtypes)."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        if a.dtype == np.bool_:
            dt = torch.bool
        elif np.issubdtype(a.dtype, np.integer):
            dt = torch.int32
        elif np.issubdtype(a.dtype, np.floating):
            dt = torch.float32
        else:
            raise TypeError(f"unsupported dtype {a.dtype}")
        # a copy: arrays read back from JAX are read-only
        out.append(torch.tensor(a, dtype=dt, device=device))
    return tuple(out)


def keyframe_store_from_numpy(clouds, cloud_masks, intensities, poses,
                              poses_corrected, timestamps, count,
                              device: torch.device | str) -> KeyframeStore:
    """The fields of ``fast_lio_sam_qn_tpu.models.keyframes.KeyframeStore``
    as numpy arrays, per-point intensities (K, P) included (``count`` a
    scalar) -> the port's store on ``device``."""
    return KeyframeStore(*tensors_from_numpy(
        clouds, cloud_masks, intensities, poses, poses_corrected, timestamps,
        np.int32(count), device=device))


def graph_state_from_numpy(poses, num_nodes, prior_pose, odom_meas, loop_i,
                           loop_j, loop_meas, loop_var, num_loops,
                           device: torch.device | str) -> GraphState:
    """The fields of ``fast_lio_sam_qn_tpu.ops.pgo.GraphState`` as numpy
    arrays (the two counts scalars) -> the port's graph on ``device``."""
    return GraphState(*tensors_from_numpy(
        poses, np.int32(num_nodes), prior_pose, odom_meas,
        np.asarray(loop_i, np.int32), np.asarray(loop_j, np.int32),
        loop_meas, loop_var, np.int32(num_loops), device=device))
