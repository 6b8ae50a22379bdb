"""Carry state across from numpy: point clouds, masks, poses, the keyframe
store, the pose graph and the LIO's filter state.

The system has no learned weights; its state is clouds, poses, the
keyframe store and the filter with its surfel map.  Both packages accept
numpy arrays, so a test (or a session moved from the JAX package) feeds
the same numpy state to both.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.keyframes import KeyframeStore
from .models.lio import LioState
from .ops.hashgrid import HashGrid
from .ops.ieskf import Extrinsic, NavState
from .ops.pgo import GraphState
from .ops.surfel_map import SurfelMap


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


def lio_state_from_numpy(nav, P, grid, t, num_scans, num_matches, ext,
                         device: torch.device | str) -> LioState:
    """The fields of ``fast_lio_sam_qn_tpu.models.lio.LioState`` with their
    leaves as numpy arrays: ``nav`` the six NavState fields (R, p, v, bg,
    ba, grav), ``grid`` the map's four arrays and its res (a float) — a
    SurfelMap's (key, mom, plane, nbr) or, when the first array is a
    float (T, 3) one, a HashGrid's (points, coords, occupied, src_idx) —
    ``P`` 18x18 or 24x24, ``ext`` (R, t) -> the port's LioState on
    ``device``, its host scan counter set from ``num_scans``."""
    *arrays, res = grid
    kind = HashGrid if np.issubdtype(np.asarray(arrays[0]).dtype,
                                     np.floating) else SurfelMap
    return LioState(
        nav=NavState(*tensors_from_numpy(*nav, device=device)),
        P=tensors_from_numpy(P, device=device)[0],
        grid=kind(*tensors_from_numpy(*arrays, device=device),
                  res=float(res)),
        t=tensors_from_numpy(np.float32(t), device=device)[0],
        num_scans=tensors_from_numpy(np.int32(num_scans), device=device)[0],
        num_matches=tensors_from_numpy(np.int32(num_matches),
                                       device=device)[0],
        ext=Extrinsic(*tensors_from_numpy(*ext, device=device)),
        scans=int(num_scans))


def graph_state_from_numpy(poses, num_nodes, prior_pose, odom_meas, loop_i,
                           loop_j, loop_meas, loop_var, num_loops,
                           device: torch.device | str) -> GraphState:
    """The fields of ``fast_lio_sam_qn_tpu.ops.pgo.GraphState`` as numpy
    arrays (the two counts scalars) -> the port's graph on ``device``."""
    return GraphState(*tensors_from_numpy(
        poses, np.int32(num_nodes), prior_pose, odom_meas,
        np.asarray(loop_i, np.int32), np.asarray(loop_j, np.int32),
        loop_meas, loop_var, np.int32(num_loops), device=device))
