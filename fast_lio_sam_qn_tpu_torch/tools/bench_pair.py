"""The loop-closure benchmark's scan pair as a two-keyframe store.

The JAX package's ``bench.py`` (``build_pair``) simulates two 16,384-ray
scans of a 24 m room with 16 boxes from nearby poses.  Here keyframe 0
holds scan 2 at its true pose T2; keyframe 1 holds scan 1 with the pose
drift @ T1 (timestamps 0 s and 100 s), so a loop-closure attempt from
keyframe 1 should return drift^-1 as its correction.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import convert
from ..models import keyframes
from ..ops import se3
from ..utils import sim
from ..utils.config import LoopClosureConfig

N_SCAN = 16384
SRC_CAP, DST_CAP = 4352, 5632              # the benchmark's voxelized clouds
PIPE_SRC_CAP, PIPE_DST_CAP = 16384, 32768  # Capacities() defaults
DRIFT_TWIST = (0.0, 0.0, 0.15, 1.5, -1.0, 0.1)
YAW2 = 0.5                                 # scan 2's heading [rad]


def scans(R2):
    """The pair's two scans ((N_SCAN, 3) float32 in the LiDAR frame, NaN
    rows for no hit) with their float64 poses, ((s1, T1), (s2, T2)); R2 is
    scan 2's rotation, a yaw of YAW2, in the precision the caller wants."""
    world = sim.World.room(size=24.0, height=5.0, n_boxes=16, seed=5)
    T1 = np.eye(4)
    T1[:3, 3] = [2.0, -1.5, 1.5]
    T2 = np.eye(4)
    T2[:3, :3] = R2
    T2[:3, 3] = [4.0, -3.0, 1.5]
    s1, _ = sim.simulate_scan(world, T1, n_points=N_SCAN, noise=0.01, seed=1)
    s2, _ = sim.simulate_scan(world, T2, n_points=N_SCAN, noise=0.01, seed=2)
    return (s1, T1), (s2, T2)


def build_store(device):
    """(store, drift (4, 4) float64 numpy) on ``device``."""
    (s1, T1), (s2, T2) = scans(sim.so3_exp_np(np.array([0.0, 0.0, YAW2])))
    drift = se3.se3_exp(torch.tensor(DRIFT_TWIST)).double().numpy()
    p1, m1 = sim.pad_cloud(s1, N_SCAN)
    p2, m2 = sim.pad_cloud(s2, N_SCAN)
    store = keyframes.empty_store(2, N_SCAN, device)
    f32 = np.float32
    store = keyframes.append(store, *convert.tensors_from_numpy(
        p2, m2, T2.astype(f32), T2.astype(f32), device=device), 0.0)
    store = keyframes.append(store, *convert.tensors_from_numpy(
        p1, m1, T1.astype(f32), (drift @ T1).astype(f32), device=device),
        100.0)
    return store, drift


def bench_config(optimized: bool = True):
    """LoopClosureConfig at the benchmark's setting (planarity threshold
    65) in the given matching mode."""
    cfg = LoopClosureConfig()
    cfg.quatro = dataclasses.replace(
        cfg.quatro, planarity_threshold=65.0,
        use_optimized_matching=optimized)
    return cfg
