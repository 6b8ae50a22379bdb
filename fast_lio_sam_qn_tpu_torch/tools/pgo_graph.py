"""A drifted multi-lap circle as a pose graph, with numpy and the port's
se3 only — the counterpart of fast_lio_sam_qn_tpu/tools/profile_pgo.py
``build_graph``, which imports JAX, so the card needs its own copy.

100 keyframes a lap, 1.6 m apart; odometry factors from the true increments
with noise (0.002 rad, 0.02 m per axis), the initial estimate dead-reckoned
from them; a loop factor every 4th node of lap >= 1 to the same azimuth on
the lap before, variance 0.3.  The same seed draws the same noise as the
reference's ``build_graph``; the graphs then differ only by float32
rounding of the noise's se3_exp (2.3e-5 m on the dead-reckoned initial at 256 nodes).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..ops import se3

LAP = 100
SPACING = 1.6


def _yaw_pose(yaw: float, xyz) -> np.ndarray:
    T = np.eye(4, dtype=np.float64)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
    T[:3, 3] = xyz
    return T


def _exp6(xi) -> np.ndarray:
    return se3.se3_exp(torch.tensor(np.asarray(xi, np.float32))).double(
    ).numpy()


def build_graph(n_nodes: int, device: torch.device | str = "cuda",
                seed: int = 0, capacity: int | None = None,
                loop_capacity: int | None = None):
    """(GraphState cold-initialized to the dead-reckoned trajectory on
    ``device`` (the card unless the caller asks for the CPU), ground-truth
    poses (N, 4, 4), number of loop factors).
    ``capacity`` / ``loop_capacity`` pad the node and loop arrays (default:
    just large enough)."""
    rng = np.random.default_rng(seed)
    radius = LAP * SPACING / (2.0 * np.pi)
    gt = np.stack([
        _yaw_pose(2.0 * np.pi * k / LAP + np.pi / 2.0,
                  (radius * np.cos(2.0 * np.pi * k / LAP),
                   radius * np.sin(2.0 * np.pi * k / LAP), 0.0))
        for k in range(n_nodes)])
    odom_meas = np.broadcast_to(np.eye(4), (n_nodes, 4, 4)).copy()
    init = gt.copy()
    for k in range(1, n_nodes):
        rel = np.linalg.inv(gt[k - 1]) @ gt[k]
        noise = np.concatenate([rng.normal(0, 0.002, 3),
                                rng.normal(0, 0.02, 3)])
        odom_meas[k] = rel @ _exp6(noise)
        init[k] = init[k - 1] @ odom_meas[k]
    li, lj, lm = [], [], []
    for k in range(LAP, n_nodes, 4):
        noise = np.concatenate([rng.normal(0, 0.001, 3),
                                rng.normal(0, 0.01, 3)])
        li.append(k)
        lj.append(k - LAP)
        lm.append(np.linalg.inv(gt[k]) @ gt[k - LAP] @ _exp6(noise))
    n_loops = len(li)
    l_cap = max(1, n_loops, loop_capacity or 0)
    cap = max(capacity or 0, n_nodes)
    poses = np.broadcast_to(np.eye(4), (cap, 4, 4)).copy()
    poses[:n_nodes] = init
    odom = np.broadcast_to(np.eye(4), (cap, 4, 4)).copy()
    odom[:n_nodes] = odom_meas
    loop_meas = np.broadcast_to(np.eye(4), (l_cap, 4, 4)).copy()
    if lm:
        loop_meas[:n_loops] = lm
    f32 = np.float32
    g = convert.graph_state_from_numpy(
        poses.astype(f32), n_nodes, gt[0].astype(f32), odom.astype(f32),
        np.asarray(li + [0] * (l_cap - n_loops)),
        np.asarray(lj + [0] * (l_cap - n_loops)), loop_meas.astype(f32),
        np.full((l_cap,), 0.3, f32), n_loops, device=device)
    return g, gt, n_loops
