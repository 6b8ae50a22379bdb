"""The simulated loop pairs of tests/test_quatro.py, for the kNN FPFH
backend: two 16,384-ray scans of a 24 m room with 10 boxes from nearby
poses, the source placed in the world with a drifted pose (the loop
closure's situation), both voxelized at 0.3 m into 8,192 points; and their
registration through ``fpfh.fpfh``, Quatro and GICP.

Shared by ``chip_smoke.py`` (on the card) and the CPU tests.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import fpfh, gicp, quatro, se3, voxel
from ..utils import sim

RAYS, CAP = 16384, 8192
# name: (drift twist [w | v], scan seed, coarse (yaw rad, t m) tolerance or
# None, fine (t m, rot rad) tolerance or None) — tests/test_quatro.py
PAIRS = {
    "recovers_drift": ((0.0, 0.0, 0.15, 1.5, -1.0, 0.1), 1, (0.03, 0.25),
                       None),
    "zero_drift": ((0.0,) * 6, 3, (0.03, 0.25), None),
    "large_yaw_drift": ((0.0, 0.0, 0.6, 3.0, 2.0, 0.0), 5, (0.05, 0.4),
                        None),
    "then_gicp_fine": ((0.0, 0.0, 0.2, 2.0, -1.5, 0.1), 7, None,
                       (0.02, 0.15)),
}


def world():
    return sim.World.room(size=24.0, height=5.0, n_boxes=10, seed=5)


def _pose(xy, yaw):
    T = np.eye(4)
    T[:3, :3] = sim.so3_exp_np(np.array([0.0, 0.0, yaw]))
    T[:3, 3] = [xy[0], xy[1], 1.5]
    return T


def loop_pair(drift_xi, seed: int, device: torch.device | str = "cpu"):
    """((src, src_mask, src_viewpoint), (dst, dst_mask, dst_viewpoint),
    T_want (4, 4) float64): the voxelized clouds on ``device`` and the
    transform that registers src onto dst (the drift's inverse)."""
    w = world()
    T1, T2 = _pose((2.0, -1.5), 0.0), _pose((4.0, -3.0), 0.5)
    s1, _ = sim.simulate_scan(w, T1, n_points=RAYS, noise=0.01, seed=seed)
    s2, _ = sim.simulate_scan(w, T2, n_points=RAYS, noise=0.01,
                              seed=seed + 1)
    drift = se3.se3_exp(torch.tensor(drift_xi, dtype=torch.float32)
                        ).double().numpy()
    w1 = s1 @ T1[:3, :3].T + T1[:3, 3]
    w1 = w1 @ drift[:3, :3].T + drift[:3, 3]
    w2 = s2 @ T2[:3, :3].T + T2[:3, 3]
    out = []
    for pts, vp in ((w1, drift[:3, :3] @ T1[:3, 3] + drift[:3, 3]),
                    (w2, T2[:3, 3])):
        p, m = sim.pad_cloud(pts, RAYS)
        v, vm = voxel.voxel_downsample(torch.from_numpy(p).to(device),
                                       torch.from_numpy(m).to(device), 0.3,
                                       out_cap=CAP)
        out.append((v, vm, torch.tensor(vp, dtype=torch.float32,
                                        device=device)))
    return out[0], out[1], np.linalg.inv(drift)


class PairResult(NamedTuple):
    coarse: quatro.QuatroResult
    final: torch.Tensor | None       # fine @ coarse, with a fine stage
    fitness: torch.Tensor | None


def register(src, dst, fine: bool) -> PairResult:
    """The kNN FPFH of both clouds (normals toward their viewpoints), the
    distinctive filter, Quatro (optimized matching, the reference's
    parameters) and, with ``fine``, GICP (brute covariances) on the
    coarse-aligned source."""
    (va, vma, vpa), (vb, vmb, vpb) = src, dst
    da, fa = fpfh.fpfh(va, vma, 0.9, 1.5, viewpoint=vpa)
    db, fb = fpfh.fpfh(vb, vmb, 0.9, 1.5, viewpoint=vpb)
    fa, fb = fpfh.distinctive(da, fa), fpfh.distinctive(db, fb)
    res = quatro.align(va, da, fa, vb, db, fb, noise_bound=0.3,
                       gnc_factor=1.4, cost_diff_thr=1e-4,
                       distance_threshold=35.0, max_corres=200,
                       rot_max_iter=50)
    if not fine:
        return PairResult(res, None, None)
    out = gicp.align(se3.transform_points(va, res.transform), vma, vb, vmb,
                     cov_backend="brute")
    return PairResult(res, out.transform @ res.transform, out.fitness)


def errors(result: PairResult, T_want) -> dict:
    """The registration's errors against T_want: the coarse yaw (rad) and
    translation (m) gaps, and the fine stage's translation (m) and
    rotation (rad) errors where it ran."""
    T = result.coarse.transform.double().cpu().numpy()
    out = {"converged": bool(result.coarse.converged),
           "yaw": abs(float(np.arctan2(T[1, 0], T[0, 0])
                            - np.arctan2(T_want[1, 0], T_want[0, 0]))),
           "t": float(np.linalg.norm(T[:3, 3] - T_want[:3, 3]))}
    if result.final is not None:
        err = se3.se3_log(torch.linalg.inv(result.final.double().cpu())
                          @ torch.tensor(T_want))
        out.update(fine_t=float(err[3:].norm()),
                   fine_r=float(err[:3].norm()),
                   fitness=float(result.fitness))
    return out


def check(name: str, errs: dict) -> list[str]:
    """The tolerances of PAIRS[name] that ``errs`` misses."""
    _, _, coarse, fine = PAIRS[name]
    missed = [] if errs["converged"] else ["converged"]
    if coarse and not (errs["yaw"] < coarse[0] and errs["t"] < coarse[1]):
        missed.append(f"coarse < {coarse[0]} rad / {coarse[1]} m")
    if fine and not (errs["fine_t"] < fine[0] and errs["fine_r"] < fine[1]
                     and errs["fitness"] < 3.5):
        missed.append(f"fine < {fine[0]} m / {fine[1]} rad, fitness < 3.5")
    return missed
