"""One scan of the LiDAR-inertial filter with FAST-LIO2's own map, as the
configuration ``kitti-hdl64-point`` defines it, written plainly in the
floating type of the state it is given.  Steps 1-3 (preprocess,
propagate, deskew) and the retraction are ``lio.py``'s; then:

4. three Gauss-Newton steps of the point-to-plane MAP problem, each
   searching the planes again at its own state: every point's plane
   fitted to its ``plane_k`` nearest map points (``points.planes``); the
   posterior covariance with the planes searched once more at the result;
5. drop the map's voxels whose point lies beyond 1.5 x ``det_range``,
   insert the scan.

A scan starts from a given state: the filter's and its point map.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry as G
from . import points
from .lio import DIM, MEAS_VAR, State, boxplus, deskew, preprocess, propagate


class Scan(NamedTuple):
    state: State
    body: torch.Tensor     # (N, 3) the kept points in the scan-end body frame
    mask: torch.Tensor     # (N,)
    matched: torch.Tensor  # (N,) the rows with a plane at the posterior
    new: int               # voxels the scan's rows fell in that were absent
    placed: int            # of those, the ones the table placed


def update(s: State, body, mask, cfg: dict):
    """The iterated MAP update, the planes searched at every step and at
    the result.  Returns (state, the rows matched at the result)."""
    eye = torch.eye(DIM, dtype=s.P.dtype, device=s.P.device)
    Pinv = torch.linalg.inv(s.P + 1e-9 * eye)
    k, th = cfg["plane_k"], cfg["plane_threshold"]

    def normal(s):
        n, r, valid = points.planes(s.map, body @ s.R.T + s.p, mask, k, th)
        w = valid.to(body.dtype) / MEAS_VAR
        J = torch.cat([torch.linalg.cross(body, n @ s.R, dim=-1), n], -1)
        A = torch.zeros_like(eye)
        A[:6, :6] = (J * w[:, None]).T @ J
        return J, A, r, w, valid

    x = torch.zeros(DIM, dtype=s.P.dtype, device=s.P.device)
    for _ in range(cfg["max_iteration"]):
        J, A, r, w, _ = normal(s)
        b = torch.zeros_like(x)
        b[:6] = (r * w) @ J
        dx = torch.linalg.solve(A + Pinv, -(b + Pinv @ x))
        s, x = boxplus(s, dx), x + dx
    _, A, _, _, valid = normal(s)
    P = torch.linalg.inv(A + Pinv)
    return s._replace(R=G.orthonormal(s.R), P=0.5 * (P + P.T)), valid


def step(s: State, inputs, cfg: dict, ext_R, ext_t) -> Scan:
    """One scan from state ``s`` on the scan's raw ``inputs`` (points,
    their time offsets, mask, IMU times, gyro, accelerometer, IMU mask,
    start and end times)."""
    pts, rel_t, mask, imu_t, gyro, acc, imu_mask, t0, t1 = inputs
    dt_ = s.P.dtype
    rows = preprocess(pts, mask, cfg)
    noise = [cfg["gyr_cov"], cfg["acc_cov"], cfg["b_gyr_cov"],
             cfg["b_acc_cov"]]
    s1, log = propagate(s, imu_t, gyro, acc, imu_mask, float(t0), float(t1),
                        noise)
    pts_b = pts[rows].to(dt_) @ ext_R.to(dt_).T + ext_t.to(dt_)
    body = deskew(pts_b, rel_t[rows], float(t0), log, s1)
    # the rows padded to the scan's capacity, as the map's bids count them
    cap = cfg["max_points_per_scan"]
    body = torch.cat([body, body.new_zeros(cap - body.shape[0], 3)])
    keep = torch.arange(cap, device=body.device) < rows.numel()
    s2, matched = update(s1, body, keep, cfg)
    m = points.evict(s2.map, s2.p, 1.5 * cfg["det_range"])
    m, new, placed = points.insert(m, body @ s2.R.T + s2.p, keep)
    return Scan(s2._replace(map=m), body, keep, matched, new, placed)
