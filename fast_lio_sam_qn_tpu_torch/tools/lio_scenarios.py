"""Two LIO runs of the point-map backend and the extrinsic co-estimation,
shared by ``chip_smoke.py`` and the CPU tests:

- ``point_stream``: the sim golden's scene and stream ("sim" preset, 26 m
  room, 7 m loop lapped every 40 s, 5 Hz) with ``map_backend="point"``,
  its per-scan position errors from the truth;
- ``extrinsic_convergence``: the reference's convergence scenario
  (tests/test_extrinsic.py:108-212): a surfel map built from the truth,
  then 50 scans of the excited loop at 10 Hz from a LiDAR mounted 3 / 2 /
  2.5 deg and (8, -5, 3) cm off the configured identity.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..configs.presets import get_pipeline_config
from ..models.lio import LIO
from ..ops import se3, surfel_map
from ..run import pad_imu, sim_lio_stream
from ..utils import sim
from ..utils.config import LioConfig

POINT_SCANS, POINT_HZ = 60, 5.0
EXT_SCANS, EXT_HZ, EXT_POINTS, EXT_IMU_CAP = 50, 10.0, 4096, 32
# the LiDAR's true mounting on the body in extrinsic_convergence
EXT_ROT_DEG = (3.0, 2.0, 2.5)
EXT_LEVER_M = (0.08, -0.05, 0.03)


def point_config():
    """The "sim" preset with the point map (4,096 points, 2^17 slots,
    0.3 m)."""
    cfg = get_pipeline_config("sim")
    cfg.lio = dataclasses.replace(cfg.lio, map_backend="point")
    return cfg


def golden_world(mod=sim):
    """The sim golden's 26 m room and 7 m loop (``mod`` a sim module)."""
    return (mod.World.room(size=26.0, height=5.0, n_boxes=10, seed=3),
            mod.Trajectory.loop(radius=7.0, period=40.0))


def point_stream(device, n_scans: int = POINT_SCANS, prof=None
                 ) -> np.ndarray:
    """Per-scan position errors (m) of the point-map LIO over the golden's
    stream on ``device``."""
    world, traj = golden_world()
    return np.asarray([
        float(np.linalg.norm(pose.cpu().numpy()[:3, 3] - gt[:3, 3]))
        for pose, _, _, _, gt in sim_lio_stream(
            point_config(), world, traj, n_scans, POINT_HZ, prof=prof,
            device=device)])


class ExtrinsicRun(NamedTuple):
    rot_err: np.ndarray     # (3,) roll / pitch / yaw error, deg
    lever_err: np.ndarray   # (3,) lever-arm error, m
    pose_errs: np.ndarray   # (n_scans,) position error per scan, m
    rerun: Callable         # () -> the last scan again from its state


def extrinsic_convergence(device, n_scans: int = EXT_SCANS, prof=None
                          ) -> ExtrinsicRun:
    """The convergence scenario on ``device``; ``prof`` (``span(name)``)
    gets the LIO's stage spans and one ``lio`` span per scan."""
    world = sim.World.room(size=24.0, height=5.0, n_boxes=8, seed=3)
    traj = sim.Trajectory.loop_excited(radius=7.0, period=40.0)
    period = 1.0 / EXT_HZ
    wvec = np.deg2rad(np.array(EXT_ROT_DEG)).astype(np.float32)
    R_true = se3.so3_exp(torch.from_numpy(wvec)).numpy()
    t_true = np.array(EXT_LEVER_M, np.float32)
    T_bl = np.eye(4, dtype=np.float32)
    T_bl[:3, :3], T_bl[:3, 3] = R_true, t_true

    class LidarTraj:
        """The LiDAR's trajectory: the body's composed with the mount."""

        def pose(self, t):
            return traj.pose(t) @ T_bl

    cfg = LioConfig(blind=0.5, point_filter_num=1, filter_size_surf=0.3,
                    filter_size_map=0.3, max_points_per_scan=EXT_POINTS,
                    map_table_size=1 << 17, det_range=60.0, max_iteration=3,
                    extrinsic_est_en=True)     # extrinsic_R/T: identity
    lio = LIO(cfg, imu_cap=EXT_IMU_CAP, device=device, profiler=prof)
    dev = lio.device
    T0 = traj.pose(0.0)
    v0, _, _ = traj.derivatives(0.0)
    state = lio.init_state()
    state = state._replace(nav=state.nav._replace(
        v=torch.tensor((T0[:3, :3].T @ v0).astype(np.float32), device=dev),
        grav=torch.tensor((T0[:3, :3].T @ np.array([0.0, 0.0, -9.81]))
                          .astype(np.float32), device=dev)))
    # a map from the truth (the filter's world frame is the body at t = 0):
    # static scans at the true LiDAR poses spread over the loop
    T0inv = np.linalg.inv(T0)
    grid = state.grid
    for k in range(24):
        T_wl = (traj.pose(k * 40.0 / 24) @ T_bl).astype(np.float32)
        pts, _ = sim.simulate_scan(world, T_wl, n_points=6144, noise=0.005,
                                   seed=500 + k)
        W = (T0inv @ T_wl).astype(np.float32)
        pw = pts[np.isfinite(pts).all(-1)] @ W[:3, :3].T + W[:3, 3]
        pj, m = sim.pad_cloud(pw.astype(np.float32), 6144)
        grid = surfel_map.insert(
            grid, torch.tensor(pj, device=dev), torch.tensor(m, device=dev),
            thickness=float(np.float32(cfg.plane_threshold)),
            hood_cap=cfg.surfel_hood_cap, halo_cap=cfg.surfel_halo_cap,
            hood_window=cfg.surfel_hood_window)
    state = state._replace(grid=grid, num_scans=torch.ones(
        (), dtype=torch.int32, device=dev), scans=1)
    span = prof.span if prof is not None else (
        lambda _: contextlib.nullcontext())
    pose_errs = []
    before = inputs = None
    for i in range(n_scans):
        t0, t1 = i * period, (i + 1) * period
        pts, rel_t = sim.simulate_scan_swept(
            world, LidarTraj(), t0, n_points=EXT_POINTS, noise=0.01,
            seed=10 + i, scan_period=period)
        imu = sim.simulate_imu(traj, t0, t1, rate=200.0, gyro_noise=0.002,
                               acc_noise=0.02, seed=20 + i)
        pj, mask = sim.pad_cloud(pts, EXT_POINTS)
        before = state
        inputs = (pj, rel_t, mask, *pad_imu(*imu, EXT_IMU_CAP), t0, t1)
        with span("lio"):
            state, res = lio.process_scan(state, *inputs)
        T_gt = T0inv @ traj.pose(t1)
        pose_errs.append(float(np.linalg.norm(
            res.pose.cpu().numpy()[:3, 3] - T_gt[:3, 3])))
    rot_err = np.rad2deg(se3.so3_log(
        torch.from_numpy(R_true.T) @ state.ext.R.cpu()).numpy())
    return ExtrinsicRun(rot_err, state.ext.t.cpu().numpy() - t_true,
                        np.asarray(pose_errs),
                        lambda: lio.process_scan(before, *inputs))
