"""Drivers of the port — for now the simulated LIO stream that the 240-scan
sim golden replays into the pipeline (the JAX package's
``run.sim_lio_stream``).  The CLI modes join this module with Slice E.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.lio import LIO
from .utils import sim
from .utils.profiling import Profiler

IMU_CAP = 64


def sim_lio_stream(cfg, world, traj, n_scans, scan_hz=5.0, prof=None,
                   device: torch.device | str = "cuda"):
    """Simulate the sequence and run the LIO front end over it, yielding
    one (pose, cloud_body, cloud_mask, t1, gt_pose) tuple per scan: the
    pose and the deskewed body cloud as tensors on ``device``, t1 the scan
    end, gt_pose the ground truth (4, 4) in the filter's world frame (the
    body frame at t = 0).  ``prof`` (``span(name)``) gets the spans
    ``sim`` and ``lio`` per scan and the LIO's stage spans (a host clock
    measures what was enqueued: ``process_scan`` does not wait for the
    device)."""
    prof = prof or Profiler()
    lio = LIO(cfg.lio, imu_cap=IMU_CAP, device=device, profiler=prof)
    period = 1.0 / scan_hz
    state = initial_state(lio, traj)
    # simulate at 4x the processing capacity: the preprocess downsamples
    # to it, as a real spinning LiDAR's many azimuth steps are
    raw_n = 4 * cfg.lio.max_points_per_scan
    T0_inv = np.linalg.inv(traj.pose(0.0))
    for i in range(n_scans):
        with prof.span("sim"):
            inputs = sim_scan_inputs(world, traj, i, period, raw_n)
        with prof.span("lio"):
            state, res = lio.process_scan(state, *inputs)
        yield res.pose, res.cloud_body, res.cloud_mask, inputs[-1], \
            T0_inv @ traj.pose(inputs[-1])


def sim_scan_inputs(world, traj, i, period, raw_n, imu_noise=True,
                    seed=100):
    """The inputs of ``LIO.process_scan`` for scan i of a simulated run:
    a swept scan of ``raw_n`` rays over [i period, (i + 1) period) (noise
    seed ``seed + i``), 200 Hz IMU samples padded to IMU_CAP (with the
    sim stream's gyro / accelerometer noise, seed ``seed + 100 + i``, or
    none), and the scan's start and end times."""
    t0, t1 = i * period, (i + 1) * period
    pts, rel_t = sim.simulate_scan_swept(
        world, traj, t0, n_points=raw_n, noise=0.01, seed=seed + i,
        scan_period=period)
    noise = dict(gyro_noise=0.002, acc_noise=0.02) if imu_noise else {}
    ts, gyro, acc = sim.simulate_imu(traj, t0, t1, rate=200.0,
                                     seed=seed + 100 + i, **noise)
    cloud, mask = sim.pad_cloud(pts, raw_n)
    it = np.zeros(IMU_CAP, np.float32)
    ig = np.zeros((IMU_CAP, 3), np.float32)
    ia = np.zeros((IMU_CAP, 3), np.float32)
    im = np.zeros(IMU_CAP, bool)
    k = min(len(ts), IMU_CAP)
    it[:k], ig[:k], ia[:k], im[:k] = ts[:k], gyro[:k], acc[:k], True
    return cloud, rel_t, mask, it, ig, ia, im, t0, t1


def initial_state(lio: LIO, traj):
    """A fresh filter state whose world frame is the body frame at t = 0,
    moving with the trajectory's initial velocity (in that frame)."""
    state = lio.init_state()
    T0 = traj.pose(0.0)
    v0, _, _ = traj.derivatives(0.0)
    return state._replace(nav=state.nav._replace(v=torch.tensor(
        (T0[:3, :3].T @ v0).astype(np.float32), device=lio.device)))
