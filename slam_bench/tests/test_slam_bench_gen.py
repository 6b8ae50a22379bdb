"""The torch generator against the port's numpy simulator
(``utils/sim.py``) at its 32-ring pattern: the same swept scan and the
same IMU on the same world and trajectory, noise off; and a stream is the
same for the same seed."""
from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slam_bench import gen  # noqa: E402


def _port_scene():
    from fast_lio_sam_qn_tpu_torch.utils import sim

    world = sim.World.room(size=26.0, height=5.0, n_boxes=10, seed=3)
    traj = sim.Trajectory.loop(radius=7.0, period=30.0)
    route = gen.Route(kind="circle", speed=2 * math.pi * 7.0 / 30.0, z=1.5,
                      radius=7.0)
    return sim, world, traj, route


def test_swept_scan_equals_the_port_simulator():
    sim, world, traj, route = _port_scene()
    n, t0 = 4096, 1.3
    want, want_t = sim.simulate_scan_swept(world, traj, t0, n_points=n,
                                           noise=0.0)
    sensor = gen.Sensor(rings=sim.N_RINGS, el_top=0.0, el_bottom=0.0,
                        az_steps=n // sim.N_RINGS, hz=10.0, min_range=0.5,
                        max_range=60.0, imu_hz=100.0)
    pattern = gen.ring_pattern(sensor, "cpu", ring_major=False,
                               elevations=np.linspace(-0.35, 0.15,
                                                      sim.N_RINGS))
    times = gen.chunk_times(pattern, t0, sensor.period, "cpu")
    poses = route.pose(times)
    pts, hit = gen.cast_sweep(gen.rectangles(world.surfaces, "cpu"), sensor,
                              pattern, poses)
    want_hit = np.isfinite(want).all(1)
    assert np.array_equal(pattern[1].numpy(), want_t)
    assert (hit.numpy() != want_hit).mean() < 1e-3
    both = hit.numpy() & want_hit
    assert both.mean() > 0.9
    assert np.abs(pts.numpy()[both] - want[both]).max() < 1e-4


def test_imu_equals_the_port_simulator():
    sim, _, traj, route = _port_scene()
    ts, gyro, acc = sim.simulate_imu(traj, 2.0, 2.1, rate=100.0)
    g, a = gen.imu(route, torch.as_tensor(ts, dtype=torch.float64))
    assert np.abs(g.numpy() - gyro).max() < 1e-5
    assert np.abs(a.numpy() - acc).max() < 1e-4


def test_a_stream_repeats_for_its_seed():
    sensor = gen.Sensor(rings=16, el_top=2.0, el_bottom=-24.9, az_steps=64,
                        hz=10.0, min_range=0.9, max_range=120.0,
                        imu_hz=100.0)
    route = gen.Route(kind="s_curve", speed=8.2, z=0.93, a=15.0, ts=30.0,
                      b=4.0, tb=17.0)
    scene = {"tile_m": 40.0, "buildings": 2, "building_size": [4.0, 12.0],
             "building_height": [4.0, 16.0], "building_offset": [7.0, 16.0],
             "objects": 1, "object_size": [0.6, 2.5],
             "object_height": [1.0, 3.0], "object_offset": [4.5, 6.5],
             "seed": 3}

    def stream(seed):
        return gen.Stream(sensor, route, scene, np.eye(3).ravel(),
                          [0.81, -0.32, 0.8], seed, 3, "cpu")

    a, b, c = stream(2**31 + 11), stream(2**31 + 11), stream(5)
    assert torch.equal(a.points, b.points) and torch.equal(a.imu[1],
                                                           b.imu[1])
    assert not torch.equal(a.points, c.points)
    assert a.masks.float().mean() > 0.5
    logged = []
    a.log = logged.append
    assert a.inputs(4)[0].shape == (sensor.rays, 3) and logged
