"""The port's LIO front end (``models/lio.py``, ``run.sim_lio_stream``,
``convert.lio_state_from_numpy``) held against the JAX package's on the
same simulated scans, at a small width: the "sim" preset cut to 2,048
points a scan and a 2^13-slot table.

Tolerances:

- one ``process_scan`` from a JAX mid-run state carried over: pose within
  1e-5 m and 1e-5 rad, plane matches equal (the same map and state: only
  this scan's fp32 roundings differ);
- an 8-scan stream from ``init_state``: every pose within 1e-4 m and 1e-4
  rad.  Free-running, the two maps part where a point's fp32 position lands
  on the other side of a voxel face, so the match counts may differ by a
  few and the poses by more than one step's roundings;
- the 240-scan sim golden on the CPU (slow): every pose within 1 cm and
  2 mrad of the JAX stream's outside scans 88-119, and the golden's own
  pins.  Over scans 88-119 the LIO itself (both packages) leaves the truth
  by up to 24 cm and 20 mrad: there the two streams' last-bit differences
  grow to centimetres before both re-converge (within 5e-3 m of each other
  by scan 120); there the port's own error from the truth is held within
  1.2x the reference's largest (PERF.md, PR 6).

The JAX side is cached with conftest.deterministic_cache."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fast_lio_sam_qn_tpu.configs.presets import get_pipeline_config as jget
from fast_lio_sam_qn_tpu.models.lio import LIO as JLIO
from fast_lio_sam_qn_tpu.run import sim_lio_stream as jstream
from fast_lio_sam_qn_tpu.utils import sim as jsim
from fast_lio_sam_qn_tpu_torch.configs.presets import get_pipeline_config
from fast_lio_sam_qn_tpu_torch.convert import lio_state_from_numpy
from fast_lio_sam_qn_tpu_torch.models.lio import LIO
from fast_lio_sam_qn_tpu_torch.ops import se3
from fast_lio_sam_qn_tpu_torch.run import (initial_state, sim_lio_stream,
                                           sim_scan_inputs)
from fast_lio_sam_qn_tpu_torch.utils import sim
from fast_lio_sam_qn_tpu_torch.utils.config import LioConfig

torch.set_num_threads(1)

SMALL = dict(max_points_per_scan=2048, map_table_size=1 << 13)
# the golden's scans where the LIO leaves the truth by up to 24 cm
GOLDEN_EXCURSION = range(88, 120)
PERIOD = 0.2
MIDRUN = (3, 6)


def _cache(name, params, build):
    from conftest import deterministic_cache

    return deterministic_cache(name, params, build, extra_files=(__file__,))


def _world(mod):
    return (mod.World.room(size=26.0, height=5.0, n_boxes=10, seed=3),
            mod.Trajectory.loop(radius=7.0, period=40.0))


def _small_cfg(get):
    cfg = get("sim")
    cfg.lio = dataclasses.replace(cfg.lio, **SMALL)
    return cfg


def _pose_gap(a, b):
    """(max |dp| in m, |log(Ra^T Rb)| in rad) of two (4, 4) poses."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dr = se3.so3_log(torch.from_numpy(a[:3, :3].T @ b[:3, :3]))
    return float(np.abs(a[:3, 3] - b[:3, 3]).max()), float(
        torch.linalg.norm(dr))


def _state_numpy(state):
    return [
        [np.asarray(x) for x in state.nav], np.asarray(state.P),
        [np.asarray(x) for x in state.grid[:4]] + [state.grid.res],
        np.asarray(state.t), int(state.num_scans), int(state.num_matches),
        [np.asarray(x) for x in state.ext]]


@pytest.fixture(scope="module")
def ref_midrun():
    """The JAX LIO over the small-width stream: the state before each scan
    of MIDRUN and that scan's pose and match count."""
    def build():
        cfg = _small_cfg(jget).lio
        world, traj = _world(sim)
        lio = JLIO(cfg)
        state = lio.init_state()
        T0 = traj.pose(0.0)
        v0, _, _ = traj.derivatives(0.0)
        state = state._replace(nav=state.nav._replace(
            v=jnp.asarray(T0[:3, :3].T @ v0, jnp.float32)))
        out = {}
        for i in range(max(MIDRUN) + 1):
            inputs = sim_scan_inputs(world, traj, i, PERIOD,
                                     4 * cfg.max_points_per_scan)
            before = _state_numpy(state)
            state, res = lio.process_scan(
                state, *map(jnp.asarray, inputs[:7]), *inputs[7:])
            if i in MIDRUN:
                out[i] = (before, np.asarray(res.pose),
                          int(res.num_matches), np.asarray(res.cloud_body))
        return out

    return _cache("torch_lio_midrun", (SMALL, MIDRUN), build)


@pytest.mark.parametrize("scan", MIDRUN)
def test_process_scan_from_reference_state(scan, ref_midrun):
    before, pose, matches, body = ref_midrun[scan]
    state = lio_state_from_numpy(*before, device="cpu")
    assert state.scans == scan
    cfg = _small_cfg(get_pipeline_config).lio
    world, traj = _world(sim)
    inputs = sim_scan_inputs(world, traj, scan, PERIOD,
                             4 * cfg.max_points_per_scan)
    new, res = LIO(cfg, device="cpu").process_scan(state, *inputs)
    dp, dr = _pose_gap(res.pose.numpy(), pose)
    print(f"scan {scan}: {dp:.3e} m, {dr:.3e} rad, matches "
          f"{int(res.num_matches)} / {matches}")
    assert dp < 1e-5 and dr < 1e-5
    assert int(res.num_matches) == matches > 100
    assert new.scans == scan + 1 and int(new.num_scans) == scan + 1
    np.testing.assert_allclose(res.cloud_body.numpy(), body, rtol=0,
                               atol=1e-4)


def test_stream_matches_reference():
    """8 scans from init_state through run.sim_lio_stream: every pose
    within 1e-4 m and 1e-4 rad of the JAX stream's."""
    n = 8

    def build():
        world, traj = _world(jsim)
        return [tuple(np.asarray(x) if hasattr(x, "shape") else x
                      for x in item)
                for item in jstream(_small_cfg(jget), world, traj, n, 5.0)]

    want = _cache("torch_lio_stream", (SMALL, n), build)
    world, traj = _world(sim)
    got = list(sim_lio_stream(_small_cfg(get_pipeline_config), world, traj,
                              n, 5.0, device="cpu"))
    gaps = []
    for (pose, cloud, mask, t1, gt), w in zip(got, want):
        assert pose.device.type == "cpu" and cloud.shape == (2048, 3)
        assert t1 == w[3]
        np.testing.assert_array_equal(gt, w[4])
        np.testing.assert_array_equal(mask.numpy(), w[2])
        gaps.append(_pose_gap(pose.numpy(), w[0]))
    gaps = np.asarray(gaps)
    print(f"largest pose gap over {n} scans: {gaps[:, 0].max():.3e} m, "
          f"{gaps[:, 1].max():.3e} rad")
    assert gaps[:, 0].max() < 1e-4 and gaps[:, 1].max() < 1e-4


def test_init_state_and_map_points_match_reference(ref_midrun):
    cfg = _small_cfg(get_pipeline_config).lio
    gdir, bias = np.array([0.1, -0.2, 9.7]), np.array([0.01, 0.0, -0.02])
    got = LIO(cfg, device="cpu").init_state(gdir, bias, t0=1.25)
    want = JLIO(_small_cfg(jget).lio).init_state(gdir, bias, t0=1.25)
    for x, y in zip(got.nav, want.nav):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6)
    np.testing.assert_array_equal(got.P.numpy(), np.asarray(want.P))
    assert float(got.t) == float(want.t) and got.scans == 0
    assert got.grid.key.shape == want.grid.key.shape
    for x, y in zip(LIO.init_from_imu(np.ones((5, 3)), np.eye(3)[[2] * 5]),
                    JLIO.init_from_imu(np.ones((5, 3)), np.eye(3)[[2] * 5])):
        np.testing.assert_array_equal(x, y)
    before = ref_midrun[MIDRUN[-1]][0]
    state = lio_state_from_numpy(*before, device="cpu")
    from fast_lio_sam_qn_tpu.ops.surfel_map import SurfelMap as JMap

    jstate = JLIO(_small_cfg(jget).lio).init_state()._replace(
        grid=JMap(*map(jnp.asarray, before[2][:4]), res=before[2][4]))
    pts = LIO.get_map_points(state)
    np.testing.assert_allclose(pts, JLIO.get_map_points(jstate), rtol=0,
                               atol=1e-6)
    assert len(pts) > 1000


def test_lio_surfel_backend_low_drift():
    """Mirror of the reference's tests/test_surfel_map.py low-drift case:
    60 scans at 10 Hz over a 24 m room's loop, final drift < 0.15 m."""
    world = sim.World.room(size=24.0, height=5.0, n_boxes=8, seed=3)
    traj = sim.Trajectory.loop(radius=7.0, period=40.0)
    cfg = LioConfig(blind=0.5, point_filter_num=1, filter_size_surf=0.3,
                    filter_size_map=0.3, max_points_per_scan=4096,
                    map_table_size=1 << 17, det_range=60.0, max_iteration=3)
    lio = LIO(cfg, imu_cap=32, device="cpu")
    state = initial_state(lio, traj)
    T0_inv = np.linalg.inv(traj.pose(0.0))
    errs = []
    for i in range(60):
        t0, t1 = i * 0.1, (i + 1) * 0.1
        pts, rel_t = sim.simulate_scan_swept(
            world, traj, t0, n_points=4096, noise=0.01, seed=10 + i,
            scan_period=0.1)
        ts, gyro, acc = sim.simulate_imu(
            traj, t0, t1, rate=200.0, gyro_noise=0.002, acc_noise=0.02,
            seed=20 + i)
        pj, mask = sim.pad_cloud(pts, 4096)
        it = np.zeros(32, np.float32)
        ig = np.zeros((32, 3), np.float32)
        ia = np.zeros((32, 3), np.float32)
        im = np.zeros(32, bool)
        k = len(ts)
        it[:k], ig[:k], ia[:k], im[:k] = ts, gyro, acc, True
        state, res = lio.process_scan(state, pj, rel_t, mask, it, ig, ia, im,
                                      t0, t1)
        T_gt = T0_inv @ traj.pose(t1)
        errs.append(np.linalg.norm(res.pose.numpy()[:3, 3] - T_gt[:3, 3]))
    errs = np.asarray(errs)
    assert errs[-1] < 0.15, errs[-5:]
    assert errs.max() < 0.3, errs.max()


@pytest.mark.slow
def test_golden_sim_cpu_twin():
    """The 240-scan sim golden on the CPU through the port: its LIO stream
    against the JAX stream (tests/test_golden.py's cached feed), every pose
    within 1 cm and 2 mrad outside GOLDEN_EXCURSION and within 1.2x the
    reference's largest error from the truth inside it, then replayed into
    the port's pipeline with the golden's pins (34 keyframes, 4-8 pairs,
    12 events, ATE 0.0417 m +- 20 %)."""
    import test_golden as tg
    from conftest import deterministic_cache
    from fast_lio_sam_qn_tpu_torch.models.pipeline import FastLioSamQnPipeline
    from fast_lio_sam_qn_tpu_torch.utils import evaluation

    def build():
        world, traj = _world(jsim)
        return [tuple(np.asarray(x) if hasattr(x, "shape") else x
                      for x in item)
                for item in jstream(tg._native_cfg(), world, traj,
                                    tg.N_SCANS, tg.SCAN_HZ)]

    want = deterministic_cache(
        "golden_lio_feed",
        ("room26-10-3", "loop7-40", tg.N_SCANS, tg.SCAN_HZ, tg._caps()),
        build, extra_files=(tg.__file__,))
    cfg = get_pipeline_config("sim")
    cfg.caps = dataclasses.replace(cfg.caps, max_keyframes=256,
                                   max_loop_factors=32, keyframe_points=2048,
                                   src_points=2048, dst_points=4096)
    world, traj = _world(sim)
    feed = list(sim_lio_stream(cfg, world, traj, tg.N_SCANS, tg.SCAN_HZ,
                               device="cpu"))
    gaps = np.asarray([_pose_gap(f[0].numpy(), w[0])
                       for f, w in zip(feed, want)])
    err = np.asarray([_pose_gap(f[0].numpy(), w[4]) for f, w in zip(feed,
                                                                   want)])
    ref = np.asarray([_pose_gap(w[0], w[4]) for w in want])
    calm = np.ones(len(feed), bool)
    calm[GOLDEN_EXCURSION] = False
    print(f"largest pose gap over {calm.sum()} scans outside the excursion: "
          f"{gaps[calm, 0].max():.3e} m, {gaps[calm, 1].max():.3e} rad; "
          f"inside: {gaps[~calm, 0].max():.3e} m, {gaps[~calm, 1].max():.3e} "
          f"rad; largest error from the truth: port {err[:, 0].max():.4f} m "
          f"{err[:, 1].max():.4f} rad, reference {ref[:, 0].max():.4f} m "
          f"{ref[:, 1].max():.4f} rad")
    assert gaps[calm, 0].max() < 1e-2 and gaps[calm, 1].max() < 2e-3
    assert (err.max(0) <= 1.2 * ref.max(0)).all()

    pipe = FastLioSamQnPipeline(cfg, device="cpu")
    gt = []
    for pose, cloud, mask, t1, gt_pose in feed:
        pipe.feed(pose, cloud, mask, t1)
        gt.append(gt_pose)
    gtn = np.stack(gt)
    period = 1.0 / tg.SCAN_HZ
    gt_kf = [gtn[min(int(round(t / period)) - 1, len(gtn) - 1)]
             for t in pipe.kf_timestamps]
    _, corrected = pipe.get_trajectories()
    ate = evaluation.ate_rmse(corrected, np.stack(gt_kf))
    print(f"{pipe.current_kf_idx} keyframes, {len(pipe.loop_events)} events,"
          f" {len(pipe.loop_idx_pairs)} committed, ATE {ate!r} m")
    assert pipe.current_kf_idx == 34
    assert abs(ate - 0.0417) < 0.2 * 0.0417, ate
    assert 4 <= len(pipe.loop_idx_pairs) <= 8
    assert len(pipe.loop_events) == 12


@pytest.mark.slow
def test_kitti_run_matches_reference_at_cut_width():
    """chip_smoke.py's lio_kitti run (LioConfig() defaults, the 120 m room,
    a straight 2 m/s drive, 30 scans) cut to 8,192 points and 2^17 slots:
    the port's final position error agrees with the JAX package's within
    1e-4 m, and so do the match counts within 1 %."""
    from fast_lio_sam_qn_tpu.utils.config import LioConfig as JCfg
    from fast_lio_sam_qn_tpu_torch.tools import profile_insert as pi

    n, table = 8192, 1 << 17

    def build():
        _, state0 = pi.kitti_lio("cpu", n, table)
        lio = JLIO(dataclasses.replace(JCfg(), max_points_per_scan=n,
                                       map_table_size=table))
        state = lio.init_state()
        state = state._replace(nav=state.nav._replace(
            v=jnp.asarray(state0.nav.v.numpy())))
        matches = []
        for s in range(pi.KITTI_SCANS):
            inputs = pi.kitti_inputs(s, n)
            state, res = lio.process_scan(
                state, *map(jnp.asarray, inputs[:7]), *inputs[7:])
            matches.append(int(res.num_matches))
        err = np.linalg.norm(np.asarray(res.pose)[:3, 3]
                             - pi.kitti_truth(inputs[-1])[:3, 3])
        return float(err), matches

    want, want_m = _cache("torch_lio_kitti_cut", (n, table), build)
    err, matches = pi.drift("cpu", n_points=n, table=table)
    print(f"final position error: port {err!r} m, reference {want!r} m; "
          f"matches {matches} / {want_m}")
    assert abs(err - want) < 1e-4
    assert all(abs(a - b) <= 0.01 * b for a, b in zip(matches, want_m))
