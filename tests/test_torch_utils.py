"""The port's host-side helpers (``fast_lio_sam_qn_tpu_torch.utils`` and
``configs``) held against the JAX package's modules they copy: every config
field the port keeps has the reference's default, every LIO preset equals
the reference's, the simulator's scans, swept scans, IMU samples and
trajectories are bit-identical, the ATE is the same number and the stage
timers report alike."""
import dataclasses

import numpy as np
import pytest

from fast_lio_sam_qn_tpu.configs import presets as jpresets
from fast_lio_sam_qn_tpu.utils import config as jconfig
from fast_lio_sam_qn_tpu.utils import evaluation as jevaluation
from fast_lio_sam_qn_tpu.utils import profiling as jprofiling
from fast_lio_sam_qn_tpu.utils import sim as jsim
from fast_lio_sam_qn_tpu_torch.configs import presets
from fast_lio_sam_qn_tpu_torch.utils import config, evaluation, profiling, sim


def _same_defaults(port, ref):
    """Every field of the port's dataclass instance exists on the
    reference's with an equal value, nested blocks recursively."""
    for f in dataclasses.fields(port):
        mine, theirs = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(mine):
            _same_defaults(mine, theirs)
        else:
            assert mine == theirs, f.name


@pytest.mark.parametrize("name", ["GicpConfig", "QuatroConfig",
                                  "LoopClosureConfig", "LioConfig",
                                  "Capacities", "PipelineConfig"])
def test_config_defaults_match_reference(name):
    port, ref = getattr(config, name)(), getattr(jconfig, name)()
    _same_defaults(port, ref)
    assert len(dataclasses.fields(port)) >= 3


@pytest.mark.parametrize("seed", [3, 5])
def test_sim_scans_bit_identical(seed):
    kw = dict(size=24.0, height=5.0, n_boxes=8, seed=seed)
    w, jw = sim.World.room(**kw), jsim.World.room(**kw)
    assert len(w.surfaces) == len(jw.surfaces)
    for a, b in zip(w.surfaces, jw.surfaces):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    traj, jtraj = sim.Trajectory.loop(7.0, 20.0), jsim.Trajectory.loop(7.0,
                                                                       20.0)
    for t in (0.0, 3.3, 17.9):
        T = traj.pose(t)
        np.testing.assert_array_equal(T, jtraj.pose(t))
        scan, rel = sim.simulate_scan(w, T, n_points=2048, seed=seed)
        jscan, jrel = jsim.simulate_scan(jw, T, n_points=2048, seed=seed)
        np.testing.assert_array_equal(scan, jscan)
        np.testing.assert_array_equal(rel, jrel)
        for x, y in zip(sim.pad_cloud(scan, 2100),
                        jsim.pad_cloud(jscan, 2100)):
            np.testing.assert_array_equal(x, y)
    w_ = np.array([0.1, -0.4, 0.7])
    np.testing.assert_array_equal(sim.so3_exp_np(w_), jsim.so3_exp_np(w_))


def test_lio_config_has_every_reference_field():
    """The LIO block is copied whole: no field of the reference's is
    missing."""
    assert ({f.name for f in dataclasses.fields(config.LioConfig)}
            == {f.name for f in dataclasses.fields(jconfig.LioConfig)})


@pytest.mark.parametrize("name", sorted(jpresets.LIO_PRESETS))
def test_lio_presets_match_reference(name):
    assert set(presets.LIO_PRESETS) == set(jpresets.LIO_PRESETS)
    assert dataclasses.asdict(presets.LIO_PRESETS[name]) == \
        dataclasses.asdict(jpresets.LIO_PRESETS[name])
    cfg, ref = presets.get_pipeline_config(name), \
        jpresets.get_pipeline_config(name)
    _same_defaults(cfg, ref)
    assert cfg.lio is not presets.LIO_PRESETS[name]
    with pytest.raises(KeyError):
        presets.get_pipeline_config("no-such-preset")


TRAJECTORIES = {
    "loop": lambda m: m.Trajectory.loop(7.0, 40.0),
    "figure8": lambda m: m.Trajectory.figure8(12.0, 60.0),
    "loop_excited": lambda m: m.Trajectory.loop_excited(),
    "straight": lambda m: m.Trajectory.straight(2.0),
}


@pytest.mark.parametrize("kind", sorted(TRAJECTORIES))
def test_trajectories_bit_identical(kind):
    traj, jtraj = TRAJECTORIES[kind](sim), TRAJECTORIES[kind](jsim)
    for t in (0.0, 0.37, 5.2, 33.3):
        np.testing.assert_array_equal(traj.pose(t), jtraj.pose(t))
        for x, y in zip(traj.derivatives(t), jtraj.derivatives(t)):
            np.testing.assert_array_equal(x, y)
    R = traj.pose(1.3)[:3, :3]
    np.testing.assert_array_equal(sim.so3_log_np(R), jsim.so3_log_np(R))


@pytest.mark.parametrize("seed", [0, 4, 9])
def test_swept_scans_and_imu_bit_identical(seed):
    kw = dict(size=26.0, height=5.0, n_boxes=10, seed=3)
    for world, jworld in ((sim.World.room(**kw), jsim.World.room(**kw)),
                          (sim.World.corridor(), jsim.World.corridor())):
        assert len(world.surfaces) == len(jworld.surfaces)
        for a, b in zip(world.surfaces, jworld.surfaces):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        traj, jtraj = sim.Trajectory.loop_excited(), \
            jsim.Trajectory.loop_excited()
        t0 = 0.2 * seed
        got = sim.simulate_scan_swept(world, traj, t0, n_points=1024,
                                      seed=seed, scan_period=0.2)
        want = jsim.simulate_scan_swept(jworld, jtraj, t0, n_points=1024,
                                        seed=seed, scan_period=0.2)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(world.sample_points(300, seed, 0.01),
                                      jworld.sample_points(300, seed, 0.01))
    got = sim.simulate_imu(traj, t0, t0 + 0.2, gyro_noise=0.002,
                           acc_noise=0.02, gyro_bias=(0.01, 0, 0), seed=seed)
    want = jsim.simulate_imu(jtraj, t0, t0 + 0.2, gyro_noise=0.002,
                             acc_noise=0.02, gyro_bias=(0.01, 0, 0),
                             seed=seed)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("align", [False, True])
def test_ate_matches_reference(align):
    rng = np.random.default_rng(1)
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, :3, 3] = rng.normal(size=(20, 3)) * 5
    est = gt.copy()
    est[:, :3, 3] += rng.normal(size=(20, 3)) * 0.1
    assert evaluation.ate_rmse(est, gt, align=align) == \
        jevaluation.ate_rmse(est, gt, align=align)


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_matches_reference(delta):
    """rpe_rmse equal to the JAX package's, exactly (both numpy)."""
    rng = np.random.default_rng(2)
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(size=(20, 3)), axis=0)
    est = gt.copy()
    for i in range(20):
        w = rng.normal(size=3) * 0.01
        c, s = np.cos(w[2]), np.sin(w[2])
        est[i, :3, :3] = gt[i, :3, :3] @ np.array([[c, -s, 0], [s, c, 0],
                                                   [0, 0, 1]])
    est[:, :3, 3] += rng.normal(size=(20, 3)) * 0.05
    got = evaluation.rpe_rmse(est, gt, delta=delta)
    assert got == jevaluation.rpe_rmse(est, gt, delta=delta)
    assert got[0] > 0 and got[1] > 0


def test_profiler_reports_alike():
    port, ref = profiling.Profiler(), jprofiling.Profiler()
    for prof in (port, ref):
        for name in ("real", "real", "opt"):
            with prof.span(name):
                pass
    assert {n: s["count"] for n, s in port.summary().items()} == \
        {n: s["count"] for n, s in ref.summary().items()} == \
        {"real": 2, "opt": 1}
    for prof, mod in ((port, profiling), (ref, jprofiling)):
        prof.stats["real"] = mod.StageStats(4, 10.0, 4.0)
    assert port.report_line() == ref.report_line()
