"""The port's host-side helpers (``fast_lio_sam_qn_tpu_torch.utils``) held
against the JAX package's modules they copy: every config field the port
keeps has the reference's default, the simulator's scans are bit-identical,
the ATE is the same number and the stage timers report alike."""
import dataclasses

import numpy as np
import pytest

from fast_lio_sam_qn_tpu.utils import config as jconfig
from fast_lio_sam_qn_tpu.utils import evaluation as jevaluation
from fast_lio_sam_qn_tpu.utils import profiling as jprofiling
from fast_lio_sam_qn_tpu.utils import sim as jsim
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
                                  "LoopClosureConfig", "Capacities",
                                  "PipelineConfig"])
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


@pytest.mark.parametrize("align", [False, True])
def test_ate_matches_reference(align):
    rng = np.random.default_rng(1)
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, :3, 3] = rng.normal(size=(20, 3)) * 5
    est = gt.copy()
    est[:, :3, 3] += rng.normal(size=(20, 3)) * 0.1
    assert evaluation.ate_rmse(est, gt, align=align) == \
        jevaluation.ate_rmse(est, gt, align=align)


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
