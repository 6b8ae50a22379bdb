"""The port's pipeline, ``FastLioSamQnPipeline(cfg, device="cpu").feed``,
held against the JAX package's on the same numpy feed: the revisiting run
of tests/test_pipeline.py (26 m room, 7 m circle, drifting odometry,
4096-ray scans) with its compact loop timing (20 s lap, 12 s time gap,
5 m radius, 1 Hz ticks), in the lossy mode (``loop_batch = 0``), in the
batched mode (``loop_batch = 2``) and in strict parity
(``apply_strict_parity()``: the reference's fitness-only acceptance, raw
loop noise and lossy timer).  The batched run starts from capacities small
enough (16 keyframes, 2 loop factors) that both grow.

Loop events (query, closest, accepted) must be equal and the corrected
trajectories within 5e-3 m (PARITY.md:153-158); a decision that differs is
a fault to find, not a tolerance to widen.  The JAX side is cached with
conftest.deterministic_cache."""
import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu.models.pipeline import FastLioSamQnPipeline as JPipe
from fast_lio_sam_qn_tpu.utils import evaluation, sim
from fast_lio_sam_qn_tpu.utils import config as jconfig
from fast_lio_sam_qn_tpu_torch.models.pipeline import FastLioSamQnPipeline
from fast_lio_sam_qn_tpu_torch.ops import se3
from fast_lio_sam_qn_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

N_SCANS, N_RAYS, SCAN_HZ = 120, 4096, 5.0
MODES = {"lossy": (0, 128, 16), "batched": (2, 16, 2),
         "strict": (0, 128, 16)}


def _config(mode, config=tconfig):
    """The port's config (or, given its module, the JAX package's)."""
    batch, max_kf, max_loops = MODES[mode]
    cfg = config.PipelineConfig()
    cfg.caps = config.Capacities(max_keyframes=max_kf, max_loop_factors=max_loops,
                          keyframe_points=2048, src_points=2048,
                          dst_points=4096)
    cfg.loop.loop_detection_timediff_threshold = 12.0
    cfg.loop.loop_detection_radius = 5.0
    cfg.loop.loop_batch = batch
    cfg.loop_update_hz = 1.0
    if mode == "strict":
        cfg.apply_strict_parity()
    return cfg


@pytest.fixture(scope="module")
def feed():
    """(odometry pose, cloud, mask, t, ground truth) per scan; odometry
    drifts by a seeded random twist per scan (the port's se3_exp, float32,
    as the reference test's)."""
    world = sim.World.room(size=26.0, height=5.0, n_boxes=10, seed=3)
    traj = sim.Trajectory.loop(radius=7.0, period=20.0)
    rng = np.random.default_rng(0)
    out, odom, prev = [], None, None
    for i in range(N_SCANS):
        t = i / SCAN_HZ
        T_gt = traj.pose(t)
        if odom is None:
            odom = T_gt.copy()
        else:
            xi = rng.normal(0, 0.004, 6) * np.array([0.2, 0.2, 1, 1, 1, 0.2])
            noise = se3.se3_exp(torch.tensor(xi, dtype=torch.float32))
            odom = odom @ np.linalg.inv(prev) @ T_gt @ noise.double().numpy()
        prev = T_gt
        scan, _ = sim.simulate_scan(world, T_gt, n_points=N_RAYS, noise=0.01,
                                    seed=100 + i)
        cloud, mask = sim.pad_cloud(scan, N_RAYS)
        out.append((odom.astype(np.float32), cloud, mask, t, T_gt))
    return out


def _drive(pipe, feed):
    gt = []
    for pose, cloud, mask, t, T_gt in feed:
        n = pipe.current_kf_idx
        pipe.feed(pose, cloud, mask, t)
        if pipe.current_kf_idx > n:
            gt.append(T_gt)
    odom, corrected = pipe.get_trajectories()
    last_tick = max((e.tick_time for e in pipe.loop_events), default=0.0)
    n_before = sum(1 for t in pipe.kf_timestamps if t <= last_tick)
    return dict(
        events=[(e.query_idx, e.closest_idx, e.accepted)
                for e in pipe.loop_events],
        commits=list(pipe.loop_idx_pairs), corrected=np.asarray(corrected),
        odom=np.asarray(odom), gt=np.stack(gt),
        processed=bool(all(pipe._kf_processed[:n_before])),
        kf_poses=np.asarray(pipe.get_corrected_keyframe_poses()),
        scan=np.asarray(pipe.get_corrected_current_scan()),
        map_points=len(pipe.get_global_map()),
        caps=(pipe.cfg.caps.max_keyframes, pipe.cfg.caps.max_loop_factors))


@pytest.fixture(scope="module", params=sorted(MODES))
def runs(request, feed):
    from conftest import deterministic_cache

    mode = request.param
    want = deterministic_cache(
        "torch_pipeline", (mode, N_SCANS, N_RAYS),
        lambda: _drive(JPipe(_config(mode, jconfig)), feed), extra_files=(__file__,))
    got = _drive(FastLioSamQnPipeline(_config(mode), device="cpu"), feed)
    return mode, got, want


def test_loop_events_equal(runs):
    mode, got, want = runs
    assert got["events"] == want["events"]
    assert got["commits"] == want["commits"]
    assert any(acc for _, _, acc in got["events"])
    if mode == "batched":
        # not lossy: every keyframe stamped before the last tick was seen
        assert got["processed"] and want["processed"]
        assert len({q for q, _, _ in got["events"]}) >= 3


def test_trajectories_agree(runs):
    mode, got, want = runs
    assert got["corrected"].shape == want["corrected"].shape
    diff = np.abs(got["corrected"][:, :3, 3] - want["corrected"][:, :3, 3])
    print(f"{mode}: largest corrected-trajectory difference "
          f"{diff.max():.3e} m")
    assert diff.max() < 5e-3
    np.testing.assert_allclose(got["odom"], want["odom"], atol=1e-5)
    ate = evaluation.ate_rmse(got["corrected"], got["gt"], align=False)
    ate_odom = evaluation.ate_rmse(got["odom"], got["gt"], align=False)
    assert ate < ate_odom and ate < 0.5, (ate, ate_odom)


def test_getters_and_growth(runs):
    mode, got, want = runs
    np.testing.assert_allclose(got["kf_poses"], want["kf_poses"], atol=5e-3)
    assert got["scan"].shape == want["scan"].shape
    np.testing.assert_allclose(got["scan"], want["scan"], atol=2e-2)
    assert abs(got["map_points"] - want["map_points"]) <= 0.01 * \
        want["map_points"]
    assert got["caps"] == want["caps"]
    if mode == "batched":
        # both capacities grew past the configured 16 keyframes / 2 loops
        assert got["caps"][0] > 16 and got["caps"][1] > 2


def test_consensus_gate_vs_strict_parity_commit():
    """Mirror of tests/test_pipeline.py's case, both packages: with the
    consensus window on, a single accepted loop waits; in strict parity
    (the reference's YAML loaded with its defaults) it commits at once."""
    from fast_lio_sam_qn_tpu.models.pipeline import FastLioSamQnPipeline as J

    def prime(pipe):
        for i in range(3):
            T = np.eye(4, dtype=np.float32)
            T[0, 3] = 2.0 * i
            pipe.feed(T, np.zeros((64, 3), np.float32), np.ones(64, bool),
                      float(i))
        pipe._consensus_commit(2, 0, np.eye(4, dtype=np.float32), 0.5)
        return list(pipe.loop_idx_pairs)

    out = {}
    for name, mod, make in (("port", tconfig, lambda c: FastLioSamQnPipeline(
            c, device="cpu")), ("jax", jconfig, J)):
        caps = mod.Capacities(max_keyframes=8, max_loop_factors=4,
                              keyframe_points=256, src_points=256,
                              dst_points=512)
        for gate, cfg in (("native", mod.PipelineConfig()),
                          ("strict", mod.load_reference_yaml({}))):
            cfg.caps = caps
            cfg.loop.loop_detection_radius = 0.0
            out[name, gate] = prime(make(cfg))
    assert out["port", "native"] == out["jax", "native"] == []
    assert out["port", "strict"] == out["jax", "strict"] == [(2, 0)]
