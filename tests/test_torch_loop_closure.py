"""The port's loop-closure module held against the JAX package: candidate
gating, src/dst cloud construction, and the whole attempt
``LoopClosure(cfg, src_cap, dst_cap).fetch_and_perform(store, query)`` on a
simulated scan pair, both packages fed the same numpy keyframe store."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu.models import keyframes as jkf
from fast_lio_sam_qn_tpu.models import loop_closure as jlc
from fast_lio_sam_qn_tpu.ops import se3 as jse3
from fast_lio_sam_qn_tpu.utils import sim
from fast_lio_sam_qn_tpu.utils.config import LoopClosureConfig
from fast_lio_sam_qn_tpu_torch import convert
from fast_lio_sam_qn_tpu_torch.utils import config as tconfig
from fast_lio_sam_qn_tpu_torch.models import loop_closure
from fast_lio_sam_qn_tpu_torch.ops import se3

torch.set_num_threads(1)


def _stores(frames, n_pts, capacity=32):
    """The same keyframes appended to a JAX store, then carried across."""
    js = jkf.empty_store(capacity, n_pts)
    for cloud, mask, T, Tc, t in frames:
        js = jkf.append(js, jnp.asarray(cloud), jnp.asarray(mask),
                        jnp.asarray(T), jnp.asarray(Tc), jnp.float32(t))
    ts = convert.keyframe_store_from_numpy(*[np.asarray(f) for f in js],
                                           device="cpu")
    return js, ts


def _frames_at(positions, times, n_pts=64):
    rng = np.random.default_rng(0)
    frames = []
    for i, (p, t) in enumerate(zip(positions, times)):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = p
        cloud = rng.normal(0, 1, (n_pts, 3)).astype(np.float32)
        cloud[:, 2] += 100.0 * i  # frame i sits at z = 100 i
        frames.append((cloud, np.ones(n_pts, bool), T, T, t))
    return frames


@pytest.mark.parametrize("positions,times,want", [
    # close+old, too far, too recent, farther, the query itself
    ([(1.0, 0, 0), (40.0, 0, 0), (2.0, 0, 0), (5.0, 0, 0), (0.0, 0, 0)],
     [10.0, 10.0, 90.0, 20.0, 100.0], 0),
    ([(100.0, 0, 0), (0.0, 0, 0)], [10.0, 100.0], -1),   # gated out
    ([(0.1, 0, 0), (0.0, 0, 0)], [10.0, 100.0], 0),      # latest excluded
])
def test_fetch_closest_matches_jax(positions, times, want):
    js, ts = _stores(_frames_at(positions, times), 64)
    q = len(positions) - 1
    got = loop_closure.fetch_closest_keyframe_idx(
        ts, ts.poses_corrected[q], ts.timestamps[q], 35.0, 30.0)
    ref = jlc.fetch_closest_keyframe_idx(
        js, js.poses_corrected[q], js.timestamps[q], jnp.float32(35.0),
        jnp.float32(30.0))
    assert int(got) == int(ref) == want


@pytest.mark.parametrize("submap,quatro", [(False, False), (True, True),
                                           (False, True)])
def test_src_dst_clouds_match_jax(submap, quatro):
    """All construction modes; submap bounds [idx-R, idx+R] clipped to
    [0, count-1) exclude the newest keyframe."""
    frames = _frames_at([(float(i), 0, 0) for i in range(6)],
                        [float(i) for i in range(6)], n_pts=32)
    js, ts = _stores(frames, 32)
    kw = dict(submap_range=2, src_cap=512, dst_cap=512, voxel_res=0.01,
              enable_quatro=quatro, enable_submap_matching=submap)
    (ws, wsm), (wd, wdm) = jlc.set_src_and_dst_cloud(
        js, jnp.int32(5), jnp.int32(4), **kw)
    (gs, gsm), (gd, gdm) = loop_closure.set_src_and_dst_cloud(ts, 5, 4, **kw)
    for g, gm, w, wm in ((gs, gsm, ws, wsm), (gd, gdm, wd, wdm)):
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        m = np.asarray(wm)
        np.testing.assert_allclose(g.numpy()[m], np.asarray(w)[m],
                                   atol=1e-4)
    levels = set(np.round(gd.numpy()[gdm.numpy()][:, 2] / 100).astype(int))
    assert levels == ({4} if quatro and not submap else {2, 3, 4})


# The smallest simulated pair found at which the JAX reference passes the
# benchmark's ground-truth gate on the CPU: 4096-ray scans of a 16 m room
# with 12 boxes (world seed 6), voxelized into 1536-point clouds.  (The
# benchmark's own 16k-ray pair fails the gate in the JAX package on the
# CPU: its 16-box room admits a 90-degree-rotated solution that fp32
# summation order alone can select.)
N_RAYS, CAP = 4096, 1536


def _pair():
    world = sim.World.room(size=16.0, height=5.0, n_boxes=12, seed=6)
    T1 = np.eye(4)
    T1[:3, 3] = [2.0, -1.5, 1.5]
    T2 = np.eye(4)
    T2[:3, :3] = sim.so3_exp_np(np.array([0.0, 0.0, 0.5]))
    T2[:3, 3] = [4.0, -3.0, 1.5]
    s1, _ = sim.simulate_scan(world, T1, n_points=N_RAYS, noise=0.01, seed=1)
    s2, _ = sim.simulate_scan(world, T2, n_points=N_RAYS, noise=0.01, seed=2)
    drift = np.asarray(jse3.se3_exp(jnp.asarray(
        [0.0, 0.0, 0.15, 1.5, -1.0, 0.1], jnp.float32)), np.float64)
    p1, m1 = sim.pad_cloud(s1, N_RAYS)
    p2, m2 = sim.pad_cloud(s2, N_RAYS)
    f32 = np.float32
    frames = [(p2, m2, T2.astype(f32), T2.astype(f32), 0.0),
              (p1, m1, T1.astype(f32), (drift @ T1).astype(f32), 100.0)]
    return frames, drift


def _gate_err(T, drift):
    e = se3.se3_log(torch.tensor(np.asarray(T), dtype=torch.float64)
                    @ torch.as_tensor(drift))
    return float(e[3:].norm()), float(e[:3].norm())


def test_whole_attempt_matches_jax():
    """Both packages pass the gate (< 6 cm, < 0.01 rad) on the same store;
    is_valid, is_converged and closest_idx are equal; the transforms agree
    within 2 cm / 0.005 rad; so do the graph measurements."""
    frames, drift = _pair()
    js, ts = _stores(frames, N_RAYS, capacity=2)
    cfgs = []
    for cls in (LoopClosureConfig, tconfig.LoopClosureConfig):
        cfg = cls()
        cfg.quatro = dataclasses.replace(cfg.quatro, planarity_threshold=65.0)
        cfgs.append(cfg)
    wreg, wmeas = jlc.LoopClosure(cfgs[0], CAP, CAP).fetch_and_perform(js, 1)
    greg, gmeas = loop_closure.LoopClosure(cfgs[1], CAP,
                                           CAP).fetch_and_perform(ts, 1)
    for reg in (wreg, greg):
        t_err, r_err = _gate_err(reg.pose_between, drift)
        assert t_err < 0.06 and r_err < 0.01, (t_err, r_err)
    assert bool(greg.is_valid) == bool(wreg.is_valid)
    assert bool(greg.is_converged) == bool(wreg.is_converged)
    assert int(greg.closest_idx) == int(wreg.closest_idx) == 0
    for g, w in ((greg.pose_between, wreg.pose_between), (gmeas, wmeas)):
        d = se3.se3_log(torch.linalg.inv(g.double()) @ torch.tensor(
            np.asarray(w), dtype=torch.float64))
        assert float(d[3:].norm()) < 0.02 and float(d[:3].norm()) < 0.005
    np.testing.assert_allclose(float(greg.score), float(wreg.score),
                               rtol=0.05)


def test_no_candidate_tick():
    frames = _frames_at([(100.0, 0, 0), (0.0, 0, 0)], [10.0, 100.0])
    _, ts = _stores(frames, 64)
    reg, meas = loop_closure.LoopClosure(
        tconfig.LoopClosureConfig()).fetch_and_perform(ts, 1)
    assert int(reg.closest_idx) == -1
    assert not bool(reg.is_valid) and not bool(reg.is_converged)
    torch.testing.assert_close(meas, se3.pose_between(
        ts.poses_corrected[1], ts.poses_corrected[0]))
