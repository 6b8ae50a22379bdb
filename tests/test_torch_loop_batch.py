"""The port's keyframe store and batched loop closure held against the JAX
package on the same numpy store: ``append`` with intensity, ``grow`` and
``rewrite_corrected`` (exact), ``fetch_closest_batch`` (exact),
``perform_loop_closure_batch`` with B = 3 lanes, one without a candidate,
against the JAX package's vmapped registration and against the port's own
single-candidate ``perform_loop_closure`` on each lane; and the intensity
(``feats``) channel of ``voxel_downsample``.

Tolerances: lanes against the JAX package as the single attempt's test
(tests/test_torch_loop_closure.py): decisions equal, transforms within
2 cm / 0.005 rad, fitness within 5 %.  Lanes against the port's single
path: decisions equal, transforms within 1 mm / 1e-3 rad (the batched path
differs only in fp summation order)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu.models import keyframes as jkf
from fast_lio_sam_qn_tpu.models import loop_closure as jlc
from fast_lio_sam_qn_tpu.ops import se3 as jse3
from fast_lio_sam_qn_tpu.ops import voxel as jvoxel
from fast_lio_sam_qn_tpu.utils import sim
from fast_lio_sam_qn_tpu.utils.config import LoopClosureConfig
from fast_lio_sam_qn_tpu_torch import convert
from fast_lio_sam_qn_tpu_torch.models import keyframes as kf
from fast_lio_sam_qn_tpu_torch.models import loop_closure
from fast_lio_sam_qn_tpu_torch.ops import se3, voxel
from fast_lio_sam_qn_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

N_RAYS, CAP = 4096, 1536


def _frames():
    """Three keyframes of a 16 m room: keyframes 0 and 1 are
    tests/test_torch_loop_closure.py's scan pair (keyframe 1 drifted),
    keyframe 2 a third drifted scan; all with per-point intensities."""
    world = sim.World.room(size=16.0, height=5.0, n_boxes=12, seed=6)
    rng = np.random.default_rng(4)
    frames = []
    for seed, yaw, xyz, twist, t in (
            (2, 0.5, (4.0, -3.0, 1.5), None, 0.0),
            (1, 0.0, (2.0, -1.5, 1.5), (0.0, 0.0, 0.15, 1.5, -1.0, 0.1),
             100.0),
            (3, 0.3, (3.0, -2.0, 1.5), (0.0, 0.0, -0.1, -1.0, 0.8, 0.0),
             110.0)):
        T = np.eye(4)
        T[:3, :3] = sim.so3_exp_np(np.array([0.0, 0.0, yaw]))
        T[:3, 3] = xyz
        scan, _ = sim.simulate_scan(world, T, n_points=N_RAYS, noise=0.01,
                                    seed=seed)
        p, m = sim.pad_cloud(scan, N_RAYS)
        Tc = T if twist is None else np.asarray(jse3.se3_exp(jnp.asarray(
            twist, jnp.float32)), np.float64) @ T
        inten = rng.random(N_RAYS).astype(np.float32)
        frames.append((p, m, T.astype(np.float32), Tc.astype(np.float32), t,
                       inten))
    return frames


@pytest.fixture(scope="module")
def stores():
    js = jkf.empty_store(4, N_RAYS)
    ts = kf.empty_store(4, N_RAYS, "cpu")
    for p, m, T, Tc, t, inten in _frames():
        js = jkf.append(js, jnp.asarray(p), jnp.asarray(m), jnp.asarray(T),
                        jnp.asarray(Tc), jnp.float32(t),
                        intensity=jnp.asarray(inten))
        ts = kf.append(ts, *convert.tensors_from_numpy(p, m, T, Tc,
                                                       device="cpu"),
                       t, intensity=torch.from_numpy(inten))
    return js, ts


def _cfg(cls=tconfig.LoopClosureConfig):
    """The port's config (or, given the class, the JAX package's)."""
    cfg = cls()
    cfg.quatro = dataclasses.replace(cfg.quatro, planarity_threshold=65.0)
    return cfg


def test_store_append_grow_rewrite_match_jax(stores):
    js, ts = stores
    for name, w, g in zip(js._fields, js, ts):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    jg, tg = jkf.grow(js, 6), kf.grow(ts, 6)
    assert tg.capacity == 6 and kf.grow(tg, 3) is tg
    for name, w, g in zip(jg._fields, jg, tg):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    poses = np.random.default_rng(5).normal(size=(8, 4, 4)).astype(
        np.float32)
    jr = jkf.rewrite_corrected(jg, jnp.asarray(poses))
    tr = kf.rewrite_corrected(tg, torch.from_numpy(poses))
    np.testing.assert_array_equal(tr.poses_corrected.numpy(),
                                  np.asarray(jr.poses_corrected))


def test_fetch_closest_batch_matches_jax(stores):
    js, ts = stores
    q = np.array([1, 2, 0, 2])
    want = jlc.LoopClosure(_cfg(LoopClosureConfig)).fetch_closest_batch(
        js, js.poses_corrected[q], js.timestamps[q])
    got = loop_closure.LoopClosure(_cfg()).fetch_closest_batch(
        ts, ts.poses_corrected[q], ts.timestamps[q])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [0, 0, -1, 0]


def _jax_batch(js, qidx, cidx):
    from conftest import deterministic_cache

    def build():
        reg = jlc.LoopClosure(_cfg(LoopClosureConfig), CAP,
                              CAP).perform_loop_closure_batch(
            js, jnp.asarray(qidx, jnp.int32), jnp.asarray(cidx, jnp.int32))
        return tuple(np.asarray(a) for a in reg)

    return deterministic_cache("torch_loop_batch", (qidx, cidx, CAP), build,
                               extra_files=(__file__,))


def _pose_gap(a, b):
    d = se3.se3_log(torch.linalg.inv(torch.as_tensor(a).double())
                    @ torch.tensor(np.asarray(b)).double())
    return float(d[3:].norm()), float(d[:3].norm())


def test_batch_matches_jax_and_single_lanes(stores):
    js, ts = stores
    qidx, cidx = [1, 2, 0], [0, 0, -1]
    want = _jax_batch(js, qidx, cidx)
    frames = _frames()
    for b in range(2):  # both registrations recover the drift
        T, Tc = (frames[qidx[b]][k].astype(np.float64) for k in (2, 3))
        t_err, r_err = _pose_gap(T @ np.linalg.inv(Tc), want[0][b])
        assert t_err < 0.06 and r_err < 0.02, (b, t_err, r_err)
    lc = loop_closure.LoopClosure(_cfg(), CAP, CAP)
    lc.warm_batch(ts)  # a CPU store: nothing to load
    got = lc.perform_loop_closure_batch(ts, qidx, cidx)
    np.testing.assert_array_equal(got.closest_idx.numpy(), [0, 0, -1])
    np.testing.assert_array_equal(got.closest_idx.numpy(), want[4])
    np.testing.assert_array_equal(got.is_valid.numpy(), want[2])
    np.testing.assert_array_equal(got.is_converged.numpy(), want[3])
    assert not bool(got.is_valid[2])
    for b in range(2):
        t_err, r_err = _pose_gap(got.pose_between[b], want[0][b])
        assert t_err < 0.02 and r_err < 0.005, (b, t_err, r_err)
        np.testing.assert_allclose(float(got.score[b]), want[1][b],
                                   rtol=0.05)
    worst = (0.0, 0.0)
    for b, (q, c) in enumerate(zip(qidx, cidx)):
        one = lc.perform_loop_closure(ts, q, c)
        assert int(one.closest_idx) == int(got.closest_idx[b])
        assert bool(one.is_valid) == bool(got.is_valid[b])
        assert bool(one.is_converged) == bool(got.is_converged[b])
        gap = _pose_gap(one.pose_between, got.pose_between[b].numpy())
        worst = tuple(max(w, g) for w, g in zip(worst, gap))
    print(f"largest lane vs single difference {worst[0]:.3e} m / "
          f"{worst[1]:.3e} rad")
    assert worst[0] < 1e-3 and worst[1] < 1e-3


@pytest.mark.parametrize("out_cap", [300, 2048])
def test_voxel_feats_match_jax(out_cap):
    """Intensity averaged per voxel with the points (the keyframe store's
    intensity channel); truncated and padded output capacities."""
    rng = np.random.default_rng(9)
    pts = rng.uniform(-3, 3, (1500, 3)).astype(np.float32)
    mask = rng.random(1500) > 0.2
    feats = rng.random((1500, 2)).astype(np.float32)
    wp, wm, wf = map(np.asarray, jvoxel.voxel_downsample(
        jnp.asarray(pts), jnp.asarray(mask), 0.5, out_cap=out_cap,
        feats=jnp.asarray(feats)))
    gp, gm, gf = voxel.voxel_downsample(
        torch.from_numpy(pts), torch.from_numpy(mask), 0.5, out_cap=out_cap,
        feats=torch.from_numpy(feats))
    np.testing.assert_array_equal(gm.numpy(), wm)
    np.testing.assert_allclose(gp.numpy()[wm], wp[wm], atol=1e-5)
    np.testing.assert_allclose(gf.numpy()[wm], wf[wm], atol=1e-6)
    assert gf.shape == (out_cap, 2) and not gf.numpy()[~wm].any()
    # without feats the same points come back
    p2, m2 = voxel.voxel_downsample(torch.from_numpy(pts),
                                    torch.from_numpy(mask), 0.5,
                                    out_cap=out_cap)
    assert torch.equal(p2, gp) and torch.equal(m2, gm)
