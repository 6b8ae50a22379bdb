"""The rest of the port's LIO — the point-map backend (``ieskf.update``,
``_plane_correspondences``) and the LiDAR-IMU extrinsic co-estimated in a
24-dim error state (``propagate`` with a 24x24 P, ``boxplus_ext``,
``_pose_ext_rows``, ``update_surfel_ext``, ``update_ext``) — held against
the JAX package on the same numpy inputs, through the ops and through
``LIO.process_scan``, plus the port's mirrors of the reference's
tests/test_extrinsic.py.

Tolerances:

- propagate with a 24x24 P over 64 samples: R, p, v within 1e-5, P within
  rtol 1e-4 on the matrix's scale (``_assert_cov``, as
  tests/test_torch_lio_ops.py); its 18x18 block equals the port's 18-dim
  propagate bit for bit and the extrinsic block is the prior plus the
  random walk;
- boxplus_ext and the 12 measurement columns: within 1e-6 (a few fp32
  products); the columns also within 5e-3 of central differences;
- the plane fits (the same map on both sides): ``valid`` equal, normals
  (sign-aligned) and residuals within 1e-4 (a 3x3 Jacobi solve in fp32);
- one update from one state: the state and extrinsic within 1e-5, P
  within rtol 1e-4, matches equal;
- ``process_scan`` from a JAX mid-run state: pose and extrinsic within
  1e-5, matches equal, P as above with 18 dims; with 24 the posterior is
  held to the first-order bound of an inverse's error, fp32's unit
  roundoff times cond(P) of its largest entry (``_assert_cov24``).  Its
  pose and extrinsic rotations are nearly collinear in the update, so
  cond(P) is ~1e5 and last-bit differences of A + P^-1 move P by up to
  4.3e-4 of its scale (traced: 6.8e-5 to 4.3e-4 over the four mid-run
  scans, against 1e-6 with the point map's 18 dims);
- a 5-scan stream from ``init_state``: every pose within 1e-4 m / 1e-4
  rad, with the extrinsic co-estimated within 5e-4 m / 2e-4 rad: there
  the posterior's conditioning carries into the next scans' gains
  (traced: 1.3e-4 m / 4.7e-5 rad with the surfel map, 9.0e-6 m with the
  point map, each scan from one state within 3e-6 m).

The JAX side is cached with conftest.deterministic_cache."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fast_lio_sam_qn_tpu.configs.presets import get_pipeline_config as jget
from fast_lio_sam_qn_tpu.models.lio import LIO as JLIO
from fast_lio_sam_qn_tpu.ops import hashgrid as jgrid
from fast_lio_sam_qn_tpu.ops import ieskf as jieskf
from fast_lio_sam_qn_tpu.ops import surfel_map as jsurfel
from fast_lio_sam_qn_tpu.utils import sim as jsim
from fast_lio_sam_qn_tpu_torch.configs.presets import get_pipeline_config
from fast_lio_sam_qn_tpu_torch.convert import (lio_state_from_numpy,
                                               tensors_from_numpy)
from fast_lio_sam_qn_tpu_torch.models.lio import LIO
from fast_lio_sam_qn_tpu_torch.ops import hashgrid, ieskf, se3, surfel_map
from fast_lio_sam_qn_tpu_torch.run import sim_lio_stream, sim_scan_inputs
from fast_lio_sam_qn_tpu_torch.tools import lio_scenarios as ls
from fast_lio_sam_qn_tpu_torch.utils import sim
from test_torch_lio import _pose_gap, _state_numpy
from test_torch_lio_ops import _assert_cov

torch.set_num_threads(1)

SMALL = dict(max_points_per_scan=2048, map_table_size=1 << 13)
NOISE6 = np.array([0.1, 0.1, 1e-4, 1e-4, 1e-5, 1e-5], np.float32)
MEAS_VAR = float(np.float32(0.0025))
TH = float(np.float32(0.1))
PERIOD = 0.2
MIDRUN = (3, 6)
# the LIO configurations of this slice: (map_backend, extrinsic_est_en)
MODES = {"point": ("point", False), "ext-surfel": ("surfel", True),
         "ext-point": ("point", True)}


def _cache(name, params, build):
    from conftest import deterministic_cache

    return deterministic_cache(name, params, build, extra_files=(__file__,))


def _t(*arrays):
    return tensors_from_numpy(*arrays, device="cpu")


def _assert_cov24(P, want):
    """|P - want| <= 6e-8 cond(want) max |want|, elementwise."""
    want = np.asarray(want, np.float64)
    bound = 6e-8 * np.linalg.cond(want) * np.abs(want).max()
    gap = np.abs(np.asarray(P, np.float64) - want).max()
    assert gap <= bound, (gap, bound)


def _rot(rng, scale):
    return se3.so3_exp(torch.from_numpy(
        rng.normal(0, scale, 3).astype(np.float32))).numpy()


# ---------------------------------------------------------------------------
# the 24-dim filter's pieces
# ---------------------------------------------------------------------------

def _imu(k=64, valid=40):
    traj = sim.Trajectory.loop_excited()
    ts, gyro, acc = sim.simulate_imu(traj, 2.0, 2.2, gyro_noise=0.01,
                                     acc_noise=0.05, seed=4)
    t = np.zeros(k, np.float32)
    g = np.zeros((k, 3), np.float32)
    a = np.zeros((k, 3), np.float32)
    m = np.zeros(k, bool)
    t[:valid], g[:valid], a[:valid], m[:valid] = (ts[:valid], gyro[:valid],
                                                  acc[:valid], True)
    m[5:8] = False
    T0 = traj.pose(2.0)
    v0, _, _ = traj.derivatives(2.0)
    nav = [T0[:3, :3], T0[:3, 3], T0[:3, :3].T @ v0, [0.01, -0.02, 0.005],
           [0.05, 0.02, -0.03], [0.0, 0.0, -9.81]]
    nav = [np.asarray(x, np.float32) for x in nav]
    P0 = np.diag(np.linspace(1e-4, 1e-2, 24)).astype(np.float32)
    P0[20, 2] = P0[2, 20] = 1e-5          # a nav-extrinsic cross term
    return nav, P0, t, g, a, m


def test_propagate_24_matches_reference():
    nav, P0, t, g, a, m = _imu()

    def build():
        s, P, log = jieskf.propagate(
            jieskf.NavState(*map(jnp.asarray, nav)), jnp.asarray(P0),
            *map(jnp.asarray, (t, g, a, m)), jnp.float32(2.0),
            jnp.float32(2.2), jnp.asarray(NOISE6))
        return [np.asarray(x) for x in s], np.asarray(P), \
            [np.asarray(x) for x in log]

    ws, wP, wlog = _cache("torch_lio_propagate24", (), build)
    t0, t1 = torch.tensor(2.0), torch.tensor(2.2)
    s, P, log = ieskf.propagate(ieskf.NavState(*_t(*nav)), *_t(P0, t, g, a, m),
                                t0, t1, torch.from_numpy(NOISE6))
    assert P.shape == (24, 24)
    for x, y in zip(s[:3], ws[:3]):
        np.testing.assert_allclose(x.numpy(), y, rtol=0, atol=1e-5)
    _assert_cov(P.numpy(), wP)
    for x, y in zip(log, wlog):
        np.testing.assert_allclose(x.numpy(), y, rtol=0, atol=1e-5)
    # the nav block is the 18-dim propagate's, bit for bit, when the
    # extrinsic has no cross-covariance
    P0[20, 2] = P0[2, 20] = 0.0
    _, P24, _ = ieskf.propagate(ieskf.NavState(*_t(*nav)),
                                *_t(P0, t, g, a, m), t0, t1,
                                torch.from_numpy(NOISE6))
    _, P18, _ = ieskf.propagate(ieskf.NavState(*_t(*nav)),
                                *_t(P0[:18, :18], t, g, a, m), t0, t1,
                                torch.from_numpy(NOISE6[:4]))
    assert torch.equal(P24[:18, :18], P18)
    assert float(P24[:18, 18:].abs().max()) == 0.0
    # the random walk over the scan's 0.2 s
    np.testing.assert_allclose(np.diag(P24[18:, 18:].numpy()),
                               np.diag(P0[18:, 18:]) + 1e-5 * 0.2, rtol=1e-5)


def test_propagate_is_shape_generic_in_p():
    """Mirror of tests/test_extrinsic.py's: with a zero random walk the
    24x24 P carries its 18-block like the 18x18 path and the extrinsic
    block stays the prior."""
    nav, _, t, g, a, m = _imu()
    args = (ieskf.NavState(*_t(*nav)),)
    rest = _t(t, g, a, m) + (torch.tensor(2.0), torch.tensor(2.2))
    noise = torch.tensor([0.1, 0.1, 1e-4, 1e-4, 0.0, 0.0])
    _, P18, _ = ieskf.propagate(*args, ieskf.init_covariance("cpu"), *rest,
                                noise[:4])
    _, P24, _ = ieskf.propagate(
        *args, ieskf.init_covariance("cpu", est_extrinsic=True), *rest, noise)
    np.testing.assert_allclose(P24[:18, :18].numpy(), P18.numpy(), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(P24[18:, 18:].numpy(), 1e-3 * np.eye(6),
                               rtol=1e-6)
    assert float(P24[:18, 18:].abs().max()) == 0.0


def test_init_covariance_and_boxplus_ext_match_reference():
    for est in (False, True):
        np.testing.assert_array_equal(
            ieskf.init_covariance("cpu", est_extrinsic=est).numpy(),
            np.asarray(jieskf.init_covariance(est_extrinsic=est)))
    rng = np.random.default_rng(1)
    R, t = _rot(rng, 0.3), rng.normal(0, 0.2, 3).astype(np.float32)
    dx = (rng.normal(0, 0.05, 6)).astype(np.float32)
    got = ieskf.boxplus_ext(ieskf.Extrinsic(*_t(R, t)), torch.from_numpy(dx))
    want = jieskf.boxplus_ext(jieskf.Extrinsic(jnp.asarray(R),
                                               jnp.asarray(t)),
                              jnp.asarray(dx))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                   atol=1e-6)


def _ext_problem(seed=0, n=16):
    rng = np.random.default_rng(seed)
    nav = [_rot(rng, 0.5), rng.normal(0, 2, 3).astype(np.float32)] + [
        np.zeros(3, np.float32)] * 3 + [np.array([0, 0, -9.81], np.float32)]
    ext = [_rot(rng, 0.2), rng.normal(0, 0.2, 3).astype(np.float32)]
    pts_l = rng.normal(0, 5, (n, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (n, 3)).astype(np.float32)
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(
        np.float32)
    return nav, ext, pts_l, nrm


def test_pose_ext_rows_match_reference_and_finite_differences():
    """The analytic rows of d r / d [dtheta dp dphi_li dt_li] against the
    JAX package's and against central differences of the residual through
    boxplus / boxplus_ext (tests/test_extrinsic.py's check)."""
    nav, ext, pts_l, nrm = _ext_problem()
    s, e = ieskf.NavState(*_t(*nav)), ieskf.Extrinsic(*_t(*ext))
    pl, n = _t(pts_l, nrm)
    p_b = ieskf._ptransform(pl, e.R, e.t)
    h = ieskf._pose_ext_rows(pl, p_b, s, e, n).numpy()
    js = jieskf.NavState(*map(jnp.asarray, nav))
    je = jieskf.Extrinsic(*map(jnp.asarray, ext))
    want = jieskf._pose_ext_rows(
        jnp.asarray(pts_l), jieskf._ptransform(jnp.asarray(pts_l), je.R,
                                               je.t), js, je,
        jnp.asarray(nrm))
    np.testing.assert_allclose(h, np.asarray(want), rtol=0, atol=1e-5)

    def resid(dx12):
        s2 = ieskf.boxplus(s, torch.cat([dx12[:6], torch.zeros(12)]))
        e2 = ieskf.boxplus_ext(e, dx12[6:])
        pw = ieskf._ptransform(ieskf._ptransform(pl, e2.R, e2.t), s2.R, s2.p)
        return torch.sum(n * pw, dim=-1)

    eps = 1e-3
    for j in range(12):
        d = torch.zeros(12)
        d[j] = eps
        fd = ((resid(d) - resid(-d)) / (2 * eps)).numpy()
        np.testing.assert_allclose(h[:, j], fd, atol=5e-3, err_msg=f"col {j}")


# ---------------------------------------------------------------------------
# the point map's plane fits and the updates, from one state
# ---------------------------------------------------------------------------

def _room_points(n, seed):
    world = sim.World.room(size=6.0, height=2.5, n_boxes=2, seed=5)
    return world.sample_points(n, seed=seed, noise=0.005)


@pytest.fixture(scope="module")
def maps():
    """A point map and a surfel map of the same small room (0.3 m), and a
    scan of it seen from a pose off the prior, in the body frame."""
    pts = _room_points(6000, 1)
    mask = np.ones(len(pts), bool)
    grid = jgrid.build(jnp.asarray(pts), jnp.asarray(mask), res=0.3,
                       table_size=1 << 14)
    smap = jsurfel.insert(jsurfel.empty(res=0.3, table_size=1 << 14),
                          jnp.asarray(pts), jnp.asarray(mask),
                          thickness=jnp.float32(TH), hood_window=7)
    scan = _room_points(2048, 2)
    scan_mask = np.random.default_rng(3).random(len(scan)) > 0.05
    R = se3.so3_exp(torch.tensor([0.0, 0.004, 0.01])).numpy()
    p = np.array([0.03, -0.02, 0.01], np.float32)
    body = ((scan - p) @ R).astype(np.float32)      # R^T (x - p)
    return dict(grid=jgrid.HashGrid(*map(np.asarray, grid[:4]), res=0.3),
                smap=jsurfel.SurfelMap(*map(np.asarray, smap[:4]), res=0.3),
                body=body, mask=scan_mask)


def _jgrid(maps):
    return jgrid.HashGrid(*map(jnp.asarray, maps["grid"][:4]), res=0.3)


def _tgrid(maps):
    return hashgrid.HashGrid(*_t(*maps["grid"][:4]), res=0.3)


@pytest.mark.parametrize("plane_k", [5, 8])
def test_plane_correspondences_match_reference(maps, plane_k):
    pts_w = maps["body"] + np.float32(0.02)
    n, r, v = ieskf._plane_correspondences(_tgrid(maps),
                                           *_t(pts_w, maps["mask"]), plane_k,
                                           TH)
    wn, wr, wv = jieskf._plane_correspondences(
        _jgrid(maps), jnp.asarray(pts_w), jnp.asarray(maps["mask"]), plane_k,
        jnp.float32(TH))
    v, wv = v.numpy(), np.asarray(wv)
    np.testing.assert_array_equal(v, wv)
    assert v.mean() > 0.5
    n, wn = n.numpy()[v], np.asarray(wn)[v]
    sign = np.sign(np.sum(n * wn, axis=-1, keepdims=True))
    np.testing.assert_allclose(n, sign * wn, rtol=0, atol=1e-4)
    np.testing.assert_allclose(r.numpy()[v], sign[:, 0] * np.asarray(wr)[v],
                               rtol=0, atol=1e-4)


def _nav0():
    return [np.eye(3, dtype=np.float32)] + [np.zeros(3, np.float32)] * 4 + [
        np.array([0, 0, -9.81], np.float32)]


UPDATES = ("update", "update_ext", "update_surfel_ext")


@pytest.mark.parametrize("which", UPDATES)
def test_updates_match_reference(maps, which):
    """One iterated update on the same map and state; the extrinsic ones
    from a wrong extrinsic, the scan in its LiDAR frame."""
    nav = _nav0()
    ext = [se3.so3_exp(torch.tensor([0.01, -0.01, 0.02])).numpy(),
           np.array([0.02, -0.01, 0.015], np.float32)]
    est = which != "update"
    P0 = np.asarray(jieskf.init_covariance(est_extrinsic=est))
    body, mask = maps["body"], maps["mask"]
    pts_l = ((body - ext[1]) @ ext[0]).astype(np.float32) if est else body

    def build():
        js = jieskf.NavState(*map(jnp.asarray, nav))
        je = jieskf.Extrinsic(*map(jnp.asarray, ext))
        args = (jnp.asarray(pts_l), jnp.asarray(mask), jnp.float32(MEAS_VAR))
        if which == "update":
            out = jieskf.update(js, jnp.asarray(P0), _jgrid(maps), *args,
                                jnp.float32(TH), max_iter=3)
            out = (out[0], je) + out[1:]
        elif which == "update_ext":
            out = jieskf.update_ext(js, je, jnp.asarray(P0), _jgrid(maps),
                                    *args, jnp.float32(TH), max_iter=3)
        else:
            jm = jsurfel.SurfelMap(*map(jnp.asarray, maps["smap"][:4]),
                                   res=0.3)
            out = jieskf.update_surfel_ext(js, je, jnp.asarray(P0), jm,
                                           *args, max_iter=3, window=1)
        return ([np.asarray(x) for x in out[0]],
                [np.asarray(x) for x in out[1]], np.asarray(out[2]),
                int(out[3]))

    ws, we, wP, wk = _cache("torch_lio_update_ext", (which,), build)
    s0, e0 = ieskf.NavState(*_t(*nav)), ieskf.Extrinsic(*_t(*ext))
    args = _t(pts_l, mask) + (MEAS_VAR,)
    if which == "update":
        s, P, k = ieskf.update(s0, *_t(P0), _tgrid(maps), *args, TH,
                               max_iter=3)
        e = e0
    elif which == "update_ext":
        s, e, P, k = ieskf.update_ext(s0, e0, *_t(P0), _tgrid(maps), *args,
                                      TH, max_iter=3)
    else:
        smap = surfel_map.SurfelMap(*_t(*maps["smap"][:4]), res=0.3)
        s, e, P, k = ieskf.update_surfel_ext(s0, e0, *_t(P0), smap, *args,
                                             max_iter=3, window=1)
    print(f"{which}: matches {int(k)} / {wk}")
    assert int(k) == wk and wk > 500
    for x, y in zip(list(s) + list(e), ws + we):
        np.testing.assert_allclose(x.numpy(), y, rtol=0, atol=1e-5)
    _assert_cov(P.numpy(), wP)
    assert P.shape == ((24, 24) if est else (18, 18))
    assert np.linalg.norm(s.p.numpy()) > 1e-3      # the update moved


def test_update_ext_point_backend_reduces_extrinsic_error():
    """Mirror of tests/test_extrinsic.py's point-map case: against an exact
    map of three orthogonal planes, iterated updates from a wrong extrinsic
    cut the composed error below a quarter and move the extrinsic itself
    toward the truth."""
    rng = np.random.default_rng(7)
    k = 800
    floor = np.stack([rng.uniform(0, 8, k), rng.uniform(0, 8, k),
                      np.zeros(k)], -1)
    wx = np.stack([np.full(k, 8.0), rng.uniform(0, 8, k),
                   rng.uniform(0, 4, k)], -1)
    wy = np.stack([rng.uniform(0, 8, k), np.full(k, 8.0),
                   rng.uniform(0, 4, k)], -1)
    p_w = torch.from_numpy(np.concatenate([floor, wx, wy]).astype(np.float32))
    grid = hashgrid.insert(hashgrid.empty(0.3, 1 << 15, "cpu"), p_w,
                           torch.ones(len(p_w), dtype=bool))
    wvec = torch.from_numpy(np.deg2rad(np.array([2.5, 1.5, 2.0],
                                                np.float32)))
    R_true = se3.so3_exp(wvec)
    t_true = torch.tensor([0.06, -0.04, 0.02])
    origin = torch.tensor([3.0, 3.0, 1.5])
    p_l = (p_w - origin - t_true) @ R_true
    nav = ieskf.identity_state("cpu")._replace(p=origin)
    ext = ieskf.Extrinsic(R=torch.eye(3), t=torch.zeros(3))
    P = ieskf.init_covariance("cpu", est_extrinsic=True)
    mask = torch.ones(len(p_l), dtype=bool)

    def comp_err(nav_, ext_):
        pw = ieskf._ptransform(ieskf._ptransform(p_l, ext_.R, ext_.t),
                               nav_.R, nav_.p)
        return float(torch.sqrt(torch.mean(torch.sum((pw - p_w) ** 2, -1))))

    err0 = comp_err(nav, ext)
    for _ in range(5):
        nav, ext, P, matches = ieskf.update_ext(nav, ext, P, grid, p_l, mask,
                                                MEAS_VAR, TH, max_iter=3)
    err1 = comp_err(nav, ext)
    assert int(matches) > 1000, int(matches)
    assert err1 < 0.25 * err0, (err0, err1)
    rot_err1 = float(torch.linalg.norm(se3.so3_log(R_true.T @ ext.R)))
    assert rot_err1 < 0.7 * float(torch.linalg.norm(wvec))


# ---------------------------------------------------------------------------
# LIO.process_scan with the point map and with the extrinsic co-estimated
# ---------------------------------------------------------------------------

def _cfg(get, mode):
    backend, est = MODES[mode]
    cfg = get("sim")
    cfg.lio = dataclasses.replace(cfg.lio, map_backend=backend,
                                  extrinsic_est_en=est, **SMALL)
    return cfg


def _world(mod):
    return (mod.World.room(size=26.0, height=5.0, n_boxes=10, seed=3),
            mod.Trajectory.loop(radius=7.0, period=40.0))


@pytest.fixture(scope="module", params=sorted(MODES))
def ref_midrun(request):
    """The JAX LIO in one mode over the small-width stream: the state
    before each scan of MIDRUN, that scan's pose, match count, extrinsic
    and body cloud."""
    mode = request.param

    def build():
        cfg = _cfg(jget, mode).lio
        world, traj = _world(jsim)
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
                          int(res.num_matches), np.asarray(res.cloud_body),
                          [np.asarray(x) for x in state.ext],
                          np.asarray(state.P))
        return out

    return mode, _cache("torch_lio_ext_midrun", (mode, SMALL, MIDRUN), build)


@pytest.mark.parametrize("scan", MIDRUN)
def test_process_scan_from_reference_state(scan, ref_midrun):
    mode, runs = ref_midrun
    before, pose, matches, body, ext, P = runs[scan]
    state = lio_state_from_numpy(*before, device="cpu")
    backend, est = MODES[mode]
    assert isinstance(state.grid, hashgrid.HashGrid if backend == "point"
                      else surfel_map.SurfelMap)
    assert state.P.shape == ((24, 24) if est else (18, 18))
    cfg = _cfg(get_pipeline_config, mode).lio
    world, traj = _world(sim)
    inputs = sim_scan_inputs(world, traj, scan, PERIOD,
                             4 * cfg.max_points_per_scan)
    new, res = LIO(cfg, device="cpu").process_scan(state, *inputs)
    dp, dr = _pose_gap(res.pose.numpy(), pose)
    print(f"{mode} scan {scan}: {dp:.3e} m, {dr:.3e} rad, matches "
          f"{int(res.num_matches)} / {matches}")
    assert dp < 1e-5 and dr < 1e-5
    assert int(res.num_matches) == matches > 100
    for x, y in zip(new.ext, ext):
        np.testing.assert_allclose(x.numpy(), y, rtol=0, atol=1e-5)
    (_assert_cov24 if est else _assert_cov)(new.P.numpy(), P)
    np.testing.assert_allclose(res.cloud_body.numpy(), body, rtol=0,
                               atol=1e-4)
    if est:
        # the extrinsic is filter state: it moved from the configured one
        assert not np.array_equal(ext[0], np.eye(3, dtype=np.float32))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_stream_matches_reference(mode):
    """5 scans from init_state through run.sim_lio_stream: every pose
    within 1e-4 m and 1e-4 rad of the JAX stream's (5e-4 m, 2e-4 rad with
    the extrinsic co-estimated)."""
    from fast_lio_sam_qn_tpu.run import sim_lio_stream as jstream

    n = 5

    def build():
        world, traj = _world(jsim)
        return [np.asarray(item[0]) for item in
                jstream(_cfg(jget, mode), world, traj, n, 5.0)]

    want = _cache("torch_lio_ext_stream", (mode, SMALL, n), build)
    world, traj = _world(sim)
    got = [item[0].numpy() for item in sim_lio_stream(
        _cfg(get_pipeline_config, mode), world, traj, n, 5.0, device="cpu")]
    gaps = np.asarray([_pose_gap(a, b) for a, b in zip(got, want)])
    print(f"{mode}: largest pose gap over {n} scans: {gaps[:, 0].max():.3e} "
          f"m, {gaps[:, 1].max():.3e} rad")
    tol = (5e-4, 2e-4) if MODES[mode][1] else (1e-4, 1e-4)
    assert gaps[:, 0].max() < tol[0] and gaps[:, 1].max() < tol[1]


def test_init_state_and_map_points_of_the_point_map(ref_midrun):
    mode, runs = ref_midrun
    backend, est = MODES[mode]
    cfg = _cfg(get_pipeline_config, mode).lio
    got = LIO(cfg, device="cpu").init_state()
    want = JLIO(_cfg(jget, mode).lio).init_state()
    np.testing.assert_array_equal(got.P.numpy(), np.asarray(want.P))
    for x, y in zip(got.grid[:4], want.grid[:4]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    before = runs[MIDRUN[-1]][0]
    state = lio_state_from_numpy(*before, device="cpu")
    kind = jgrid.HashGrid if backend == "point" else jsurfel.SurfelMap
    jstate = want._replace(grid=kind(*map(jnp.asarray, before[2][:4]),
                                     res=before[2][4]))
    pts = LIO.get_map_points(state)
    np.testing.assert_allclose(pts, JLIO.get_map_points(jstate), rtol=0,
                               atol=1e-6)
    assert len(pts) > 1000


# ---------------------------------------------------------------------------
# the extrinsic's convergence on a truth map (tests/test_extrinsic.py:108)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_extrinsic_estimation_converges_on_sim():
    """The port's twin of tests/test_extrinsic.py's convergence test, with
    its tolerances: roll and pitch below 0.8 deg, yaw below 3 deg, each
    lever arm below 2.5 cm, the last 10 scans' mean position error below
    5 cm."""
    rot_err, trans_err, pose_errs, _ = ls.extrinsic_convergence("cpu")
    print(f"extrinsic error: {rot_err} deg, {trans_err} m; last 10 scans "
          f"{pose_errs[-10:].mean():.4f} m")
    assert abs(rot_err[0]) < 0.8 and abs(rot_err[1]) < 0.8, rot_err
    assert abs(rot_err[2]) < 3.0, rot_err
    assert np.all(np.abs(trans_err) < 0.025), trans_err
    assert np.mean(pose_errs[-10:]) < 0.05, pose_errs[-10:]


@pytest.mark.slow
def test_point_stream_drift_pin():
    """The pin of chip_smoke.py's lio_point stream: the JAX package's
    largest position error over the 60-scan point-map stream at the sim
    width (``POINT_JAX_ERR``), and the port's on the CPU within 1.5x of
    it.  Run with ``python -m pytest tests/test_torch_lio_ext.py -m slow
    -k drift_pin -s`` to recompute the figure."""
    import chip_smoke
    from fast_lio_sam_qn_tpu.run import sim_lio_stream as jstream

    def build():
        cfg = jget("sim")
        cfg.lio = dataclasses.replace(cfg.lio, map_backend="point")
        world, traj = ls.golden_world(jsim)
        return [float(np.linalg.norm(np.asarray(pose)[:3, 3] - gt[:3, 3]))
                for pose, _, _, _, gt in jstream(
                    cfg, world, traj, ls.POINT_SCANS, ls.POINT_HZ)]

    want = max(_cache("torch_lio_point_drift", (ls.POINT_SCANS,), build))
    got = ls.point_stream("cpu")
    print(f"largest position error over {ls.POINT_SCANS} scans: JAX "
          f"{want!r} m, port on the CPU {got.max()!r} m")
    assert want == chip_smoke.POINT_JAX_ERR
    assert got.max() <= 1.5 * want
