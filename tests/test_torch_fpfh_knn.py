"""The port's kNN FPFH backend held against the JAX package: kernel K1's
plain version at k = 48 / 64 (what ``knn_pallas`` runs on the CPU),
``estimate_normals``, ``fpfh`` (single and lane-batched), the grid plane
covariances, and ``LoopClosure`` with ``fpfh_backend="knn"``; plus the
port's own mirrors of tests/test_quatro.py (descriptor invariance, the
distinctive filter, a loop pair) and of tests/test_fpfh_stream.py's
stream-vs-kNN agreement.

Tolerances: kNN validity exact, indices equal except at near-ties within
4 ulp of d2 (counted, at most 1 % of the valid slots).  Descriptors:
validity exact; within 1e-3 on every row whose own pairs and whose
neighbours' pairs have no angle within 1e-5 of a bin edge and no distance
within 1e-4 m^2 of a radius (the two packages round the expansion's d2 and
the angles differently); rows beyond 1e-3 at most 1 % of the valid rows.
Loop closure: decisions equal, poses within 1e-3 m / 1e-3 rad.  Grid
covariances: equal valid masks, covariances within 1e-5."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu.models import loop_closure as jlc
from fast_lio_sam_qn_tpu.ops import fpfh as jfpfh
from fast_lio_sam_qn_tpu.ops import gicp as jgicp
from fast_lio_sam_qn_tpu.ops import knn as jknn
from fast_lio_sam_qn_tpu.ops import voxel as jvoxel
from fast_lio_sam_qn_tpu.utils import sim as jsim
from fast_lio_sam_qn_tpu.utils.config import LoopClosureConfig
from fast_lio_sam_qn_tpu_torch.models import loop_closure
from fast_lio_sam_qn_tpu_torch.ops import fpfh, fpfh_stream, gicp, knn_cuda
from fast_lio_sam_qn_tpu_torch.ops import se3, voxel
from fast_lio_sam_qn_tpu_torch.utils import config as tconfig
from fast_lio_sam_qn_tpu_torch.utils import sim

torch.set_num_threads(1)

WORLD = sim.World.room(size=24.0, height=5.0, n_boxes=10, seed=5)
JWORLD = jsim.World.room(size=24.0, height=5.0, n_boxes=10, seed=5)
VP = np.array([0.0, 0.0, 1.5], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# K1 at k = 48 / 64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f,k", [(3, 48), (3, 64), (33, 48), (33, 64)])
def test_knn_large_k_matches_jax(f, k):
    rng = np.random.default_rng(f * 100 + k)
    m, n = 300, 700
    q = (rng.normal(size=(m, f)) * 3).astype(np.float32)
    db = (rng.normal(size=(n, f)) * 3).astype(np.float32)
    qm, dm = rng.random(m) > 0.2, rng.random(n) > 0.2
    wd, wi, wv = map(np.asarray, jknn.brute_knn(
        *map(jnp.asarray, (q, qm, db, dm)), k=k))
    gd, gi, gv = (a.numpy() for a in knn_cuda.knn(*map(_t, (q, qm, db, dm)),
                                                  k))
    np.testing.assert_array_equal(gv, wv)
    assert gv.any()
    # the two expansions round |q|^2 - 2 q.v + |v|^2 differently: d2
    # within 4 ulp of its largest term
    big = (np.sum(q * q, 1)[:, None] + np.sum(db * db, 1)[
        np.clip(wi, 0, None)]).astype(np.float32)
    ulp4 = 4 * np.spacing(big)
    assert np.all(np.abs(np.where(gv, gd, 0) - np.where(gv, wd, 0)) <= ulp4)
    # a swapped index is a near-tie: the two candidates' true distances
    # within 4 ulp of d2
    swap = (gi != wi) & gv
    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    for r, c in zip(*np.nonzero(swap)):
        a = np.sum((q64[r] - db64[gi[r, c]]) ** 2)
        b = np.sum((q64[r] - db64[wi[r, c]]) ** 2)
        assert abs(a - b) <= ulp4[r, c], (r, c, a, b)
    assert swap.sum() <= 0.01 * gv.sum(), swap.sum()
    # the batched plain version: each lane the single search
    bd, bi, bv = knn_cuda.knn_batched(*(torch.stack([_t(a)] * 2)
                                        for a in (q, qm, db, dm)), k)
    for lane in range(2):
        np.testing.assert_array_equal(bi[lane].numpy(), gi)
        np.testing.assert_array_equal(bd[lane].numpy(), gd)


# ---------------------------------------------------------------------------
# normals and descriptors
# ---------------------------------------------------------------------------

def _cloud(n_points, seed, cap, noise=0.005):
    """WORLD sampled and voxelized at 0.3 m by the JAX package: (points,
    mask) as numpy."""
    a = JWORLD.sample_points(n_points, seed=seed, noise=noise)
    pa, ma = jsim.pad_cloud(a, n_points)
    va, vma = jvoxel.voxel_downsample(jnp.asarray(pa), jnp.asarray(ma), 0.3,
                                      out_cap=cap)
    return np.array(va), np.array(vma)


def _bin_edge_rows(p, m, vp, k_feat=48, k_normal=32, nr=0.9, fr=1.5):
    """Rows whose descriptor may differ between the packages: a pair of the
    row or of one of its in-radius neighbours has an angle within 1e-5 of
    a bin edge or a d2 within 1e-4 of a radius (JAX's kNN and normals)."""
    d2, idx, v = map(np.asarray, jknn.brute_knn(
        *map(jnp.asarray, (p, m, p, m)), k=max(k_feat, k_normal)))
    n, nv = map(np.asarray, jfpfh._normals_from_knn(
        jnp.asarray(p), jnp.asarray(m), jnp.asarray(d2[:, :k_normal]),
        jnp.asarray(idx[:, :k_normal]), jnp.asarray(v[:, :k_normal]), nr,
        jnp.asarray(vp)))
    ic = np.clip(idx[:, :k_feat], 0, None)
    alpha, phi, theta, _ = map(np.asarray, jfpfh._pair_features(
        jnp.asarray(p[:, None]), jnp.asarray(n[:, None]), jnp.asarray(p[ic]),
        jnp.asarray(n[ic])))

    def near(x, lo, hi):
        edges = lo + np.arange(12) * (hi - lo) / 11
        return (np.abs(x[..., None] - edges) < 1e-5).any(-1)

    w = v[:, :k_feat] & nv[ic] & (m & nv)[:, None] & (d2[:, :k_feat]
                                                      <= fr * fr)
    edge = w & (near(alpha, -1, 1) | near(phi, -1, 1)
                | near(theta, -np.pi, np.pi))
    edge |= v[:, :k_feat] & ((np.abs(d2[:, :k_feat] - fr * fr) < 1e-4)
                             | (np.abs(d2[:, :k_feat] - nr * nr) < 1e-4))
    own = edge.any(1)
    return own | (own[ic] & w).any(1)


def _check_desc(got, want, edge_rows):
    gd, gv = (np.asarray(a) for a in got)
    wd, wv = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum() > 100
    bad = np.abs(gd - wd).max(1) > 1e-3
    assert not (bad & ~edge_rows).any(), np.nonzero(bad & ~edge_rows)[0]
    assert bad.sum() <= 0.01 * wv.sum(), (bad.sum(), wv.sum())
    return bad.sum()


@pytest.fixture(scope="module")
def clouds():
    return [_cloud(4096, seed, 2048) for seed in (3, 4)]


def test_estimate_normals_matches_jax(clouds):
    p, m = clouds[0]
    wn, wv = map(np.asarray, jfpfh.estimate_normals(
        jnp.asarray(p), jnp.asarray(m), jnp.float32(0.9), k=32,
        viewpoint=jnp.asarray(VP)))
    gn, gv = fpfh.estimate_normals(_t(p), _t(m), 0.9, 32, viewpoint=_t(VP))
    np.testing.assert_array_equal(gv.numpy(), wv)
    # a normal's sign can only flip where it is near-perpendicular to the
    # viewpoint direction; everywhere else the normals agree
    dots = np.sum(gn.numpy() * wn, -1)[wv]
    assert np.mean(dots > 1 - 1e-4) > 0.99, np.mean(dots > 1 - 1e-4)


@pytest.mark.parametrize("return_knn", [False, True])
def test_fpfh_matches_jax(clouds, return_knn):
    p, m = clouds[0]
    want = jfpfh.fpfh(jnp.asarray(p), jnp.asarray(m), jnp.float32(0.9),
                      jnp.float32(1.5), viewpoint=jnp.asarray(VP),
                      return_knn=return_knn)
    got = fpfh.fpfh(_t(p), _t(m), 0.9, 1.5, viewpoint=_t(VP),
                    return_knn=return_knn)
    _check_desc(got[:2], want[:2], _bin_edge_rows(p, m, VP))
    if return_knn:
        assert got[2][1].shape == (p.shape[0], 48)
        np.testing.assert_array_equal(got[2][2].numpy(),
                                      np.asarray(want[2][2]))


def test_fpfh_batched_matches_jax_and_single(clouds):
    """Two clouds as lanes of one batched K1 search, each with its own
    viewpoint (as the loop closure passes them), against the JAX package
    and the single-cloud path; without viewpoints each lane takes its own
    centroid, as the single-cloud path does."""
    P = torch.stack([_t(p) for p, _ in clouds])
    M = torch.stack([_t(m) for _, m in clouds])
    vps = np.stack([VP, VP + np.float32(0.5)])
    desc, valid, knn = fpfh.fpfh_batched(P, M, 0.9, 1.5, viewpoint=_t(vps),
                                         return_knn=True)
    assert knn[1].shape == (2, P.shape[1], 48)
    centroid = fpfh.fpfh_batched(P, M, 0.9, 1.5)
    for lane, (p, m) in enumerate(clouds):
        want = jfpfh.fpfh(jnp.asarray(p), jnp.asarray(m), jnp.float32(0.9),
                          jnp.float32(1.5), viewpoint=jnp.asarray(vps[lane]))
        _check_desc((desc[lane], valid[lane]), want,
                    _bin_edge_rows(p, m, vps[lane]))
        for got, vp in (((desc[lane], valid[lane]), _t(vps[lane])),
                        ((centroid[0][lane], centroid[1][lane]), None)):
            one = fpfh.fpfh(_t(p), _t(m), 0.9, 1.5, viewpoint=vp)
            torch.testing.assert_close(got[0], one[0], atol=1e-4, rtol=0)
            assert torch.equal(got[1], one[1])


# ---------------------------------------------------------------------------
# mirrors of tests/test_quatro.py and tests/test_fpfh_stream.py, on the port
# ---------------------------------------------------------------------------

def _port_cloud(n_points, seed, noise):
    a = WORLD.sample_points(n_points, seed=seed, noise=noise)
    pa, ma = sim.pad_cloud(a, n_points)
    return voxel.voxel_downsample(_t(pa), _t(ma), 0.3, out_cap=n_points)


def test_fpfh_descriptor_invariance():
    """FPFH is (approximately) invariant under rigid transforms
    (tests/test_quatro.py:70-85)."""
    va, vma = _port_cloud(2048, 3, 0.0)
    T = se3.se3_exp(torch.tensor([0.0, 0.0, 0.8, 5.0, 2.0, 0.0]))
    vb = se3.transform_points(va, T)
    vp = torch.zeros(3)
    da, fa = fpfh.fpfh(va, vma, 0.9, 1.5, viewpoint=vp)
    db, fb = fpfh.fpfh(vb, vma, 0.9, 1.5,
                       viewpoint=se3.transform_points(vp[None], T)[0])
    both = fa & fb
    assert both.sum() > 100
    assert float(torch.abs(da - db)[both].mean()) < 1.0


def test_distinctive_filters_planes():
    """tests/test_quatro.py:88-98: the filter drops a substantial share
    (walls, floor) and keeps features."""
    va, vma = _port_cloud(2048, 4, 0.005)
    da, fa = fpfh.fpfh(va, vma, 0.9, 1.5, viewpoint=torch.tensor(VP))
    keep = fpfh.distinctive(da, fa)
    frac = float(keep.sum()) / max(float(fa.sum()), 1.0)
    assert 0.05 < frac < 0.9, frac


@pytest.mark.parametrize("name", ["recovers_drift", "then_gicp_fine"])
def test_loop_pair_registers(name):
    """tests/test_quatro.py's loop pairs through the port's kNN FPFH,
    Quatro and GICP (tools/loop_pairs.py): Quatro within 0.03 rad / 0.25 m
    of the truth; with the fine stage (GICP, brute covariances) within
    2 cm / 0.15 rad and fitness below 3.5."""
    from fast_lio_sam_qn_tpu_torch.tools import loop_pairs as lp

    drift, seed, _, fine = lp.PAIRS[name]
    src, dst, T_want = lp.loop_pair(drift, seed)
    errs = lp.errors(lp.register(src, dst, fine=fine is not None), T_want)
    assert lp.check(name, errs) == [], errs


def test_stream_agrees_with_knn_fpfh():
    """tests/test_fpfh_stream.py:80-99 on the port: where the kNN caps do
    not bind, the radius formulation's descriptors agree closely with the
    kNN ones (theta binned by half-plane tests there, atan2 here)."""
    rng = np.random.default_rng(3)
    n = 700
    pts = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    pts[: n // 2, 2] = np.abs(pts[: n // 2, 2]) * 0.05
    mask = np.ones(n, bool)
    mask[-10:] = False
    p, m = _t(pts), _t(mask)
    desc_r, val_r, _ = fpfh_stream.fpfh_radius(p, m, 0.9, 1.5)
    desc_k, val_k = fpfh.fpfh(p, m, 0.9, 1.5, k_feat=64, k_normal=48)
    both = (val_r & val_k).numpy()
    assert both.sum() > 200
    d2 = torch.cdist(p[m], p[m]) ** 2
    assert int((d2 <= 1.5 * 1.5).sum(1).max()) < 64   # the caps never bind
    l1 = np.abs(desc_r.numpy()[both] - desc_k.numpy()[both]).sum(1) / 300.0
    assert np.median(l1) < 0.02, np.median(l1)
    assert (l1 < 0.1).mean() > 0.95, (l1 < 0.1).mean()


# ---------------------------------------------------------------------------
# grid plane covariances
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,window", [(15, 5), (8, 3)])
def test_grid_plane_covariances_match_jax(clouds, k, window):
    """The same neighbours from both packages' grids; covariances within
    1e-5 except where the two smallest eigenvalues of the neighbourhood's
    covariance are within 1e-3 of the largest (the plane normal is
    ill-defined there and fp32 summation order picks it), at most 1 % of
    the valid rows."""
    from fast_lio_sam_qn_tpu.ops import hashgrid as jhashgrid
    from fast_lio_sam_qn_tpu_torch.ops import hashgrid

    p, m = clouds[1]
    t = gicp.grid_table_size(p.shape[0])
    assert t == 8192
    jgrid = jhashgrid.build(jnp.asarray(p), jnp.asarray(m), res=0.3,
                            table_size=t)
    wp, _, wn = map(np.asarray, jhashgrid.query_knn(
        jgrid, jnp.asarray(p), jnp.asarray(m), k=k, window=window))
    gp, _, gn = hashgrid.query_knn(hashgrid.build(_t(p), _t(m), 0.3, t),
                                   _t(p), _t(m), k=k, window=window)
    np.testing.assert_array_equal(gn.numpy(), wn)
    np.testing.assert_array_equal(gp.numpy()[wn], wp[wn])
    wc, wv = map(np.asarray, jgicp.plane_covariances(
        jnp.asarray(p), jnp.asarray(m), k=k, backend="grid", window=window))
    gc, gv = gicp.plane_covariances(_t(p), _t(m), k=k, backend="grid",
                                    window=window)
    np.testing.assert_array_equal(gv.numpy(), wv)
    assert 0.25 * m.sum() < wv.sum() <= m.sum()
    w = wn.astype(np.float64)
    cnt = np.maximum(w.sum(1), 1)
    d = (wp - (wp * w[..., None]).sum(1)[:, None] / cnt[:, None, None]
         ) * w[..., None]
    ev = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", d, d))
    loose = ev[:, 1] - ev[:, 0] < 1e-3 * ev[:, 2]
    beyond = np.abs(gc.numpy() - wc).reshape(-1, 9).max(1) > 1e-5
    assert not (beyond & ~loose).any(), np.nonzero(beyond & ~loose)[0]
    assert beyond.sum() <= 0.01 * wv.sum(), beyond.sum()


@pytest.mark.parametrize("backend", ["grid", "brute"])
def test_align_cov_backends_match_jax(clouds, backend):
    """``align`` computing its own covariances against the JAX package's
    on the same moved pair.  (The JAX package's ``align`` passes its
    ``voxel_res`` into the jitted grid search as a traced value, which its
    hash grid refuses; its grid covariances are given to it instead, made
    by its ``plane_covariances`` at the default resolution.)"""
    p, m = clouds[1]
    T = np.asarray(se3.se3_exp(torch.tensor(
        [0.0, 0.0, 0.05, 0.2, -0.1, 0.0])), np.float32)
    q = (p @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    covs = {}
    if backend == "grid":
        covs = {f"{tag}_cov": jgicp.plane_covariances(
            jnp.asarray(c), jnp.asarray(m), k=15, backend="grid")
            for tag, c in (("src", q), ("dst", p))}
    want = jgicp.align(jnp.asarray(q), jnp.asarray(m), jnp.asarray(p),
                       jnp.asarray(m), cov_backend=backend, **covs)
    got = gicp.align(_t(q), _t(m), _t(p), _t(m), cov_backend=backend)
    np.testing.assert_allclose(got.transform.numpy(),
                               np.asarray(want.transform), atol=1e-4)
    assert got.num_iters == int(want.num_iters)


# ---------------------------------------------------------------------------
# LoopClosure(fpfh_backend="knn")
# ---------------------------------------------------------------------------

def _knn_cfg(cls, optimized=True):
    cfg = cls()
    cfg.quatro = dataclasses.replace(cfg.quatro, fpfh_backend="knn",
                                     use_optimized_matching=optimized)
    return cfg


def _pose_gap(a, b):
    d = se3.se3_log(torch.linalg.inv(torch.as_tensor(np.asarray(a)).double())
                    @ torch.tensor(np.asarray(b)).double())
    return float(d[3:].norm()), float(d[:3].norm())


@pytest.mark.parametrize("optimized", [True, False])
def test_knn_attempt_matches_jax(optimized):
    from test_torch_loop_closure import CAP, N_RAYS, _gate_err, _pair, \
        _stores

    frames, drift = _pair()
    js, ts = _stores(frames, N_RAYS, capacity=2)
    wreg, wmeas = jlc.LoopClosure(_knn_cfg(LoopClosureConfig, optimized),
                                  CAP, CAP).fetch_and_perform(js, 1)
    greg, gmeas = loop_closure.LoopClosure(
        _knn_cfg(tconfig.LoopClosureConfig, optimized), CAP,
        CAP).fetch_and_perform(ts, 1)
    t_err, r_err = _gate_err(greg.pose_between, drift)
    assert t_err < 0.06 and r_err < 0.01, (t_err, r_err)
    for f in ("is_valid", "is_converged", "closest_idx"):
        assert int(getattr(greg, f)) == int(getattr(wreg, f)), f
    for g, w in ((greg.pose_between, wreg.pose_between), (gmeas, wmeas)):
        t_gap, r_gap = _pose_gap(g, w)
        assert t_gap < 1e-3 and r_gap < 1e-3, (t_gap, r_gap)


def test_knn_batch_matches_jax_and_single_lanes():
    """tests/test_torch_loop_batch.py's three-keyframe store, B = 3 lanes,
    one without a candidate."""
    from fast_lio_sam_qn_tpu.models import keyframes as jkf
    from fast_lio_sam_qn_tpu_torch import convert
    from fast_lio_sam_qn_tpu_torch.models import keyframes as kf
    from test_torch_loop_batch import CAP, N_RAYS, _frames

    js, ts = jkf.empty_store(4, N_RAYS), kf.empty_store(4, N_RAYS, "cpu")
    for p, m, T, Tc, t, _ in _frames():
        js = jkf.append(js, jnp.asarray(p), jnp.asarray(m), jnp.asarray(T),
                        jnp.asarray(Tc), jnp.float32(t))
        ts = kf.append(ts, *convert.tensors_from_numpy(p, m, T, Tc,
                                                       device="cpu"), t)
    qidx, cidx = [1, 2, 0], [0, 0, -1]
    want = jlc.LoopClosure(_knn_cfg(LoopClosureConfig), CAP,
                           CAP).perform_loop_closure_batch(
        js, jnp.asarray(qidx, jnp.int32), jnp.asarray(cidx, jnp.int32))
    lc = loop_closure.LoopClosure(_knn_cfg(tconfig.LoopClosureConfig), CAP,
                                  CAP)
    got = lc.perform_loop_closure_batch(ts, qidx, cidx)
    for f in ("is_valid", "is_converged", "closest_idx"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert got.is_valid.numpy().tolist()[:2] == [True, True]
    for b, (q, c) in enumerate(zip(qidx, cidx)):
        if c < 0:
            continue
        t_gap, r_gap = _pose_gap(got.pose_between[b], want.pose_between[b])
        assert t_gap < 1e-3 and r_gap < 1e-3, (b, t_gap, r_gap)
        one = lc.perform_loop_closure(ts, q, c)
        assert bool(one.is_valid) == bool(got.is_valid[b])
        t_gap, r_gap = _pose_gap(one.pose_between, got.pose_between[b])
        assert t_gap < 1e-3 and r_gap < 1e-3, (b, t_gap, r_gap)
