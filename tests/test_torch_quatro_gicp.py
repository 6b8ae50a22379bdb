"""Quatro and Nano-GICP stages of the port held against the JAX package,
each stage given identical numpy inputs.

Tolerances: clique mask exact; yaw 1e-5 rad; translations and scale 1e-5;
GICP transform 1e-4 (a few Gauss-Newton steps of fp32 normal equations)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu.ops import gicp as jgicp
from fast_lio_sam_qn_tpu.ops import knn as jknn
from fast_lio_sam_qn_tpu.ops import quatro as jquatro
from fast_lio_sam_qn_tpu.ops import se3 as jse3
from fast_lio_sam_qn_tpu_torch.ops import gicp, quatro

torch.set_num_threads(1)

NB = 0.3


def _t(a):
    return torch.from_numpy(np.array(a))


def _yaw_pose(yaw, t):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = t
    return T


def _correspondences(c, n_inl, seed, scale=1.0):
    """c correspondences, the first n_inl consistent with a yaw+translation
    (plus noise), the rest random; shuffled; the last 10% invalid."""
    rng = np.random.default_rng(seed)
    T = _yaw_pose(0.4, [1.0, -2.0, 0.3])
    s = rng.uniform(-15, 15, (c, 3)).astype(np.float32)
    d = rng.uniform(-15, 15, (c, 3)).astype(np.float32)
    d[:n_inl] = (scale * s[:n_inl] @ T[:3, :3].T + T[:3, 3]
                 + rng.normal(0, 0.02, (n_inl, 3)))
    perm = rng.permutation(c)
    valid = np.arange(c) < int(0.9 * c)
    return s[perm], d[perm].astype(np.float32), valid[perm]


@pytest.mark.parametrize("c", [200, 400])
def test_max_clique_inliers_exact(c):
    """c <= greedy_cap (full greedy pass) and c > greedy_cap (top-256)."""
    s, d, v = _correspondences(c, 40, seed=c)
    want = np.asarray(jquatro.max_clique_inliers(
        jnp.asarray(s), jnp.asarray(d), jnp.asarray(v), jnp.float32(NB)))
    got = quatro.max_clique_inliers(_t(s), _t(d), _t(v), NB).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() >= 30


@pytest.fixture(scope="module")
def clique():
    s, d, v = _correspondences(200, 40, seed=5)
    inl = np.asarray(jquatro.max_clique_inliers(
        jnp.asarray(s), jnp.asarray(d), jnp.asarray(v), jnp.float32(NB)))
    return s, d, v, inl


def test_gnc_yaw_and_voting_match_jax(clique):
    s, d, _, inl = clique
    j = [jnp.asarray(a) for a in (s, d, inl)]
    wy, ww, wc = jquatro.gnc_rotation_yaw(
        *j, jnp.float32(NB), jnp.float32(1.4), jnp.float32(1e-4))
    gy, gw, gc = quatro.gnc_rotation_yaw(_t(s), _t(d), _t(inl), NB, 1.4, 1e-4)
    assert abs(float(gy) - float(wy)) < 1e-5
    assert bool(gc) == bool(wc)
    np.testing.assert_allclose(gw.numpy(), np.asarray(ww), atol=1e-5)
    wt, wv = jquatro.translation_voting(*j, wy, jnp.float32(NB))
    gt, gv = quatro.translation_voting(_t(s), _t(d), _t(inl), gy, NB)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=1e-5)
    assert int(gv) == int(wv)
    wy2, wt2 = jquatro.refine_yaw_translation(*j, wy, wt, jnp.float32(NB))
    gy2, gt2 = quatro.refine_yaw_translation(_t(s), _t(d), _t(inl), gy, gt,
                                             NB)
    assert abs(float(gy2) - float(wy2)) < 1e-5
    np.testing.assert_allclose(gt2.numpy(), np.asarray(wt2), atol=1e-5)
    assert abs(float(gy2) - 0.4) < 0.01


def test_scale_estimate_matches_jax():
    """Scale voting over all valid matches (TEASER order: before the
    clique), as quatro.align runs it with estimate_scale."""
    s, d, inl = _correspondences(200, 60, seed=6, scale=1.3)
    ws, wn = jquatro.estimate_scale_tims(jnp.asarray(s), jnp.asarray(d),
                                         jnp.asarray(inl), jnp.float32(NB))
    gs, gn = quatro.estimate_scale_tims(_t(s), _t(d), _t(inl), NB)
    assert abs(float(gs) - float(ws)) < 1e-5
    assert int(gn) == int(wn)


@pytest.mark.parametrize("optimized", [True, False])
def test_matching_and_align_match_jax(optimized):
    """Descriptor matching through K1's plain version, then the whole
    Quatro pipeline, both modes, identical descriptors."""
    rng = np.random.default_rng(9)
    n = 300
    src = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    T = _yaw_pose(0.3, [0.5, 1.0, 0.0])
    dst = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    desc = rng.dirichlet(np.ones(33), n).astype(np.float32) * 300
    desc_d = (desc + rng.normal(0, 0.5, desc.shape)).astype(np.float32)
    vs, vd = rng.random(n) > 0.1, rng.random(n) > 0.1
    max_corres = 200 if optimized else n
    ws, wd, wv = jquatro.match_features(
        *map(jnp.asarray, (src, desc, vs, dst, desc_d, vd)),
        jnp.float32(35.0), max_corres=max_corres,
        optimized_matching=optimized)
    gs, gd, gv = quatro.match_features(
        *map(_t, (src, desc, vs, dst, desc_d, vd)), 35.0,
        max_corres=max_corres, optimized_matching=optimized)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    # the same correspondences; their rank order may swap where two
    # descriptor distances tie to fp32 rounding, so compare as sets
    m = np.asarray(wv)

    def rows(a, b):
        pairs = np.concatenate([np.asarray(a)[m], np.asarray(b)[m]], 1)
        return pairs[np.lexsort(pairs.T[::-1])]

    np.testing.assert_array_equal(rows(gs, gd), rows(ws, wd))
    kw = dict(noise_bound=0.3, gnc_factor=1.4, cost_diff_thr=1e-4,
              distance_threshold=35.0, max_corres=max_corres,
              optimized_matching=optimized)
    want = jquatro.align(*map(jnp.asarray, (src, desc, vs, dst, desc_d, vd)),
                         **{k: jnp.float32(v) if isinstance(v, float) else v
                            for k, v in kw.items()})
    got = quatro.align(*map(_t, (src, desc, vs, dst, desc_d, vd)), **kw)
    np.testing.assert_allclose(got.transform.numpy(),
                               np.asarray(want.transform), atol=1e-5)
    assert bool(got.converged) == bool(want.converged)
    assert int(got.num_inliers) == int(want.num_inliers)
    assert int(got.num_corres) == int(want.num_corres)


@pytest.fixture(scope="module")
def gicp_inputs():
    rng = np.random.default_rng(11)
    # three planes (a corner) plus scattered points: well constrained
    n = 900
    a = rng.uniform(-4, 4, (n, 2))
    pts = np.zeros((n, 3))
    pts[:300, :2] = a[:300]
    pts[300:600, [0, 2]] = a[300:600]
    pts[600:, 1:] = a[600:]
    pts = (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    mask = rng.random(n) > 0.05
    T = np.asarray(jse3.se3_exp(jnp.asarray(
        [0.02, -0.01, 0.05, 0.1, -0.05, 0.08], jnp.float32)))
    src = ((pts - T[:3, 3]) @ T[:3, :3]).astype(np.float32)  # T^-1 pts
    return src, mask, pts, mask.copy()


def test_plane_covariances_match_jax(gicp_inputs):
    src, sm, _, _ = gicp_inputs
    wc, wv = jgicp.plane_covariances(jnp.asarray(src), jnp.asarray(sm),
                                     k=15, backend="brute")
    gc, gv = gicp.plane_covariances(_t(src), _t(sm), k=15)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-4)


def test_gicp_align_matches_jax(gicp_inputs):
    src, sm, dst, dm = gicp_inputs
    scov = jgicp.plane_covariances(jnp.asarray(src), jnp.asarray(sm), k=15,
                                   backend="brute")
    dcov = jgicp.plane_covariances(jnp.asarray(dst), jnp.asarray(dm), k=15,
                                   backend="brute")
    want = jgicp.align(jnp.asarray(src), jnp.asarray(sm), jnp.asarray(dst),
                       jnp.asarray(dm), src_cov=scov, dst_cov=dcov,
                       banded=False)
    # the port Morton-sorts and searches through K2's plain version; the
    # reference on the CPU takes its unpruned path: the same NN results
    got = gicp.align(_t(src), _t(sm), _t(dst), _t(dm),
                     src_cov=tuple(map(_t, scov)),
                     dst_cov=tuple(map(_t, dcov)))
    np.testing.assert_allclose(got.transform.numpy(),
                               np.asarray(want.transform), atol=1e-4)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness),
                               rtol=1e-3, atol=1e-6)
    assert got.num_iters == int(want.num_iters)
    assert int(got.num_corr) == int(want.num_corr)
    assert bool(got.converged) == bool(want.converged)
    assert bool(got.degenerate) == bool(want.degenerate)
    # and it recovers the true offset
    T = np.asarray(jse3.se3_exp(jnp.asarray(
        [0.02, -0.01, 0.05, 0.1, -0.05, 0.08], jnp.float32)))
    np.testing.assert_allclose(got.transform.numpy(), T, atol=5e-3)


def test_fitness_ignores_masked_points():
    rng = np.random.default_rng(2)
    p = _t(rng.normal(size=(50, 3)).astype(np.float32))
    m = torch.arange(50) < 40
    fit = gicp.fitness_score(p, m, p, m, torch.eye(4))
    want = jgicp.fitness_score(jnp.asarray(p.numpy()), jnp.asarray(m.numpy()),
                               jnp.asarray(p.numpy()),
                               jnp.asarray(m.numpy()), jnp.eye(4))
    assert float(want) == 0.0
    assert abs(float(fit)) < 1e-6  # self-distance expansion residue
    d2 = jknn.brute_nn(jnp.asarray(p.numpy()), jnp.asarray(m.numpy()),
                       jnp.asarray(p.numpy()), jnp.asarray(m.numpy()))[0]
    assert bool(jnp.all(jnp.isinf(d2[40:])))
