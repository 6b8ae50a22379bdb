"""Kernels K3-K5's plain versions (ops/fpfh_stream.py *_plain, reached
through the kernel wrappers on CPU tensors) held against the JAX package's
streaming radius-FPFH: the XLA path and the Pallas kernels in interpret
mode, on the same numpy inputs.

Tolerances (the reference's own, tests/test_fpfh_stream.py): moments atol
1e-3; SPFH atol 1e-3; aggregation rtol 1e-4 / atol 1e-2.  Each stage gets
identical inputs, so differences are fp rounding only.  SPFH holds counts:
a row beyond atol is accepted only if its difference is whole pairs at a
boundary (fast_lio_sam_qn_tpu_torch/parity.py): equal neighbour count and
an L1 difference of at most 2 per pair within 1e-4 of a bin edge in
float64, or a pair within 1e-4 r^2 of the radius."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu.ops import fpfh_stream as jfs
from fast_lio_sam_qn_tpu_torch import parity
from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream as fs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(3)
    # box-structured cloud: surfaces + corners at ~0.3 m voxel spacing
    n = 700
    pts = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    pts[: n // 2, 2] = np.abs(pts[: n // 2, 2]) * 0.05  # half on a floor
    mask = np.ones(n, bool)
    mask[-10:] = False
    return pts, mask


@pytest.fixture(scope="module")
def jax_stages(cloud):
    p, m = map(jnp.asarray, cloud)
    mom = jfs._moments_xla(p, m, 0.9, 0.6)
    nrm, nv, cov, mean = jfs.moments_to_normals_covs(mom, p, m, None)
    raw = jfs._spfh_xla(p, m, nrm, nv, 1.5)
    spfh = raw[:, :33] / jnp.maximum(raw[:, 33:], 1.0)
    agg = jfs._fpfh_agg_xla(p, m, nv, spfh, 1.5)
    return {k: np.asarray(v) for k, v in dict(
        mom=mom, nrm=nrm, nv=nv, cov=cov, mean=mean, raw=raw, spfh=spfh,
        agg=agg).items()}


def _t(a):
    return torch.from_numpy(np.array(a))


def test_moments_match_jax(cloud, jax_stages):
    p, m = cloud
    got = fs.moments(_t(p), _t(m), 0.9, 0.6).numpy()
    np.testing.assert_allclose(got, jax_stages["mom"], atol=1e-3)
    kern = np.asarray(jfs._moments_tpu(jnp.asarray(p), jnp.asarray(m), 0.9,
                                       0.6, interpret=True))
    np.testing.assert_allclose(got, kern, atol=1e-3)


def test_normals_and_covariances_match_jax(cloud, jax_stages):
    p, m = cloud
    nrm, nv, cov, mean = fs.moments_to_normals_covs(
        _t(jax_stages["mom"]), _t(p), _t(m), None)
    np.testing.assert_array_equal(nv.numpy(), jax_stages["nv"])
    np.testing.assert_allclose(nrm.numpy(), jax_stages["nrm"], atol=1e-4)
    np.testing.assert_allclose(cov.numpy(), jax_stages["cov"], atol=1e-4)
    np.testing.assert_allclose(mean.numpy(), jax_stages["mean"], atol=1e-5)


def test_spfh_matches_jax(cloud, jax_stages):
    p, m = cloud
    nrm, nv = jax_stages["nrm"], jax_stages["nv"]
    got = fs.spfh(_t(p), _t(m), _t(nrm), _t(nv), 1.5)
    kern = np.asarray(jfs._spfh_tpu(
        jnp.asarray(p), jnp.asarray(m), jnp.asarray(nrm), jnp.asarray(nv),
        1.5, interpret=True))
    for want in (jax_stages["raw"], kern):
        want = _t(want)
        rows = parity.rows_beyond(got, want, 1e-3, 0.0)
        assert len(rows) <= 3, rows
        if len(rows):
            ok = parity.spfh_rows_explained(got, want, _t(p), _t(nrm),
                                            _t(m & nv), rows, 1.5)
            assert bool(ok.all()), rows[~ok]


def test_aggregation_matches_jax(cloud, jax_stages):
    p, m = cloud
    nv, spfh = jax_stages["nv"], jax_stages["spfh"]
    got = fs.fpfh_agg(_t(p), _t(m), _t(nv), _t(spfh), 1.5).numpy()
    np.testing.assert_allclose(got, jax_stages["agg"], rtol=1e-4, atol=1e-2)
    kern = np.asarray(jfs._fpfh_agg_tpu(
        jnp.asarray(p), jnp.asarray(m), jnp.asarray(nv), jnp.asarray(spfh),
        1.5, interpret=True))
    np.testing.assert_allclose(got, kern, rtol=1e-4, atol=1e-2)


def test_fpfh_radius_matches_jax(cloud):
    """The whole driver: same valid set; descriptors (blocks normalized to
    100) to 1e-2, the aggregation tolerance carried through.  Normals and
    covariances to 5e-3: here the moments differ in summation order (given
    equal moments they agree to 1e-4, test above), and the smallest
    eigenvector of a neighbourhood whose two smallest eigenvalues nearly
    tie amplifies that."""
    p, m = cloud
    vp = np.array([0.0, 0.0, 2.0], np.float32)
    wd, wv, (wn, wnv, wc) = jfs.fpfh_radius(
        jnp.asarray(p), jnp.asarray(m), 0.9, 1.5, viewpoint=jnp.asarray(vp),
        use_tpu=False)
    gd, gv, (gn, gnv, gc) = fs.fpfh_radius(_t(p), _t(m), 0.9, 1.5,
                                           viewpoint=_t(vp))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gnv.numpy(), np.asarray(wnv))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=1e-2)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), atol=5e-3)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=5e-3)
    assert not gd.numpy()[~gv.numpy()].any()


def test_plane_covariance_geometry():
    """Points on a tilted plane: the smallest axis of the regularized
    covariance is the plane normal, with the (eps, 1, 1) spectrum."""
    rng = np.random.default_rng(0)
    u = np.array([1.0, 0.0, 0.5]) / np.linalg.norm([1.0, 0.0, 0.5])
    v = np.array([0.0, 1.0, 0.0])
    nrm = np.cross(u, v)
    ab = rng.uniform(-1, 1, (256, 2))
    pts = (ab[:, :1] * u + ab[:, 1:2] * v).astype(np.float32)
    p, m = _t(pts), torch.ones(256, dtype=torch.bool)
    mom = fs.moments(p, m, 0.9, 0.6)
    normals, n_valid, cov, _ = fs.moments_to_normals_covs(
        mom, p, m, _t((10.0 * nrm).astype(np.float32)))
    assert bool(n_valid.all())
    assert np.all(np.abs(normals.numpy() @ nrm) > 0.99)
    vals, vecs = np.linalg.eigh(cov[0].numpy())
    np.testing.assert_allclose(vals, [fs.PLANE_EPS, 1.0, 1.0], atol=1e-4)
    assert abs(vecs[:, 0] @ nrm) > 0.99
