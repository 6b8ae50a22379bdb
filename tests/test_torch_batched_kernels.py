"""The batched kernels' plain versions (K1, K2 and K3-K5 over a leading
batch axis, reached through the ``*_batched`` wrappers on CPU tensors) held
against the JAX package's grid-batched lowerings: ``jax.vmap`` of the
Pallas kernels in interpret mode, as tests/test_pallas_knn.py and
tests/test_fpfh_stream.py drive them.  Every lane must also equal the
port's single plain version exactly, and one lane is fully masked.

Tolerances are those of the single-cloud tests (tests/test_torch_knn.py,
tests/test_torch_fpfh_stream.py): kNN validity exact, d2 within 2e-3
relative (the Pallas kernels' packed-key quantization) plus 2^-20
(|q|^2 + |v|^2) (the expansion's fp32 rounding), indices equal up to ties
of that size; moments atol 1e-3; SPFH atol 1e-3 except whole pairs at a
radius or bin-edge boundary; aggregation rtol 1e-4 / atol 1e-2."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu.ops import fpfh_stream as jfs
from fast_lio_sam_qn_tpu.ops import pallas_knn
from fast_lio_sam_qn_tpu_torch import parity
from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream as fs
from fast_lio_sam_qn_tpu_torch.ops import knn_cuda

torch.set_num_threads(1)

B = 3


def _lanes(m, n, f, seed):
    """B lanes of clustered clouds; the last lane's queries are all
    masked."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, f)).astype(np.float32) * 20
    q = (centers[rng.integers(0, 8, (B, m))]
         + rng.normal(size=(B, m, f)) * 2).astype(np.float32)
    db = (centers[rng.integers(0, 8, (B, n))]
          + rng.normal(size=(B, n, f)) * 2).astype(np.float32)
    qm = rng.random((B, m)) > 0.3
    qm[-1] = False
    return q, qm, db, rng.random((B, n)) > 0.3


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _check_knn(got, want_d, want_i, q, db):
    d_t, i_t, v_t = (a.numpy() for a in got)
    np.testing.assert_array_equal(v_t, np.isfinite(want_d))
    d_t, d_p = np.where(v_t, d_t, 0.0), np.where(v_t, want_d, 0.0)
    big = np.sum(q * q, -1)[..., None] + np.take_along_axis(
        np.sum(db * db, -1), np.clip(i_t, 0, None).reshape(B, -1),
        axis=1).reshape(i_t.shape)
    tol = 2e-3 * d_t + 2.0 ** -20 * big
    assert np.all(np.abs(d_t - d_p) <= tol)
    alt = np.take_along_axis(
        db, np.clip(want_i, 0, None).reshape(B, -1, 1), axis=1
    ).reshape(want_i.shape + (db.shape[-1],))
    d_true = np.sum((alt - q[:, :, None, :]) ** 2, -1)
    mism = (want_i != i_t) & v_t
    assert np.all(np.abs(d_true - d_t)[mism] <= tol[mism])


def _lane_equal(batched, single_fn):
    for i in range(B):
        one = single_fn(i)
        one = (one,) if isinstance(one, torch.Tensor) else one
        batched_i = (batched,) if isinstance(batched, torch.Tensor) \
            else batched
        for b, o in zip(batched_i, one):
            assert torch.equal(b[i], o), i


@pytest.mark.parametrize("m,n,f,k", [(200, 500, 3, 15), (300, 400, 33, 1)])
def test_knn_batched_matches_vmapped_pallas(m, n, f, k):
    q, qm, db, dm = _lanes(m, n, f, seed=m + k)
    call = functools.partial(pallas_knn._knn_pallas_tpu, k=k, interpret=True)
    wd, wi, _ = map(np.asarray, jax.vmap(call)(*map(jnp.asarray,
                                                     (q, qm, db, dm))))
    args = _t(q, qm, db, dm)
    got = knn_cuda.knn_batched(*args, k)
    _check_knn(got, wd, wi, q, db)
    _lane_equal(got, lambda i: knn_cuda.knn(*(a[i] for a in args), k))
    assert not bool(got[2][-1].any())


@pytest.mark.parametrize("k", [1, 4])
def test_knn_banded_batched_matches_grid_batched_pallas(k):
    """On Morton-sorted lanes, as the reference's vmapped GICP calls it;
    the vmap goes through the custom_vmap rule to the grid-batched
    lowering (pallas_knn.py:469)."""
    q, qm, db, dm = _lanes(300, 700, 3, seed=7 + k)
    q, qm, db, dm = map(jnp.asarray, (q, qm, db, dm))
    qo = jax.vmap(pallas_knn.morton_order)(q, qm)
    do = jax.vmap(pallas_knn.morton_order)(db, dm)
    take = jax.vmap(lambda a, o: a[o])
    q, qm, db, dm = take(q, qo), take(qm, qo), take(db, do), take(dm, do)
    call = functools.partial(pallas_knn._knn_banded_tpu, k=k, interpret=True)
    wd, wi, _ = map(np.asarray, jax.vmap(call)(q, qm, db, dm))
    q, qm, db, dm = map(np.asarray, (q, qm, db, dm))
    args = _t(q, qm, db, dm)
    got = knn_cuda.knn_banded_batched(*args, k)
    _check_knn(got, wd, wi, q, db)
    _lane_equal(got, lambda i: knn_cuda.knn_banded(*(a[i] for a in args),
                                                   k))
    # the prune is exact: each lane equals batched brute force
    for g, w in zip(got, knn_cuda.knn_batched(*args, k)):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def clouds():
    """B jittered, differently masked copies of a box-structured cloud
    (tests/test_torch_fpfh_stream.py's), the last lane fully masked, with
    the JAX package's normals for the SPFH stages."""
    rng = np.random.default_rng(3)
    n = 400
    p0 = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    p0[: n // 2, 2] = np.abs(p0[: n // 2, 2]) * 0.05
    pts = np.stack([p0 + rng.normal(0, 0.05, p0.shape).astype(np.float32)
                    for _ in range(B)])
    msk = np.stack([rng.random(n) > 0.1 * i for i in range(B)])
    msk[-1] = False
    mom = jax.vmap(lambda p, m: jfs._moments_xla(p, m, 0.9, 0.6))(
        jnp.asarray(pts), jnp.asarray(msk))
    nrm, nv, _, _ = jax.vmap(
        lambda mo, p, m: jfs.moments_to_normals_covs(mo, p, m, None))(
            mom, jnp.asarray(pts), jnp.asarray(msk))
    return pts, msk, np.asarray(nrm), np.asarray(nv)


def test_moments_batched_matches_grid_batched_pallas(clouds):
    pts, msk, _, _ = clouds
    want = np.asarray(jax.vmap(functools.partial(
        jfs._moments_tpu, radius=0.9, cov_radius=0.6, interpret=True))(
            jnp.asarray(pts), jnp.asarray(msk)))
    p, m = _t(pts, msk)
    got = fs.moments_batched(p, m, 0.9, 0.6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    _lane_equal(got, lambda i: fs.moments(p[i], m[i], 0.9, 0.6))
    assert not got[-1].any()


def test_spfh_batched_matches_grid_batched_pallas(clouds):
    pts, msk, nrm, nv = clouds
    want = np.asarray(jax.vmap(functools.partial(
        jfs._spfh_tpu, radius=1.5, interpret=True))(
            *map(jnp.asarray, (pts, msk, nrm, nv))))
    p, m, n_, v_ = _t(pts, msk, nrm, nv)
    got = fs.spfh_batched(p, m, n_, v_, 1.5)
    for i in range(B):
        w = torch.from_numpy(want[i].copy())
        rows = parity.rows_beyond(got[i], w, 1e-3, 0.0)
        assert len(rows) <= 0.02 * len(w), rows
        if len(rows):
            ok = parity.spfh_rows_explained(got[i], w, p[i], n_[i],
                                            m[i] & v_[i], rows, 1.5)
            assert bool(ok.all()), rows[~ok]
    _lane_equal(got, lambda i: fs.spfh(p[i], m[i], n_[i], v_[i], 1.5))


def test_fpfh_agg_batched_matches_grid_batched_pallas(clouds):
    pts, msk, _, nv = clouds
    raw = jax.vmap(functools.partial(jfs._spfh_xla, radius=1.5))(
        *map(jnp.asarray, clouds))
    spfh = np.asarray(raw[..., :33] / jnp.maximum(raw[..., 33:], 1.0))
    want = np.asarray(jax.vmap(functools.partial(
        jfs._fpfh_agg_tpu, radius=1.5, interpret=True))(
            *map(jnp.asarray, (pts, msk, nv, spfh))))
    p, m, v_, s_ = _t(pts, msk, nv, spfh)
    got = fs.fpfh_agg_batched(p, m, v_, s_, 1.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-2)
    _lane_equal(got, lambda i: fs.fpfh_agg(p[i], m[i], v_[i], s_[i], 1.5))


def test_fpfh_radius_batched_lanes(clouds):
    """``fpfh_radius_batched`` (one launch per stage for all lanes) against
    ``fpfh_radius`` on each lane: the same valid sets; descriptors, normals
    and covariances equal up to fp rounding (the flattened Jacobi sweeps
    and the stage reductions take other vector paths on the CPU)."""
    pts, msk, _, _ = clouds
    p, m = _t(pts, msk)
    vp = torch.tensor([[0.0, 0.0, 2.0]] * B)
    desc, val, (nrm, nv, cov) = fs.fpfh_radius_batched(p, m, 0.9, 1.5, vp)
    for i in range(B):
        d1, v1, (n1, nv1, c1) = fs.fpfh_radius(p[i], m[i], 0.9, 1.5,
                                               viewpoint=vp[i])
        assert torch.equal(val[i], v1) and torch.equal(nv[i], nv1)
        torch.testing.assert_close(desc[i], d1, atol=1e-4, rtol=0)
        torch.testing.assert_close(nrm[i], n1, atol=1e-5, rtol=0)
        torch.testing.assert_close(cov[i], c1, atol=1e-5, rtol=0)
    assert not val[-1].any()


def test_batched_wrappers_validate_shapes():
    """A batched wrapper on the CPU takes the plain version and launches
    nothing; the kernel path refuses a batch beyond the grid's y axis."""
    from fast_lio_sam_qn_tpu_torch import kernels

    before = (knn_cuda.knn_batched.launches,
              knn_cuda.knn_banded_batched.launches,
              fs.moments_batched.launches)
    p = torch.rand(2, 50, 3)
    m = torch.ones(2, 50, dtype=torch.bool)
    knn_cuda.knn_batched(p, m, p, m, 2)
    knn_cuda.knn_banded_batched(p, m, p, m, 2)
    fs.moments_batched(p, m, 0.9, 0.6)
    assert before == (knn_cuda.knn_batched.launches,
                      knn_cuda.knn_banded_batched.launches,
                      fs.moments_batched.launches)
    with pytest.raises(ValueError, match="batch"):
        kernels.require_batch(kernels.MAX_BATCH + 1)
