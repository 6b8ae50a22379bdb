"""The radius prune of kernels K3, K4 and K5 and the K4 / K5 step of the
Morton-sorted route (ops/fpfh_stream.py ``radius_tile_keep``,
``spfh_agg``, ``sorted_route``), on the CPU.

- ``radius_tile_keep`` (the model of csrc/tile_prune.cuh's keep rule) keeps
  every (query block, db tile) pair that holds a pair whose fp32 d2 passes
  the radius test: d2 by the plain version's expansion, by an emulation of
  the kernels' fmaf chain, and exact in float64; on the 700-point cloud of
  tests/test_torch_fpfh_stream.py, on the same cloud 500 m out, with
  duplicate points (d2 = 0) and with holed masks; at K4 / K5's 1.5 m over
  mask & n_valid and at K3's 0.9 m (the larger of its radii) over mask.
- The kernels' contract on that rule: the histogram and the aggregation
  over the pairs of kept (block, tile) pairs equal the unpruned ones on
  every valid query row, exactly; masked query rows are zero.
- The sorted route with the plain versions (sort, plain K4 / K5, unsort)
  agrees with the JAX package on valid rows: with ``_spfh_tpu`` /
  ``_fpfh_agg_tpu`` in interpret mode on the reference's Morton-sorted
  cloud (its own bbox prune), and with ``_spfh_xla`` / ``_fpfh_agg_xla``
  unsorted.  Tolerances are tests/test_torch_fpfh_stream.py's: SPFH atol
  1e-3 except whole pairs at a radius or bin-edge boundary, aggregation
  rtol 1e-4 / atol 1e-2 except rows with a pair on the radius
  (fast_lio_sam_qn_tpu_torch/parity.py).
- The batched Morton order equals ``morton_order`` lane by lane and the
  JAX package's ``pallas_knn.morton_order``.
"""
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

R = 1.5
CASES = ("base", "far", "duplicates", "holed")


def _base_cloud():
    """tests/test_torch_fpfh_stream.py's cloud: 700 points, half on a
    floor, the last 10 masked."""
    rng = np.random.default_rng(3)
    n = 700
    pts = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    pts[: n // 2, 2] = np.abs(pts[: n // 2, 2]) * 0.05
    mask = np.ones(n, bool)
    mask[-10:] = False
    return pts, mask


def _case(name):
    """(points, mask, normals, n_valid) numpy arrays of one edge case; unit
    normals and n_valid (90 % of the mask) drawn from a seed."""
    pts, mask = _base_cloud()
    rng = np.random.default_rng(11)
    if name == "far":
        pts = pts + np.array([500.0, -300.0, 40.0], np.float32)
    elif name == "duplicates":
        pts[60:120] = pts[0:60]
    elif name == "holed":
        mask &= rng.random(len(pts)) > 0.3
    nrm = rng.normal(size=pts.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    n_valid = mask & (rng.random(len(pts)) > 0.1)
    return pts, mask, nrm, n_valid


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _sorted(points, *rest):
    order = knn_cuda.morton_order(points, rest[0])
    return order, (points[order],) + tuple(x[order] for x in rest)


def _kernel_d2(q, v, qq, vv):
    """d2 as the kernels round it: cross = fma(qz, vz, fma(qy, vy, qx vx))
    (each fma emulated in float64, then rounded), then (qq - 2 cross) + vv
    with every step rounded to fp32."""
    q64 = q.astype(np.float64)[:, None, :]
    v64 = v.astype(np.float64)[None, :, :]
    c = (q64[..., 0] * v64[..., 0]).astype(np.float32)
    c = (q64[..., 1] * v64[..., 1] + c).astype(np.float32)
    c = (q64[..., 2] * v64[..., 2] + c).astype(np.float32)
    a = (qq[:, None] - np.float32(2.0) * c).astype(np.float32)
    return (a + vv[None, :]).astype(np.float32)


@pytest.mark.parametrize("kernel", ["K4K5", "K3"])
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("name", CASES)
def test_radius_tile_keep_keeps_every_pair(name, sort, kernel):
    """K4 / K5: 1.5 m over mask & n_valid; K3: 0.9 m over mask."""
    pts, mask, _, n_valid = _case(name)
    p, m, v = _t(pts, mask, n_valid)
    if sort:
        _, (p, m, v) = _sorted(p, m, v)
    radius, keep = (R, m & v) if kernel == "K4K5" else (0.9, m)
    kept = fs.radius_tile_keep(p, m, keep, radius)
    r2 = np.float32(radius * radius)
    qq = fs.sq_norms(p)
    d2_plain = fs._block_d2(p, p, fs._db_norms(p, keep)).numpy()
    pn = p.numpy()
    d2_kern = _kernel_d2(pn, pn, qq.numpy(), qq.numpy())
    d2_true = torch.cdist(p.double(), p.double()).numpy() ** 2
    pairs = ((d2_plain <= r2) | (d2_kern <= r2) | (d2_true <= r2)) \
        & m.numpy()[:, None] & keep.numpy()[None, :]
    qi, vi = np.nonzero(pairs)
    assert len(qi) > 1000
    assert kept.numpy()[qi // fs.FP_BLOCK, vi // fs.FP_TILE].all()
    if sort and name == "base":
        # the rule prunes even this sparse cloud's sorted blocks
        assert float(kept.float().mean()) < 1.0


def _pair_model(points, mask, normals, n_valid, pair_ok):
    """The kernels' arithmetic over all (query, point) pairs allowed by
    ``pair_ok`` ((N, N) bool), rows of masked queries zero: (raw SPFH
    (N, 34), aggregation (N, 34)) with the aggregation over the raw's
    normalized rows."""
    keep = mask & n_valid
    n = len(points)
    d2 = fs._block_d2(points, points, fs._db_norms(points, keep))
    w = (d2 <= R * R) & fs._not_self(0, n, torch.arange(n)) & pair_ok \
        & mask[:, None]
    ang = fs._angles((points[:, 0:1], points[:, 1:2], points[:, 2:3]),
                     (normals[:, 0:1], normals[:, 1:2], normals[:, 2:3]),
                     points.T, normals.T, d2)
    raw = fs._hist33(*ang, w)
    spfh_n = fs._normalized_spfh(raw)
    wt = torch.where(w, torch.rsqrt(torch.clamp(d2, min=1e-12)), 0.0)
    agg = torch.cat([wt @ spfh_n, torch.sum(w, 1, dtype=torch.float32
                                            )[:, None]], 1)
    return raw, agg


@pytest.mark.parametrize("name", CASES)
def test_kept_pairs_give_the_unpruned_rows(name):
    """Restricting the pairs to the kept (block, tile) pairs of the sorted
    cloud changes no valid row, bit for bit; masked rows are zero."""
    _, (p, m, nrm, v) = _sorted(*_t(*_case(name)))
    kept = fs.radius_tile_keep(p, m, m & v, R)
    blk = torch.arange(len(p)) // fs.FP_BLOCK
    tile = torch.arange(len(p)) // fs.FP_TILE
    pruned = _pair_model(p, m, nrm, v, kept[blk][:, tile])
    full = _pair_model(p, m, nrm, v, torch.ones(len(p), len(p), dtype=bool))
    assert bool(kept[blk][:, tile].float().mean() < 1.0)
    for a, b in zip(pruned, full):
        assert torch.equal(a[m], b[m])
        assert not a[~m].any()
    assert torch.equal(pruned[0][:, 33], pruned[1][:, 33])


@pytest.fixture(scope="module")
def jax_ref():
    """The base cloud with the JAX package's normals and SPFH; its SPFH and
    aggregation unsorted (XLA) and on its own Morton-sorted rows (the
    Pallas kernels in interpret mode, unsorted back).  Both aggregations
    take the XLA SPFH, so every aggregation below has the same input."""
    pts, mask = _base_cloud()
    p, m = jnp.asarray(pts), jnp.asarray(mask)
    mom = jfs._moments_xla(p, m, 0.9, 0.6)
    nrm, nv, _, _ = jfs.moments_to_normals_covs(mom, p, m, None)
    raw = jfs._spfh_xla(p, m, nrm, nv, R)
    spfh = raw[:, :33] / jnp.maximum(raw[:, 33:], 1.0)
    agg = jfs._fpfh_agg_xla(p, m, nv, spfh, R)
    o = pallas_knn.morton_order(p, m)
    inv = jnp.argsort(o)
    raw_s = jfs._spfh_tpu(p[o], m[o], nrm[o], nv[o], R, interpret=True)
    agg_s = jfs._fpfh_agg_tpu(p[o], m[o], nv[o], spfh[o], R, interpret=True)
    return {k: np.asarray(x) for k, x in dict(
        pts=pts, mask=mask, nrm=nrm, nv=nv, raw=raw, spfh=spfh, agg=agg,
        raw_tpu=raw_s[inv], agg_tpu=agg_s[inv]).items()}


def _ref_tensors(ref, *keys):
    return _t(*(ref[k] for k in keys))


def _sorted_spfh_agg(p, m, nrm, nv):
    """The sorted route's K4 / K5 step by hand: sort, ``spfh_agg`` (the
    plain batched versions) on the sorted rows, unsort."""
    order = knn_cuda.morton_order_batched(p[None], m[None])
    srt = (knn_cuda.take_rows(x[None], order) for x in (p, m, nrm, nv))
    return tuple(knn_cuda.put_rows(o, order)[0]
                 for o in fs.spfh_agg(*srt, R, batched=True))


def test_sorted_route_spfh_matches_jax(jax_ref):
    """The sorted route's SPFH (plain K4 on the sorted rows, unsorted
    back) against the JAX package, valid rows."""
    p, m, nrm, nv = _ref_tensors(jax_ref, "pts", "mask", "nrm", "nv")
    raw, _ = _sorted_spfh_agg(p, m, nrm, nv)
    for key in ("raw", "raw_tpu"):
        want = _t(jax_ref[key])[0]
        rows = torch.nonzero(m).flatten()[
            parity.rows_beyond(raw[m], want[m], 1e-3, 0.0)]
        assert len(rows) <= 3, (key, rows)
        if len(rows):
            ok = parity.spfh_rows_explained(raw, want, p, nrm, m & nv,
                                            rows, R)
            assert bool(ok.all()), (key, rows[~ok])


def test_sorted_route_aggregation_matches_jax(jax_ref):
    """The route's K5 step (sort, the plain batched K5 on the sorted rows,
    unsort) on the JAX package's SPFH, against its aggregation, valid
    rows."""
    p, m, nv, spfh = _ref_tensors(jax_ref, "pts", "mask", "nv", "spfh")
    order = knn_cuda.morton_order_batched(p[None], m[None])
    ps, ms, vs, ss = (knn_cuda.take_rows(x[None], order)
                      for x in (p, m, nv, spfh))
    agg = knn_cuda.put_rows(fs.fpfh_agg_batched(ps, ms, vs, ss, R), order)[0]
    for key in ("agg", "agg_tpu"):
        want = _t(jax_ref[key])[0]
        rows = torch.nonzero(m).flatten()[
            parity.rows_beyond(agg[m], want[m], 1e-2, 1e-4)]
        assert len(rows) <= 3, (key, rows)
        if len(rows):
            ok = parity.radius_boundary_rows(p, m & nv, rows, (R,))
            assert bool(ok.all()), (key, rows[~ok])


def test_sorted_route_returns_the_callers_rows(jax_ref):
    """The sorted route's K4 / K5 step returns rows in the caller's order:
    on the CPU, where the plain versions run, its SPFH equals the unsorted
    plain route's and its aggregation the unsorted plain K5's on the same
    SPFH, except whole pairs at a radius or bin-edge boundary (a matmul
    may round a pair's d2 by its row's position); K4's and K5's count
    columns are equal."""
    p, m, nrm, nv = _ref_tensors(jax_ref, "pts", "mask", "nrm", "nv")
    raw, agg = _sorted_spfh_agg(p, m, nrm, nv)
    raw_u = fs.spfh(p, m, nrm, nv, R)
    agg_u = fs.fpfh_agg(p, m, nv, fs._normalized_spfh(raw), R)
    rows = parity.rows_beyond(raw, raw_u, 1e-3, 0.0)
    assert len(rows) <= 3
    if len(rows):
        assert bool(parity.spfh_rows_explained(raw, raw_u, p, nrm, m & nv,
                                               rows, R).all())
    rows = parity.rows_beyond(agg, agg_u, 1e-2, 1e-4)
    assert len(rows) <= 3
    if len(rows):
        assert bool(parity.radius_boundary_rows(p, m & nv, rows, (R,)).all())
    assert torch.equal(raw[:, 33], agg[:, 33])


def test_morton_order_batched_equals_single_and_jax():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-20, 20, (3, 500, 3)).astype(np.float32)
    mask = rng.random((3, 500)) > 0.2
    mask[2] = False
    p, m = _t(pts, mask)
    got = knn_cuda.morton_order_batched(p, m)
    for i in range(3):
        assert torch.equal(got[i], knn_cuda.morton_order(p[i], m[i]))
        want = np.asarray(pallas_knn.morton_order(jnp.asarray(pts[i]),
                                                  jnp.asarray(mask[i])))
        np.testing.assert_array_equal(got[i].numpy(), want)
    # rows gathered by the order and put back are the rows given
    back = knn_cuda.put_rows(knn_cuda.take_rows(p, got), got)
    assert torch.equal(back, p)
