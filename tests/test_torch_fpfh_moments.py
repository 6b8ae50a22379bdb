"""Kernel K3's radius prune and the Morton-sorted FPFH route
(ops/fpfh_stream.py ``sorted_route``, the card's route), on the CPU.

- K3's contract on the keep rule at 0.9 m over mask: the moments over the
  pairs of kept (block, tile) pairs equal the unpruned ones on every valid
  query row, exactly; masked query rows are zero.
- The whole sorted route with the plain versions (sort, plain K3-K5 and
  the normals on the sorted rows, unsort) against the JAX package's own
  sorted route, built by hand: ``pallas_knn.morton_order``, then
  ``_moments_tpu``, ``_spfh_tpu`` and ``_fpfh_agg_tpu`` in interpret mode,
  then unsort.  Tolerances are ``test_fpfh_radius_matches_jax``'s: equal
  ``valid`` / ``n_valid``, descriptors 1e-2, normals and covariances 5e-3
  (the moments differ in summation order, and a neighbourhood whose two
  smallest eigenvalues nearly tie amplifies that).  A normal that moves
  by up to that much can move a pair of its point's SPFH across a bin
  edge: a descriptor row beyond 1e-2 is accepted only within the feature
  radius of an SPFH row whose difference is whole pairs moved between the
  bins of one angle (equal neighbour count, integer differences summing
  to zero in each 11-bin block), and such rows must be few (2 % of the
  valid rows at most).
- The route returns the caller's rows (the same rules against the
  unsorted route); with ``viewpoint=None`` it orients the normals toward
  the centroid of the caller's rows, bit for bit.
- ``fpfh_radius`` and ``fpfh_radius_batched``, routed as on the card, sort
  each lane once, ahead of K3, and K3 sees the sorted rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu.ops import fpfh_stream as jfs
from fast_lio_sam_qn_tpu.ops import pallas_knn
from fast_lio_sam_qn_tpu_torch import kernels
from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream as fs
from fast_lio_sam_qn_tpu_torch.ops import knn_cuda

from test_torch_fpfh_prune import CASES, _base_cloud, _case, _sorted, _t

torch.set_num_threads(1)

RADII = (0.9, 1.5, 0.6)  # normal, feature, cov
VP = np.array([0.0, 0.0, 2.0], np.float32)


def _moment_model(points, mask, pair_ok):
    """K3's arithmetic over the (query, point) pairs allowed by ``pair_ok``
    ((N, N) bool), rows of masked queries zero: (N, 20)."""
    d2 = fs._block_d2(points, points, fs._db_norms(points, mask))
    feats = fs._features(points)
    return torch.cat([((d2 <= r * r) & pair_ok & mask[:, None]).float()
                      @ feats for r in (0.9, 0.6)], dim=1)


@pytest.mark.parametrize("name", CASES)
def test_kept_pairs_give_the_unpruned_moments(name):
    """Restricting the pairs to the (block, tile) pairs that the keep rule
    keeps at 0.9 m over mask, on the sorted cloud, changes no valid row,
    bit for bit; masked rows are zero."""
    pts, mask, _, _ = _case(name)
    _, (p, m) = _sorted(*_t(pts, mask))
    kept = fs.radius_tile_keep(p, m, m, RADII[0])
    blk = torch.arange(len(p)) // fs.FP_BLOCK
    tile = torch.arange(len(p)) // fs.FP_TILE
    pair_ok = kept[blk][:, tile]
    pruned = _moment_model(p, m, pair_ok)
    full = _moment_model(p, m, torch.ones_like(pair_ok))
    assert bool(pair_ok.float().mean() < 1.0)
    assert torch.equal(pruned[m], full[m])
    assert not pruned[~m].any()
    # every valid row counts itself at both radii
    assert bool((pruned[m][:, [0, 10]] >= 1).all())


def _jax_sorted_route(pts, mask, vp):
    """The JAX package's ``use_tpu`` route (fpfh_stream.py:630-663) by
    hand, with the Pallas kernels in interpret mode: (desc, valid,
    normals, n_valid, cov_reg, raw SPFH) in the caller's row order,
    numpy."""
    p, m = jnp.asarray(pts), jnp.asarray(mask)
    o = pallas_knn.morton_order(p, m)
    p, m = p[o], m[o]
    mom = jfs._moments_tpu(p, m, RADII[0], RADII[2], interpret=True)
    nrm, nv, cov, _ = jfs.moments_to_normals_covs(mom, p, m, jnp.asarray(vp))
    raw = jfs._spfh_tpu(p, m, nrm, nv, RADII[1], interpret=True)
    spfh = raw[:, :33] / jnp.maximum(raw[:, 33:], 1.0)
    agg = jfs._fpfh_agg_tpu(p, m, nv, spfh, RADII[1], interpret=True)
    fp = spfh + agg[:, :33] / jnp.maximum(agg[:, 33:], 1.0)
    desc = jnp.concatenate([
        100.0 * fp[:, s:s + 11] / jnp.maximum(
            jnp.sum(fp[:, s:s + 11], -1, keepdims=True), 1e-9)
        for s in range(0, 33, 11)], axis=-1)
    valid = nv & (raw[:, 33] >= 3)
    desc = jnp.where(valid[:, None], desc, 0.0)
    inv = jnp.argsort(o)
    return tuple(np.asarray(x[inv])
                 for x in (desc, valid, nrm, nv, cov, raw))


def _with_spfh(outs, p, m, order):
    """The port's route outputs (numpy) and their raw SPFH: the plain K4
    on the rows in ``order`` with the route's normals, unsorted back, as
    the route computed it."""
    outs = tuple(o[0] for o in outs)
    nrm, nv = (knn_cuda.take_rows(x[None], order)[0] for x in outs[2:4])
    raw = fs.spfh_plain(p[order[0]], m[order[0]], nrm, nv, RADII[1])
    raw = knn_cuda.put_rows(raw[None], order)[0]
    return tuple(o.numpy() for o in outs) + (raw.numpy(),)


@pytest.fixture(scope="module")
def routes():
    """The base cloud through the JAX package's sorted route, the port's
    sorted route (plain versions on the sorted rows) and the port's
    unsorted route, all with the viewpoint VP."""
    pts, mask = _base_cloud()
    p, m, vp = _t(pts, mask, VP)
    order = knn_cuda.morton_order_batched(p[None], m[None])
    ident = torch.arange(len(p))[None]
    return {"points": pts,
            "jax": _jax_sorted_route(pts, mask, VP),
            "sorted": _with_spfh(fs.sorted_route(
                p[None], m[None], RADII, vp[None], batched=False), p, m,
                order),
            "unsorted": _with_spfh(fs._stages(
                p[None], m[None], RADII, vp[None], batched=False), p, m,
                ident)}


def _agree(got, want, points):
    """``test_fpfh_radius_matches_jax``'s tolerances, descriptor rows
    beyond 1e-2 accepted near whole-pair SPFH bin moves (module
    docstring)."""
    gd, gv, gn, gnv, gc, graw = got
    wd, wv, wn, wnv, wc, wraw = want
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gnv, wnv)
    np.testing.assert_allclose(gn, wn, atol=5e-3)
    np.testing.assert_allclose(gc, wc, atol=5e-3)
    assert not gd[~gv].any()
    moved = np.nonzero((np.abs(graw - wraw) > 1e-3).any(1))[0]
    assert len(moved) <= 0.02 * gv.sum(), moved
    diff = (graw - wraw)[moved]
    np.testing.assert_array_equal(graw[moved, 33], wraw[moved, 33])
    np.testing.assert_array_equal(diff, np.round(diff))
    np.testing.assert_array_equal(diff[:, :33].reshape(-1, 3, 11).sum(-1), 0)
    bad = np.nonzero((np.abs(gd - wd) > 1e-2).any(1))[0]
    if len(bad):
        pts = torch.from_numpy(points).double()
        near = torch.cdist(pts[bad], pts[moved]) <= RADII[1] * (1 + 1e-4)
        assert bool(near.any(1).all()), bad[~near.any(1).numpy()]


def test_sorted_route_matches_jax_sorted_route(routes):
    assert routes["jax"][1].sum() > 300
    _agree(routes["sorted"], routes["jax"], routes["points"])


def test_sorted_route_matches_unsorted_route(routes):
    """The sorted route returns the caller's rows: it agrees with every
    stage run on the caller's rows, row by row."""
    _agree(routes["sorted"], routes["unsorted"], routes["points"])


def test_sorted_route_centroid_is_the_callers():
    """With no viewpoint, each lane's normals face the centroid of its
    caller-order rows, taken before the sort: the same bits as that
    centroid passed in, and the same centroid the unsorted route takes."""
    pts, mask = _base_cloud()
    rng = np.random.default_rng(9)
    lanes = np.stack([pts, pts[rng.permutation(len(pts))]])
    masks = np.stack([mask, rng.random(len(pts)) > 0.2])
    p, m = _t(lanes, masks)
    cen = torch.stack([fs._centroid(p[i], m[i]) for i in range(2)])
    unsorted = fs.moments_to_normals_covs(
        fs.moments(p[0], m[0], RADII[0], RADII[2]), p[0], m[0], None)
    _, _, (n_u, _, _) = fs.fpfh_radius(p[0], m[0], *RADII[:2],
                                       cov_radius=RADII[2])
    assert torch.equal(n_u, unsorted[0])
    got = fs.sorted_route(p, m, RADII, None)
    want = fs.sorted_route(p, m, RADII, cen)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the orientation test sees the caller-order centroid: normals of the
    # valid rows point the same way as the unsorted route's
    nv = got[3][0]
    dots = torch.sum(got[2][0][nv] * n_u[nv], dim=1)
    assert bool((dots > 0.9).float().mean() > 0.99)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_card_route_sorts_once_ahead_of_k3(monkeypatch, batched):
    """Routed as on the card (the plain versions standing in for the
    kernels), ``fpfh_radius`` / ``fpfh_radius_batched`` take one Morton
    sort for all lanes, before K3, and K3 gets the sorted rows; the result
    equals ``sorted_route``'s."""
    pts, mask, _, _ = _case("holed")
    p, m = _t(np.stack([pts, pts[::-1].copy()]), np.stack([mask, mask]))
    if not batched:
        p, m = p[:1], m[:1]
    vp = torch.tensor([[0.0, 0.0, 2.0]] * len(p))
    calls = []
    sort = knn_cuda.morton_order_batched
    k3 = fs.moments_batched if batched else fs.moments

    def counted_sort(points, mask_):
        calls.append(("sort", sort(points, mask_)))
        return calls[-1][1]

    def seen_k3(points, *args, **kw):
        calls.append(("K3", points))
        return k3(points, *args, **kw)

    on_cuda = kernels.on_cuda
    monkeypatch.setattr(kernels, "on_cuda", lambda name, t: (
        name == "fpfh_radius" or on_cuda(name, t)))
    monkeypatch.setattr(knn_cuda, "morton_order_batched", counted_sort)
    monkeypatch.setattr(fs, "moments_batched" if batched else "moments",
                        seen_k3)
    if batched:
        got = fs.fpfh_radius_batched(p, m, *RADII[:2], vp,
                                     cov_radius=RADII[2])
    else:
        d, v, rest = fs.fpfh_radius(p[0], m[0], *RADII[:2], vp[0],
                                    cov_radius=RADII[2])
        got = (d[None], v[None], tuple(x[None] for x in rest))
    assert [c[0] for c in calls] == ["sort", "K3"]
    order = calls[0][1]
    rows = calls[1][1] if batched else calls[1][1][None]
    assert torch.equal(rows, knn_cuda.take_rows(p, order))
    monkeypatch.undo()
    want = fs.sorted_route(p, m, RADII, vp, batched)
    flat = got[:2] + tuple(got[2])
    for g, w in zip(flat, want):
        assert torch.equal(g, w)
