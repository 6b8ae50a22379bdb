"""The port's voxel hash grid (``ops/hashgrid.py``: ``empty``, ``insert``,
``build``, ``contains``, ``evict_beyond``, ``gather_candidates``,
``query_nn``, ``query_knn``) held against the JAX package's on the same
numpy inputs, plus mirrors of the reference's own cases
(tests/test_voxel_hashgrid.py).

The grid and the neighbours are exact: the slots, ``occupied``,
``coords``, ``src_idx`` and the points are integer or copied values, the
candidate lists are gathers, and the neighbour order is (d2, candidate
index) on both sides.  Ties are planted on clouds of small integers, where
every d2 is exact and most are tied.  The distances themselves agree
within 5e-7 of themselves (4 ulp): inside the reference's fused query XLA
contracts the sum of three squares into fused multiply-adds, one rounding
per term fewer than the port's (traced: 48 of 200 nearest distances on
the crowded cloud differ, by 1-2 ulp, with the same neighbours)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fast_lio_sam_qn_tpu.ops import hashgrid as jgrid
from fast_lio_sam_qn_tpu.ops import knn as jknn
from fast_lio_sam_qn_tpu_torch.ops import hashgrid
from fast_lio_sam_qn_tpu_torch.ops.voxel import voxel_coords

torch.set_num_threads(1)


def _cloud(seed, n, scale=5.0):
    return np.random.default_rng(seed).uniform(
        -scale, scale, (n, 3)).astype(np.float32)


def _integer_cloud(seed, n, side=6):
    """Points on a unit lattice with duplicates: voxels of res 1 hold
    several contenders, and equal distances are everywhere."""
    return np.random.default_rng(seed).integers(
        -side, side, (n, 3)).astype(np.float32)


def _mask(seed, n, holes=0.1):
    return np.random.default_rng(seed + 1).random(n) >= holes


def _jax(grid):
    return [np.asarray(x) for x in grid[:4]]


def _port(grid):
    return [x.numpy() for x in grid[:4]]


def _assert_grids_equal(got, want):
    for name, x, y in zip(("points", "coords", "occupied", "src_idx"),
                          _port(got), _jax(want)):
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert got.res == want.res


def _both_build(pts, mask, res, table):
    got = hashgrid.build(torch.from_numpy(pts), torch.from_numpy(mask), res,
                         table)
    want = jgrid.build(jnp.asarray(pts), jnp.asarray(mask), res=res,
                       table_size=table)
    return got, want


def _assert_same(got, want, distances):
    """Equal, or for the distances equal infinities and finite values
    within 5e-7 of themselves."""
    if not distances:
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=5e-7, atol=0)


def _port_grid(want):
    return hashgrid.HashGrid(*(torch.from_numpy(x.copy())
                               for x in _jax(want)), res=want.res)


BUILD_CASES = {
    "uniform": lambda: (_cloud(0, 700), _mask(0, 700), 0.5, 2048),
    "integers": lambda: (_integer_cloud(1, 900), _mask(1, 900), 1.0, 1024),
    "crowded": lambda: (_cloud(2, 3000, 3.0), _mask(2, 3000, 0.3), 0.4,
                        1024),
}


def test_empty_matches_reference():
    got = hashgrid.empty(0.3, 64, "cpu")
    _assert_grids_equal(got, jgrid.empty(0.3, 64))
    assert got.table_size == 64
    with pytest.raises(ValueError):
        hashgrid.empty(0.3, 63, "cpu")


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_build_and_insert_match_reference(case):
    pts, mask, res, table = BUILD_CASES[case]()
    got, want = _both_build(pts, mask, res, table)
    _assert_grids_equal(got, want)
    assert int(got.occupied.sum()) > 100
    # a second batch: occupants kept, new voxels claimed by the lowest index
    more = (pts + np.float32(0.37 * res)).astype(np.float32)
    got = hashgrid.insert(got, torch.from_numpy(more), torch.from_numpy(mask))
    want = jgrid.insert(want, jnp.asarray(more), jnp.asarray(mask))
    _assert_grids_equal(got, want)


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_contains_matches_reference(case):
    pts, mask, res, table = BUILD_CASES[case]()
    _, want = _both_build(pts, mask, res, table)
    probe = np.concatenate([pts, pts + np.float32(3 * res)])
    coords = voxel_coords(torch.from_numpy(probe), res)
    got = hashgrid.contains(_port_grid(want), coords)
    ref = jgrid.contains(want, jnp.asarray(coords.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.numpy().mean() < 1


@pytest.mark.parametrize("radius", [2.0, 4.5])
def test_evict_beyond_matches_reference(radius):
    pts, mask, res, table = BUILD_CASES["uniform"]()
    _, want = _both_build(pts, mask, res, table)
    center = np.array([0.5, -1.0, 0.25], np.float32)
    got = hashgrid.evict_beyond(_port_grid(want), torch.from_numpy(center),
                                radius)
    ref = jgrid.evict_beyond(want, jnp.asarray(center), jnp.float32(radius))
    _assert_grids_equal(got, ref)
    assert 0 < int(got.occupied.sum()) < int(want.occupied.sum())


@pytest.mark.parametrize("case,window", [("uniform", 3), ("integers", 3),
                                         ("crowded", 5)])
def test_gather_candidates_matches_reference(case, window):
    pts, mask, res, table = BUILD_CASES[case]()
    _, want = _both_build(pts, mask, res, table)
    q = (pts[:200] + np.float32(0.11)).astype(np.float32)
    got = hashgrid.gather_candidates(_port_grid(want), torch.from_numpy(q),
                                     window)
    ref = jgrid.gather_candidates(want, jnp.asarray(q), window=window)
    assert got[0].shape == (200, window ** 3 * hashgrid.NUM_PROBES, 3)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_query_nn_matches_reference(case):
    """Nearest neighbours, their distances and sources equal, ties (the
    integer cloud's queries at lattice midpoints) taken at the first
    candidate on both sides."""
    pts, mask, res, table = BUILD_CASES[case]()
    _, want = _both_build(pts, mask, res, table)
    q = np.concatenate([pts[:150] + np.float32(0.5 * res),
                        _cloud(9, 50, 8.0)]).astype(np.float32)
    qm = _mask(7, len(q))
    got = hashgrid.query_nn(_port_grid(want), *map(torch.from_numpy, (q, qm)))
    ref = jgrid.query_nn(want, jnp.asarray(q), jnp.asarray(qm))
    for i, (x, y) in enumerate(zip(got, ref)):
        _assert_same(x.numpy(), np.asarray(y), i == 1)
    assert got[3].numpy().sum() > 50


@pytest.mark.parametrize("case,k,window", [
    ("uniform", 5, 3), ("integers", 5, 3), ("integers", 12, 5),
    ("crowded", 10, 5)])
def test_query_knn_matches_reference(case, k, window):
    """k nearest within the window: points, distances and validity equal,
    ties included (the integer cloud: every query sits on the lattice, so
    whole shells of neighbours are tied)."""
    pts, mask, res, table = BUILD_CASES[case]()
    _, want = _both_build(pts, mask, res, table)
    q = np.concatenate([pts[:200], _cloud(11, 56, 6.0)])
    qm = _mask(5, len(q))
    got = hashgrid.query_knn(_port_grid(want), torch.from_numpy(q),
                             torch.from_numpy(qm), k, window)
    ref = jgrid.query_knn(want, jnp.asarray(q), jnp.asarray(qm), k=k,
                          window=window)
    for i, (x, y) in enumerate(zip(got, ref)):
        _assert_same(x.numpy(), np.asarray(y), i == 1)
    d2 = got[1].numpy()
    if case == "integers":
        # ties are really exercised: equal distances within a row
        fin = np.isfinite(d2[:, :-1]) & (d2[:, :-1] == d2[:, 1:])
        assert fin.sum() > 200


def test_query_knn_tie_keeps_lower_candidate():
    """Four points at equal distance from the query, one per voxel: the
    first two in candidate order are kept."""
    pts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0]],
                   np.float32) + np.float32(0.5)
    grid = hashgrid.build(torch.from_numpy(pts), torch.ones(4, dtype=bool),
                          1.0, 64)
    q = torch.tensor([[0.5, 0.5, 0.5]])
    cand, valid, _ = hashgrid.gather_candidates(grid, q, 3)
    order = [tuple(cand[0, j].tolist()) for j in range(cand.shape[1])
             if valid[0, j]]
    knn_pts, d2, ok = hashgrid.query_knn(grid, q, torch.ones(1, dtype=bool),
                                         2, 3)
    assert ok.all() and (d2 == 1.0).all()
    assert [tuple(p) for p in knn_pts[0].tolist()] == order[:2]
    nn, nd2, _, found = hashgrid.query_nn(grid, q, torch.ones(1, dtype=bool))
    assert found.all() and tuple(nn[0].tolist()) == order[0]


# ---------------------------------------------------------------------------
# mirrors of tests/test_voxel_hashgrid.py
# ---------------------------------------------------------------------------

def test_hashgrid_build_and_nn():
    pts = torch.from_numpy(_cloud(3, 256, 4.0))
    grid = hashgrid.build(pts, torch.ones(256, dtype=bool), 0.5, 2048)
    _, d2, _, found = hashgrid.query_nn(grid, pts[:50],
                                        torch.ones(50, dtype=bool))
    assert found.all()
    assert (d2 <= 3 * 0.5 ** 2 + 1e-6).all()


def test_hashgrid_nn_matches_brute_on_sparse():
    pts = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(4)),
                   -1).reshape(-1, 3).astype(np.float32)
    grid = hashgrid.build(torch.from_numpy(pts), torch.ones(len(pts),
                                                            dtype=bool),
                          1.0, 1024)
    q = pts[:64] + np.float32(0.3)
    _, d2, _, _ = hashgrid.query_nn(grid, torch.from_numpy(q),
                                    torch.ones(64, dtype=bool), window=3)
    bd2, _, _ = jknn.brute_nn(jnp.asarray(q), jnp.ones(64, bool),
                              jnp.asarray(pts), jnp.ones(len(pts), bool))
    np.testing.assert_allclose(d2.numpy(), np.asarray(bd2), atol=1e-5)


def test_hashgrid_knn_recall_vs_brute():
    """Within the window's guaranteed reach (2 res for window 5) the grid's
    kNN equals brute force on a 0.3 m voxelized cloud."""
    from fast_lio_sam_qn_tpu_torch.ops import voxel

    pts = torch.from_numpy(_cloud(5, 2048, 6.0))
    vp, vm = voxel.voxel_downsample(pts, torch.ones(2048, dtype=bool), 0.3)
    grid = hashgrid.build(vp, vm, 0.3, 8192)
    q, qm = vp[:256], vm[:256]
    _, gd2, gv = hashgrid.query_knn(grid, q, qm, k=10, window=5)
    bd2, _, bv = jknn.brute_knn(*(jnp.asarray(x.numpy())
                                  for x in (q, qm, vp, vm)), k=10)
    gd, bd = np.sqrt(gd2.numpy()), np.sqrt(np.asarray(bd2))
    bv = np.asarray(bv)
    in_reach = gv.numpy() & bv & (bd <= 2 * 0.3 - 1e-4)
    assert in_reach.sum() > 100
    assert np.isclose(gd[in_reach], bd[in_reach], atol=1e-4).mean() > 0.995


def test_hashgrid_insert_keeps_existing():
    grid = hashgrid.build(torch.tensor([[0.25, 0.25, 0.25]]),
                          torch.ones(1, dtype=bool), 1.0, 64)
    grid = hashgrid.insert(grid, torch.tensor([[0.4, 0.4, 0.4],
                                               [5.0, 5.0, 5.0]]),
                           torch.ones(2, dtype=bool))
    nn, _, _, found = hashgrid.query_nn(
        grid, torch.tensor([[0.4, 0.4, 0.4], [5.1, 5.1, 5.1]]),
        torch.ones(2, dtype=bool))
    np.testing.assert_allclose(nn.numpy(), [[0.25] * 3, [5.0] * 3],
                               atol=1e-6)
    assert found.all()


def test_empty_grid_query():
    grid = hashgrid.empty(0.5, 64, "cpu")
    _, d2, _, found = hashgrid.query_nn(grid, torch.zeros(4, 3),
                                        torch.ones(4, dtype=bool))
    assert not found.any() and torch.isinf(d2).all()
