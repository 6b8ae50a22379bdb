"""Kernel K1's plain version (ops/knn.py brute_knn, reached through the
ops/knn_cuda.py wrappers on CPU tensors) held against the JAX package: the
Pallas kNN kernel in interpret mode and the XLA brute-force path.

Tolerances: validity exact; d2 within 2e-3 relative (the Pallas kernel's
packed-key quantization); indices equal up to ties of that size.  Against
the XLA path, which computes the same fp32 expansion, indices are equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu.ops import knn as jknn
from fast_lio_sam_qn_tpu.ops import pallas_knn
from fast_lio_sam_qn_tpu_torch import kernels
from fast_lio_sam_qn_tpu_torch.ops import knn, knn_cuda
from fast_lio_sam_qn_tpu_torch.tools import profile_knn

torch.set_num_threads(1)

CASES = [
    (300, 700, 3, 15),   # off-tile sizes, the covariance-path k
    (256, 2048, 3, 1),   # GICP nearest neighbour
    (400, 500, 33, 1),   # FPFH descriptor matching
    (100, 200, 3, 15),   # k close to the valid-db size
]


def _inputs(m, n, f, seed=42):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(m, f)).astype(np.float32) * 5
    db = rng.normal(size=(n, f)).astype(np.float32) * 5
    return q, rng.random(m) > 0.3, db, rng.random(n) > 0.3


@pytest.mark.parametrize("m,n,f,k", CASES)
def test_plain_matches_pallas_interpret(m, n, f, k):
    q, qm, db, dm = _inputs(m, n, f)
    d_p, i_p, v_p = map(np.asarray, pallas_knn._knn_pallas_tpu(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(db), jnp.asarray(dm), k,
        interpret=True))
    d_t, i_t, v_t = (a.numpy() for a in knn_cuda.knn(
        torch.from_numpy(q), torch.from_numpy(qm), torch.from_numpy(db),
        torch.from_numpy(dm), k))
    np.testing.assert_array_equal(v_t, v_p)
    # invalid slots hold inf on both sides: compare valid slots only
    d_t, d_p = np.where(v_t, d_t, 1.0), np.where(v_t, d_p, 1.0)
    rel = np.where(v_t, np.abs(d_t - d_p) / np.maximum(d_t, 1e-6), 0.0)
    assert rel.max() < 2e-3
    # index mismatches only at quantization-scale ties
    alt = db[np.clip(i_p, 0, None)]
    d_true = np.sum((alt - q[:, None, :]) ** 2, -1)
    mism = (i_p != i_t) & v_t
    gap = np.where(mism, np.abs(d_true - d_t) / np.maximum(d_t, 1e-6), 0.0)
    assert gap.max() < 2e-3


@pytest.mark.parametrize("m,n,f,k", CASES)
def test_plain_matches_xla_brute(m, n, f, k):
    q, qm, db, dm = _inputs(m, n, f, seed=7)
    want = jknn.brute_knn(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(db),
                          jnp.asarray(dm), k=k)
    got = knn.brute_knn(torch.from_numpy(q), torch.from_numpy(qm),
                        torch.from_numpy(db), torch.from_numpy(dm), k)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-3, atol=1e-5)


def test_brute_nn_matches_xla():
    q, qm, db, dm = _inputs(300, 700, 3, seed=8)
    want = jknn.brute_nn(*map(jnp.asarray, (q, qm, db, dm)))
    got = knn.brute_nn(*map(torch.from_numpy, (q, qm, db, dm)))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-3, atol=1e-5)


def test_ties_go_to_lowest_index():
    """Duplicate db points: the lowest index wins, as lax.top_k breaks
    ties."""
    db = torch.zeros((8, 3))
    db[4:] = 1.0
    q = torch.full((2, 3), 0.9)
    d2, idx, valid = knn_cuda.knn(q, torch.ones(2, dtype=torch.bool), db,
                                  torch.ones(8, dtype=torch.bool), 3)
    assert idx.tolist() == [[4, 5, 6], [4, 5, 6]]
    assert bool(valid.all())


def test_masks_and_short_db():
    q = torch.zeros((4, 3))
    db = torch.ones((6, 3))
    qm = torch.tensor([True, False, True, True])
    dm = torch.tensor([False, True, False, True, False, False])
    d2, idx, valid = knn_cuda.knn(q, qm, db, dm, 4)
    assert valid.sum(dim=1).tolist() == [2, 0, 2, 2]
    assert idx[0].tolist() == [1, 3, -1, -1]
    assert bool(torch.isinf(d2[1]).all())
    d, i, v = knn_cuda.nn(q, qm, db, dm)
    assert i.tolist() == [1, -1, 1, 1] and v.tolist() == [True, False, True,
                                                          True]


# ---------------------------------------------------------------------------
# K2: the banded (bbox-pruned) kNN over Morton-sorted clouds
# ---------------------------------------------------------------------------

def _clustered(m, n, seed=3):
    """Clustered clouds, as tests/test_pallas_knn.py uses them, so the
    prune bites and empty / partial tiles occur."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, 3)).astype(np.float32) * 20
    q = (centers[rng.integers(0, 8, m)]
         + rng.normal(size=(m, 3)) * 2).astype(np.float32)
    db = (centers[rng.integers(0, 8, n)]
          + rng.normal(size=(n, 3)) * 2).astype(np.float32)
    return q, rng.random(m) > 0.3, db, rng.random(n) > 0.3


def _sorted_pair(m, n, seed=3):
    """The clustered clouds, each Morton-sorted by the JAX package."""
    q, qm, db, dm = _clustered(m, n, seed)
    qo = np.asarray(pallas_knn.morton_order(jnp.asarray(q), jnp.asarray(qm)))
    do = np.asarray(pallas_knn.morton_order(jnp.asarray(db),
                                            jnp.asarray(dm)))
    return q[qo], qm[qo], db[do], dm[do]


@pytest.mark.parametrize("m,n", [(300, 700), (1000, 2048)])
def test_morton_order_matches_jax(m, n):
    """The same permutation, masked points last (exact)."""
    q, qm, _, _ = _clustered(m, n, seed=m)
    want = np.asarray(pallas_knn.morton_order(jnp.asarray(q),
                                              jnp.asarray(qm)))
    got = knn_cuda.morton_order(torch.from_numpy(q), torch.from_numpy(qm))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,td", [(1, 512), (15, 128), (4, 512)])
def test_block_tile_keep_matches_jax(k, td):
    """The keep bitmap of the reference's query blocks (TQ rows) and db
    tiles, bit for bit, and it prunes."""
    m, n = 1000, 5000
    q, qm, db, dm = _sorted_pair(m, n)
    tq = pallas_knn.TQ
    want = np.asarray(pallas_knn._block_tile_keep(
        jnp.asarray(q), jnp.asarray(qm), -(-m // tq) * tq, jnp.asarray(db),
        jnp.asarray(dm), -(-n // td) * td, td, k)) != 0
    got = knn_cuda.block_tile_keep(
        torch.from_numpy(q), torch.from_numpy(qm), torch.from_numpy(db),
        torch.from_numpy(dm), k, block=tq, td=td).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("m,n,k", [(300, 700, 15), (64, 512, 1),
                                   (1000, 2048, 1)])
def test_banded_plain_matches_pallas_interpret(m, n, k):
    """K2's plain version (the CPU wrapper) against the reference's banded
    kernel in interpret mode on the same sorted clouds: validity exact; d2
    within 2e-3 relative (packed-key quantization) plus 2^-20 (|q|^2 +
    |v|^2), the fp32 rounding of the expansion's two large terms, which the
    MXU-precision cross term and torch's matmul round differently at these
    +-40 m coordinates; indices equal up to ties of that size."""
    q, qm, db, dm = _sorted_pair(m, n, seed=m + k)
    d_p, i_p, _ = map(np.asarray, pallas_knn._knn_banded_tpu(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(db), jnp.asarray(dm), k,
        interpret=True))
    d_t, i_t, v_t = (a.numpy() for a in knn_cuda.knn_banded(
        *map(torch.from_numpy, (q, qm, db, dm)), k))
    np.testing.assert_array_equal(v_t, np.isfinite(d_p))
    d_t, d_p = np.where(v_t, d_t, 0.0), np.where(v_t, d_p, 0.0)
    big = np.sum(q * q, -1)[:, None] + np.sum(db * db, -1)[
        np.clip(i_t, 0, None)]
    tol = 2e-3 * d_t + 2.0 ** -20 * big
    assert np.all(np.abs(d_t - d_p) <= tol)
    d_true = np.sum((db[np.clip(i_p, 0, None)] - q[:, None, :]) ** 2, -1)
    mism = (i_p != i_t) & v_t
    assert np.all(np.abs(d_true - d_t)[mism] <= tol[mism])


@pytest.mark.parametrize("k", [1, 15])
def test_banded_equals_brute_on_sorted_clouds(k):
    """The prune is exact: K2's plain version returns brute_knn's result
    bit for bit, while its keep bitmap skips most (block, tile) pairs."""
    q, qm, db, dm = map(torch.from_numpy, _sorted_pair(2000, 3000, seed=k))
    got = knn_cuda.knn_banded(q, qm, db, dm, k)
    want = knn.brute_knn(q, qm, db, dm, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    keep = knn_cuda.block_tile_keep(q, qm, db, dm, k)
    searched = keep[torch.unique(torch.nonzero(qm).flatten()
                                 // knn_cuda.BAND_BLOCK)]
    assert float(searched.float().mean()) < 0.8


def test_banded_k_greater_1_sparse_near_tile():
    """k-soundness: the nearest tile holds one valid point, neighbours
    2..k sit in a far tile that must not be pruned."""
    td, k = knn_cuda.BAND_TILE, 4
    rng = np.random.default_rng(0)
    db = np.zeros((2 * td, 3), np.float32)
    db[0] = (0.1, 0.0, 0.0)
    db[td:] = 200.0 + rng.normal(size=(td, 3)).astype(np.float32)
    dm = np.zeros(2 * td, bool)
    dm[0] = True
    dm[td:] = True
    q = np.zeros((knn_cuda.BAND_BLOCK, 3), np.float32)
    qm = np.ones(knn_cuda.BAND_BLOCK, bool)
    args = tuple(map(torch.from_numpy, (q, qm, db, dm)))
    d, i, v = knn_cuda.knn_banded(*args, k)
    assert bool(v.all())
    assert torch.equal(i, knn.brute_knn(*args, k)[1])


def test_banded_masked_query_block_and_db():
    q = torch.randn(64, 3)
    d, i, v = knn_cuda.knn_banded(q, torch.zeros(64, dtype=torch.bool),
                                  torch.randn(512, 3),
                                  torch.ones(512, dtype=torch.bool), 1)
    assert not bool(v.any()) and bool((i == -1).all())
    d, i, v = knn_cuda.nn_banded(torch.zeros(32, 3),
                                 torch.ones(32, dtype=torch.bool),
                                 torch.ones(128, 3),
                                 torch.zeros(128, dtype=torch.bool))
    assert not bool(v.any()) and bool(torch.isinf(d).all())


# ---------------------------------------------------------------------------
# The Python side of the k = 1 kernels' design (csrc/knn_tile.cuh): the
# lanes' extents, the split plan and a plain model of split-and-merge
# ---------------------------------------------------------------------------

def test_lane_extents_last_valid_row():
    """1 + the last valid index of each lane, 0 for an all-masked lane."""
    mask = torch.tensor([[True, False, True, False, False],
                         [False, False, False, False, False],
                         [True, True, True, True, True],
                         [False, False, False, False, True]])
    ext = knn_cuda.lane_extents(mask)
    assert ext.dtype == torch.int32
    assert ext.tolist() == [3, 0, 5, 5]
    empty = knn_cuda.lane_extents(torch.zeros((2, 0), dtype=torch.bool))
    assert empty.tolist() == [0, 0]


@pytest.mark.parametrize("seed", range(3))
def test_lane_extents_random_masks(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((6, 300)) < rng.random((6, 1))
    mask[0] = False
    mask[1, 250:] = False
    want = [max(np.nonzero(row)[0], default=-1) + 1 for row in mask]
    assert knn_cuda.lane_extents(torch.from_numpy(mask)).tolist() == want


@pytest.mark.parametrize("splits", range(1, knn_cuda.MAX_SPLITS + 1))
def test_split_plan_covers_every_active_row_once(splits):
    """split_lo, the formula of csrc/knn_tile.cuh: K1's slices of the db
    tiles below an extent (tile-aligned, ascending) hold every row under
    the extent exactly once, for every extent 0..N; K2's slices of a kept
    list hold every entry exactly once."""
    tile = knn_cuda.BAND_TILE
    for end in range(0, 5 * tile + 3):
        tiles = -(-end // tile)
        hits = np.zeros(end, int)
        prev = 0
        for z in range(splits):
            lo = knn_cuda.split_lo(tiles, splits, z) * tile
            hi = min(knn_cuda.split_lo(tiles, splits, z + 1) * tile, end)
            assert lo % tile == 0 and lo >= prev
            hits[lo:hi] += 1
            prev = lo
        assert np.all(hits == 1), (end, splits)
    for units in range(0, 70):
        slices = [range(knn_cuda.split_lo(units, splits, z),
                        knn_cuda.split_lo(units, splits, z + 1))
                  for z in range(splits)]
        assert sorted(u for s in slices for u in s) == list(range(units))


def test_split_count_fills_the_card():
    """Grid z: 1 at k > 1 or once the query blocks alone give SPLIT_CTAS
    CTAs; never more slices than db tiles or MAX_SPLITS."""
    assert knn_cuda.split_count(1, 4352, 5632, 1) == knn_cuda.MAX_SPLITS
    assert knn_cuda.split_count(1, 16384, 32768, 1) == 3
    assert knn_cuda.split_count(4, 16384, 32768, 1) == 1
    assert knn_cuda.split_count(1, 4352, 5632, 15) == 1
    assert knn_cuda.split_count(1, 37, 300, 1) == 3
    assert knn_cuda.split_count(1, 37, 0, 1) == 1


def _split_merge_nn(q, qm, db, dm, splits):
    """A plain model of the k = 1 kernels' split: brute_knn over the db
    rows of each slice (split_lo over the tiles below the extent), then
    the lexicographic (d2, idx) minimum of the slices' partials."""
    tile = knn_cuda.BAND_TILE
    end = int(knn_cuda.lane_extents(dm[None])[0])
    tiles = -(-end // tile)
    best_d = torch.full((q.shape[0],), torch.inf)
    best_i = torch.full((q.shape[0],), -1, dtype=torch.int32)
    for z in range(splits):
        lo = knn_cuda.split_lo(tiles, splits, z) * tile
        hi = min(knn_cuda.split_lo(tiles, splits, z + 1) * tile, end)
        part = dm.clone()
        part[:lo] = False
        part[hi:] = False
        d, i, _ = knn.brute_knn(q, qm, db, part, 1)
        d, i = d[:, 0], i[:, 0]
        better = (d < best_d) | ((d == best_d) & (i < best_i))
        best_d = torch.where(better, d, best_d)
        best_i = torch.where(better, i, best_i)
    return best_d, best_i


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
def test_split_and_merge_model_equals_brute(splits):
    """Small-integer clouds (exact d2, so ties are exact) with the same
    point on both sides of every tile edge and a query on it: the merged
    slices give brute_knn's first minimum, index for index."""
    rng = np.random.default_rng(splits)
    m, n, tile = 90, 9 * knn_cuda.BAND_TILE + 50, knn_cuda.BAND_TILE
    q = rng.integers(-3, 4, (m, 3)).astype(np.float32)
    db = rng.integers(-3, 4, (n, 3)).astype(np.float32)
    qm, dm = rng.random(m) > 0.2, rng.random(n) > 0.2
    dm[n - 70:] = False
    for j, e in enumerate(range(tile, n - 70, tile)):
        db[e] = db[e - 1] = (10.0 + j, 0.0, 0.0)
        dm[e - 1:e + 1] = True
        q[j] = db[e]
        qm[j] = True
    args = tuple(map(torch.from_numpy, (q, qm, db, dm)))
    d, i = _split_merge_nn(*args, splits)
    want_d, want_i, _ = knn.brute_knn(*args, 1)
    assert torch.equal(d, want_d[:, 0]) and torch.equal(i, want_i[:, 0])
    edges = range(tile, n - 70, tile)
    assert i[:len(edges)].tolist() == [e - 1 for e in edges]


@pytest.mark.parametrize("k", [1, 4])
def test_brute_knn_holed_masks_match_xla(k):
    """Masks with holes, a masked tail and a masked-out query half: the
    port's brute_knn against the JAX package's brute path."""
    q, qm, db, dm = _inputs(300, 900, 3, seed=11 + k)
    qm[150:] = False
    dm[::3] = False
    dm[600:] = False
    want = jknn.brute_knn(*map(jnp.asarray, (q, qm, db, dm)), k=k)
    got = knn.brute_knn(*map(torch.from_numpy, (q, qm, db, dm)), k)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-3, atol=1e-5)
    assert not bool(got[2][150:].any())


# ---------------------------------------------------------------------------
# K1 at k > 1: the numpy model of the warp-cooperative selection
# (tools/profile_knn.py warp_select, step for step csrc/knn.cu
# knnk_warp_kernel over csrc/knn_tile.cuh sel_*) against brute_knn.  These
# tests hold the algorithm, not the kernel: nothing ties the model to the
# CUDA source, and chip_smoke.py's kNN edge cases are the kernel's check
# ---------------------------------------------------------------------------

def _warp_select_knn(q, qm, db, dm, k):
    """The model over every query: (d2 (M, k), idx (M, k), flushes)."""
    f = q.shape[1]
    d2 = knn._dist2_tile(torch.from_numpy(q), torch.from_numpy(db)).numpy()
    d2 = np.where(dm[None, :], d2, np.float32(np.inf))
    dend = int(knn_cuda.lane_extents(torch.from_numpy(dm)[None])[0])
    out_d = np.full((len(q), k), np.inf, np.float32)
    out_i = np.full((len(q), k), -1, np.int64)
    flushes = 0
    for r in np.nonzero(qm)[0]:
        out_d[r], out_i[r], fl = profile_knn.warp_select(
            d2[r], dend, k, profile_knn.sel_rows(f))
        flushes += fl
    return out_d, out_i, flushes


def _tied_clouds(rng, m, n, f, tail):
    """Small-integer clouds (exact d2: equal distances abound) whose db
    repeats a point on both sides of every 32-row edge (a lane stride, so
    every tile edge) and at rows r, r + 257 (further apart than a queue
    flush of 4 rows a lane), a query on each; the last ``tail`` db rows
    masked, so the extent is off every tile."""
    q = rng.integers(-2, 3, (m, f)).astype(np.float32)
    db = rng.integers(-2, 3, (n, f)).astype(np.float32)
    qm, dm = rng.random(m) > 0.2, rng.random(n) > 0.2
    dm[n - tail:] = False
    pairs = [(e - 1, e) for e in range(32, n - tail, 32)]
    pairs += [(r, r + 257) for r in range(40, n - tail - 257, 150)
              if r % 32 not in (0, 31) and (r + 257) % 32 not in (0, 31)]
    for j, (a, b) in enumerate(pairs):
        db[b] = db[a]
        dm[[a, b]] = True
        q[j % m] = db[a]
        qm[j % m] = True
    return q, qm, db, dm


@pytest.mark.parametrize("f,k", [(3, 2), (3, 15), (3, 48), (3, 64),
                                 (33, 17), (33, 33), (33, 63),
                                 (64, 16), (64, 31), (64, 64)])
def test_warp_select_model_equals_brute(f, k):
    """The k > 1 kernel's selection, modelled step for step (the
    algorithm; the kernel itself is checked on the card), returns
    brute_knn's result bit for bit on clouds full of exact ties (on lane
    stride and tile edges, across queue flushes), with the db extent off
    every tile and some valid queries whose neighbours all tie."""
    rng = np.random.default_rng(100 * f + k)
    q, qm, db, dm = _tied_clouds(rng, 24, 700, f, 45)
    d, i, flushes = _warp_select_knn(q, qm, db, dm, k)
    want_d, want_i, _ = knn.brute_knn(*map(torch.from_numpy, (q, qm, db, dm)),
                                      k)
    np.testing.assert_array_equal(d.view(np.int32),
                                  want_d.numpy().view(np.int32))
    np.testing.assert_array_equal(i, want_i.numpy())
    assert flushes >= int(qm.sum())


@pytest.mark.parametrize("k", [2, 33, 64])
def test_warp_select_model_fewer_rows_than_k(k):
    """A db with fewer valid rows than k (and one with none): the model
    fills the tail with (inf, -1), as brute_knn does."""
    rng = np.random.default_rng(k)
    q, qm, db, dm = _tied_clouds(rng, 10, 300, 3, 20)
    few = np.zeros_like(dm)
    few[rng.choice(280, 1 if k == 2 else 20, replace=False)] = True
    for mask in (few, np.zeros_like(dm)):
        d, i, _ = _warp_select_knn(q, qm, db, mask, k)
        want_d, want_i, _ = knn.brute_knn(
            *map(torch.from_numpy, (q, qm, db, mask)), k)
        np.testing.assert_array_equal(d, want_d.numpy())
        np.testing.assert_array_equal(i, want_i.numpy())


@pytest.mark.parametrize("f,k", [(3, 2), (3, 33), (3, 63), (33, 2),
                                 (33, 33), (33, 63)])
def test_plain_matches_knn_pallas_with_ties(f, k):
    """K1's plain version against the JAX package's knn_pallas (its CPU
    path) on tied small-integer clouds: every distance exact, so d2 bits
    and indices (ties to the lower db index) equal."""
    rng = np.random.default_rng(7 * f + k)
    q, qm, db, dm = _tied_clouds(rng, 60, 500, f, 30)
    want = pallas_knn.knn_pallas(*map(jnp.asarray, (q, qm, db, dm)), k)
    got = knn_cuda.knn(*map(torch.from_numpy, (q, qm, db, dm)), k)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


_BBOX = "_ZN4flsq16tile_bbox_kernelILi32EEEvPKfPKhPKiiiPf"
_WARP = ("_ZN38_GLOBAL__N__51bbeb45_6_knn_cu_flsq_knn16knnk_warp_kernelILi3ELi2"
         "EEEvPKfS2_PKhS2_S2_S4_PKiS6_iiiiPfPi")
PTXAS_LOG = "".join(
    f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
    f"ptxas info    : Function properties for {name}\n"
    f"    {frame}\n"
    f"ptxas info    : Used {regs}\n"
    "ptxas info    : Compile time = 18.892 ms\n"
    for name, frame, regs in (
        (_BBOX, "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
         "loads", "30 registers, used 0 barriers"),
        (_WARP, "16 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
         "loads", "76 registers, used 1 barriers, 400 bytes cmem[0]")))


def test_ptxas_entries_parse_a_build_log():
    """kernels.ptxas_entries: one entry per compiled kernel with its
    registers, stack and spills (chip_smoke.py logs them by name)."""
    got = kernels.ptxas_entries(PTXAS_LOG)
    assert [e["registers"] for e in got] == [30, 76]
    assert [(e["stack"], e["spill_stores"], e["spill_loads"])
            for e in got] == [(0, 0, 0), (16, 8, 4)]
    assert "tile_bbox_kernel" in got[0]["name"]
    assert "knnk_warp_kernel" in got[1]["name"]
    assert kernels.ptxas_entries("nvcc: no ptxas lines\n") == []
