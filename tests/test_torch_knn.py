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
from fast_lio_sam_qn_tpu_torch.ops import knn, knn_cuda

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
