"""The H100 bounds of ``fast_lio_sam_qn_tpu_torch.tools.roofline`` against
counts made by hand on toy clouds: a 3-point cloud for the kNN bound and
two lanes of 3 points for the radius bound."""
import pytest
import torch

from fast_lio_sam_qn_tpu_torch.tools import roofline as rl

MS_PER_FLOP = 1e3 / 67e12     # the fp32 peak
MS_PER_BYTE = 1e3 / 3.35e12   # the HBM rate


def test_bound_takes_the_larger_time():
    assert rl.bound(67e9, 1.0) == (pytest.approx(1.0), "operations")
    assert rl.bound(1.0, 3.35e9) == (pytest.approx(1.0), "bytes")


def test_per_run_counts_valid_rows_in_padded_runs():
    mask = torch.tensor([True, False, True, True, True])
    assert rl.per_run(mask, 2).tolist() == [1.0, 2.0, 1.0]


CLOUD = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 2.0, 0.0]])


@pytest.mark.parametrize("qmask,keep,pairs", [
    ([True, True, True], None, 9),      # K1: every valid pair
    ([True, True, False], None, 6),
    ([True, True, True], [[True]], 9),  # K2: the one kept (block, tile)
    ([True, True, True], [[False]], 0),
])
def test_knn_bound_on_three_points(qmask, keep, pairs):
    """2F + 2 = 8 flops a pair at F = 3; each valid row's F + 1 floats and
    mask byte (17 bytes), and 8 bytes an output entry (3 rows x k = 2)."""
    qm = torch.tensor(qmask)
    dbm = torch.ones(3, dtype=torch.bool)
    kp = None if keep is None else torch.tensor(keep)
    got = rl.knn_bound(CLOUD, qm, CLOUD, dbm, 2, keep=kp)
    nbytes = (int(qm.sum()) + 3) * 17 + 3 * 2 * 8
    t_ops, t_bytes = pairs * 8 * MS_PER_FLOP, nbytes * MS_PER_BYTE
    assert got[0] == pytest.approx(max(t_ops, t_bytes), rel=1e-12)
    assert got[1] == ("operations" if t_ops >= t_bytes else "bytes")


LANES = torch.tensor([[[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [3.0, 0.0, 0.0]],
                      [[0.0, 0.0, 0.0], [0.0, 0.9, 0.0], [0.0, 0.0, 2.0]]])
QM = torch.tensor([[True, True, True], [True, True, False]])
DBM = torch.tensor([[True, True, True], [True, False, True]])


@pytest.mark.parametrize("pair_flops,hit_flops,flops,by", [
    # lane 0: 9 pairs, 5 within 1 m (3 self pairs, 0-1 both ways); lane 1:
    # queries 0, 1 against db rows 0, 2: 4 pairs, 2 within 1 m
    (9, 10, 9 * 13 + 10 * 7, "bytes"),
    (0, 1000, 1000 * 7, "operations"),
])
def test_radius_bound_on_two_lanes(pair_flops, hit_flops, flops, by):
    """Per lane: pair_flops for each (valid query, valid db row) pair,
    hit_flops for each within the radius; 12 bytes in a valid query row,
    4 out for every row of both lanes."""
    got = rl.radius_bound(LANES, QM, DBM, (1.0,), pair_flops, (hit_flops,),
                          12, 4)
    t_ops, t_bytes = flops * MS_PER_FLOP, (5 * 12 + 6 * 4) * MS_PER_BYTE
    assert got == (pytest.approx(max(t_ops, t_bytes), rel=1e-12), by)


# ---------------------------------------------------------------------------
# the stage budgets, the census and the report (tools/roofline.py's counts)
# ---------------------------------------------------------------------------

def _jax_cloud(offset=0.0):
    """tests/test_roofline.py's cloud: 2,000 seeded points in a 30 m cube,
    padded to 3,072 rows, moved by ``offset`` metres on every axis."""
    import numpy as np

    rng = np.random.default_rng(3)
    p = np.concatenate([rng.uniform(-15, 15, (2000, 3)).astype(np.float32),
                        np.zeros((1072, 3), np.float32)])
    return p + np.float32(offset), np.arange(len(p)) < 2000


def _slab():
    """2,000 seeded points in a 10 x 10 x 2 m slab (about 30 neighbours
    within 0.9 m, so nearly every point has a normal), padded to 2,500."""
    import numpy as np

    rng = np.random.default_rng(4)
    p = np.concatenate([rng.uniform([-5, -5, -1], [5, 5, 1],
                                    (2000, 3)).astype(np.float32),
                        np.zeros((500, 3), np.float32)])
    return p, np.arange(len(p)) < 2000


@pytest.mark.parametrize("offset", [0.0, 500.0])
def test_survivors_never_prune_real_pairs(offset):
    """Every (block, tile) of the Morton-sorted cloud that holds a pair
    within 1.5 m (exact distances) is kept, at the origin and 500 m from it
    (where the fp32 expansion's error is largest)."""
    from fast_lio_sam_qn_tpu_torch.ops import knn_cuda

    p, m = _jax_cloud(offset)
    keep = rl.block_tile_survivors(p, m, 1.5)
    pt, mt = torch.from_numpy(p), torch.from_numpy(m)
    order = knn_cuda.morton_order(pt, mt)
    ps, ms = pt[order].double(), mt[order]
    near = (torch.cdist(ps, ps) ** 2 <= 1.5 ** 2) & ms[:, None] & ms[None]
    b, t = torch.nonzero(near, as_tuple=True)
    blocks, tiles = b // 32, t // 32
    assert len(blocks) > 2000
    assert bool(keep[blocks, tiles].all())
    assert keep.shape == (96, 96) and 0 < int(keep.sum()) < 96 * 96


@pytest.mark.parametrize("offset", [0.0, 500.0])
def test_survivors_contain_jax_survivors(offset):
    """At the JAX package's widths (query blocks of 128 rows, db tiles of
    512) the port's keep matrix keeps every (block, tile) that the JAX
    package's ``_block_tile_survivors`` keeps: the port's rule only adds
    slack (PRUNE_SLACK and the expansion's error term).  On this cloud it
    keeps the same 61 of 144 at both offsets, 0 more; at the port's own
    32-row widths the slack shows 500 m out (1,603 kept against 1,489 at
    the origin)."""
    import numpy as np

    from fast_lio_sam_qn_tpu.tools.roofline import _block_tile_survivors

    p, m = _jax_cloud(offset)
    want = np.asarray(_block_tile_survivors(p, m, 1.5))
    got = rl.block_tile_survivors(p, m, 1.5, block=128, tile=512).numpy()
    assert got.shape == want.shape == (24, 6)
    assert not (want & ~got).any()
    print(f"offset {offset}: JAX keeps {want.sum()}, the port "
          f"{got.sum()} ({(got & ~want).sum()} more)")
    assert want.sum() > 0


@pytest.mark.parametrize("stage", rl.STAGES)
def test_stage_budget_sanity(stage):
    """0 < surviving <= total, a positive bound, the pair bound no larger
    than the all-pairs bound, both equal to ``radius_bound`` called with the
    constants of the kernel table in ``chip_smoke.py``, and the pruned
    kernel's own bound above the pair bound (it tests every row pair of a
    kept (block, tile))."""
    from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream as fs

    p, m = _slab()
    b = rl.stage_budget(p, m, stage)
    assert 0 < b["surviving"] <= b["total"]
    assert 0.0 < b["prune_keep"] <= 1.0 and b["bound_ms"] > 0.0
    assert b["pair_bound_ms"] <= b["all_pairs_bound_ms"]
    assert b["pair_bound_ms"] <= b["bound_ms"]
    pt, mt = torch.from_numpy(p), torch.from_numpy(m)
    mom = fs.moments_plain(pt, mt, 0.9, 0.6)
    _, nv, _, _ = fs.moments_to_normals_covs(mom, pt, mt, None)
    assert int(nv.sum()) > 1900
    by_hand = {"moments": (mt, (0.9, 0.6), (16, 10), 13, 80),
               "spfh": (mt & nv, (1.5,), (75,), 26, 136),
               "agg": (mt & nv, (1.5,), (68,), 146, 136)}[stage]
    dbm, radii, hit, row_in, row_out = by_hand
    for key, pair_flops in (("pair_bound_ms", 0), ("all_pairs_bound_ms", 9)):
        want = rl.radius_bound(pt, mt, dbm, radii, pair_flops, hit, row_in,
                               row_out)[0]
        assert b[key] == pytest.approx(want, rel=1e-12)


def test_gicp_nn_budget_equals_knn_bound():
    """One iteration, unpruned: ``knn_bound``'s count on a hand-made pair
    of 5 and 7 valid points at k = 1 (8 flops a pair; 17 bytes a valid row,
    8 an output row); three iterations at half the pairs scale as said."""
    q, db = torch.rand(5, 3), torch.rand(7, 3)
    ones = torch.ones(7, dtype=torch.bool)
    want = rl.knn_bound(q, ones[:5], db, ones, 1)
    one = rl.gicp_nn_budget(5, 7, iters=1)
    assert (one["bound_ms"], one["bound_by"]) == (
        pytest.approx(want[0], rel=1e-12), want[1])
    three = rl.gicp_nn_budget(5, 7, iters=3, keep=0.5)
    assert three["gflop"] == pytest.approx(3 * 0.5 * 5 * 7 * 8 / 1e9)
    assert three["mb"] == pytest.approx(3 * (12 * 17 + 5 * 8) / 1e6)


def test_traced_ops_counts_new_tensors():
    """A product and a sum are two ops (a view is none): each reads its
    two 4-byte inputs and writes 4 bytes."""
    def fn(a, b):
        return (a * b + a)[..., 0]

    assert rl.traced_ops(fn, torch.ones(1, 1), torch.ones(1, 1)) == (2, 24)


def test_insert_budget_totals_are_row_sums():
    """The census's totals are the sums of its rows; its HBM bound is its
    bytes at the HBM rate; both plane fits (own and hood) are counted; the
    claim runs twice (the points, then the halo fan)."""
    c = rl.insert_budget()
    assert c["table_ops"] == sum(r["ops"] for r in c["rows"])
    assert c["bytes"] == sum(r["bytes"] for r in c["rows"])
    assert c["hbm_bound_ms"] == pytest.approx(c["bytes"] * MS_PER_BYTE)
    fits = [r for r in c["rows"] if "Jacobi" in r["stage"]]
    assert [r["rows"] for r in fits] == [32768, 8192]
    # each fit: its elementwise ops, the eigensolve one launch of K6
    assert fits[0]["ops"] == fits[1]["ops"] > 1
    assert sum("claim rounds" in r["stage"] for r in c["rows"]) == 2
    assert all(r["ops"] > 0 and r["bytes"] > 0 for r in c["rows"])


def test_insert_budget_reads_profile_insert_scale():
    """The census counts ``tools/profile_insert.py``'s insert: its N points
    in the locate (one probe row each), its hood cap over the 27-voxel
    hood (a centre row, the neighbour rows and their probes) and its halo
    cap in the fan (6 neighbours a source)."""
    from fast_lio_sam_qn_tpu_torch.ops.hashgrid import NUM_PROBES
    from fast_lio_sam_qn_tpu_torch.tools import profile_insert as pi

    lines = []
    c = rl.insert_budget(say=lines.append)
    rows = {r["stage"]: r for r in c["rows"]}
    assert rows["locate"]["rows"] == pi.N * NUM_PROBES
    h = pi.HOOD_CAP
    assert rows["refit hood27 gathers"]["rows"] == (2 * h + 27 * h
                                                    + 27 * h * NUM_PROBES)
    assert rows["halo fan hint lookup"]["rows"] == 7 * pi.HALO_CAP
    assert lines[0] == (f"surfel insert census ({pi.N} points, {pi.TABLE} "
                        f"slots, hood27 cap {h}, halo cap {pi.HALO_CAP}):")
    assert len(lines) == len(c["rows"]) + 2


def test_report_on_the_cpu_has_the_counts_only():
    """``report(cpu)`` runs on the bench pair and returns its 6 rows (2
    clouds x 3 stages) without measured columns."""
    lines = []
    rows = rl.report(torch.device("cpu"), say=lines.append)
    assert [(r["cloud"], r["stage"]) for r in rows] == [
        (c, s) for c in ("src", "dst") for s in rl.STAGES]
    assert all("measured_ms" not in r for r in rows)
    assert all(r["bound_ms"] > r["pair_bound_ms"] > 0 for r in rows)
    assert any("surfel insert census" in line for line in lines)


def test_measure_kernel_ms_refuses_the_cpu():
    p, m = _slab()
    with pytest.raises(ValueError, match="on the card"):
        rl.measure_kernel_ms("moments", p, m, device="cpu")


def test_main_needs_the_card_unless_told_cpu(monkeypatch, capsys):
    """``python -m ...tools.roofline`` defaults to the card: without one it
    exits 1 with a message and prints no row."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert rl.main([]) == 1
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and "stage" not in out.out
