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
