"""The benchmark's copy of the FPFH kernels' least time
(``slam_bench/roofline_fpfh.py``) held to the port's
``tools/roofline.py``: the same peaks, radii and per-pair work, and the
same bound of every stage on the same clouds, batched or not."""
import pytest
import torch

from fast_lio_sam_qn_tpu_torch.tools import roofline
from slam_bench import roofline_fpfh as copy


def test_constants_are_the_originals():
    assert (copy.FP32_FLOPS, copy.HBM_BYTES_S) == (roofline.FP32_FLOPS,
                                                   roofline.HBM_BYTES_S)
    assert copy.STAGES == roofline.STAGES
    assert copy.STAGE_RADII == roofline.STAGE_RADII
    assert copy.PAIR_WORK == roofline.PAIR_WORK


def _clouds(b=2, n=600, seed=3):
    g = torch.Generator().manual_seed(seed)
    p = torch.rand(b, n, 3, generator=g) * torch.tensor([6.0, 6.0, 1.0])
    m = torch.rand(b, n, generator=g) > 0.15
    nv = m & (torch.rand(b, n, generator=g) > 0.1)
    return p, m, nv


@pytest.mark.parametrize("stage", ["moments", "spfh", "agg"])
@pytest.mark.parametrize("pair_flops", [0, 9])
def test_stage_bounds_are_the_originals(stage, pair_flops):
    p, m, nv = _clouds()
    dbm = m if stage == "moments" else m & nv
    for args in ((p, m, dbm), (p[0], m[0], dbm[0])):
        assert copy.stage_pair_bound(stage, *args, pair_flops) == \
            roofline.stage_pair_bound(stage, *args, pair_flops)


def test_fpfh_bound_sums_the_three_stages():
    p, m, nv = _clouds()
    want = sum(roofline.stage_pair_bound(
        s, p, m, m if s == "moments" else m & nv)[0] for s in roofline.STAGES)
    assert copy.fpfh_bound_ms(p, m, nv) == pytest.approx(want, rel=1e-12)
    assert want > 0
