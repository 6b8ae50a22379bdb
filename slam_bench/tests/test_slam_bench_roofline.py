"""The benchmark's copy of the roofline counts against the port's
``tools/roofline.py``: the surfel insert's census."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slam_bench import roofline  # noqa: E402


def test_insert_census_equals_the_tool():
    from fast_lio_sam_qn_tpu_torch.ops.hashgrid import NUM_PROBES
    from fast_lio_sam_qn_tpu_torch.tools import profile_insert as pi
    from fast_lio_sam_qn_tpu_torch.tools import roofline as tool

    assert roofline.NUM_PROBES == NUM_PROBES
    assert (roofline.FIT_OPS, roofline.FIT_ROW_BYTES) == \
        tool._plane_fit_ops()
    want = tool.insert_budget()
    got = roofline.insert_budget(pi.N, pi.TABLE, pi.HOOD_CAP, pi.HALO_CAP,
                                 27)
    assert got["bytes"] == want["bytes"]
    assert got["table_ops"] == want["table_ops"]
    assert got["hbm_bound_ms"] == pytest.approx(want["hbm_bound_ms"],
                                                rel=1e-12)

