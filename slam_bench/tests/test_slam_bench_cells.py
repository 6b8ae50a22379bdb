"""Each cell at a small width on the CPU: one result line with the
contract's keys, correct against the reference, and not correct with the
timed path broken underneath (a state left unchanged, half of the points
left out of the map, a pose altered where it is produced)."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slam_bench import harness as H  # noqa: E402
from slam_bench.tests.small import run_cell  # noqa: E402

CELLS = [w["name"] for w in H.benchmark()["workloads"]]
STREAM = [c for c in CELLS if H.load_cell(c)[0]["driver"] == "stream"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_one_result_line(capsys, cell, trace):
    rc, res, err = run_cell(capsys, cell, trace)
    assert rc == 0, err[-3000:]
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in H.cell_metrics(cell, kind)}
    assert set(res["metrics"]) <= allowed
    if not trace:
        assert set(res["metrics"]) == allowed
        assert res["metrics"]["setup_s"]["value"] > 0
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in res["checks"].items():
        assert f"check {name}:" in err
    assert err.rstrip().splitlines()[-1].startswith("check ")


def _unchanged_state(monkeypatch):
    from fast_lio_sam_qn_tpu_torch.models.lio import LIO

    orig = LIO.process_scan

    def process_scan(self, state, *args, **kwargs):
        new, res = orig(self, state, *args, **kwargs)
        return (state, res) if state.scans > 0 else (new, res)
    monkeypatch.setattr(LIO, "process_scan", process_scan)


def _half_the_points(monkeypatch):
    from fast_lio_sam_qn_tpu_torch.ops import surfel_map

    orig = surfel_map.insert

    def insert(grid, points, mask, **kwargs):
        half = torch.arange(mask.shape[0], device=mask.device) % 2 == 0
        return orig(grid, points, mask & half, **kwargs)
    monkeypatch.setattr(surfel_map, "insert", insert)


def _moved_pose(monkeypatch):
    from fast_lio_sam_qn_tpu_torch.models.lio import LIO

    orig = LIO.process_scan

    def process_scan(self, state, *args, **kwargs):
        new, res = orig(self, state, *args, **kwargs)
        nav = new.nav._replace(p=new.nav.p + 0.05)
        return new._replace(nav=nav), res
    monkeypatch.setattr(LIO, "process_scan", process_scan)


FAULTS = [(c, f) for c in STREAM
          for f in (_unchanged_state, _half_the_points, _moved_pose)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(capsys, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, res, err = run_cell(capsys, cell, 0)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res["checks"]
