"""The point-map cell ``kitti-hdl64-point.drive`` at a small width on the
CPU (``small.py``'s: 16,384 rays, 2,048 rows, a 2^14-slot table that the
window fills past half): one result line, correct against the reference
at ``--trace`` 0 and 1 with the new per-layer metric of the association's
spans, and on a 2^13-slot table that every scan finds loaded; not correct
with the timed path broken underneath (a plane search skipped, one map
point moved 5 cm, the pose moved 5 cm) or, on the loaded table, with the
reference's claim model off."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slam_bench import harness as H  # noqa: E402
from slam_bench.tests.small import overrides, run_module  # noqa: E402

CELL = "kitti-hdl64-point.drive"


def run_cell(capsys, trace: int, table: int | None = None,
             seed: int = 4294967311, seconds: float = 3.0):
    """``small.run_cell`` of the cell, on a table of ``table`` slots if
    given."""
    ov = overrides(CELL)
    if table:
        ov["config"]["lio"] = dict(ov["config"]["lio"], map_table_size=table)
    rc = run_module().main(
        ["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)], device="cpu", overrides=ov)
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), err


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_prints_one_correct_result_line(capsys, trace):
    rc, res, err = run_cell(capsys, trace)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(H.load_cell(CELL)[0]["limits"])
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in H.cell_metrics(CELL, kind)}
    assert set(res["metrics"]) <= allowed
    if trace:
        # on the CPU the device metrics read nothing; the spans do
        assert res["metrics"]["plane_assoc_ms"]["value"] > 0
        assert "plane_assoc_roofline_pct" not in res["metrics"]
    else:
        assert set(res["metrics"]) == allowed
    assert "slots occupied" in err and "left unplaced" in err


def _skipped_search(monkeypatch):
    from fast_lio_sam_qn_tpu_torch.ops import ieskf

    orig, calls = ieskf.update, []

    def update(*args, **kwargs):
        search = ieskf._plane_correspondences
        first = []

        def held(*a, **k):
            if len(first) == 1 and not calls:
                calls.append(1)
                return first[0]
            out = search(*a, **k)
            first.append(out)
            return out
        monkeypatch.setattr(ieskf, "_plane_correspondences", held)
        try:
            return orig(*args, **kwargs)
        finally:
            monkeypatch.setattr(ieskf, "_plane_correspondences", search)
            calls.clear()
    monkeypatch.setattr(ieskf, "update", update)


def _moved_point(monkeypatch):
    from fast_lio_sam_qn_tpu_torch.ops import hashgrid

    orig = hashgrid.insert

    def insert(grid, points, mask):
        out = orig(grid, points, mask)
        slot = int(torch.nonzero(out.occupied)[0])
        moved = out.points.clone()
        moved[slot, 0] += 0.05
        return out._replace(points=moved)
    monkeypatch.setattr(hashgrid, "insert", insert)


def _moved_pose(monkeypatch):
    from fast_lio_sam_qn_tpu_torch.models.lio import LIO

    orig = LIO.process_scan

    def process_scan(self, state, *args, **kwargs):
        new, res = orig(self, state, *args, **kwargs)
        nav = new.nav._replace(p=new.nav.p + 0.05)
        return new._replace(nav=nav), res
    monkeypatch.setattr(LIO, "process_scan", process_scan)


def _claim_off(monkeypatch):
    from slam_bench.reference import geometry as G
    from slam_bench.reference import points

    def claim(m, keys, bids):
        return G.probe_slots(G.unpack(keys), m.table)[:, 0], \
            torch.ones_like(bids, dtype=torch.bool)
    monkeypatch.setattr(points, "claim", claim)


@pytest.mark.parametrize("fault", [_skipped_search, _moved_point,
                                   _moved_pose, _claim_off],
                         ids=lambda f: f.__name__[1:])
def test_a_fault_is_not_correct(capsys, monkeypatch, fault):
    """The claim model off on a 2^13-slot table, which every sampled scan
    finds loaded (at 2^14 a sampled scan may place all its voxels)."""
    fault(monkeypatch)
    rc, res, err = run_cell(capsys, 0,
                            table=1 << 13 if fault is _claim_off else None)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res["checks"]


def test_the_cell_is_correct_on_a_loaded_table(capsys):
    rc, res, err = run_cell(capsys, 0, table=1 << 13)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res["checks"]
