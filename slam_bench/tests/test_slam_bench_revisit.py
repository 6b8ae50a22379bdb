"""The revisit cell at a small width on the CPU: one result line, correct
against the references, the new per-layer metrics in a traced run, and
not correct with the registration or the graph broken underneath (the
coarse transform moved by 5 cm, one bin of every descriptor zeroed, one
valid descriptor row of each cloud zeroed, a committed loop factor
dropped).

The small width is ``small.py``'s, with what a revisit needs to come
round within a few seconds of data on the CPU: a 12 m circle (a 10.8 s
lap), candidates older than 10.3 s (the first lies ~3 m back along the
lap, so the few scans of a CPU window reach the overlap), the cell's 1.5 m
keyframes and clouds that the keyframe caps do not cut."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slam_bench import harness as H  # noqa: E402
from slam_bench.tests.small import overrides, run_module  # noqa: E402

CELL = "mulran-os1-64.revisit-batch4"
NEW = {"loop_tick_ms", "reg_fpfh_ms", "reg_quatro_ms", "reg_gicp_ms",
       "reg_lanes_per_tick"}


def _overrides():
    ov = overrides(CELL)
    ov["workload"].update({"route": {"radius": 12.0}, "setup_scans_max": 200,
                           "stream_scans": 160})
    pipe = ov["config"]["pipeline"]
    pipe["keyframe_threshold"] = 1.5
    pipe["caps"] = dict(pipe["caps"], keyframe_points=4096, src_points=4096,
                        dst_points=4096)
    pipe["loop"] = {"loop_detection_timediff_threshold": 10.3}
    return ov


def _run(capsys, trace: int, seed: int = 4294967311, seconds: float = 9.0):
    rc = run_module().main(
        ["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)], device="cpu", overrides=_overrides())
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), err


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_prints_one_correct_result_line(capsys, trace):
    rc, res, err = _run(capsys, trace)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(
        H.load_cell(CELL)[0]["limits"])
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in H.cell_metrics(CELL, kind)}
    assert set(res["metrics"]) <= allowed
    if trace:
        assert NEW <= set(res["metrics"]), res["metrics"]
        assert res["metrics"]["reg_lanes_per_tick"]["value"] > 1
    else:
        assert set(res["metrics"]) == allowed
    assert "loop factors committed" in err and "5-step solves" in err


def _moved_coarse(monkeypatch):
    from fast_lio_sam_qn_tpu_torch.ops import quatro

    orig = quatro.solve

    def solve(*args, **kwargs):
        out = orig(*args, **kwargs)
        T = out.transform.clone()
        T[0, 3] += 0.05
        return out._replace(transform=T)
    monkeypatch.setattr(quatro, "solve", solve)


def _zeroed_bin(monkeypatch):
    from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream

    for name in ("fpfh_radius", "fpfh_radius_batched"):
        orig = getattr(fpfh_stream, name)

        def zeroed(*args, _orig=orig, **kwargs):
            desc, valid, geo = _orig(*args, **kwargs)
            desc = desc.clone()
            desc[..., 16] = 0.0       # phi's middle bin: in-plane pairs
            return desc, valid, geo
        monkeypatch.setattr(fpfh_stream, name, zeroed)


def _zeroed_row(monkeypatch):
    from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream

    for name in ("fpfh_radius", "fpfh_radius_batched"):
        orig = getattr(fpfh_stream, name)

        def zeroed(*args, _orig=orig, **kwargs):
            desc, valid, geo = _orig(*args, **kwargs)
            desc = desc.clone()
            lanes = desc[None] if desc.dim() == 2 else desc
            for lane, ok in zip(lanes, valid.reshape(lanes.shape[:2])):
                lane[int(ok.nonzero()[0])] = 0.0   # the first valid row
            return desc, valid, geo
        monkeypatch.setattr(fpfh_stream, name, zeroed)


def _dropped_factor(monkeypatch):
    from fast_lio_sam_qn_tpu_torch.ops import pgo

    orig = pgo.add_loop_factor
    calls = []

    def add_loop_factor(graph, *args, **kwargs):
        calls.append(1)
        if len(calls) == 3:          # the window's first commit
            return graph
        return orig(graph, *args, **kwargs)
    monkeypatch.setattr(pgo, "add_loop_factor", add_loop_factor)


@pytest.mark.parametrize("fault", [_moved_coarse, _zeroed_bin,
                                   _zeroed_row, _dropped_factor],
                         ids=lambda f: f.__name__[1:])
def test_a_broken_registration_or_graph_is_not_correct(capsys, monkeypatch,
                                                       fault):
    fault(monkeypatch)
    rc, res, err = _run(capsys, 0)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res["checks"]
