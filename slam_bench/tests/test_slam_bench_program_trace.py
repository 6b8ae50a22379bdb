"""The program's own trace of a drive (``program_trace.py``) at a small
width on the CPU, its attribution of idle time and host reads to the
innermost program span, and the readers of the two per-layer metrics that
read the program's ``scan`` spans on the profiler's trace."""
from __future__ import annotations

import math
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slam_bench import harness as H  # noqa: E402
from slam_bench import program_trace as PT  # noqa: E402
from slam_bench.tests.small import overrides  # noqa: E402

CELL = "kitti-hdl64.drive"


def _rec(name, parent, t0, t1):
    return SimpleNamespace(name=name, parent=parent, t0_ns=t0, t1_ns=t1)


# feed [0, 100] > real [10, 30] > sync.pull [20, 30]; feed > opt [40, 90]
RECS = [_rec("feed", -1, 0, 100), _rec("real", 0, 10, 30),
        _rec("sync.pull", 1, 20, 30), _rec("opt", 0, 40, 90)]


@pytest.mark.parametrize("t,want", [(5, 0), (15, 1), (25, 2), (35, 0),
                                    (50, 3), (95, 0), (150, None)])
def test_innermost_open_record(t, want):
    starts = [r.t0_ns for r in RECS]
    assert PT.innermost(RECS, starts, t) == want


def test_idle_time_goes_to_the_innermost_span():
    # records in ns, the trace in us: offset 0, one device op at 45-80 us
    recs = [_rec(r.name, r.parent, r.t0_ns * 1000, r.t1_ns * 1000)
            for r in RECS]
    tr = H.Trace({}, {}, dict(ops=[("k", 45.0, 80.0, 41.0)], spans=[],
                              host=[], window=(0.0, 120.0)))
    got = PT.idle_by_span(tr, recs, 0.0)
    want = {"feed": 0.010 + 0.010 + 0.010, "real": 0.010,
            "real>sync.pull": 0.010, "opt": 0.005 + 0.010,
            "no span": 0.020}
    assert set(got) == set(want)
    assert all(math.isclose(got[k], v) for k, v in want.items()), got


def test_reads_are_named_by_their_span():
    reads = PT.Reads(False)
    reads.seen = [(25, "/x/pipeline.py:60"), (50, "/x/se3.py:132"),
                  (150, "/x/program_trace.py:9")]
    assert reads.by_span([RECS]) == {
        "named": {"real>sync.pull": 1}, "unnamed": {"opt @ se3.py:132": 1},
        "outside": {"program_trace.py:9": 1}}


def test_readers_of_the_scan_spans():
    mods = H.readers()
    prof = dict(ops=[("a", 0.0, 1000.0, 5.0), ("b", 1000.0, 3000.0, 20.0),
                     ("c", 3000.0, 3500.0, 150.0), ("d", 4000.0, 4100.0,
                                                    260.0)],
                spans=[("scan", 0.0, 100.0), ("scan", 200.0, 300.0)],
                host=[], window=(0.0, 5000.0))
    tr = H.Trace({"lio": [9.0]}, {}, prof)
    assert mods["lio_launches"].read(tr) == 1.5
    assert mods["lio_device_ms"].read(tr) == pytest.approx(1.55)
    parent = H.Trace({"lio": [9.0]}, {}, dict(prof, spans=[]))
    assert mods["lio_launches"].read(parent) is None
    assert mods["lio_device_ms"].read(parent) is None
    assert mods["lio_device_ms"].read(H.Trace({}, {}, None)) is None


@pytest.fixture(scope="module")
def traced():
    return PT.run(CELL, 4294967311, 3.0, 2, "cpu", overrides(CELL))


def test_a_small_traced_run(traced):
    m = traced["metrics"]
    assert traced["scans"] > 0 and traced["scans_per_s"] > 0
    assert m["lio_host_ms"] > 0 and math.isfinite(m["lio_host_ms"])
    # every feed pulls once; a keyframe at every small scan reads more
    assert m["host_syncs_per_scan"] >= 1
    assert 0 <= m["sync_wait_ms"] < math.inf
    assert 0 < m["pgo_pcg_iters"] <= 128
    # no device operation on the CPU
    assert m["lio_launches"] == 0 and m["lio_device_ms"] is None
    assert traced["syncs_by_site"]["sync.pull"] >= 1
    assert {"scan", "feed", "real", "opt"} <= set(traced["self_host_ms"])
    assert traced["anchor_gap_us"] < 1e3
    assert traced["idle_by_span"] and traced["reads"] is None
    assert set(traced["span_us"]) == {"span", "sync_span",
                                      "site_without_span", "records_read"}


def test_small_runs_without_the_profiler_window(monkeypatch):
    monkeypatch.setattr(PT, "BLOCK", 2)
    spans = PT.run(CELL, 7, 0.5, 1, "cpu", overrides(CELL))
    assert spans["scans"] >= 4, spans["scans"]
    assert spans["scans_per_s_tracer_on"] > 0
    assert spans["scans_per_s_tracer_off"] > 0
    assert spans["metrics"]["host_syncs_per_scan"] >= 1
    assert "lio_launches" not in spans["metrics"]
    assert "idle_by_span" not in spans and "span_us" in spans
    off = PT.run(CELL, 7, 1.0, 0, "cpu", overrides(CELL))
    assert off["scans_per_s"] > 0 and "metrics" not in off
