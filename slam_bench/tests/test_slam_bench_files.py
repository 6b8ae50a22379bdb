"""The benchmark's files: every configuration and workload parses and
agrees with BENCHMARK.json, names and units keep to their characters,
each per-layer reader declares what BENCHMARK.json says of it, and a new
cell or metric is picked up from new files alone."""
from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slam_bench import harness as H  # noqa: E402

BENCH = H.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names), names
    metric_names = [m["name"] for m in BENCH["end_to_end"]
                    + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file(cfg):
    path = ROOT / cfg["file"]
    spec = json.loads(path.read_text())
    assert spec["name"] == cfg["name"] == path.stem
    assert set(cfg["reduced"]) == set(spec["reduced"])
    for block in ("sensor", "lio", "pipeline", "assumed"):
        assert block in spec
    from fast_lio_sam_qn_tpu_torch.utils import config as prog_config

    pc = H.pipeline_config(prog_config, spec)
    assert pc.lio.max_points_per_scan == spec["lio"]["max_points_per_scan"]
    assert pc.caps.max_keyframes == spec["pipeline"]["caps"]["max_keyframes"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_file(cell):
    work, cfg = H.load_cell(cell["name"])
    assert work["config"] == cell["config"] == cfg["name"]
    assert work["driver"] == "stream"
    assert work["limits"] and all(v > 0 for v in work["limits"].values())
    e2e = [m["name"] for m in H.cell_metrics(cell["name"], "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert H.cell_metrics(cell["name"], "per_layer")


def test_readers_agree_with_benchmark_json():
    readers = H.readers()
    assert set(readers) == {m["name"] for m in BENCH["per_layer"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        r = readers[m["name"]]
        assert (r.LAYER, r.UNIT, r.MOVES, r.WORKLOADS) == (
            m["layer"], m["unit"], m["moves"], m["workloads"])
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        layers.setdefault(m["layer"], m["layer"])


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    """A copy of the benchmark gains a cell (a workload file), a metric (a
    reader) and their BENCHMARK.json entries; the harness finds both, and
    no file that was there changes."""
    shutil.copytree(ROOT / "slam_bench", tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "slam_bench")
    bench = json.loads(json.dumps(BENCH))
    base = json.loads((ROOT / "slam_bench" / "workloads"
                       / "kitti-hdl64.drive.json").read_text())
    (tmp_path / "slam_bench" / "workloads" / "kitti-hdl64.slow.json"
     ).write_text(json.dumps(dict(base, route=dict(base["route"],
                                                   speed=4.0))))
    (tmp_path / "slam_bench" / "metrics" / "deskew_ms.py").write_text(
        'LAYER = "LIO stages"\nUNIT = "ms"\nMOVES = "scans_per_s"\n'
        'WORKLOADS = ["kitti-hdl64.slow"]\n\n\ndef read(trace):\n'
        '    ms = trace.spans.get("deskew")\n'
        '    return sum(ms) / len(ms) if ms else None\n')
    bench["workloads"].append(dict(bench["workloads"][0],
                                   name="kitti-hdl64.slow", traffic="slow"))
    bench["per_layer"].append({"name": "deskew_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "LIO stages", "moves": "scans_per_s",
                               "workloads": ["kitti-hdl64.slow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from slam_bench import harness as H;"
        "w, c = H.load_cell('kitti-hdl64.slow');"
        "assert w['route']['speed'] == 4.0 and c['name'] == 'kitti-hdl64';"
        "tr = H.Trace({'deskew': [2.0, 4.0]}, {}, None);"
        "m = H.read_per_layer('kitti-hdl64.slow', tr);"
        "assert m['deskew_ms']['value'] == 3.0, m;"
        "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr
    after = _digest(tmp_path / "slam_bench")
    assert {k: v for k, v in after.items() if k in before} == before
