"""The CPU tests' small widths: every cell at a few thousand rays, small
maps and capacities, a short stream, and two sampled runs of scans; a
keyframe at every scan, so that a short window on the CPU has one to
compare."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent

LIO = {"max_points_per_scan": 2048, "map_table_size": 1 << 14,
       "surfel_hood_cap": 1024, "surfel_halo_cap": 512}
CAPS = {"max_keyframes": 64, "max_loop_factors": 16, "keyframe_points": 1024,
        "src_points": 2048, "dst_points": 4096}
WORK = {"stream_scans": 14, "warm_scans": 3, "samples": 2,
        "profile_scans": 2}


def overrides(cell: str) -> dict:
    """Small widths for ``cell``: only keys its workload file has."""
    with open(BENCH / "workloads" / f"{cell}.json", encoding="utf-8") as fh:
        base = json.load(fh)
    return {"config": {"sensor": {"az_steps": 256}, "lio": LIO,
                       "pipeline": {"caps": CAPS,
                                    "keyframe_threshold": 0.5}},
            "workload": {k: v for k, v in WORK.items() if k in base}}


def run_module():
    """``slam_bench/run.py`` as a module (it is a script, not a package
    member)."""
    spec = importlib.util.spec_from_file_location("slam_bench_run",
                                                  BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(capsys, cell: str, trace: int, seed: int = 4294967311,
             seconds: float = 3.0):
    """One small run of ``cell`` on the CPU: (exit code, the last stdout
    line parsed, stderr)."""
    rc = run_module().main(
        ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)], device="cpu", overrides=overrides(cell))
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), err
