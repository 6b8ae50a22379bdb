"""The control of each cell, on the card: the reference put in the
program's place at every compared step and computed with TF32 matrix
products, the precision below the configurations' float32, has to come out
not correct on every seed.  It needs a CUDA card (TF32 exists only there)
and skips without one; on the card:

    python3 -m pytest slam_bench/tests/test_slam_bench_control.py -q
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slam_bench import harness as H  # noqa: E402

CELLS = [w["name"] for w in H.benchmark()["workloads"]]
SEEDS = (2147483701, 3221225473, 4294967291)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 products need a CUDA card")
    for seed in SEEDS:
        out = subprocess.run(
            [sys.executable, "slam_bench/run.py", "--workload", cell,
             "--seed", str(seed), "--seconds", "6", "--trace", "0",
             "--control", "1"], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"] is False, (seed, res["checks"])
