"""The pose-graph solve alone across graph sizes — port of
fast_lio_sam_qn_tpu/tools/profile_pgo.py.

The pipeline runs ``pgo.optimize`` on every keyframe (the reference's
isam.update, x2, and x5 after a loop: fast_lio_sam_qn.cpp:156-165), so
its cost over node count is the scaling story of the per-scan budget.
This tool times the solver on the drifted multi-lap circle of
``tools/pgo_graph.py`` (1.6 m keyframe spacing, the reference's noise
vectors, a loop factor every 4th node across laps) at 128 / 512 / 1024
nodes, 2 and 5 Gauss-Newton steps, 64-iteration PCG, in two regimes:

- cold: every solve restarts from the dead-reckoned initial, every loop
  residual live (the first solve after a large loop closure);
- warm: every solve continues from the previous one's optimum (the
  per-keyframe steady state; PCG stops early on its residual test).

Times are CUDA events around one solve, the median of ``--reps``.  The
convergence check of the JAX tool is kept: a chain of 20 solves from the
cold initial must cut the ATE against the truth below 0.6 of the
initial's (block-Jacobi PCG moves a correction ~64 hops a solve, so one
solve cannot cross a 1,024-node chain: the pipeline converges over its
per-keyframe solves).

Usage (from the repository root; the card unless ``--device cpu``):

    python3 -m fast_lio_sam_qn_tpu_torch.tools.profile_pgo [--reps 10] \
        [--sizes 128 512 1024] [--out chiprun_out/profile_pgo.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..ops import pgo
from .pgo_graph import build_graph

PRIOR_VAR = (1e-4, 1e-4, 1e-4, 1e-2, 1e-2, 1e-2)
PCG_ITERS = 64
CHAIN = 20


def ate(graph, gt) -> float:
    """Position RMSE of the graph's first len(gt) poses against gt."""
    p = graph.poses[:len(gt), :3, 3].double().cpu().numpy()
    return float(np.sqrt(np.mean(np.sum((p - gt[:, :3, 3]) ** 2, -1))))


def solve(graph, gn: int):
    return pgo.optimize(graph, PRIOR_VAR, PRIOR_VAR, gn_iters=gn,
                        pcg_iters=PCG_ITERS)


def chain(graph, gn: int, n: int = CHAIN):
    """``n`` solves, each from the previous one's result."""
    for _ in range(n):
        graph = solve(graph, gn)
    return graph


def converges(n_nodes: int, gn: int, device) -> tuple[float, float]:
    """(ATE of the cold initial, ATE after a chain of CHAIN solves) on the
    ``n_nodes`` graph; raises unless the chain cuts it below 0.6 of it."""
    g, gt, _ = build_graph(n_nodes, device=device)
    ate0, ate1 = ate(g, gt), ate(chain(g, gn), gt)
    if not ate1 < 0.6 * ate0:
        raise AssertionError(f"{n_nodes} nodes, {gn} GN steps: {CHAIN} "
                             f"chained solves left the ATE at {ate1} m "
                             f"(cold initial {ate0} m)")
    return ate0, ate1


def _ms(fn, reps: int, device) -> float:
    """Median time of ``fn()`` over ``reps`` calls after one warm-up: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def profile(sizes, reps: int, device) -> list[dict]:
    rows = []
    for n_nodes in sizes:
        g, gt, n_loops = build_graph(n_nodes, device=device)
        for gn in (2, 5):
            ate0, ate1 = converges(n_nodes, gn, device)
            warm = [chain(g, gn)]

            def warm_solve():
                warm[0] = solve(warm[0], gn)

            row = {"nodes": n_nodes, "loops": n_loops, "gn_iters": gn,
                   "cold_ms": _ms(lambda: solve(g, gn), reps, device),
                   "warm_ms": _ms(warm_solve, reps, device),
                   "ate_initial_m": ate0, "ate_chained_m": ate1}
            rows.append(row)
            print(f"nodes {n_nodes:5d}  loops {n_loops:3d}  gn x{gn}:  "
                  f"cold {row['cold_ms']:8.3f} ms   warm "
                  f"{row['warm_ms']:8.3f} ms   (ATE {ate0:.4f} -> "
                  f"{ate1:.4f} m over {CHAIN} chained)", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sizes", type=int, nargs="+", default=[128, 512, 1024])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out/profile_pgo.json")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (host clock)")
    print(f"device: {where}", flush=True)
    rows = profile(args.sizes, args.reps, dev)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": where, "pcg_iters": PCG_ITERS, "rows": rows},
                  f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
