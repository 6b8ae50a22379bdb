"""Where the time of one loop-closure attempt goes, on one CUDA card.

Usage (from the repository root, on a machine with a CUDA card):

    python3 -m fast_lio_sam_qn_tpu_torch.tools.profile_match \
        [--reps 5] [--out chiprun_out/profile_match.json]

For each cell (optimized and advanced matching at the benchmark's caps,
optimized at the pipeline's caps) on the benchmark's store
(``tools/bench_pair.py``) it reports:

- ``attempt_ms``: the median of ``reps`` whole ``fetch_and_perform`` calls
  by CUDA events, no instrumentation;
- ``stage_ms``: the mean host-clock time of each stage over ``reps``
  attempts, with a ``torch.cuda.synchronize()`` before and after every
  stage call (so the stages add up to more than ``attempt_ms``);
- ``device_ms`` and ``device_kernels``: the summed device time and the
  number of device kernels of one attempt under ``torch.profiler``;
- ``busy_share``: ``device_ms / attempt_ms``.

Prints one line per cell and writes everything as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..models.loop_closure import LoopClosure
from ..ops import fpfh_stream, gicp, knn_cuda, quatro, voxel
from . import bench_pair

# (label, module, attribute): every stage is a module-level function that
# its caller looks up on the module at call time, so it can be wrapped
STAGES = (
    ("voxel_downsample", voxel, "voxel_downsample"),
    ("fpfh_radius", fpfh_stream, "fpfh_radius"),
    ("quatro.match_features", quatro, "match_features"),
    ("quatro.max_clique_inliers", quatro, "max_clique_inliers"),
    ("quatro.gnc_rotation_yaw", quatro, "gnc_rotation_yaw"),
    ("quatro.translation_voting", quatro, "translation_voting"),
    ("quatro.refine_yaw_translation", quatro, "refine_yaw_translation"),
    ("gicp.morton_order", knn_cuda, "morton_order"),
    ("gicp._gicp_iterate", gicp, "_gicp_iterate"),
    ("gicp._fitness", gicp, "_fitness"),
)
CELLS = (
    ("optimized", True, (bench_pair.SRC_CAP, bench_pair.DST_CAP)),
    ("advanced", False, (bench_pair.SRC_CAP, bench_pair.DST_CAP)),
    ("optimized@pipeline caps", True,
     (bench_pair.PIPE_SRC_CAP, bench_pair.PIPE_DST_CAP)),
)


def _timed(fn, label, acc):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        acc[label] = acc.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
        return out
    return wrapper


def stage_ms(lc, store, reps):
    acc = {}
    saved = [(mod, attr, getattr(mod, attr)) for _, mod, attr in STAGES]
    try:
        for label, mod, attr in STAGES:
            setattr(mod, attr, _timed(getattr(mod, attr), label, acc))
        for _ in range(reps):
            lc.fetch_and_perform(store, 1)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return {k: v / reps for k, v in acc.items()}


def attempt_ms(lc, store, reps):
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        lc.fetch_and_perform(store, 1)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_time(lc, store):
    """(device ms, device kernels) of one attempt under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lc.fetch_and_perform(store, 1)
        torch.cuda.synchronize()
    ms, kernels = 0.0, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            ms += evt.device_time_total / 1e3
            kernels += 1
    if kernels == 0:  # device events folded into their host ops
        ms = sum(a.self_device_time_total for a in prof.key_averages()) / 1e3
    return ms, kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/profile_match.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_match: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    store, _ = bench_pair.build_store(dev)
    report = {"card": card, "reps": args.reps, "cells": {}}
    for label, optimized, caps in CELLS:
        lc = LoopClosure(bench_pair.bench_config(optimized), *caps)
        lc.fetch_and_perform(store, 1)   # warm-up: kernel build, allocator
        torch.cuda.synchronize()
        cell = {"attempt_ms": attempt_ms(lc, store, args.reps)}
        cell["stage_ms"] = stage_ms(lc, store, args.reps)
        cell["device_ms"], cell["device_kernels"] = device_time(lc, store)
        cell["busy_share"] = cell["device_ms"] / cell["attempt_ms"]
        report["cells"][label] = cell
        stages = ", ".join(f"{k} {v:.3f}" for k, v in sorted(
            cell["stage_ms"].items(), key=lambda kv: -kv[1]))
        print(f"{label}: attempt {cell['attempt_ms']:.3f} ms, device "
              f"{cell['device_ms']:.3f} ms in {cell['device_kernels']} "
              f"kernels (busy {cell['busy_share']:.3f}); stages (ms, "
              f"synchronized): {stages} [{card}]", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
