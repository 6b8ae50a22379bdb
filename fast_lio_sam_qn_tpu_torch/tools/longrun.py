"""The KITTI-scale long run — port of fast_lio_sam_qn_tpu/tools/longrun.py:
the sequence, its replay through the pipeline, and the golden summary.

1,600 scans at 10 Hz over a ~650 m multi-lap course (a 26 m radius loop
at 4 m/s, 3.9 laps) in a 110 m room with 36 boxes.  Every lap re-passes
the previous one within the 35 m loop radius and past the 30 s time gate,
so the run exercises together what the 240-scan golden cannot: both
growth paths doubling mid-run (the keyframe store from 128, ~400
keyframes arrive; the loop factors from 8), the corrected-pose rewrite
and a pose-graph solve per keyframe at hundreds of nodes, the surfel
map's eviction churn (det_range 40 m on a 52 m course) and loop gating
over a dense field of candidates.  Scan and map sizes are the reference
tool's (2,048-point scans, 2^17 slots at 0.5 m).

The golden's pins (tests/test_golden_longrun.py): 400 keyframes, 64 loop
attempts, 39-59 committed loops (accepted >= committed), corrected ATE
0.1274 m +- 30 %, odometry ATE < 0.05 m, the keyframe capacity 128 ->
>= 512 and the loop capacity 8 -> >= 32.

Usage (from the repository root; the card unless ``--device cpu``):

    python3 -m fast_lio_sam_qn_tpu_torch.tools.longrun [--scans N] \
        [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

N_SCANS = 1600
SCAN_HZ = 10.0
RADIUS = 26.0          # lap = 163.4 m; 1600 scans @ 4 m/s = 3.9 laps, 640 m
SPEED = 4.0
WORLD_SIZE = 110.0     # the course fits with margin; far walls beyond range


def longrun_config():
    """The "sim" preset at the long run's scan and map sizes, det_range
    tightened for eviction churn, small initial keyframe and loop
    capacities so both grow mid-run, and 0.5 Hz loop ticks (~60
    registration attempts over laps 2-4)."""
    from ..configs.presets import get_pipeline_config
    from ..utils.config import Capacities

    cfg = get_pipeline_config("sim")
    cfg.lio = dataclasses.replace(
        cfg.lio, det_range=40.0, max_points_per_scan=2048,
        map_table_size=1 << 17, filter_size_surf=0.5, filter_size_map=0.5)
    cfg.caps = Capacities(max_keyframes=128, max_loop_factors=8,
                          keyframe_points=2048, src_points=2048,
                          dst_points=4096)
    cfg.loop_update_hz = 0.5
    return cfg


def longrun_world_traj():
    from ..utils import sim

    world = sim.World.room(size=WORLD_SIZE, height=6.0, n_boxes=36, seed=11)
    traj = sim.Trajectory.loop(radius=RADIUS,
                               period=2.0 * np.pi * RADIUS / SPEED)
    return world, traj


def longrun_feed(cfg, n_scans: int = N_SCANS, prof=None,
                 device: torch.device | str = "cuda"):
    """The simulated LIO stream of the course on ``device``: one (pose,
    cloud_body, cloud_mask, t1, gt_pose) per scan (``run.sim_lio_stream``;
    ``prof`` gets its spans)."""
    from ..run import sim_lio_stream

    world, traj = longrun_world_traj()
    return sim_lio_stream(cfg, world, traj, n_scans, SCAN_HZ, prof=prof,
                          device=device)


def run_pipeline(cfg, feed, prof=None, device: torch.device | str = "cuda"):
    """Feed every item of ``feed`` to a new pipeline on ``device``, each
    ``feed`` call in ``prof``'s span "feed" where given.  Returns (the
    pipeline, the ground-truth poses at its keyframes (K, 4, 4))."""
    from ..models.pipeline import FastLioSamQnPipeline

    pipe = FastLioSamQnPipeline(cfg, device=device)
    gt = []
    for pose, cloud, mask, t1, gt_pose in feed:
        if prof is None:
            pipe.feed(pose, cloud, mask, float(t1))
        else:
            with prof.span("feed"):
                pipe.feed(pose, cloud, mask, float(t1))
        gt.append(gt_pose)
    period = 1.0 / SCAN_HZ
    gtn = np.stack(gt)
    gt_kf = np.stack([gtn[min(int(round(t / period)) - 1, len(gtn) - 1)]
                      for t in pipe.kf_timestamps])
    return pipe, gt_kf


def replay(cfg, feed, prof=None, device: torch.device | str = "cuda"):
    """Drive the pipeline over the feed and return the golden summary.
    Asserts what the long run exists to exercise: both capacities grew
    past their initial sizes."""
    from ..utils import evaluation

    kf0 = cfg.caps.max_keyframes
    lf0 = cfg.caps.max_loop_factors
    pipe, gt_kf = run_pipeline(cfg, feed, prof=prof, device=device)
    raw, corrected = pipe.get_trajectories()
    assert pipe.store.capacity > kf0, (
        f"keyframe store never grew past {kf0} ({pipe.store.capacity})")
    assert pipe.graph.loop_i.shape[0] > lf0, (
        f"loop-factor capacity never grew past {lf0}")
    return {
        "n_keyframes": int(pipe.current_kf_idx),
        "ate_corrected_m": float(evaluation.ate_rmse(corrected, gt_kf)),
        "ate_odom_m": float(evaluation.ate_rmse(raw, gt_kf)),
        "loops_committed": len(pipe.loop_idx_pairs),
        "loop_attempts": len(pipe.loop_events),
        "loops_accepted": sum(1 for e in pipe.loop_events if e.accepted),
        "kf_capacity_final": int(pipe.store.capacity),
        "loop_capacity_final": int(pipe.graph.loop_i.shape[0]),
        "kf_capacity_initial": kf0,
        "loop_capacity_initial": lf0,
    }


def check_golden(s: dict) -> list[str]:
    """The pins of tests/test_golden_longrun.py that ``s`` misses."""
    pins = {
        "400 keyframes": s["n_keyframes"] == 400,
        "ATE 0.1274 m +- 30 %": abs(s["ate_corrected_m"] - 0.1274)
        < 0.3 * 0.1274,
        "odometry ATE < 0.05 m": s["ate_odom_m"] < 0.05,
        "64 attempts": s["loop_attempts"] == 64,
        "39-59 committed": 39 <= s["loops_committed"] <= 59,
        "accepted >= committed": s["loops_accepted"] >= s["loops_committed"],
        "keyframes 128 -> >= 512": s["kf_capacity_initial"] == 128
        and s["kf_capacity_final"] >= 512,
        "loops 8 -> >= 32": s["loop_capacity_initial"] == 8
        and s["loop_capacity_final"] >= 32,
    }
    return [name for name, ok in pins.items() if not ok]


def main(argv=None) -> int:
    from ..utils.profiling import Profiler

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=N_SCANS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    print(f"device: {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""), flush=True)
    cfg = longrun_config()
    prof = Profiler()
    t0 = time.perf_counter()
    summary = replay(cfg, longrun_feed(cfg, args.scans, prof=prof,
                                       device=dev), prof=prof, device=dev)
    wall = time.perf_counter() - t0
    dist = args.scans / SCAN_HZ * SPEED
    print(f"long run: {args.scans} scans / {dist:.0f} m in {wall:.1f} s "
          f"wall ({wall / args.scans * 1e3:.1f} ms/scan incl. the "
          f"simulation)", flush=True)
    for k, v in summary.items():
        print(f"  {k}: {v}", flush=True)
    print("  spans (host clock): " + "  ".join(
        f"{k}={v.avg_ms:.1f}ms" for k, v in sorted(prof.stats.items())),
        flush=True)
    if args.scans == N_SCANS:
        missed = check_golden(summary)
        print(f"  golden pins: {'all met' if not missed else missed}",
              flush=True)
        return 1 if missed else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
