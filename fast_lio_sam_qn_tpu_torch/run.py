"""End-to-end runner of the port — the `roslaunch fast_lio_sam_qn run.launch`
equivalent, as the JAX package's ``run.py``:

  python -m fast_lio_sam_qn_tpu_torch.run --sim --out /tmp/out
      A synthetic closed-loop sequence through the whole stack (the LIO
      front end, the pose graph and the two-stage loop closure), then the
      export and a JSON report.  ``--device`` (default ``cuda``) holds
      every tensor; ``--device cpu`` runs the kernels' plain versions.

The dataset modes (``--kitti``, ``--scans/--poses``, ``--bag``),
checkpointing, ``--plot`` and the device mesh are not ported yet: their
flags stop with an error that names the ROADMAP item.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from .configs.presets import LIO_PRESETS, get_pipeline_config
from .models.lio import LIO
from .models.pipeline import FastLioSamQnPipeline
from .utils import evaluation, io, sim
from .utils.config import Capacities, load_lio_yaml, load_reference_yaml
from .utils.profiling import Profiler

IMU_CAP = 64


class RunObservers:
    """Mid-run observability — the reference's vis timer and /save_dir
    topic (fast_lio_sam_qn.cpp:254-325, :327):

    - ``--save-trigger PATH``: when PATH appears, export the results to the
      directory named by its content (or PATH + '.out' if empty) and
      delete it;
    - ``--watch DIR``: every 1/vis_hz of data time, the corrected and raw
      trajectories, the loop pairs and the latest corrected scan into DIR;
      touching DIR/map.request makes the next tick write the voxelized
      corrected map to DIR/corrected_map.pcd and delete the request (the
      subscriber-gated /corrected_map, fast_lio_sam_qn.cpp:303-321).
    """

    def __init__(self, args, vis_hz: float, save_voxel_res: float = 0.3):
        self.trigger = args.save_trigger
        self.watch = args.watch
        self.period = 1.0 / max(vis_hz, 1e-6)
        self.save_voxel_res = save_voxel_res
        self._next = None
        if self.watch:
            os.makedirs(self.watch, exist_ok=True)

    def tick(self, pipe, t: float):
        if self.trigger and os.path.exists(self.trigger):
            with open(self.trigger) as f:
                dest = f.read().strip() or (self.trigger + ".out")
            os.remove(self.trigger)
            io.save_results(pipe, dest)
            print(f"saved results to {dest} (trigger)", file=sys.stderr)
        if not self.watch:
            return
        req = os.path.join(self.watch, "map.request")
        if os.path.exists(req) and pipe.current_kf_idx > 0:
            io.save_pcd(os.path.join(self.watch, "corrected_map.pcd"),
                        pipe.get_global_map(self.save_voxel_res))
            os.remove(req)
        if self._next is None:
            self._next = t
        if t < self._next:
            return
        self._next += self.period
        n = pipe.current_kf_idx
        if n == 0:
            return
        odom, corrected = pipe.get_trajectories()
        io.save_pcd(os.path.join(self.watch, "corrected_current.pcd"),
                    pipe.get_corrected_current_scan())
        io.save_poses_kitti(os.path.join(self.watch, "corrected_path.txt"),
                            corrected)
        io.save_poses_kitti(os.path.join(self.watch, "odom_path.txt"), odom)
        with open(os.path.join(self.watch, "loops.json"), "w") as f:
            json.dump({"pairs": pipe.loop_idx_pairs, "keyframes": n,
                       "t": t}, f)


def _get_pipeline_config(args, preset):
    """The preset's config with the CLI's overrides applied to a copy:
    ``--ref-config`` (the reference's rosparam YAML for the pose graph and
    the loop closure, strict parity unless ``--no-strict-parity``; the LIO
    keeps the preset's tuning), ``--lio-config`` (a FAST-LIO YAML over the
    LIO config), ``--scan-cap``, ``--table-size`` and ``--loop-batch``."""
    if args.ref_config:
        cfg = load_reference_yaml(args.ref_config,
                                  strict_parity=not args.no_strict_parity)
        cfg.lio = dataclasses.replace(LIO_PRESETS[preset])
    else:
        cfg = get_pipeline_config(preset)
    if args.lio_config:
        cfg.lio = load_lio_yaml(args.lio_config, base=cfg.lio)
    over = {k: v for k, v in (
        ("max_points_per_scan", args.scan_cap),
        ("map_table_size", args.table_size)) if v}
    if over:
        cfg.lio = dataclasses.replace(cfg.lio, **over)
    if args.loop_batch is not None:
        cfg.loop.loop_batch = args.loop_batch
    return cfg


def sim_lio_stream(cfg, world, traj, n_scans, scan_hz=5.0, prof=None,
                   device: torch.device | str = "cuda"):
    """Simulate the sequence and run the LIO front end over it, yielding
    one (pose, cloud_body, cloud_mask, t1, gt_pose) tuple per scan: the
    pose and the deskewed body cloud as tensors on ``device``, t1 the scan
    end, gt_pose the ground truth (4, 4) in the filter's world frame (the
    body frame at t = 0).  ``prof`` (``span(name)``) gets the spans
    ``sim`` and ``lio`` per scan and the LIO's stage spans (a host clock
    measures what was enqueued: ``process_scan`` does not wait for the
    device)."""
    prof = prof or Profiler()
    lio = LIO(cfg.lio, imu_cap=IMU_CAP, device=device, profiler=prof)
    period = 1.0 / scan_hz
    state = initial_state(lio, traj)
    # simulate at 4x the processing capacity: the preprocess downsamples
    # to it, as a real spinning LiDAR's many azimuth steps are
    raw_n = 4 * cfg.lio.max_points_per_scan
    T0_inv = np.linalg.inv(traj.pose(0.0))
    for i in range(n_scans):
        with prof.span("sim"):
            inputs = sim_scan_inputs(world, traj, i, period, raw_n)
        with prof.span("lio"):
            state, res = lio.process_scan(state, *inputs)
        yield res.pose, res.cloud_body, res.cloud_mask, inputs[-1], \
            T0_inv @ traj.pose(inputs[-1])


def sim_scan_inputs(world, traj, i, period, raw_n, imu_noise=True,
                    seed=100):
    """The inputs of ``LIO.process_scan`` for scan i of a simulated run:
    a swept scan of ``raw_n`` rays over [i period, (i + 1) period) (noise
    seed ``seed + i``), 200 Hz IMU samples padded to IMU_CAP (with the
    sim stream's gyro / accelerometer noise, seed ``seed + 100 + i``, or
    none), and the scan's start and end times."""
    t0, t1 = i * period, (i + 1) * period
    pts, rel_t = sim.simulate_scan_swept(
        world, traj, t0, n_points=raw_n, noise=0.01, seed=seed + i,
        scan_period=period)
    noise = dict(gyro_noise=0.002, acc_noise=0.02) if imu_noise else {}
    ts, gyro, acc = sim.simulate_imu(traj, t0, t1, rate=200.0,
                                     seed=seed + 100 + i, **noise)
    cloud, mask = sim.pad_cloud(pts, raw_n)
    return cloud, rel_t, mask, *pad_imu(ts, gyro, acc), t0, t1


def pad_imu(ts, gyro, acc, cap=IMU_CAP):
    """IMU samples (times, gyro, accelerometer) padded to ``cap`` with
    their mask, as ``LIO.process_scan`` takes them; samples beyond ``cap``
    are dropped."""
    it = np.zeros(cap, np.float32)
    ig = np.zeros((cap, 3), np.float32)
    ia = np.zeros((cap, 3), np.float32)
    im = np.zeros(cap, bool)
    k = min(len(ts), cap)
    it[:k], ig[:k], ia[:k], im[:k] = ts[:k], gyro[:k], acc[:k], True
    return it, ig, ia, im


def initial_state(lio: LIO, traj):
    """A fresh filter state whose world frame is the body frame at t = 0,
    moving with the trajectory's initial velocity (in that frame)."""
    state = lio.init_state()
    T0 = traj.pose(0.0)
    v0, _, _ = traj.derivatives(0.0)
    return state._replace(nav=state.nav._replace(v=torch.tensor(
        (T0[:3, :3].T @ v0).astype(np.float32), device=lio.device)))


def _sim_scene(trajectory: str, cfg):
    """(world, trajectory, cfg) of a ``--trajectory`` scenario."""
    if trajectory == "figure8":
        return (sim.World.room(size=40.0, height=6.0, n_boxes=16, seed=3),
                sim.Trajectory.figure8(radius=12.0, period=60.0), cfg)
    if trajectory == "corridor":
        # a sparse repetitive world driven straight through, det_range
        # tightened so that the moving-window eviction recycles table slots
        cfg.lio = dataclasses.replace(cfg.lio, det_range=25.0)
        return (sim.World.corridor(length=150.0, width=8.0, height=4.0),
                sim.Trajectory.straight(speed=2.0), cfg)
    return (sim.World.room(size=26.0, height=5.0, n_boxes=10, seed=3),
            sim.Trajectory.loop(radius=7.0, period=40.0), cfg)


def run_sim(args):
    """``--sim``: the "sim" preset with the run's capacities over the
    chosen trajectory, ATE at the keyframes against the truth."""
    cfg = _get_pipeline_config(args, "sim")
    cfg.caps = Capacities(max_keyframes=256, max_loop_factors=32,
                          keyframe_points=2048, src_points=2048,
                          dst_points=4096)
    prof = Profiler()
    obs = RunObservers(args, cfg.vis_hz, cfg.save_voxel_resolution)
    world, traj, cfg = _sim_scene(args.trajectory, cfg)
    device = torch.device(args.device)
    pipe = FastLioSamQnPipeline(cfg, device=device)
    scan_hz = args.scan_hz or 5.0
    n_scans = args.n_scans or 240

    gt = []
    for i, (pose, cloud_body, cloud_mask, t1, gt_pose) in enumerate(
            sim_lio_stream(cfg, world, traj, n_scans, scan_hz, prof,
                           device=device)):
        with prof.span("pgo"):
            pipe.feed(pose, cloud_body, cloud_mask, t1)
        obs.tick(pipe, t1)
        gt.append(gt_pose)
        if args.verbose and i % 25 == 0:
            print(f"scan {i}/{n_scans} kfs={pipe.current_kf_idx} "
                  f"loops={len(pipe.loop_idx_pairs)}", flush=True)
    period = 1.0 / scan_hz
    _, corrected = pipe.get_trajectories()
    gtn = np.stack(gt)
    gt_kf = [gtn[min(int(round(t / period)) - 1, len(gtn) - 1)]
             for t in pipe.kf_timestamps]
    ate = evaluation.ate_rmse(corrected, np.stack(gt_kf))
    report = {
        "mode": "sim", "scans": n_scans, "keyframes": pipe.current_kf_idx,
        "loops_accepted": len(pipe.loop_idx_pairs),
        "loop_attempts": len(pipe.loop_events),
        "ate_rmse_m": round(ate, 4),
        "timing": prof.summary(),
    }
    return pipe, report


# flags of the JAX CLI whose code is not ported yet, with the ROADMAP item
# that ports it: they stop the run instead of being accepted and ignored
_NOT_PORTED = {
    "--kitti": 12, "--scans": 12, "--poses": 12, "--stamps": 12,
    "--odom-times": 12, "--sync-slop": 12, "--world-frame": 12,
    "--bag": 13, "--scan-topic": 13, "--imu-topic": 13, "--odom-topic": 13,
    "--checkpoint": 14, "--checkpoint-every": 14, "--resume": 14,
    "--plot": 16, "--devices": 19,
}


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet (ROADMAP.md, "
                     f"queue 1 item {_NOT_PORTED[option_string]})")


def parser() -> argparse.ArgumentParser:
    """The CLI's flags; ``parse_args([])`` gives every field's default."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sim", action="store_true",
                   help="run the simulated closed-loop sequence")
    p.add_argument("--device", default="cuda",
                   help="device of every tensor (default cuda; cpu runs "
                        "the kernels' plain versions)")
    p.add_argument("--preset", default="kitti",
                   help="LIO preset of the dataset modes; --sim always "
                        "runs the 'sim' preset, as the JAX CLI")
    p.add_argument("--lio-config", default=None, dest="lio_config",
                   help="FAST-LIO per-dataset YAML layered over the "
                        "preset's LIO config")
    p.add_argument("--ref-config", default=None, dest="ref_config",
                   help="the pose graph's and the loop closure's config "
                        "from a reference-format rosparam YAML, with its "
                        "effective values and strict parity")
    p.add_argument("--no-strict-parity", action="store_true",
                   dest="no_strict_parity",
                   help="with --ref-config: keep the consensus window, the "
                        "degeneracy gate and the Huber loss")
    p.add_argument("--out", default=None, help="export directory")
    p.add_argument("--no-auto-save", action="store_true",
                   help="skip the shutdown export: without --out, a run "
                        "exports to ./results/<seq_name> when the config's "
                        "save flags are set, like the reference's "
                        "destructor (fast_lio_sam_qn.cpp:415-450)")
    p.add_argument("--save-trigger", default=None,
                   help="mid-run save request file: when it appears, "
                        "export to the directory it names and delete it")
    p.add_argument("--watch", default=None,
                   help="directory for trajectory / loop dumps every "
                        "1/vis_hz of data time")
    p.add_argument("--n-scans", type=int, default=None)
    p.add_argument("--scan-cap", type=int, default=None,
                   help="override lio.max_points_per_scan")
    p.add_argument("--table-size", type=int, default=None,
                   help="override lio.map_table_size (voxel-hash slots)")
    p.add_argument("--loop-batch", type=int, default=None, dest="loop_batch",
                   help="register up to N pending keyframes per loop tick "
                        "(0 or absent: the reference's latest keyframe)")
    p.add_argument("--trajectory", default="loop",
                   choices=["loop", "figure8", "corridor"])
    p.add_argument("--scan-hz", type=float, default=None, dest="scan_hz")
    p.add_argument("-v", "--verbose", action="store_true")
    for flag, item in _NOT_PORTED.items():
        p.add_argument(flag, nargs="?", action=_NotPorted,
                       help=f"not ported yet (ROADMAP.md queue 1 item "
                            f"{item})")
    return p


def main(argv=None):
    p = parser()
    args = p.parse_args(argv)
    if not args.sim:
        p.error("pick a mode: --sim (the dataset modes are not ported yet)")

    pipe, report = run_sim(args)
    cfg = pipe.cfg
    if args.out or (not args.no_auto_save and (
            cfg.save_map_pcd or cfg.save_map_bag or cfg.save_in_kitti_format)):
        report["exported_to"] = io.save_results(pipe, args.out or "results")
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
