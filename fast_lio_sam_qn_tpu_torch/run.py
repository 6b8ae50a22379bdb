"""End-to-end runner of the port — the `roslaunch fast_lio_sam_qn run.launch`
equivalent, as the JAX package's ``run.py``:

  python -m fast_lio_sam_qn_tpu_torch.run --sim --out /tmp/out
      A synthetic closed-loop sequence through the whole stack (the LIO
      front end, the pose graph and the two-stage loop closure), then the
      export and a JSON report.

  python -m fast_lio_sam_qn_tpu_torch.run --kitti DIR --preset kitti
      Integrated mode: DIR holds scans/*.bin (KITTI velodyne, LiDAR frame),
      imu.txt ("t gx gy gz ax ay az" rows), times.txt (scan end stamps) and
      optionally rel_times/%06d.npy (per-point sweep times); the LIO front
      end and the pose graph.  --checkpoint PATH [--checkpoint-every N]
      saves the whole state; --resume PATH continues a saved run (a file of
      the port or of the JAX package) at its scan index.

  python -m fast_lio_sam_qn_tpu_torch.run --scans DIR --poses F [--stamps T
         --odom-times O --sync-slop S --world-frame]
      Parity mode: external odometry (a KITTI pose file) and body-frame
      scan files (.bin / .pcd, sorted), optionally paired by ApproximateTime
      sync of the two streams' stamps, as the reference consumes FAST-LIO.

  python -m fast_lio_sam_qn_tpu_torch.run --bag FILE [--odom-topic T]
      A ROS bag streamed straight into the LIO and the pipeline (the
      ``rosbag play`` path), or with --odom-topic its odometry drives the
      pipeline through ApproximateTime sync.

``--device`` (default ``cuda``) holds every tensor; ``--device cpu`` runs
the kernels' plain versions.  ``--plot PNG`` renders the trajectories, the
loop edges and the map (needs matplotlib; without it the run stops before
it starts).  The device mesh (``--devices``) is not ported yet: its flag
stops with an error that names the ROADMAP item.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
from collections import deque

import numpy as np
import torch

from .configs.presets import LIO_PRESETS, get_pipeline_config
from .models.lio import LIO
from .models.pipeline import FastLioSamQnPipeline
from .runtime import ApproxTimeSync, ScanLoader
from .runtime import rosbag
from .utils import evaluation, io, sim, sweep
from .utils.checkpoint import load_checkpoint, save_checkpoint
from .utils.config import Capacities, load_lio_yaml, load_reference_yaml
from .utils.profiling import Profiler
from .utils.viz import plot_results, require_matplotlib

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




# ---------------------------------------------------------------------------
# the dataset modes
# ---------------------------------------------------------------------------

def _decimate(cap, pts, *per_point):
    """Uniform decimation to the configured capacity: every
    ceil(n / cap)-th point of ``pts`` and of each per-point array."""
    if len(pts) <= cap:
        return (pts, *per_point)
    step = int(np.ceil(len(pts) / cap))
    return (pts[::step], *(a[::step] for a in per_point))


def _pad(values, cap):
    """(n,) values zero-padded (or cut) to ``cap``, float32."""
    out = np.zeros(cap, np.float32)
    out[:len(values)] = values[:cap]
    return out


def _to_body(pts, T):
    """World-frame points back to the body frame of pose T
    (pose_pcd.hpp:39-40)."""
    Ti = np.linalg.inv(T)
    return pts @ Ti[:3, :3].T + Ti[:3, 3]


def _feed_cloud(pipe, T, xyzi, t, cap, world_frame):
    """One odometry pose and its xyzi scan into the pipeline: the scan
    un-transformed when it is world-frame, decimated and padded to
    ``cap`` with its intensities."""
    pts, inten = xyzi[:, :3], xyzi[:, 3]
    if world_frame:
        pts = _to_body(pts, T)
    pts, inten = _decimate(cap, pts, inten)
    cloud, mask = sim.pad_cloud(pts.astype(np.float32), cap)
    pipe.feed(np.asarray(T, np.float32), cloud, mask, float(t),
              intensity=_pad(inten, cap))


def _feed_scan_files(pipe, scan_paths, poses, stamps, world_frame, cap,
                     obs):
    loader = ScanLoader(scan_paths, cap=1 << 18)
    try:
        for i, (T, t) in enumerate(zip(poses, stamps)):
            _feed_cloud(pipe, T, loader.get(i), t, cap, world_frame)
            obs.tick(pipe, float(t))
    finally:
        loader.close()


def run_parity(args):
    """``--scans DIR --poses F``: external odometry and scan files; with
    ``--odom-times`` the two streams are paired by ApproximateTime sync
    (fast_lio_sam_qn.cpp:75-78) and scans with no odometry stamp within
    ``--sync-slop`` are dropped and counted, the pairs stamped with the
    odometry's time."""
    cfg = _get_pipeline_config(args, args.preset)
    pipe = FastLioSamQnPipeline(cfg, device=torch.device(args.device))
    prof = Profiler()
    scan_paths = sorted(glob.glob(os.path.join(args.scans, "*.bin"))
                        + glob.glob(os.path.join(args.scans, "*.pcd")))
    poses = io.load_poses_kitti(args.poses)
    dropped = 0
    if args.odom_times:
        if not args.stamps:
            raise SystemExit("--odom-times requires --stamps (scan stamps)")
        scan_t = np.loadtxt(args.stamps)[:len(scan_paths)]
        odom_t = np.loadtxt(args.odom_times)[:len(poses)]
        sync = ApproxTimeSync(slop=args.sync_slop)
        for i, t in enumerate(scan_t):
            sync.push_a(float(t), i)
        for j, t in enumerate(odom_t):
            sync.push_b(float(t), j)
        pairs = []
        while (p := sync.pop()) is not None:
            pairs.append(p)
        sync.close()
        scan_sel = [scan_paths[ia] for ia, _, _, _ in pairs]
        pose_sel = np.stack([poses[ib] for _, ib, _, _ in pairs]) if pairs \
            else np.zeros((0, 4, 4))
        stamps = np.asarray([tb for _, _, _, tb in pairs])
        n = len(pairs)
        dropped = len(scan_t) - n
    else:
        n = min(len(scan_paths), len(poses))
        scan_sel, pose_sel = scan_paths[:n], poses[:n]
        stamps = (np.loadtxt(args.stamps)[:n] if args.stamps
                  else np.arange(n) * 0.1)
    with prof.span("run"):
        _feed_scan_files(pipe, scan_sel, pose_sel, stamps, args.world_frame,
                         cfg.caps.keyframe_points,
                         obs=RunObservers(args, cfg.vis_hz,
                                          cfg.save_voxel_resolution))
    report = {
        "mode": "parity", "scans": n, "keyframes": pipe.current_kf_idx,
        "dropped_unmatched": dropped,
        "loops_accepted": len(pipe.loop_idx_pairs),
        "loop_attempts": len(pipe.loop_events),
        "timing": prof.summary(),
    }
    return pipe, report


def _pack_imu(rows):
    """IMU rows ``[t gx gy gz ax ay az]`` padded to IMU_CAP."""
    rows = np.asarray(rows, np.float64).reshape(-1, 7)
    return pad_imu(rows[:, 0], rows[:, 1:4], rows[:, 4:7])


def _extrinsic_report(cfg, state):
    """The refined LiDAR -> IMU extrinsic of a run with extrinsic_est_en."""
    if state is None or not cfg.lio.extrinsic_est_en:
        return None
    return {"R": np.round(state.ext.R.cpu().numpy(), 6).tolist(),
            "t": np.round(state.ext.t.cpu().numpy(), 6).tolist()}


def _lio_inputs(cfg, pts, inten, rel, t0, t1, imu_rows):
    """The inputs of ``LIO.process_scan`` for one raw scan: its points,
    intensities and sweep times decimated and padded to the capacity, the
    IMU rows of (t0, t1] padded to IMU_CAP."""
    cap = cfg.lio.max_points_per_scan
    pts, rel, inten = _decimate(cap, pts, rel, inten)
    cloud, mask = sim.pad_cloud(pts.astype(np.float32), cap)
    return (cloud, _pad(rel, cap), mask, *_pack_imu(imu_rows), float(t0),
            float(t1)), _pad(inten, cap)


def run_bag(args):
    """``--bag FILE``: a ROS bag streamed one message at a time into the
    LIO and the pipeline (the reference's ``rosbag play`` path, README.md:
    83-94), memory bounded by the scan / IMU look-ahead.  A scan is
    processed once an IMU sample past its stamp has arrived.  With
    ``--odom-topic`` the bag's odometry drives the pipeline instead, the
    two streams paired by ApproximateTime sync and every decoded message
    that was not fed counted as dropped."""
    cfg = _get_pipeline_config(args, args.preset)
    device = torch.device(args.device)
    pipe = FastLioSamQnPipeline(cfg, device=device)
    prof = Profiler()
    obs = RunObservers(args, cfg.vis_hz, cfg.save_voxel_resolution)
    reader = rosbag.BagReader(args.bag)
    scan_topic, imu_topic = args.scan_topic, args.imu_topic
    off = cfg.lio.time_offset_lidar_to_imu
    scan_decoders = rosbag.scan_decoders(cfg.lio.timestamp_unit)

    if args.odom_topic:
        cap = cfg.caps.keyframe_points
        sync = ApproxTimeSync(slop=args.sync_slop)
        scans, odoms = {}, {}
        na = nb = n_fed = 0
        drop_a = drop_b = 0     # messages the sync discarded unmatched
        next_a = next_b = 0     # ids below these are fed or dropped
        with prof.span("run"):
            for topic, mtype, _, raw in reader.messages():
                if mtype in scan_decoders and scan_topic is None:
                    scan_topic = topic
                if topic == scan_topic and mtype in scan_decoders:
                    stamp, xyzi, _ = scan_decoders[mtype](raw)
                    scans[na] = xyzi
                    sync.push_a(stamp + off, na)
                    na += 1
                elif topic == args.odom_topic and \
                        mtype == "nav_msgs/Odometry":
                    stamp, T = rosbag.decode_odometry(raw)
                    odoms[nb] = T
                    sync.push_b(stamp, nb)
                    nb += 1
                else:
                    continue
                while (p := sync.pop()) is not None:
                    ia, ib, _, tb = p
                    # the matcher consumes both queues front to back: a
                    # buffered message below the pair was discarded by it
                    drop_a += sum(scans.pop(j, None) is not None
                                  for j in range(next_a, ia))
                    drop_b += sum(odoms.pop(j, None) is not None
                                  for j in range(next_b, ib))
                    next_a, next_b = ia + 1, ib + 1
                    _feed_cloud(pipe, odoms.pop(ib), scans.pop(ia), tb, cap,
                                args.world_frame)
                    obs.tick(pipe, float(tb))
                    n_fed += 1
        sync.close()
        # messages never matched before the end of the stream are dropped
        drop_a += len(scans)
        drop_b += len(odoms)
        return pipe, {
            "mode": "bag", "scans": n_fed,
            "dropped_unmatched": drop_a + drop_b,
            "keyframes": pipe.current_kf_idx,
            "loops_accepted": len(pipe.loop_idx_pairs),
            "loop_attempts": len(pipe.loop_events),
            "scan_topic": scan_topic, "odom_topic": args.odom_topic,
            "timing": prof.summary(),
        }

    lio = LIO(cfg.lio, imu_cap=IMU_CAP, device=device)
    run = dict(state=None, last_t=None, n_fed=0)
    imu_rows: deque = deque()      # time-ordered [t gx gy gz ax ay az]
    imu_seen: list = []            # kept before the init, for gravity
    pending: deque = deque()       # (t_eff, pts, inten, rel or None)

    # FAST-LIO2's time_sync_en (kitti.yaml:4), mirrored from the JAX
    # package: when the first scan and IMU stamps differ by more than 0.1
    # s, that difference is taken as the LiDAR -> IMU clock offset and
    # every scan stamp is moved onto the IMU clock (on top of the
    # configured time_offset_lidar_to_imu); below 0.1 s the offset is 0
    sync = dict(off=None if cfg.lio.time_sync_en else 0.0, scan=None,
                imu=None)
    presync: deque = deque()       # scans held until the offset is known

    def resolve_sync(flush_unsynced=False):
        if sync["off"] is None:
            if flush_unsynced:
                sync["off"] = 0.0  # an IMU-less bag: nothing to sync to
            elif sync["scan"] is None or sync["imu"] is None:
                return
            else:
                d = sync["imu"] - sync["scan"]
                sync["off"] = d if abs(d) > 0.1 else 0.0
                if sync["off"]:
                    print(f"time_sync_en: LiDAR->IMU clock offset "
                          f"{sync['off']:+.3f} s detected from first stamps; "
                          "remapping scan stamps onto the IMU clock",
                          file=sys.stderr, flush=True)
        while presync:
            stamp, pts, inten, rel = presync.popleft()
            pending.append((stamp + off + sync["off"], pts, inten, rel))

    def drain(force=False):
        # a scan is ready once an IMU sample past its stamp has arrived
        # (or the bag ended): its (t0, t1] IMU window is then complete
        while pending and (force or (imu_rows and
                                     imu_rows[-1][0] > pending[0][0])):
            t1, pts, inten, rel = pending.popleft()
            t0 = run["last_t"] if run["last_t"] is not None else t1 - 0.1
            if run["state"] is None:
                pre = [r for r in imu_seen if r[0] <= t1]
                rows = np.asarray(pre if len(pre) >= 5 else imu_seen[:20]
                                  or [[t1, 0, 0, 0, 0, 0, 9.81]])
                gdir, bg = LIO.init_from_imu(rows[:, 1:4], rows[:, 4:7])
                run["state"] = lio.init_state(gravity_dir=gdir, gyro_bias=bg,
                                              t0=t0)
                imu_seen.clear()
            if rel is None:
                rel = sweep.synthesize_rel_times(
                    pts, t1 - t0, cfg.lio.lidar_type, cfg.lio.scan_line)
            window = []
            while imu_rows and imu_rows[0][0] <= t1:
                r = imu_rows.popleft()
                if r[0] > t0:
                    window.append(r)
            inputs, ipad = _lio_inputs(cfg, pts, inten, rel, t0, t1, window)
            with prof.span("lio"):
                run["state"], res = lio.process_scan(run["state"], *inputs,
                                                     inten=ipad)
            with prof.span("pgo"):
                pipe.feed(res.pose, res.cloud_body, res.cloud_mask, float(t1),
                          intensity=res.intensity)
            obs.tick(pipe, float(t1))
            run["last_t"] = t1
            run["n_fed"] += 1

    with prof.span("run"):
        for topic, mtype, _, raw in reader.messages():
            if mtype in scan_decoders and scan_topic is None:
                scan_topic = topic
            if mtype == "sensor_msgs/Imu" and imu_topic is None:
                imu_topic = topic
            if topic == scan_topic and mtype in scan_decoders:
                with prof.span("decode"):
                    stamp, xyzi, rel = scan_decoders[mtype](raw)
                has_rel = rel is not None and len(rel) and \
                    float(rel.max()) > 0
                item = (xyzi[:, :3], xyzi[:, 3], rel if has_rel else None)
                if sync["off"] is None:
                    if sync["scan"] is None:
                        sync["scan"] = stamp
                    presync.append((stamp, *item))
                    resolve_sync()
                else:
                    pending.append((stamp + off + sync["off"], *item))
            elif topic == imu_topic and mtype == "sensor_msgs/Imu":
                stamp, gyro, acc = rosbag.decode_imu(raw)
                row = [stamp, *gyro, *acc]
                imu_rows.append(row)
                if run["state"] is None:
                    imu_seen.append(row)
                if sync["imu"] is None:
                    sync["imu"] = stamp
                    resolve_sync()
            else:
                continue
            drain()
        resolve_sync(flush_unsynced=True)
        drain(force=True)

    report = {
        "mode": "bag", "scans": run["n_fed"],
        "keyframes": pipe.current_kf_idx,
        "loops_accepted": len(pipe.loop_idx_pairs),
        "loop_attempts": len(pipe.loop_events),
        "scan_topic": scan_topic, "imu_topic": imu_topic,
        "timing": prof.summary(),
    }
    if cfg.lio.time_sync_en:
        report["time_sync_offset"] = round(float(sync["off"] or 0.0), 6)
    if (ext := _extrinsic_report(cfg, run["state"])) is not None:
        report["extrinsic_estimate"] = ext
    return pipe, report


def run_kitti(args):
    """``--kitti DIR``: the LIO front end and the pipeline over a
    KITTI-style directory; the filter starts from a standstill init on the
    IMU samples up to the first scan; scans take their rel_times/ sidecar
    or a synthesized sweep; ``--checkpoint`` / ``--checkpoint-every`` save
    the whole state, ``--resume`` continues a saved run."""
    cfg = _get_pipeline_config(args, args.preset)
    device = torch.device(args.device)
    pipe = FastLioSamQnPipeline(cfg, device=device)
    prof = Profiler()
    lio = LIO(cfg.lio, imu_cap=IMU_CAP, device=device)
    obs = RunObservers(args, cfg.vis_hz, cfg.save_voxel_resolution)

    scan_paths = sorted(glob.glob(os.path.join(args.kitti, "scans", "*.bin")))
    # lidar stamps onto the IMU clock (kimera-multi.yaml:6)
    stamps = np.loadtxt(os.path.join(args.kitti, "times.txt")) \
        + cfg.lio.time_offset_lidar_to_imu
    imu = np.loadtxt(os.path.join(args.kitti, "imu.txt"))  # t gx gy gz ax..az
    n = min(len(scan_paths), len(stamps))
    if args.n_scans:
        n = min(n, args.n_scans)

    # gravity and gyro bias from the samples before the first scan
    pre = imu[imu[:, 0] <= stamps[0]]
    init_rows = pre if len(pre) >= 5 else imu[:20]
    gdir, bg = LIO.init_from_imu(init_rows[:, 1:4], init_rows[:, 4:7])
    state = lio.init_state(gravity_dir=gdir, gyro_bias=bg, t0=stamps[0])

    start = 0
    if args.resume:
        pipe, st, extra = load_checkpoint(pipe, args.resume,
                                          lio_template=state)
        if st is None:
            raise SystemExit(f"{args.resume} holds no LIO state; re-save "
                             "with a recent --checkpoint")
        state, start = st, int(extra.get("scan_index", 0))

    loader = ScanLoader(scan_paths[:n], cap=1 << 18)
    try:
        for i in range(start, n):
            t1 = stamps[i]
            t0 = stamps[i - 1] if i else t1 - 0.1
            with prof.span("io"):
                xyzi = loader.get(i)
                pts = xyzi[:, :3].astype(np.float32)
                rel = sweep.load_rel_times(args.kitti, i, len(pts))
                if rel is None:
                    rel = sweep.synthesize_rel_times(
                        pts, t1 - t0, cfg.lio.lidar_type, cfg.lio.scan_line)
                rows = imu[(imu[:, 0] > t0) & (imu[:, 0] <= t1)]
                inputs, ipad = _lio_inputs(cfg, pts, xyzi[:, 3], rel, t0, t1,
                                           rows)
            with prof.span("lio"):
                state, res = lio.process_scan(state, *inputs, inten=ipad)
            with prof.span("pgo"):
                pipe.feed(res.pose, res.cloud_body, res.cloud_mask,
                          float(t1), intensity=res.intensity)
            obs.tick(pipe, float(t1))
            if args.checkpoint and args.checkpoint_every and \
                    (i + 1) % args.checkpoint_every == 0:
                save_checkpoint(pipe, args.checkpoint, lio_state=state,
                                extra={"scan_index": i + 1})
            if args.verbose and i % 50 == 0:
                print(f"scan {i}/{n} kfs={pipe.current_kf_idx} "
                      f"matches={int(res.num_matches)}", flush=True)
    finally:
        loader.close()
    if args.checkpoint:
        save_checkpoint(pipe, args.checkpoint, lio_state=state,
                        extra={"scan_index": n})
    report = {
        "mode": "kitti", "scans": n, "keyframes": pipe.current_kf_idx,
        "resumed_at": start or None,
        "loops_accepted": len(pipe.loop_idx_pairs),
        "timing": prof.summary(),
    }
    if args.checkpoint:
        report["checkpoint"] = args.checkpoint
    if (ext := _extrinsic_report(cfg, state)) is not None:
        report["extrinsic_estimate"] = ext
    return pipe, report


# flags of the JAX CLI whose code is not ported yet, with the ROADMAP item
# that ports it: they stop the run instead of being accepted and ignored
_NOT_PORTED = {"--devices": 19}


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet (ROADMAP.md, "
                     f"queue 1 item {_NOT_PORTED[option_string]})")


def parser() -> argparse.ArgumentParser:
    """The CLI's flags; ``parse_args([])`` gives every field's default."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sim", action="store_true",
                   help="run the simulated closed-loop sequence")
    p.add_argument("--kitti", help="KITTI-style dataset dir")
    p.add_argument("--bag", help="ROS bag file: stream it into the LIO and "
                                 "the pipeline, or with --odom-topic drive "
                                 "the pipeline from its odometry")
    p.add_argument("--scan-topic", default=None,
                   help="--bag: scan topic, PointCloud2 or livox CustomMsg "
                        "(default: the first found)")
    p.add_argument("--imu-topic", default=None,
                   help="--bag: Imu topic (default: the first found)")
    p.add_argument("--odom-topic", default=None,
                   help="--bag: drive the pipeline from this nav_msgs/"
                        "Odometry topic instead of the LIO front end")
    p.add_argument("--scans", help="scan dir for parity mode")
    p.add_argument("--poses", help="KITTI-format odometry pose file")
    p.add_argument("--stamps", help="timestamps file (one float per scan)")
    p.add_argument("--odom-times",
                   help="parity mode: odometry timestamps file; pairs the "
                        "scan / odometry streams by ApproximateTime sync and "
                        "drops unmatched frames (fast_lio_sam_qn.cpp:75-78)")
    p.add_argument("--sync-slop", type=float, default=0.05,
                   help="max |scan_t - odom_t| for an ApproximateTime pair")
    p.add_argument("--world-frame", action="store_true",
                   help="scans are world-frame (un-transform by pose)")
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
    p.add_argument("--checkpoint", default=None,
                   help="save the whole state (pipeline and LIO) here at "
                        "the end of the run; with --checkpoint-every, also "
                        "periodically")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="integrated mode: save --checkpoint every N scans")
    p.add_argument("--resume", default=None,
                   help="integrated (--kitti) mode: restore the pipeline and "
                        "the LIO from this checkpoint (of either package) "
                        "and continue at its saved scan index")
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
    p.add_argument("--plot", default=None,
                   help="write a trajectory / loop / map PNG here (needs "
                        "matplotlib)")
    p.add_argument("-v", "--verbose", action="store_true")
    for flag, item in _NOT_PORTED.items():
        p.add_argument(flag, nargs="?", action=_NotPorted,
                       help=f"not ported yet (ROADMAP.md queue 1 item "
                            f"{item})")
    return p


def main(argv=None):
    p = parser()
    args = p.parse_args(argv)
    if args.resume and not args.kitti:
        p.error("--resume is supported in integrated (--kitti) mode")
    if args.plot:
        require_matplotlib()
    if args.sim:
        pipe, report = run_sim(args)
    elif args.kitti:
        pipe, report = run_kitti(args)
    elif args.bag:
        pipe, report = run_bag(args)
    elif args.scans and args.poses:
        pipe, report = run_parity(args)
    else:
        p.error("pick a mode: --sim | --kitti DIR | --bag FILE | "
                "--scans DIR --poses F")

    if args.checkpoint and "checkpoint" not in report:
        save_checkpoint(pipe, args.checkpoint)
        report["checkpoint"] = args.checkpoint
    cfg = pipe.cfg
    if args.out or (not args.no_auto_save and (
            cfg.save_map_pcd or cfg.save_map_bag or cfg.save_in_kitti_format)):
        report["exported_to"] = io.save_results(pipe, args.out or "results")
    if args.plot:
        report["plot"] = plot_results(pipe, args.plot)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
