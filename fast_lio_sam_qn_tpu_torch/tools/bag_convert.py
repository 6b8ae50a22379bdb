"""Convert a ROS bag into this framework's dataset layout.

The reference is driven by `rosbag play` of dataset bags with per-dataset
presets (`fast_lio_sam_qn/launch/run.launch:29-46`;
Newer-College-2020, Kimera-Multi, VBR-Colosseo and MulRan are all
distributed as bags — README.md:83-94). This tool is the bag-free
equivalent of that playback: it extracts the LiDAR PointCloud2 + Imu
topics via runtime/rosbag.py and writes the shared dataset layout consumed
by `run.py --kitti <out> --preset <preset>`:

    <out>/scans/%06d.bin      packed float32 xyzi (KITTI velodyne layout)
    <out>/rel_times/%06d.npy  per-point sweep times, float32 seconds from
                              scan start — written only when the bag's
                              PointCloud2 carries a time field (ouster 't',
                              velodyne 'time', ...); consumed by run.py for
                              true-time deskew instead of azimuth synthesis
    <out>/times.txt           scan timestamps (header stamps), seconds from t0
    <out>/imu.txt             rows: t gx gy gz ax ay az

Topics are auto-detected (first PointCloud2 / first Imu connection) unless
given. Odometry topics can additionally be exported for parity mode
(--odom-topic -> odom_poses.txt + odom_times.txt, KITTI 3x4 rows).

Usage:
    python -m fast_lio_sam_qn_tpu_torch.tools.bag_convert <bag> <out_dir> \
        [--scan-topic T] [--imu-topic T] [--odom-topic T]

A copy of the JAX package's tool of the same name: the same layout,
file for file.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..runtime.rosbag import (BagReader, decode_imu, decode_odometry,
                              scan_decoders as make_scan_decoders)


def convert(bag_path: str, out_dir: str, scan_topic: str | None = None,
            imu_topic: str | None = None,
            odom_topic: str | None = None,
            timestamp_unit: int = -1) -> dict:
    reader = BagReader(bag_path)
    scan_decoders = make_scan_decoders(timestamp_unit)
    os.makedirs(os.path.join(out_dir, "scans"), exist_ok=True)
    rel_dir = os.path.join(out_dir, "rel_times")
    os.makedirs(rel_dir, exist_ok=True)
    times = []
    imu_rows = []
    odom_rows = []
    odom_times = []
    t0 = None
    n_scan = 0
    have_rel = False
    for topic, mtype, trec, raw in reader.messages():
        if mtype in scan_decoders and scan_topic is None:
            scan_topic = topic
        if mtype == "sensor_msgs/Imu" and imu_topic is None:
            imu_topic = topic
        if topic == scan_topic and mtype in scan_decoders:
            stamp, xyzi, rel = scan_decoders[mtype](raw)
            t0 = stamp if t0 is None else min(t0, stamp)
            xyzi.astype(np.float32).tofile(
                os.path.join(out_dir, "scans", f"{n_scan:06d}.bin"))
            # write the sidecar ONLY for scans with usable times: mixed
            # bags (driver zero-fills some scans) must fall back to
            # lidar_type synthesis per scan, exactly like the streaming
            # --bag path's per-message has_rel check (run.py)
            scan_has_rel = len(rel) > 0 and float(rel.max()) > 0.0
            if scan_has_rel:
                np.save(os.path.join(rel_dir, f"{n_scan:06d}.npy"),
                        rel.astype(np.float32))
            have_rel = have_rel or scan_has_rel
            times.append(stamp)
            n_scan += 1
        elif topic == imu_topic and mtype == "sensor_msgs/Imu":
            stamp, gyro, acc = decode_imu(raw)
            t0 = stamp if t0 is None else min(t0, stamp)
            imu_rows.append([stamp, *gyro, *acc])
        elif odom_topic and topic == odom_topic and \
                mtype == "nav_msgs/Odometry":
            stamp, T = decode_odometry(raw)
            odom_rows.append(T[:3].ravel())
            odom_times.append(stamp)
    if n_scan == 0:
        raise ValueError(f"{bag_path}: no scan messages (PointCloud2 or "
                         f"livox CustomMsg; scan_topic={scan_topic!r})")
    if not have_rel:
        # bag carries no usable per-point times: drop the sidecar so run.py
        # falls back to lidar_type-pattern synthesis (utils/sweep.py)
        import shutil

        shutil.rmtree(rel_dir)
    t0 = t0 or 0.0
    np.savetxt(os.path.join(out_dir, "times.txt"),
               np.asarray(times) - t0, fmt="%.9f")
    if imu_rows:
        rows = np.asarray(imu_rows)
        rows[:, 0] -= t0
        np.savetxt(os.path.join(out_dir, "imu.txt"), rows, fmt="%.9f")
    report = {"scans": n_scan, "imu_samples": len(imu_rows),
              "scan_topic": scan_topic, "imu_topic": imu_topic,
              "per_point_times": have_rel}
    if odom_rows:
        np.savetxt(os.path.join(out_dir, "odom_poses.txt"),
                   np.asarray(odom_rows), fmt="%.9f")
        np.savetxt(os.path.join(out_dir, "odom_times.txt"),
                   np.asarray(odom_times) - t0, fmt="%.9f")
        report["odom_msgs"] = len(odom_rows)
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("bag")
    p.add_argument("out", nargs="?", default=None)
    p.add_argument("--scan-topic", default=None)
    p.add_argument("--imu-topic", default=None)
    p.add_argument("--odom-topic", default=None)
    p.add_argument("--timestamp-unit", type=int, default=-1,
                   choices=(-1, 0, 1, 2, 3),
                   help="unit of the PointCloud2 per-point time field "
                        "(FAST-LIO convention: 0 s, 1 ms, 2 us, 3 ns; "
                        "-1 = infer from field name/dtype)")
    p.add_argument("--list-topics", action="store_true",
                   help="print the bag's topics/types and exit")
    args = p.parse_args(argv)
    if args.list_topics:
        for topic, mtype in sorted(BagReader(args.bag).topics().items()):
            print(f"{topic}  [{mtype}]")
        return 0
    if args.out is None:
        p.error("out directory required (or use --list-topics)")
    report = convert(args.bag, args.out, args.scan_topic, args.imu_topic,
                     args.odom_topic, timestamp_unit=args.timestamp_unit)
    print(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
