"""Host-side bag ingestion throughput — read, decompress, decode and pack,
no device: the JAX package's ``tools/profile_ingest.py`` for the port, with
compressed chunks.

The reference ingests every dataset through ``rosbag play`` at the sensor's
~10 Hz (README.md:83-94); the port's equivalent is ``run.py --bag``
(``runtime/rosbag.BagReader`` -> the scan decoders -> fixed-capacity
packing).  This tool measures that host path's sustained rate (scans/s and
MB/s) on generated fixture bags for both wire formats the pipeline accepts,
sensor_msgs/PointCloud2 and livox_ros_driver/CustomMsg, with none / bz2 /
lz4 chunks, against the 10 Hz budget.

Usage: python -u -m fast_lio_sam_qn_tpu_torch.tools.profile_ingest \\
        [--scans N] [--points P] [--cap C] [--compression none bz2 lz4]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from ..runtime import rosbag
from . import datasets


def build_fixture_bag(path: str, fmt: str, n_scans: int, n_points: int,
                      seed: int = 0, compression: str = "none") -> int:
    """Write n_scans scans of n_points xyzi points at 10 Hz; returns the
    file's size in bytes.  fmt: 'pointcloud2' | 'livox'."""
    rng = np.random.default_rng(seed)
    # one representative cloud, perturbed per scan (generation must not
    # dominate the tool; the wire bytes still differ every scan)
    base = rng.uniform(-40.0, 40.0, (n_points, 4)).astype(np.float32)
    base[:, 3] = rng.uniform(0.0, 100.0, n_points)
    rel = np.linspace(0.0, 0.1, n_points, endpoint=False).astype(np.float32)
    msgs = []
    for i in range(n_scans):
        t = 1000.0 + 0.1 * i
        xyzi = base + np.float32(0.001 * i)
        if fmt == "livox":
            msgs.append(("/livox/lidar", "livox_ros_driver/CustomMsg", t,
                         rosbag.encode_livox_custommsg(t, xyzi, rel)))
        else:
            msgs.append(("/points", "sensor_msgs/PointCloud2", t,
                         rosbag.encode_pointcloud2(t, xyzi)))
    return datasets.write_bag(path, msgs, compression)


def ingest(path: str, cap: int, timestamp_unit: int = -1,
           clock=time.perf_counter):
    """Stream the bag through ``run_bag``'s packing (read, decompress,
    decode, decimate, pad: everything before the device).  Returns
    (n_scans, seconds by ``clock``): the wall clock by default; the
    process's CPU time (``time.process_time``) leaves out what other work
    on a shared host takes."""
    decoders = rosbag.scan_decoders(timestamp_unit)
    n = 0
    t0 = clock()
    for _, mtype, _, raw in rosbag.BagReader(path).messages():
        if mtype not in decoders:
            continue
        _, xyzi, rel = decoders[mtype](raw)
        pts, inten = xyzi[:, :3], xyzi[:, 3]
        if len(pts) > cap:
            step = int(np.ceil(len(pts) / cap))
            pts, inten, rel = pts[::step], inten[::step], rel[::step]
        cloud = np.zeros((cap, 3), np.float32)
        cloud[:len(pts)] = pts
        mask = np.zeros(cap, bool)
        mask[:len(pts)] = True
        ipad = np.zeros(cap, np.float32)
        ipad[:len(inten)] = inten[:cap]
        relp = np.zeros(cap, np.float32)
        relp[:len(rel)] = rel[:cap]
        n += 1
    return n, clock() - t0


def measure(fmt: str, compression: str, n_scans: int, n_points: int,
            cap: int) -> dict:
    """One fixture bag built and ingested: scans, bytes, seconds, rates."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"{fmt}-{compression}.bag")
        size = build_fixture_bag(path, fmt, n_scans, n_points,
                                 compression=compression)
        n, dt = ingest(path, cap)
    if n != n_scans:
        raise AssertionError(f"{fmt} {compression}: {n} of {n_scans} scans")
    return {"format": fmt, "compression": compression, "scans": n,
            "points": n_points, "bytes": size, "seconds": dt,
            "scans_per_s": n / dt, "mb_per_s": size / dt / 1e6,
            "x_10hz": n / dt / 10.0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=300)
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--cap", type=int, default=32768)
    ap.add_argument("--compression", nargs="+", default=["none"],
                    choices=("none", "bz2", "lz4"))
    args = ap.parse_args(argv)
    for fmt in ("pointcloud2", "livox"):
        for comp in args.compression:
            r = measure(fmt, comp, args.scans, args.points, args.cap)
            print(f"{fmt:<12} {comp:<5} {r['scans']} scans x {r['points']} "
                  f"pts ({r['bytes'] / 1e6:.0f} MB): {r['scans_per_s']:7.1f} "
                  f"scans/s {r['mb_per_s']:7.0f} MB/s "
                  f"({r['x_10hz']:5.1f}x the 10 Hz budget)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
