"""Recorded-data fixtures written from the port's simulator: a KITTI-style
directory, a drifted odometry file and ROS bags (PointCloud2 with a time
field or Livox CustomMsg, Imu, optionally Odometry; none / bz2 / lz4
chunks).  Test and smoke infrastructure: ``chip_smoke.py`` and the CPU
tests drive the dataset entry points (``run.py --kitti / --scans / --bag``)
with them, since no public dataset ships with the repository.

The scene is the sim golden's room (26 m, 10 boxes) and a 7 m loop that
starts from rest (``ramped_loop``): the IMU file opens with a standstill,
as the standstill init of ``--kitti`` and ``--bag`` expects.  Scans are
written in the LiDAR frame of a preset's extrinsic (p_body = R p_lidar + t):
the simulated LiDAR moves with the body, offset by t.  Each scan carries the
simulator's true per-point sweep times (a ``rel_times/`` sidecar, or the
bag's time field) and integer intensities in 1..255.  Stamps are scan-END
times, as ``times.txt`` and the bag's headers are read.

Also here: the Imu and Odometry message encoders and an LZ4 frame writer,
which a bag with lz4 chunks needs.
"""
from __future__ import annotations

import bz2
import functools
import multiprocessing
import os
import struct
from concurrent.futures import ProcessPoolExecutor
from typing import Iterable, Iterator, NamedTuple

import numpy as np

from ..runtime import rosbag
from ..utils import sim

T_BASE = 100.0          # bag stamps: seconds on the recording's clock


class Scan(NamedTuple):
    """One simulated scan: raw LiDAR-frame points (N, 3) without no-hit
    rows, integer intensities (N,), sweep times from the scan's start (N,),
    its end stamp and the true body pose then (in the filter's world
    frame: the body frame at t = 0)."""

    points: np.ndarray
    intensities: np.ndarray
    rel_times: np.ndarray
    stamp: float
    truth: np.ndarray


class Recording(NamedTuple):
    """Scans and IMU rows [t gx gy gz ax ay az]."""

    scans: list
    imu: np.ndarray

    @property
    def stamps(self) -> np.ndarray:
        return np.asarray([s.stamp for s in self.scans])

    @property
    def truth(self) -> np.ndarray:
        return np.stack([s.truth for s in self.scans])


def ramped_loop(radius=7.0, period=30.0, z=1.5, ramp=2.0,
                rest=0.5) -> sim.Trajectory:
    """``sim.Trajectory.loop`` from rest: at rest until ``rest`` seconds,
    then the phase is om (s - ramp (1 - exp(-s / ramp))) with s = t - rest,
    so the speed rises smoothly to the loop's over ~``ramp`` seconds."""
    om = 2 * np.pi / period

    def phase(t):
        s = max(t - rest, 0.0)
        return om * (s - ramp * (1.0 - np.exp(-s / ramp)))

    def pos(t):
        a = phase(t)
        return np.array([radius * np.cos(a) - radius, radius * np.sin(a), z])

    return sim.Trajectory(pos, lambda t: phase(t) + np.pi / 2)


def golden_scene():
    """The sim golden's room and a 7 m loop lapped every 30 s from rest."""
    return sim.World.room(size=26.0, height=5.0, n_boxes=10, seed=3), \
        ramped_loop()


def _extrinsic(extrinsic_R, extrinsic_T):
    R = np.eye(3) if extrinsic_R is None else \
        np.asarray(extrinsic_R, np.float64).reshape(3, 3)
    t = np.zeros(3) if extrinsic_T is None else \
        np.asarray(extrinsic_T, np.float64)
    return R, t


def simulate_scan(i: int, raw_points: int, extrinsic_R=None,
                  extrinsic_T=None, hz: float = 10.0, seed: int = 0,
                  scene=None, ring_major: bool = True) -> Scan:
    """Scan ``i`` of a run: a swept scan of ``raw_points`` rays over [i /
    hz, (i + 1) / hz) from a LiDAR mounted at the extrinsic (R row-major
    (9,), t (3,); identity by default) on the body moving along the scene's
    trajectory (the golden scene by default).  Points come ring after ring
    (``ring_major``, an organized cloud's rows) or in firing order (all
    rings of one azimuth step, then the next: an index that ramps with
    time).  Each scan has its own seeds, so scans can be made in any
    order."""
    world, traj = scene or golden_scene()
    R_li, t_li = _extrinsic(extrinsic_R, extrinsic_T)
    # the LiDAR's trajectory: the body's, offset by the lever arm; the
    # simulator casts in the body's axes, rotated into the LiDAR's after
    lidar = sim.Trajectory(lambda t: traj.pos_fn(t) + traj._rot(t) @ t_li,
                           traj.yaw_fn, traj.tilt_fn)
    period = 1.0 / hz
    t0 = i * period
    pts, rel = sim.simulate_scan_swept(
        world, lidar, t0, n_points=raw_points, noise=0.01,
        seed=seed + 100 + i, scan_period=period)
    if ring_major and raw_points % sim.N_RINGS == 0:
        # an organized cloud's order, one ring after another (the
        # simulator fires all rings per azimuth step): every k-th point
        # then keeps every ring, as the decimations of --kitti expect
        rows = np.arange(raw_points).reshape(-1, sim.N_RINGS).T.ravel()
        pts, rel = pts[rows], rel[rows]
    ok = np.isfinite(pts).all(-1)
    rng = np.random.default_rng(seed + 10_000 + i)
    T0_inv = np.linalg.inv(traj.pose(0.0))
    return Scan((pts[ok].astype(np.float64) @ R_li).astype(np.float32),
                rng.integers(1, 256, int(ok.sum())).astype(np.float32),
                rel[ok], t0 + period, T0_inv @ traj.pose(t0 + period))


def simulate_scans(n_scans: int, raw_points: int, extrinsic_R=None,
                   extrinsic_T=None, hz: float = 10.0, seed: int = 0,
                   scene=None, ring_major: bool = True,
                   workers: int = 1) -> Iterator[Scan]:
    """``simulate_scan`` for scans 0 .. n_scans - 1, in order; with
    ``workers`` > 1 they are made in that many processes (the golden scene
    only: a scene's functions do not cross processes)."""
    args = (raw_points, extrinsic_R, extrinsic_T, hz, seed)
    if workers <= 1:
        for i in range(n_scans):
            yield simulate_scan(i, *args, scene=scene, ring_major=ring_major)
        return
    if scene is not None:
        raise ValueError("a scene other than the golden one is made in one "
                         "process")
    # one BLAS thread a worker (the variables are read as numpy loads in
    # each new process): the workers share the cores
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update(dict.fromkeys(_THREAD_VARS, "1"))
    try:
        pool = ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
        scans = pool.map(functools.partial(
            simulate_scan, raw_points=raw_points, extrinsic_R=extrinsic_R,
            extrinsic_T=extrinsic_T, hz=hz, seed=seed,
            ring_major=ring_major), range(n_scans), chunksize=4)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    with pool:
        yield from scans


_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def simulate_imu_rows(duration: float, imu_hz: float = 100.0,
                      standstill: float = 0.5, seed: int = 0,
                      scene=None) -> np.ndarray:
    """IMU rows over (-standstill, duration): at rest before 0, then along
    the scene's trajectory, with the sim stream's noise; sampled half a
    period off the scan stamps, so that no sample sits on a window's
    edge."""
    _, traj = scene or golden_scene()
    rng = np.random.default_rng(seed + 7)
    half = 0.5 / imu_hz
    ts = np.arange(-standstill, 0.0, 1.0 / imu_hz) + half
    still = np.zeros((len(ts), 7))
    still[:, 0] = ts
    still[:, 4:7] = traj._rot(0.0).T @ np.array([0.0, 0.0, 9.81])
    still[:, 1:4] += rng.normal(0, 0.002, (len(ts), 3))
    still[:, 4:7] += rng.normal(0, 0.02, (len(ts), 3))
    ts, gyro, acc = sim.simulate_imu(traj, half, duration, rate=imu_hz,
                                     gyro_noise=0.002, acc_noise=0.02,
                                     seed=seed + 8)
    return np.concatenate([still, np.column_stack([ts, gyro, acc])])


def record(n_scans: int, raw_points: int, extrinsic_R=None, extrinsic_T=None,
           hz: float = 10.0, imu_hz: float = 100.0, standstill: float = 0.5,
           seed: int = 0, scene=None, ring_major: bool = True,
           workers: int = 1) -> Recording:
    """``simulate_scans`` and ``simulate_imu_rows`` of one run, held in
    memory."""
    return Recording(
        list(simulate_scans(n_scans, raw_points, extrinsic_R, extrinsic_T,
                            hz, seed, scene, ring_major, workers)),
        simulate_imu_rows(n_scans / hz, imu_hz, standstill, seed, scene))


def write_kitti(out_dir: str, scans: Iterable[Scan], imu: np.ndarray,
                rel_times: bool = True):
    """The KITTI-style layout of ``run.py --kitti``: ``scans/%06d.bin``
    (xyzi float32), ``times.txt``, ``imu.txt`` and, with ``rel_times``,
    ``rel_times/%06d.npy``; the scans are written as they come.  Returns
    (stamps (N,), truth (N, 4, 4))."""
    os.makedirs(os.path.join(out_dir, "scans"), exist_ok=True)
    if rel_times:
        os.makedirs(os.path.join(out_dir, "rel_times"), exist_ok=True)
    stamps, truth = [], []
    for i, s in enumerate(scans):
        np.column_stack([s.points, s.intensities]).astype(np.float32).tofile(
            os.path.join(out_dir, "scans", f"{i:06d}.bin"))
        if rel_times:
            np.save(os.path.join(out_dir, "rel_times", f"{i:06d}.npy"),
                    s.rel_times.astype(np.float32))
        stamps.append(s.stamp)
        truth.append(s.truth)
    np.savetxt(os.path.join(out_dir, "times.txt"), stamps, fmt="%.9f")
    np.savetxt(os.path.join(out_dir, "imu.txt"), imu, fmt="%.9f")
    return np.asarray(stamps), np.stack(truth)


def drifted_odometry(truth: np.ndarray, seed: int = 0,
                     sigma: float = 0.004) -> np.ndarray:
    """Odometry that drifts from ``truth`` (N, 4, 4): each step's relative
    motion is perturbed by a seeded random twist of ``sigma`` (m, rad), a
    fifth of it along z and about x / y, so that the drift is mostly in
    the plane and in yaw."""
    rng = np.random.default_rng(seed)
    out = [truth[0].copy()]
    for i in range(1, len(truth)):
        noise = np.eye(4)
        noise[:3, 3] = rng.normal(0, sigma, 3) * np.array([1, 1, 0.2])
        noise[:3, :3] = sim.so3_exp_np(
            rng.normal(0, sigma, 3) * np.array([0.2, 0.2, 1]))
        out.append(out[-1] @ np.linalg.inv(truth[i - 1]) @ truth[i] @ noise)
    return np.stack(out)


def body_frame_scans(rec: Recording, extrinsic_R=None, extrinsic_T=None):
    """The recording's scans in the body frame (xyzi), as parity mode reads
    them (the reference's /cloud_registered in the body frame)."""
    R, t = _extrinsic(extrinsic_R, extrinsic_T)
    return [np.column_stack([s.points.astype(np.float64) @ R.T + t,
                             s.intensities]).astype(np.float32)
            for s in rec.scans]


# ---------------------------------------------------------------------------
# messages and bags
# ---------------------------------------------------------------------------

def _header(stamp: float, frame: str) -> bytes:
    sec = int(stamp)
    nsec = int(round((stamp - sec) * 1e9))
    if nsec >= 1_000_000_000:
        sec, nsec = sec + 1, nsec - 1_000_000_000
    b = frame.encode()
    return struct.pack("<III", 0, sec, nsec) + struct.pack("<I", len(b)) + b


def encode_pointcloud2_timed(stamp: float, xyzi: np.ndarray,
                             rel: np.ndarray) -> bytes:
    """sensor_msgs/PointCloud2 of float32 x y z intensity and a velodyne-
    style float32 ``time`` field (seconds from the scan's start)."""
    n = len(xyzi)
    fields = (("x", 0), ("y", 4), ("z", 8), ("intensity", 12), ("time", 16))
    buf = _header(stamp, "lidar") + struct.pack("<III", 1, n, len(fields))
    for name, off in fields:
        buf += struct.pack("<I", len(name)) + name.encode() + \
            struct.pack("<IBI", off, 7, 1)
    raw = np.column_stack([xyzi, rel]).astype(np.float32).tobytes()
    buf += struct.pack("<BII", 0, 20, 20 * n) + struct.pack("<I", len(raw))
    return buf + raw + b"\x01"


def encode_imu(stamp: float, gyro, acc) -> bytes:
    """sensor_msgs/Imu: identity orientation, zero covariances."""
    z9 = struct.pack("<9d", *([0.0] * 9))
    return (_header(stamp, "imu") + struct.pack("<4d", 0, 0, 0, 1) + z9
            + struct.pack("<3d", *gyro) + z9 + struct.pack("<3d", *acc) + z9)


def _quat(R: np.ndarray):
    """(x, y, z, w) of a rotation matrix, w >= 0 (float64)."""
    w = np.sqrt(max(0.0, 1.0 + np.trace(R))) / 2
    x = np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2
    y = np.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2
    z = np.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2
    x = np.copysign(x, R[2, 1] - R[1, 2])
    y = np.copysign(y, R[0, 2] - R[2, 0])
    z = np.copysign(z, R[1, 0] - R[0, 1])
    return x, y, z, w


def encode_odometry(stamp: float, T: np.ndarray) -> bytes:
    """nav_msgs/Odometry with pose T (zero twist and covariances)."""
    T = np.asarray(T, np.float64)
    b = b"base"
    return (_header(stamp, "odom") + struct.pack("<I", len(b)) + b
            + struct.pack("<7d", *T[:3, 3], *_quat(T[:3, :3]))
            + struct.pack("<36d", *([0.0] * 36))
            + struct.pack("<6d", *([0.0] * 6))
            + struct.pack("<36d", *([0.0] * 36)))


def _varlen(n: int) -> bytes:
    out = bytearray()
    while n >= 255:
        out.append(255)
        n -= 255
    out.append(n)
    return bytes(out)


def _sequence(lit: bytes, offset: int = 0, mlen: int = 0) -> bytes:
    """One LZ4 sequence: literals, then (unless last) a match of ``mlen``
    bytes ``offset`` back."""
    ml = mlen - 4 if offset else 0
    out = bytes([(min(len(lit), 15) << 4) | min(ml, 15)])
    if len(lit) >= 15:
        out += _varlen(len(lit) - 15)
    out += lit
    if offset:
        out += struct.pack("<H", offset)
        if ml >= 15:
            out += _varlen(ml - 15)
    return out


def lz4_block(data: bytes) -> bytes:
    """A greedy LZ4 block compressor (4-byte hash matches, 64 KiB window;
    the format's end rules: the last 5 bytes are literals and no match
    starts in the last 12).  Pure Python: for fixtures of a few MB."""
    n, out, table, anchor, i = len(data), [], {}, 0, 0
    while i < n - 12:
        key = data[i:i + 4]
        j = table.get(key)
        table[key] = i
        if j is None or i - j > 65535:
            i += 1
            continue
        m = 4
        while i + m < n - 5 and data[j + m] == data[i + m]:
            m += 1
        out.append(_sequence(data[anchor:i], i - j, m))
        i = anchor = i + m
    out.append(_sequence(data[anchor:]))
    return b"".join(out)


def lz4_frame(payload: bytes, compress_limit: int = 1 << 20) -> bytes:
    """A standard LZ4 frame (magic 0x184D2204, 4 MiB blocks): blocks
    compressed by ``lz4_block`` while the payload is at most
    ``compress_limit`` bytes, else alternating literal-only compressed and
    stored blocks (both decoder paths, fast enough for large fixtures)."""
    bsz = 4 << 20
    out = struct.pack("<I", 0x184D2204) + bytes([0x60, 0x70, 0x00])
    for k, at in enumerate(range(0, len(payload), bsz)):
        blk = payload[at:at + bsz]
        if len(payload) <= compress_limit:
            enc = lz4_block(blk)
        elif k % 2 == 0:
            enc = _sequence(blk)
        else:
            enc = None
        if enc is None or len(enc) >= len(blk):
            out += struct.pack("<I", 0x80000000 | len(blk)) + blk
        else:
            out += struct.pack("<I", len(enc)) + enc
    return out + struct.pack("<I", 0)


def _field(name: str, value: bytes) -> bytes:
    item = name.encode() + b"=" + value
    return struct.pack("<I", len(item)) + item


def _record(fields: dict, data: bytes) -> bytes:
    hdr = b"".join(_field(k, v) for k, v in fields.items())
    return struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", len(data)) \
        + data


def write_bag(path: str, messages, compression: str = "lz4",
              chunk_bytes: int = 32 << 20) -> int:
    """A rosbag 2.0 file of ``messages`` — (topic, type, stamp, payload) in
    time order — in chunks of about ``chunk_bytes`` compressed with
    ``compression`` (none / bz2 / lz4), connections first, no index (the
    reader streams the chunks).  Returns the file's size in bytes."""
    conns, recs = {}, []
    for topic, mtype, _, _ in messages:
        if topic not in conns:
            conns[topic] = len(conns)
            inner = (_field("topic", topic.encode())
                     + _field("type", mtype.encode())
                     + _field("md5sum", b"*")
                     + _field("message_definition", b""))
            recs.append(_record({"op": b"\x07",
                                 "conn": struct.pack("<I", conns[topic]),
                                 "topic": topic.encode()}, inner))
    for topic, _, stamp, payload in messages:
        sec = int(stamp)
        nsec = min(int(round((stamp - sec) * 1e9)), 999_999_999)
        recs.append(_record({"op": b"\x02",
                             "conn": struct.pack("<I", conns[topic]),
                             "time": struct.pack("<II", sec, nsec)},
                            payload))
    chunks, cur = [], []
    for r in recs:
        cur.append(r)
        if sum(map(len, cur)) >= chunk_bytes:
            chunks.append(b"".join(cur))
            cur = []
    if cur:
        chunks.append(b"".join(cur))
    pack = {"none": lambda b: b, "bz2": bz2.compress, "lz4": lz4_frame}
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(_record({"op": b"\x03", "index_pos": struct.pack("<Q", 0),
                         "conn_count": struct.pack("<I", len(conns)),
                         "chunk_count": struct.pack("<I", len(chunks))},
                        b""))
        for c in chunks:
            f.write(_record({"op": b"\x05",
                             "compression": compression.encode(),
                             "size": struct.pack("<I", len(c))},
                            pack[compression](c)))
    return os.path.getsize(path)


def bag_messages(rec: Recording, fmt: str = "pointcloud2",
                 odometry=None, odom_skip=(), time_field: bool = True,
                 t_base: float = T_BASE):
    """The recording as bag messages in time order: scans on ``/points``
    (PointCloud2, with the ``time`` field unless ``time_field`` is off) or
    ``/livox/lidar`` (CustomMsg), IMU on ``/imu``, and with ``odometry``
    ((N, 4, 4), one per scan) ``/Odometry`` at the scans' stamps but for
    the scans in ``odom_skip``.  Stamps are ``t_base`` + the recording's."""
    msgs = []
    for i, s in enumerate(rec.scans):
        t, r = t_base + s.stamp, s.rel_times
        xyzi = np.column_stack([s.points, s.intensities]).astype(np.float32)
        if fmt == "livox":
            msgs.append(("/livox/lidar", "livox_ros_driver/CustomMsg", t,
                         rosbag.encode_livox_custommsg(t, xyzi, r)))
        elif time_field:
            msgs.append(("/points", "sensor_msgs/PointCloud2", t,
                         encode_pointcloud2_timed(t, xyzi, r)))
        else:
            msgs.append(("/points", "sensor_msgs/PointCloud2", t,
                         rosbag.encode_pointcloud2(t, xyzi, "lidar")))
        if odometry is not None and i not in odom_skip:
            msgs.append(("/Odometry", "nav_msgs/Odometry", t,
                         encode_odometry(t, odometry[i])))
    for row in rec.imu:
        t = t_base + row[0]
        msgs.append(("/imu", "sensor_msgs/Imu", t,
                     encode_imu(t, row[1:4], row[4:7])))
    # stable: a scan and the IMU sample at its stamp keep the scan first
    return sorted(msgs, key=lambda m: m[2])
