"""Reading rosbag (format 2.0) files without ROS — the reading half of the
JAX package's ``runtime/rosbag.py``, copied for the port.

The reference is driven by ``rosbag play`` of dataset bags (run.launch:29-46,
README.md:83-94 — MulRan / Newer-College / Kimera-Multi / VBR-Colosseo).
This module reads those bags directly: record framing per the rosbag 2.0
on-disk format, chunk decompression (none / bz2 via the standard library /
lz4 via the native runtime's frame decoder), and deserializers for the
message types the pipeline consumes:

  - sensor_msgs/PointCloud2 (generic: driven by its PointField array)
  - livox_ros_driver/CustomMsg (Livox driver bags, per-point offset_time)
  - sensor_msgs/Imu
  - nav_msgs/Odometry (for parity-mode replay of recorded odometry)

plus ``encode_livox_custommsg`` for fixture bags.  The writer (the
reference's ``result.bag``) lives in ``utils/rosbag.py`` and is re-exported
here, so that every name of the JAX module resolves in this one.
``tools/bag_convert.py`` turns a bag into the shared dataset layout.
"""
from __future__ import annotations

import bz2
import struct
from typing import Iterator, Optional

import numpy as np

from ..utils import rosbag as _writer

# the writer's names, re-exported
BagWriter = _writer.BagWriter
encode_pointcloud2 = _writer.encode_pointcloud2
encode_pose_stamped = _writer.encode_pose_stamped

_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNKINFO = 0x06
_OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> dict:
    """A record header: sequence of (len u32, b'name=value')."""
    fields = {}
    i = 0
    while i < len(buf):
        (flen,) = struct.unpack_from("<I", buf, i)
        i += 4
        item = buf[i:i + flen]
        i += flen
        eq = item.index(b"=")
        fields[item[:eq].decode()] = item[eq + 1:]
    return fields


def _records(buf: bytes) -> Iterator[tuple[dict, bytes]]:
    """Iterate (header_fields, data) records of a serialized record stream."""
    i = 0
    n = len(buf)
    while i + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        hdr = _parse_header(buf[i:i + hlen])
        i += hlen
        (dlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        data = buf[i:i + dlen]
        i += dlen
        yield hdr, data


class Connection:
    def __init__(self, cid: int, topic: str, conn_hdr: bytes):
        sub = _parse_header(conn_hdr)
        self.cid = cid
        self.topic = topic
        self.type = sub.get("type", b"").decode()
        self.md5 = sub.get("md5sum", b"").decode()


class BagReader:
    """Streaming reader over a rosbag 2.0 file.

    iterate via `messages(topics=...)` -> (topic, type, t_sec, raw_bytes).
    """

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic = f.readline()
            if not magic.startswith(b"#ROSBAG V2.0"):
                raise ValueError(f"{path}: not a rosbag 2.0 file")
            self._start = f.tell()
        self.connections: dict[int, Connection] = {}

    # -- record-level iteration ------------------------------------------
    @staticmethod
    def _read_record(f):
        """Frame ONE record off a file object; None at end of stream.
        The single point of truth for on-disk record framing (the in-memory
        variant over chunk payloads is _records above)."""
        head = f.read(4)
        if len(head) < 4:
            return None
        (hlen,) = struct.unpack("<I", head)
        hdr = _parse_header(f.read(hlen))
        (dlen,) = struct.unpack("<I", f.read(4))
        return hdr, f.read(dlen)

    def _raw_records(self) -> Iterator[tuple[dict, bytes]]:
        with open(self.path, "rb") as f:
            f.seek(self._start)
            while (rec := self._read_record(f)) is not None:
                yield rec

    def _register_connection(self, hdr: dict, data: bytes):
        cid = struct.unpack("<I", hdr["conn"])[0]
        topic = hdr["topic"].decode()
        self.connections[cid] = Connection(cid, topic, data)

    def messages(self, topics: Optional[set] = None
                 ) -> Iterator[tuple[str, str, float, bytes]]:
        """Yield (topic, msg_type, time_sec, serialized_msg) in file order.
        topics: optional set of topic names to keep (None = all)."""
        for hdr, data in self._raw_records():
            op = hdr["op"][0]
            if op == _OP_CONNECTION:
                self._register_connection(hdr, data)
            elif op == _OP_CHUNK:
                comp = hdr.get("compression", b"none").decode()
                if comp == "bz2":
                    data = bz2.decompress(data)
                elif comp == "lz4":
                    from . import native

                    (size,) = struct.unpack("<I", hdr["size"])
                    data = native.lz4_decompress(data, size)
                elif comp != "none":
                    raise ValueError(f"unsupported compression {comp!r}")
                for shdr, sdata in _records(data):
                    sop = shdr["op"][0]
                    if sop == _OP_CONNECTION:
                        self._register_connection(shdr, sdata)
                    elif sop == _OP_MSG:
                        msg = self._emit(shdr, sdata)
                        if topics is None or msg[0] in topics:
                            yield msg
            elif op == _OP_MSG:
                msg = self._emit(hdr, data)
                if topics is None or msg[0] in topics:
                    yield msg
        return

    def _emit(self, hdr, data):
        cid = struct.unpack("<I", hdr["conn"])[0]
        # rosbag 'time' field: secs u32 then nsecs u32, little-endian
        sec, nsec = struct.unpack("<II", hdr["time"])
        t = sec + nsec * 1e-9
        conn = self.connections.get(cid)
        topic = conn.topic if conn else f"conn{cid}"
        mtype = conn.type if conn else ""
        return topic, mtype, t, data

    def topics(self) -> dict:
        """{topic: type} from the connection records.

        Fast path: indexed bags repeat their connection records in the
        index section, located by the bag header's index_pos — seek there
        and read metadata only, skipping every chunk's payload (a
        multi-GB bz2/lz4 bag would otherwise be fully decompressed for a
        metadata query). Unindexed bags (index_pos 0) fall back to the
        full scan."""
        index_pos = 0
        with open(self.path, "rb") as f:
            f.seek(self._start)
            first = self._read_record(f)
            if first is not None:
                hdr, _ = first
                if hdr.get("op", b"\x00")[0] == _OP_BAGHDR and \
                        "index_pos" in hdr:
                    (index_pos,) = struct.unpack("<Q", hdr["index_pos"])
            if index_pos > 0:
                f.seek(index_pos)
                while (rec := self._read_record(f)) is not None:
                    hdr, data = rec
                    if hdr.get("op", b"\x00")[0] == _OP_CONNECTION:
                        self._register_connection(hdr, data)
                if self.connections:
                    return {c.topic: c.type
                            for c in self.connections.values()}
        for _ in self.messages():
            pass
        return {c.topic: c.type for c in self.connections.values()}


# ---------------------------------------------------------------------------
# Message deserializers (ROS 1 serialization: little-endian, packed)
# ---------------------------------------------------------------------------

def _read_string(buf: bytes, i: int):
    (n,) = struct.unpack_from("<I", buf, i)
    return buf[i + 4:i + 4 + n].decode(errors="replace"), i + 4 + n


def _read_ros_header(buf: bytes, i: int):
    """std_msgs/Header: seq u32, stamp (sec u32, nsec u32), frame_id."""
    seq, sec, nsec = struct.unpack_from("<III", buf, i)
    frame, i = _read_string(buf, i + 12)
    return (sec + nsec * 1e-9, frame), i


_PF_DTYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
              5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


def decode_pointcloud2(buf: bytes, timestamp_unit: int = -1):
    """sensor_msgs/PointCloud2 -> (stamp, (N, 4) xyzi f32, rel_time (N,)).

    rel_time comes from a per-point 'time'/'t'/'timestamp'/'time_offset'
    field when present (seconds, normalized to the scan minimum), else
    zeros. Intensity 0 when absent.

    timestamp_unit (FAST-LIO convention, kitti.yaml:12): 0 s, 1 ms, 2 us,
    3 ns — the unit of the raw time field. -1 infers it from the field's
    name/dtype (ouster 't' is uint32 ns; velodyne 'time' / livox
    'time_offset' are float32 s; hesai 'timestamp' is float64 absolute s),
    falling back to a logged value-range heuristic for unknown layouts."""
    (stamp, _), i = _read_ros_header(buf, 0)
    height, width = struct.unpack_from("<II", buf, i)
    i += 8
    (nfields,) = struct.unpack_from("<I", buf, i)
    i += 4
    fields = []
    for _ in range(nfields):
        name, i = _read_string(buf, i)
        off, dtype, cnt = struct.unpack_from("<IBI", buf, i)
        i += 9
        fields.append((name, off, dtype, cnt))
    is_bigendian = buf[i]
    i += 1
    point_step, row_step = struct.unpack_from("<II", buf, i)
    i += 8
    (dlen,) = struct.unpack_from("<I", buf, i)
    i += 4
    data = buf[i:i + dlen]
    i += dlen
    # is_dense trails; ignored
    if is_bigendian:
        raise ValueError("big-endian PointCloud2 unsupported")
    n = height * width
    if n == 0 or point_step == 0:
        return stamp, np.zeros((0, 4), np.float32), np.zeros(0, np.float32)
    flat = np.frombuffer(data, np.uint8)
    if height > 1 and row_step > width * point_step:
        # organized cloud with per-row padding: slice each row by
        # row_step before concatenating, or every point after row 0
        # shifts by the pad and decodes as garbage
        rows = min(height, len(flat) // row_step)
        raw = flat[: rows * row_step].reshape(rows, row_step)
        raw = raw[:, : width * point_step].reshape(rows * width, point_step)
        n = raw.shape[0]
    else:
        raw = flat[:n * point_step]
        n = len(raw) // point_step
        raw = raw[:n * point_step].reshape(n, point_step)

    def col(name, with_dtype=False):
        for fname, off, dtype, cnt in fields:
            if fname == name:
                dt = _PF_DTYPES.get(dtype)
                if dt is None:
                    return (None, None) if with_dtype else None
                w = np.dtype(dt).itemsize
                vals = raw[:, off:off + w].copy().view(dt)[:, 0].astype(
                    np.float64)
                return (vals, np.dtype(dt)) if with_dtype else vals
        return (None, None) if with_dtype else None

    x, y, z = col("x"), col("y"), col("z")
    if x is None or y is None or z is None:
        raise ValueError("PointCloud2 without x/y/z fields")
    inten = col("intensity")
    if inten is None:
        inten = np.zeros(n, np.float64)
    xyzi = np.stack([x, y, z, inten], -1).astype(np.float32)
    rel = rel_dt = tf = None
    for tf in ("time", "t", "timestamp", "time_offset", "point_time"):
        rel, rel_dt = col(tf, with_dtype=True)
        if rel is not None:
            break
    if rel is None:
        relf = np.zeros(n, np.float32)
    else:
        rel = rel - rel.min() if len(rel) else rel
        relf = (rel * _rel_time_scale(tf, rel_dt, rel, timestamp_unit)
                ).astype(np.float32)
    return stamp, xyzi, relf


_TS_UNIT_SCALE = {0: 1.0, 1: 1e-3, 2: 1e-6, 3: 1e-9}


def _rel_time_scale(fname: str, dt: np.dtype, rel: np.ndarray,
                    timestamp_unit: int) -> float:
    """Seconds-per-unit of a per-point time field.

    Explicit config wins; otherwise the unit is keyed on field name/dtype
    (the conventions are fixed per driver), and only an unknown layout hits
    the value-range fallback — which logs its guess, since a mis-scaled
    sweep silently corrupts deskew."""
    if timestamp_unit in _TS_UNIT_SCALE:
        return _TS_UNIT_SCALE[timestamp_unit]
    if dt.kind in "iu":
        if fname == "t":                       # ouster driver: uint32 ns
            return 1e-9
    elif fname in ("time", "time_offset", "point_time", "timestamp"):
        # velodyne 'time' / livox 'time_offset' are float32 s; hesai
        # 'timestamp' is float64 absolute s (already min-normalized here)
        return 1.0
    # value-range fallback, banded for typical 0.01-1 s sweeps:
    # s <= 10 < ms <= 5e3 < us <= 5e6 < ns (a ms-unit sweep lands at
    # 10-1000, never in the old us band that mis-scaled it 1000x)
    mx = float(rel.max()) if len(rel) else 0.0
    if mx <= 10.0:
        scale = 1.0
    elif mx <= 5e3:
        scale = 1e-3
    elif mx <= 5e6:
        scale = 1e-6
    else:
        scale = 1e-9
    import logging

    logging.getLogger(__name__).warning(
        "per-point time field %r (%s, max %.3g) has no known unit "
        "convention; guessing %s — set preprocess/timestamp_unit to "
        "override", fname, dt, mx,
        {1.0: "seconds", 1e-3: "milliseconds", 1e-6: "microseconds",
         1e-9: "nanoseconds"}[scale])
    return scale


def scan_decoders(timestamp_unit: int = -1) -> dict:
    """Scan-carrying message types -> decoders, all returning
    (stamp, xyzi (N, 4), rel (N,) seconds). The single source of truth
    for which bag message types can feed the pipeline (run.py --bag and
    tools/bag_convert.py share it); bags recorded by the upstream Livox
    driver carry CustomMsg instead of PointCloud2."""
    return {
        "sensor_msgs/PointCloud2": lambda raw: decode_pointcloud2(
            raw, timestamp_unit=timestamp_unit),
        "livox_ros_driver/CustomMsg": decode_livox_custommsg,
        "livox_ros_driver2/CustomMsg": decode_livox_custommsg,
    }


def decode_livox_custommsg(buf: bytes):
    """livox_ros_driver/CustomMsg -> (stamp, (N, 4) xyzi f32, rel (N,) s).

    Bags recorded by the upstream Livox driver (the submodule FAST-LIO
    compiles against, .gitmodules:4-6) carry this custom
    point type instead of PointCloud2. Layout [external, livox_ros_driver
    msg/CustomMsg.msg + CustomPoint.msg]:

      std_msgs/Header header
      uint64 timebase        # ns epoch of the first point
      uint32 point_num
      uint8  lidar_id
      uint8[3] rsvd          # fixed array: no length prefix
      CustomPoint[] points   # u32 offset_time (ns, from timebase),
                             # f32 x, f32 y, f32 z,
                             # u8 reflectivity, u8 tag, u8 line -> 19 B

    offset_time rides out as rel seconds (min-normalized like
    decode_pointcloud2) — the true-time deskew input; reflectivity maps
    to the intensity channel.
    """
    (stamp, _), i = _read_ros_header(buf, 0)
    _timebase, point_num = struct.unpack_from("<QI", buf, i)
    i += 8 + 4 + 1 + 3  # timebase, point_num, lidar_id, rsvd[3]
    (n,) = struct.unpack_from("<I", buf, i)
    i += 4
    n = min(n, point_num) if point_num else n
    if n == 0:
        return stamp, np.zeros((0, 4), np.float32), np.zeros(0, np.float32)
    rec = np.frombuffer(buf, np.uint8, n * 19, i).reshape(n, 19)
    off_ns = rec[:, 0:4].copy().view(np.uint32)[:, 0].astype(np.float64)
    xyz = rec[:, 4:16].copy().view(np.float32)
    refl = rec[:, 16].astype(np.float32)
    xyzi = np.concatenate([xyz, refl[:, None]], 1).astype(np.float32)
    rel = ((off_ns - off_ns.min()) * 1e-9).astype(np.float32)
    return stamp, xyzi, rel


def decode_imu(buf: bytes):
    """sensor_msgs/Imu -> (stamp, gyro (3,), acc (3,))."""
    (stamp, _), i = _read_ros_header(buf, 0)
    # orientation quat (4 f64) + its 9 f64 covariance
    i += 4 * 8 + 9 * 8
    gyro = np.frombuffer(buf, np.float64, 3, i)
    i += 3 * 8 + 9 * 8
    acc = np.frombuffer(buf, np.float64, 3, i)
    return stamp, gyro.copy(), acc.copy()


def decode_odometry(buf: bytes):
    """nav_msgs/Odometry -> (stamp, (4, 4) pose)."""
    (stamp, _), i = _read_ros_header(buf, 0)
    _, i = _read_string(buf, i)  # child_frame_id
    px, py, pz, qx, qy, qz, qw = struct.unpack_from("<7d", buf, i)
    T = np.eye(4)
    # quaternion -> rotation (w last, ROS convention). Deliberately NOT
    # routed through ops/se3.quat_to_rot: this is the host-side f64
    # decode path and must not pay a tensor op (or f32 rounding) per
    # message; parity with se3 is covered by the decoder round-trip test
    n = qx * qx + qy * qy + qz * qz + qw * qw
    s = 0.0 if n == 0 else 2.0 / n
    T[0, 0] = 1 - s * (qy * qy + qz * qz)
    T[0, 1] = s * (qx * qy - qz * qw)
    T[0, 2] = s * (qx * qz + qy * qw)
    T[1, 0] = s * (qx * qy + qz * qw)
    T[1, 1] = 1 - s * (qx * qx + qz * qz)
    T[1, 2] = s * (qy * qz - qx * qw)
    T[2, 0] = s * (qx * qz - qy * qw)
    T[2, 1] = s * (qy * qz + qx * qw)
    T[2, 2] = 1 - s * (qx * qx + qy * qy)
    T[:3, 3] = [px, py, pz]
    return stamp, T


def encode_livox_custommsg(stamp: float, xyzi: np.ndarray,
                           rel_s: np.ndarray,
                           frame_id: str = "livox_frame") -> bytes:
    """Serialize (N, 4) xyzi + per-point rel seconds as
    livox_ros_driver/CustomMsg (fixture bags for the --bag livox path;
    layout per decode_livox_custommsg)."""
    xyzi = np.ascontiguousarray(xyzi, np.float32)
    n = len(xyzi)
    buf = struct.pack("<III", 0, *_writer._sec_nsec(stamp))
    buf += _writer._w_string(frame_id)
    buf += struct.pack("<QIB", int(round(stamp * 1e9)), n, 0)
    buf += b"\x00" * 3  # rsvd[3]
    buf += struct.pack("<I", n)
    rec = np.zeros((n, 19), np.uint8)
    off_ns64 = np.round(np.asarray(rel_s, np.float64) * 1e9).astype(np.int64)
    if n and (off_ns64.min() < 0 or off_ns64.max() >= 2 ** 32):
        # the wire format's offset_time is uint32 ns (~4.29 s span);
        # silently wrapping would corrupt per-point times (and decode's
        # min-normalization would then shift every other point too)
        raise ValueError(
            f"livox CustomMsg offset_time must be in [0, 4.29) s, got "
            f"[{rel_s.min():.3f}, {rel_s.max():.3f}] s — rel_s must be "
            f"scan-relative, not absolute")
    off_ns = off_ns64.astype(np.uint32)
    rec[:, 0:4] = off_ns[:, None].copy().view(np.uint8)
    rec[:, 4:16] = xyzi[:, :3].copy().view(np.uint8).reshape(n, 12)
    rec[:, 16] = np.clip(xyzi[:, 3], 0, 255).astype(np.uint8)
    return buf + rec.tobytes()
