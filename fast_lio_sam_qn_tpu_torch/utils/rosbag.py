"""Writing rosbag (format 2.0) files — the reference's ``result.bag``
(fast_lio_sam_qn.cpp:380-396): ``/keyframe_pcd`` (sensor_msgs/PointCloud2)
and ``/keyframe_pose`` (geometry_msgs/PoseStamped) at the keyframes' stamps.
A copy of the writing half of the JAX package's ``runtime/rosbag.py``; the
reader comes with the port's ``--bag`` mode.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from ..ops import se3


def _w_field(name: str, value: bytes) -> bytes:
    item = name.encode() + b"=" + value
    return struct.pack("<I", len(item)) + item


def _w_record(fields: dict, data: bytes) -> bytes:
    hdr = b"".join(_w_field(k, v) for k, v in fields.items())
    return struct.pack("<I", len(hdr)) + hdr + struct.pack(
        "<I", len(data)) + data


def _sec_nsec(t: float) -> tuple[int, int]:
    """Normalized ROS time: 0 <= nsec < 1e9 (rounding may carry into sec)."""
    sec = int(t)
    nsec = int(round((t - sec) * 1e9))
    if nsec >= 1_000_000_000:
        sec += 1
        nsec -= 1_000_000_000
    return sec, nsec


def _w_time(t: float) -> bytes:
    return struct.pack("<II", *_sec_nsec(t))


def _w_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


# well-known ROS message md5sums (needed by rosbag/rostopic consumers)
_MSG_MD5 = {
    "sensor_msgs/PointCloud2": "1158d486dd51d683ce2f1be655c3c181",
    "geometry_msgs/PoseStamped": "d3812c3cbc69362b77dc0b19b345f8f5",
}

_HEADER_DEF = """MSG: std_msgs/Header
uint32 seq
time stamp
string frame_id
"""

# canonical gendeps-style message definitions (genpy-based consumers —
# rosbag Python API, rostopic echo — rebuild the message class from this
# text; an empty definition would deserialize to a fieldless class)
_MSG_DEFS = {
    "sensor_msgs/PointCloud2": """std_msgs/Header header
uint32 height
uint32 width
sensor_msgs/PointField[] fields
bool is_bigendian
uint32 point_step
uint32 row_step
uint8[] data
bool is_dense
================================================================================
""" + _HEADER_DEF + """\
================================================================================
MSG: sensor_msgs/PointField
uint8 INT8=1
uint8 UINT8=2
uint8 INT16=3
uint8 UINT16=4
uint8 INT32=5
uint8 UINT32=6
uint8 FLOAT32=7
uint8 FLOAT64=8
string name
uint32 offset
uint8 datatype
uint32 count
""",
    "geometry_msgs/PoseStamped": """std_msgs/Header header
geometry_msgs/Pose pose
================================================================================
""" + _HEADER_DEF + """\
================================================================================
MSG: geometry_msgs/Pose
geometry_msgs/Point position
geometry_msgs/Quaternion orientation
================================================================================
MSG: geometry_msgs/Point
float64 x
float64 y
float64 z
================================================================================
MSG: geometry_msgs/Quaternion
float64 x
float64 y
float64 z
float64 w
""",
}


class BagWriter:
    """Write a well-formed (indexed, uncompressed-chunk) rosbag 2.0 file.

    Produces the reference's `result.bag` layout — `/keyframe_pcd`
    (sensor_msgs/PointCloud2) + `/keyframe_pose`
    (geometry_msgs/PoseStamped) at keyframe timestamps
    (fast_lio_sam_qn.cpp:380-396) — readable by this module's BagReader
    and by standard rosbag tooling (bag header, chunk, per-connection
    index-data, connection and chunk-info records all emitted per the
    format spec; message_definition carries the canonical field text)."""

    def __init__(self, path: str):
        self._path = path
        self._conns: dict[str, int] = {}
        self._conn_records: list[bytes] = []
        self._msgs: list[tuple[int, float, bytes]] = []

    def _conn(self, topic: str, mtype: str) -> int:
        if topic in self._conns:
            return self._conns[topic]
        cid = len(self._conns)
        self._conns[topic] = cid
        inner = (_w_field("topic", topic.encode())
                 + _w_field("type", mtype.encode())
                 + _w_field("md5sum",
                            _MSG_MD5.get(mtype, "*").encode())
                 + _w_field("message_definition",
                            _MSG_DEFS.get(mtype, "").encode()))
        self._conn_records.append(_w_record(
            {"op": b"\x07", "conn": struct.pack("<I", cid),
             "topic": topic.encode()}, inner))
        return cid

    def write(self, topic: str, mtype: str, t: float, msg: bytes):
        self._msgs.append((self._conn(topic, mtype), t, msg))

    def close(self):
        parts = list(self._conn_records)
        pos = sum(len(p) for p in parts)
        offsets = []  # (cid, t, offset into uncompressed chunk)
        for cid, t, msg in self._msgs:
            offsets.append((cid, t, pos))
            rec = _w_record(
                {"op": b"\x02", "conn": struct.pack("<I", cid),
                 "time": _w_time(t)}, msg)
            parts.append(rec)
            pos += len(rec)
        chunk = b"".join(parts)
        with open(self._path, "wb") as f:
            f.write(b"#ROSBAG V2.0\n")
            # bag header record, padded to 4096 bytes like real bags;
            # index_pos is patched after layout is known
            hdr_pos = f.tell()
            f.write(self._bag_header(0))
            chunk_pos = f.tell()
            f.write(_w_record(
                {"op": b"\x05", "compression": b"none",
                 "size": struct.pack("<I", len(chunk))}, chunk))
            # per-connection index-data records follow their chunk
            for cid in sorted(set(c for c, _, _ in offsets)) or []:
                rows = [(t, off) for c, t, off in offsets if c == cid]
                data = b"".join(_w_time(t) + struct.pack("<I", off)
                                for t, off in rows)
                f.write(_w_record(
                    {"op": b"\x04", "ver": struct.pack("<I", 1),
                     "conn": struct.pack("<I", cid),
                     "count": struct.pack("<I", len(rows))}, data))
            index_pos = f.tell()
            for rec in self._conn_records:
                f.write(rec)
            times = [t for _, t, _ in self._msgs] or [0.0]
            counts: dict[int, int] = {}
            for cid, _, _ in offsets:
                counts[cid] = counts.get(cid, 0) + 1
            info_data = b"".join(
                struct.pack("<II", cid, n) for cid, n in sorted(
                    counts.items()))
            f.write(_w_record(
                {"op": b"\x06", "ver": struct.pack("<I", 1),
                 "chunk_pos": struct.pack("<Q", chunk_pos),
                 "start_time": _w_time(min(times)),
                 "end_time": _w_time(max(times)),
                 "count": struct.pack("<I", len(counts))}, info_data))
            f.seek(hdr_pos)
            f.write(self._bag_header(index_pos))

    def _bag_header(self, index_pos: int) -> bytes:
        rec_head = (_w_field("op", b"\x03")
                    + _w_field("index_pos", struct.pack("<Q", index_pos))
                    + _w_field("conn_count",
                               struct.pack("<I", len(self._conns)))
                    + _w_field("chunk_count", struct.pack("<I", 1)))
        # pad the DATA portion with spaces so the WHOLE record (both length
        # fields + header + data) occupies exactly 4096 bytes, per the spec
        pad = 4096 - 8 - len(rec_head)
        return (struct.pack("<I", len(rec_head)) + rec_head
                + struct.pack("<I", pad) + b" " * pad)


def encode_pointcloud2(stamp: float, xyzi: np.ndarray,
                       frame_id: str = "map") -> bytes:
    """Serialize an (N, 4) xyzi float32 array as sensor_msgs/PointCloud2."""
    xyzi = np.ascontiguousarray(xyzi, np.float32)
    n = len(xyzi)
    buf = struct.pack("<III", 0, *_sec_nsec(stamp))
    buf += _w_string(frame_id)
    buf += struct.pack("<II", 1, n)
    fields = [("x", 0), ("y", 4), ("z", 8), ("intensity", 12)]
    buf += struct.pack("<I", len(fields))
    for name, off in fields:
        buf += _w_string(name) + struct.pack("<IBI", off, 7, 1)
    buf += struct.pack("<B", 0)              # little-endian
    buf += struct.pack("<II", 16, 16 * n)    # point_step, row_step
    raw = xyzi.tobytes()
    buf += struct.pack("<I", len(raw)) + raw
    buf += struct.pack("<B", 1)              # is_dense
    return buf


def encode_pose_stamped(stamp: float, T: np.ndarray,
                        frame_id: str = "map") -> bytes:
    """Serialize a (4, 4) pose as geometry_msgs/PoseStamped."""
    buf = struct.pack("<III", 0, *_sec_nsec(stamp))
    buf += _w_string(frame_id)
    T = np.asarray(T, np.float64)
    # the package's one rotation -> quaternion (xyzw, w >= 0), in fp32
    qx, qy, qz, qw = se3.rot_to_quat(torch.from_numpy(
        np.asarray(T[:3, :3], np.float32))).numpy().astype(np.float64)
    buf += struct.pack("<7d", T[0, 3], T[1, 3], T[2, 3], qx, qy, qz, qw)
    return buf
