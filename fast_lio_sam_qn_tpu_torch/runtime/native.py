"""ctypes bindings of the native host runtime (``runtime.cpp``): scan
decoding, the prefetching ``ScanLoader``, the ApproximateTime pairing
``ApproxTimeSync`` and the LZ4 frame decoder of rosbag chunks — the JAX
package's ``runtime/native.py`` with the port's own build.

The library is built with ``g++`` at first use into ``build/runtime/``
beside the package, under a name keyed on a hash of the source and the
flags, through a temporary file renamed into place: a stale library is
never loaded and processes building at once do not race.  Every entry
point but ``lz4_decompress`` has a pure-Python fallback (``utils/io.py``),
the reference's host behaviour when no compiler is present; the native
path is the production one (multithreaded decode and prefetch overlapping
the device's work).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..utils import io as pyio

SRC = Path(__file__).resolve().parent / "runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "runtime"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library built from the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libflsq_runtime-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing; returns its path.  Raises
    RuntimeError with the compiler's output when the build fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SRC)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not run: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_chr_pp = ctypes.POINTER(ctypes.c_char_p)
    f32_p = ctypes.POINTER(ctypes.c_float)
    u8_p = ctypes.POINTER(ctypes.c_uint8)
    i64, dbl = ctypes.c_int64, ctypes.c_double
    sigs = {
        "flsq_read_velodyne_bin": (i64, [ctypes.c_char_p, f32_p, i64]),
        "flsq_read_pcd": (i64, [ctypes.c_char_p, f32_p, i64]),
        "flsq_loader_create": (ctypes.c_void_p, [
            c_chr_pp, ctypes.c_int, i64, ctypes.c_int, ctypes.c_int]),
        "flsq_loader_get": (i64, [ctypes.c_void_p, ctypes.c_int, f32_p]),
        "flsq_loader_destroy": (None, [ctypes.c_void_p]),
        "flsq_sync_create": (ctypes.c_void_p, [dbl]),
        "flsq_sync_push_a": (None, [ctypes.c_void_p, dbl, i64]),
        "flsq_sync_push_b": (None, [ctypes.c_void_p, dbl, i64]),
        "flsq_sync_pop": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.POINTER(i64), ctypes.POINTER(i64),
            ctypes.POINTER(dbl), ctypes.POINTER(dbl)]),
        "flsq_sync_destroy": (None, [ctypes.c_void_p]),
        "flsq_lz4_decompress": (i64, [u8_p, i64, u8_p, i64]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, built if needed; None if it cannot be
    built (``build_error()`` says why)."""
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (RuntimeError, OSError) as e:
                _build_error = str(e)
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the native library is unavailable (None when it loaded)."""
    get_lib()
    return _build_error


def lz4_decompress(data: bytes, decompressed_size: int) -> bytes:
    """Decompress a standard LZ4 frame (rosbag lz4 chunk compression),
    natively: no lz4 module is assumed."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("lz4 rosbag chunks need the native runtime: "
                           f"{_build_error}")
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(decompressed_size, np.uint8)
    u8_p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.flsq_lz4_decompress(src.ctypes.data_as(u8_p), len(src),
                                dst.ctypes.data_as(u8_p), len(dst))
    if n < 0:
        raise ValueError("corrupt LZ4 frame in rosbag chunk")
    return dst[:n].tobytes()


def read_scan_python(path: str) -> np.ndarray:
    """The Python readers: a velodyne ``.bin`` or a PCD -> (N, 4) xyzi."""
    if path.endswith(".bin"):
        return pyio.read_velodyne_bin(path)
    # with_intensity keeps the fallback consistent with the native decoder
    return pyio.load_pcd(path, with_intensity=True)


def read_scan(path: str, cap: int = 1 << 18) -> np.ndarray:
    """Decode a ``.bin`` / ``.pcd`` scan -> (N, 4) xyzi float32 (at most
    ``cap`` points natively; the Python fallback reads them all)."""
    lib = get_lib()
    if lib is None:
        return read_scan_python(path)
    buf = np.empty((cap, 4), np.float32)
    out = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    read = lib.flsq_read_velodyne_bin if path.endswith(".bin") \
        else lib.flsq_read_pcd
    n = read(path.encode(), out, cap)
    if n < 0:
        raise IOError(f"native decode failed: {path}")
    return buf[:n].copy()


class ScanLoader:
    """Prefetching scan loader over a file list (native worker pool;
    sequential Python fallback)."""

    def __init__(self, paths: Sequence[str], cap: int = 1 << 18,
                 n_threads: int = 4, lookahead: int = 8):
        self.paths = list(paths)
        self.cap = cap
        self._lib = get_lib()
        self._h = None
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._h = self._lib.flsq_loader_create(
                arr, len(self.paths), cap, n_threads, lookahead)

    def __len__(self):
        return len(self.paths)

    def get(self, idx: int) -> np.ndarray:
        if self._h is None:
            return read_scan(self.paths[idx], self.cap)
        buf = np.empty((self.cap, 4), np.float32)
        n = self._lib.flsq_loader_get(
            self._h, idx, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if n < 0:
            raise IOError(f"native decode failed: {self.paths[idx]}")
        return buf[:n].copy()

    def close(self):
        if self._h is not None:
            self._lib.flsq_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ApproxTimeSync:
    """Approximate-time pairing of two stamped streams (the message_filters
    ApproximateTime stand-in; fast_lio_sam_qn.cpp:75-78): the nearest
    stamps within ``slop``, monotonic, unmatched messages dropped.
    ``native=False`` takes the Python version of the same algorithm."""

    def __init__(self, slop: float = 0.05, native: bool = True):
        self._lib = get_lib() if native else None
        self.slop = slop
        self._h = None
        if self._lib is not None:
            self._h = self._lib.flsq_sync_create(slop)
        self._qa: list = []
        self._qb: list = []

    def push_a(self, t: float, ident: int):
        if self._h is not None:
            self._lib.flsq_sync_push_a(self._h, t, ident)
        else:
            self._qa.append((t, ident))

    def push_b(self, t: float, ident: int):
        if self._h is not None:
            self._lib.flsq_sync_push_b(self._h, t, ident)
        else:
            self._qb.append((t, ident))

    def pop(self):
        """The next matched (id_a, id_b, t_a, t_b), or None."""
        if self._h is not None:
            ia, ib = ctypes.c_int64(), ctypes.c_int64()
            ta, tb = ctypes.c_double(), ctypes.c_double()
            if self._lib.flsq_sync_pop(self._h, ctypes.byref(ia),
                                       ctypes.byref(ib), ctypes.byref(ta),
                                       ctypes.byref(tb)):
                return ia.value, ib.value, ta.value, tb.value
            return None
        qa, qb = self._qa, self._qb
        while qa and qb:
            t_a, ia = qa[0]
            t_b, ib = qb[0]
            if t_a < t_b - self.slop:
                qa.pop(0)           # a too old to ever match
                continue
            if t_b < t_a - self.slop:
                qb.pop(0)
                continue
            if len(qb) > 1 and abs(qb[1][0] - t_a) < abs(t_b - t_a):
                qb.pop(0)           # the next b is closer to this a
                continue
            if len(qa) > 1 and abs(qa[1][0] - t_b) < abs(t_b - t_a):
                qa.pop(0)           # the next a is closer to this b
                continue
            qa.pop(0)
            qb.pop(0)
            return ia, ib, t_a, t_b
        return None

    def close(self):
        if self._h is not None:
            self._lib.flsq_sync_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
