"""The port's native host runtime (``runtime/native.py`` over its own copy
of ``runtime.cpp``) held against the JAX package's and against the Python
fallbacks: decoded scans, the prefetching loader, ApproximateTime pairs and
LZ4 frames, all exact.  The port's library is built under
``build/runtime/`` from the port's source; the JAX package's library is
never loaded by the port."""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu.runtime import native as jnative
from fast_lio_sam_qn_tpu.utils import io as jio
from fast_lio_sam_qn_tpu_torch.runtime import native
from fast_lio_sam_qn_tpu_torch.tools import datasets
from fast_lio_sam_qn_tpu_torch.utils import io

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SRC = os.path.join(REPO, "fast_lio_sam_qn_tpu", "runtime", "runtime.cpp")


@pytest.fixture(scope="module")
def scan_files(tmp_path_factory):
    """Velodyne .bin, ASCII PCD and binary PCD (PCL '_' padding) scans of
    seeded points with intensities."""
    d = tmp_path_factory.mktemp("scans")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(9):
        pts = rng.normal(0, 5, (300 + 70 * i, 4)).astype(np.float32)
        kind = ("bin", "ascii", "binary")[i % 3]
        if kind == "bin":
            p = str(d / f"{i:06d}.bin")
            pts.tofile(p)
        elif kind == "ascii":
            p = str(d / f"{i:06d}.pcd")
            io.save_pcd(p, pts[:, :3], pts[:, 3])
        else:
            p = str(d / f"{i:06d}.pcd")
            rec = np.zeros(len(pts), dtype=[
                ("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("_", "<f4"),
                ("intensity", "<f4"), ("__pad", "<f4", (3,))])
            for j, k in enumerate("xyz"):
                rec[k] = pts[:, j]
            rec["intensity"] = pts[:, 3]
            head = ("VERSION 0.7\nFIELDS x y z _ intensity _\n"
                    "SIZE 4 4 4 4 4 4\nTYPE F F F F F F\nCOUNT 1 1 1 1 1 3\n"
                    f"WIDTH {len(pts)}\nHEIGHT 1\nPOINTS {len(pts)}\n"
                    "DATA binary\n")
            with open(p, "wb") as f:
                f.write(head.encode() + rec.tobytes())
        paths.append(p)
    return paths


def test_library_is_the_ports_own_build():
    """Built from the port's runtime.cpp (the JAX source's code, its header
    comment aside) into build/runtime/ under a name keyed on the source."""
    assert native.available(), native.build_error()
    path = native.library_path()
    assert path.exists()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "runtime")
    assert str(native.SRC).endswith(os.path.join(
        "fast_lio_sam_qn_tpu_torch", "runtime", "runtime.cpp"))
    ours = native.SRC.read_text().split("#include <atomic>", 1)[1]
    theirs = open(JAX_SRC).read().split("#include <atomic>", 1)[1]
    assert ours == theirs


def test_library_name_tracks_source_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "runtime.cpp"
    src.write_bytes(native.SRC.read_bytes())
    monkeypatch.setattr(native, "SRC", src)
    first = native.library_path()
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ("-g",))
    assert native.library_path() != first
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS[:-1])
    with open(src, "a") as f:
        f.write("// edited\n")
    assert native.library_path() != first


def test_concurrent_builds_share_one_library(tmp_path, monkeypatch):
    """Builds racing on one directory each compile to a temporary file
    and rename it into place: every one gets the same loadable library and
    no temporary file is left."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "runtime")
    out, errs = [], []

    def build():
        try:
            out.append(native.build())
        except Exception as e:  # reported below
            errs.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and len(set(out)) == 1
    assert sorted(os.listdir(tmp_path / "runtime")) == [out[0].name]
    import ctypes

    assert ctypes.CDLL(str(out[0])).flsq_read_pcd


def test_the_jax_library_is_never_loaded(scan_files):
    """A process that reads scans, pairs stamps and decodes LZ4 through the
    port maps the port's library and not the JAX package's."""
    code = (
        "import sys\n"
        "from fast_lio_sam_qn_tpu_torch.runtime import native\n"
        "from fast_lio_sam_qn_tpu_torch.tools import datasets\n"
        f"native.read_scan({scan_files[0]!r})\n"
        "s = native.ApproxTimeSync(0.05); s.push_a(0.0, 0); s.push_b(0.01, 0)\n"
        "assert s.pop() is not None\n"
        "assert native.lz4_decompress(datasets.lz4_frame(b'abc' * 99), "
        "297) == b'abc' * 99\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert str(native.library_path()) in maps, maps\n"
        "assert 'libflsq_runtime.so' not in maps\n"
        "assert not any(m.split('.')[0] in ('jax', 'fast_lio_sam_qn_tpu') "
        "for m in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("kind", ["bin", "ascii", "binary"])
def test_read_scan_equals_jax_and_python(scan_files, kind):
    paths = [p for i, p in enumerate(scan_files)
             if ("bin", "ascii", "binary")[i % 3] == kind]
    for p in paths:
        got = native.read_scan(p)
        assert got.dtype == np.float32 and got.shape[1] == 4
        np.testing.assert_array_equal(got, jnative.read_scan(p))
        np.testing.assert_array_equal(got, native.read_scan_python(p))
        want = jio.read_velodyne_bin(p) if kind == "bin" else \
            jio.load_pcd(p, with_intensity=True)
        np.testing.assert_array_equal(got, want)
    # the native decoder stops at its capacity
    np.testing.assert_array_equal(native.read_scan(paths[0], cap=50),
                                  jnative.read_scan(paths[0], cap=50))


@pytest.mark.parametrize("threads,lookahead", [(1, 0), (2, 3), (4, 8)])
def test_scan_loader_equals_read_scan(scan_files, threads, lookahead):
    """Out-of-order and repeated reads through the prefetching pool give
    the decoder's arrays, as the JAX loader's and the Python fallback's."""
    loader = native.ScanLoader(scan_files, cap=4096, n_threads=threads,
                               lookahead=lookahead)
    jloader = jnative.ScanLoader(scan_files, cap=4096, n_threads=threads,
                                 lookahead=lookahead)
    assert len(loader) == len(scan_files)
    for idx in [0, 2, 1, 8, 5, 3, 3, 4, 7, 6, 0]:
        got = loader.get(idx)
        np.testing.assert_array_equal(got, native.read_scan(scan_files[idx]))
        np.testing.assert_array_equal(got, jloader.get(idx))
    loader.close()
    jloader.close()
    loader.close()  # idempotent


def _pairs(sync, ts_a, ts_b):
    for i, t in enumerate(ts_a):
        sync.push_a(float(t), i)
    for j, t in enumerate(ts_b):
        sync.push_b(float(t), j)
    out = []
    while (p := sync.pop()) is not None:
        out.append(p)
    sync.close()
    return out


def _jax_python_sync(slop):
    s = jnative.ApproxTimeSync(slop=slop)
    s.close()
    s._h, s._qa, s._qb = None, [], []
    return s


@pytest.mark.parametrize("seed,slop", [(0, 0.05), (1, 0.02), (2, 0.2),
                                       (3, 0.005)])
def test_sync_pairs_equal(seed, slop):
    """Seeded streams of different densities, some stamps far apart: the
    native pairs equal the Python version's and the JAX package's (native
    and Python)."""
    rng = np.random.default_rng(seed)
    ts_a = np.sort(rng.uniform(0, 10, 60))
    ts_b = np.sort(np.concatenate([ts_a[::2] + rng.normal(0, slop, 30),
                                   rng.uniform(0, 10, 15)]))
    got = _pairs(native.ApproxTimeSync(slop), ts_a, ts_b)
    assert 5 < len(got) < 60
    assert got == _pairs(native.ApproxTimeSync(slop, native=False), ts_a,
                         ts_b)
    assert got == _pairs(jnative.ApproxTimeSync(slop), ts_a, ts_b)
    assert got == _pairs(_jax_python_sync(slop), ts_a, ts_b)
    assert all(abs(ta - tb) <= slop for _, _, ta, tb in got)


@pytest.mark.parametrize("use_native", [True, False])
def test_sync_symmetric_lookahead_and_drops(use_native):
    """A later a closer to the current b wins; an a with no b within the
    slop is dropped (tests/test_runtime.py's cases)."""
    s = native.ApproxTimeSync(0.2, native=use_native)
    assert _pairs(s, [9.90, 10.00], [10.01]) == [(1, 0, 10.0, 10.01)]
    s = native.ApproxTimeSync(0.02, native=use_native)
    assert _pairs(s, [0.0, 1.0], [1.005]) == [(1, 0, 1.0, 1.005)]


def test_read_pcd_rejects_undecodable(tmp_path):
    """binary_compressed and double-typed PCDs raise; a short ASCII line
    stops the decode (the JAX package's cases, both libraries alike)."""
    hdr = ("VERSION .7\nFIELDS x y z intensity\nSIZE {s} {s} {s} {s}\n"
           "TYPE {t} {t} {t} {t}\nCOUNT 1 1 1 1\nWIDTH 3\nHEIGHT 1\n"
           "POINTS 3\nDATA {mode}\n")
    p1 = tmp_path / "c.pcd"
    p1.write_bytes(hdr.format(s=4, t="F", mode="binary_compressed").encode()
                   + b"\x00" * 64)
    p2 = tmp_path / "d.pcd"
    p2.write_bytes(hdr.format(s=8, t="F", mode="binary").encode()
                   + np.zeros(12, np.float64).tobytes())
    for p in (p1, p2):
        with pytest.raises(IOError):
            native.read_scan(str(p))
    p3 = tmp_path / "t.pcd"
    p3.write_text(hdr.format(s=4, t="F", mode="ascii")
                  + "1 2 3 0.5\n4 5 6 0.5\n7 8\n")
    got = native.read_scan(str(p3))
    np.testing.assert_array_equal(got, jnative.read_scan(str(p3)))
    assert got.shape == (2, 4)


@pytest.mark.parametrize("size,limit", [(0, 1 << 20), (97, 1 << 20),
                                        (300_000, 1 << 20),
                                        (300_000, 1 << 10)])
def test_lz4_frames_decode_alike(size, limit):
    """Frames of ``datasets.lz4_frame`` (matched sequences, or literal and
    stored blocks past ``limit``) decode to the payload in both packages;
    a corrupt frame raises."""
    rng = np.random.default_rng(size)
    words = rng.integers(0, 255, 64, dtype=np.uint8).tobytes()
    payload = b"".join(words[k:k + 8] for k in rng.integers(0, 56, size // 8))
    payload += bytes(rng.integers(0, 255, size % 8, dtype=np.uint8))
    frame = datasets.lz4_frame(payload, compress_limit=limit)
    if size and limit > size:
        assert len(frame) < len(payload)   # matches were emitted
    assert native.lz4_decompress(frame, len(payload)) == payload
    assert jnative.lz4_decompress(frame, len(payload)) == payload
    with pytest.raises(ValueError, match="corrupt"):
        native.lz4_decompress(b"\x00" * 16, 16)
