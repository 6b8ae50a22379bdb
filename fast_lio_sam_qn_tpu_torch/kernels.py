"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``), one
process a source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, into ``build/kernels/`` beside the package, and is keyed
on a hash of the sources and flags, so a stale library is never loaded.
Loading needs a CUDA device: without one it raises.  There is no fallback
here; CPU tensors never reach this module (the wrappers route them to their
plain PyTorch versions before asking for the library).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC")

MAX_BATCH = 65535  # gridDim.y

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer and the stream as void*, sizes as int; each
# kernel takes a batch count b (its grid's y axis) before its sizes; the kNN
# kernels also take the lanes' extents and, at k = 1, a split count (grid z)
# with its partials; K3, K4 and K5 take the extents and the tile boxes that
# flsq_fpfh_boxes builds; K6 takes each component's element stride; K7
# its sample count and the state's dimension
_SIGNATURES = {
    "flsq_knn": (_P,) * 8 + (_I,) * 6 + (_P,) * 5,
    "flsq_knn_banded": (_P,) * 8 + (_I,) * 5 + (_P,) * 6,
    "flsq_fpfh_moments": (_P,) * 7 + (_I, _I, _F, _F, _P, _P),
    "flsq_fpfh_boxes": (_P, _P, _P, _I, _I, _P, _P),
    "flsq_fpfh_spfh": (_P,) * 9 + (_I, _I, _F, _P, _P),
    "flsq_fpfh_agg": (_P,) * 8 + (_I, _I, _F, _P, _P),
    "flsq_eigh3": (_P,) * 6 + (_I,) * 8 + (_P, _P),
    "flsq_propagate": (_P,) * 9 + (_I, _I, _P, _P),
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libflsq_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> tuple[Path, float]:
    """Compile the library if it is missing; returns (path, seconds spent).
    The compiler's output, register and shared-memory use included, is kept
    beside the library as ``<name>.log``."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        work = Path(work)
        jobs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = work / f"{src.stem}.o"
            with open(work / f"{src.stem}.log", "w") as out:
                jobs.append((obj, out.name, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=out, stderr=subprocess.STDOUT)))
        codes = [proc.wait() for _, _, proc in jobs]
        log = "".join(Path(name).read_text() for _, name, _ in jobs)
        tmp = work / "lib.so"
        if not any(codes):
            link = subprocess.run(
                [nvcc, *ARCH, "-shared", "-o", str(tmp),
                 *[str(obj) for obj, _, _ in jobs]],
                capture_output=True, text=True)
            codes.append(link.returncode)
            log += link.stdout + link.stderr
        path.with_suffix(".log").write_text(log)
        if any(codes):
            raise RuntimeError(f"nvcc failed ({codes}):\n{log}")
        os.replace(tmp, path)
    return path, time.perf_counter() - t0


def ptxas_entries(text: str) -> list[dict]:
    """Each kernel entry of the build log (``nvcc -Xptxas -v``): its name
    (demangled by ``c++filt`` where the host has it), registers, stack
    frame and spill bytes."""
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"name": m.group(1), "stack": 0, "spill_stores": 0,
                   "spill_loads": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            out.append(cur)
            cur = None
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(e["name"] for e in out),
            capture_output=True, text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = []
    if len(names) == len(out):
        for e, n in zip(out, names):
            e["name"] = n
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call.  Raises without a CUDA
    device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device; none is "
                           "available")
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_status(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{status}")


def on_cuda(name: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (its wrapper runs the plain version), True
    for a CUDA tensor (the kernel runs); raises on any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def per_lane(fn, *args):
    """``fn`` called on each lane of ``args`` ((B, ...) tensors or length-B
    sequences), its outputs stacked on a new leading axis (tuples and named
    tuples of tensors field by field, at any depth).  This is how a
    single-cloud function, a kernel wrapper or a plain version, runs over a
    batch."""
    return _stack([fn(*lane) for lane in zip(*args)])


def _stack(outs):
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    fields = [_stack(list(f)) for f in zip(*outs)]
    return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)


def require_batch(b: int) -> None:
    """The grid's y axis bounds the batch count of every kernel."""
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"batch of {b} clouds; the kernels take 1 to "
                         f"{MAX_BATCH}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device, contiguous: bool = True) -> None:
    """Validate a kernel operand before its pointer is passed to C (a
    kernel that takes strides asks for no contiguity)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
