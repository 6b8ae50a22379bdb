"""What every cell of the benchmark shares: finding a cell's files by name,
building the configuration it runs, CUDA-event spans, the bounded
``torch.profiler`` window and its reduction, the per-layer readers, and
the one result line.

A cell is ``workloads/<cell>.json`` (its configuration's name, its driver
and its traffic), ``configs/<config>.json`` (the deployment) and the
entries of the repository's ``BENCHMARK.json`` that name it.  A per-layer
metric is ``metrics/<metric>.py``.  Nothing here imports the port or JAX.
"""
from __future__ import annotations

import bisect
import contextlib
import copy
import dataclasses
import importlib.util
import json
import math
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names a run may not have loaded once its window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "fast_lio_sam_qn_tpu")
# the process's start, from which set-up is counted (run.py sets it first)
T_PROCESS = time.perf_counter()


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def read_json(path: Path):
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def load_cell(name: str, overrides: dict | None = None):
    """(workload, config) of cell ``name`` from its files; ``overrides``
    ({"workload": {...}, "config": {...}}) is merged over them, key by key
    (the CPU tests' small widths)."""
    work = read_json(HERE / "workloads" / f"{name}.json")
    cfg = read_json(HERE / "configs" / f"{work['config']}.json")
    if overrides:
        work = merged(work, overrides.get("workload", {}))
        cfg = merged(cfg, overrides.get("config", {}))
    return work, cfg


def merged(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _fill(obj, spec: dict):
    for f in dataclasses.fields(obj):
        if f.name not in spec:
            continue
        v = spec[f.name]
        cur = getattr(obj, f.name)
        if dataclasses.is_dataclass(cur):
            _fill(cur, v)
        else:
            setattr(obj, f.name, tuple(v) if isinstance(v, list) else v)


def pipeline_config(config_module, cfg: dict):
    """The port's ``PipelineConfig`` (``config_module``, which the caller
    imports) holding the configuration file's ``pipeline`` and ``lio``
    blocks; every field the file names is set, the others keep their
    defaults."""
    pc = config_module.PipelineConfig()
    _fill(pc, cfg["pipeline"])
    _fill(pc.lio, cfg["lio"])
    return pc


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    libraries' or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def quantile(values, q: float) -> float:
    """The q-quantile by linear interpolation between order statistics."""
    v = sorted(values)
    if not v:
        return math.nan
    x = q * (len(v) - 1)
    lo = int(math.floor(x))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class Spans:
    """Named spans of device time: a CUDA event is recorded on the current
    stream as a span opens and another as it closes, and ``ms()`` reads
    each pair's elapsed time once the work has run.  Nothing waits for the
    device while spans are open.  On a CPU device (the tests) a span reads
    the host clock.  While ``annotate`` is set, each span is also a
    ``torch.profiler.record_function`` range, so that the profiler can tell
    which kernels were launched inside it.  Passed as ``profiler=`` to the
    port's ``LIO`` and ``FastLioSamQnPipeline``, whose stages open spans
    by name."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.annotate = False
        self._open: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        rf = torch.profiler.record_function(name) if self.annotate \
            else contextlib.nullcontext()
        if self.cuda:
            a = torch.cuda.Event(enable_timing=True)
            a.record()
        else:
            a = time.perf_counter()
        with rf:
            yield
        if self.cuda:
            b = torch.cuda.Event(enable_timing=True)
            b.record()
        else:
            b = time.perf_counter()
        self._open.append((name, a, b))

    def ms(self) -> dict[str, list[float]]:
        """Every span's milliseconds by name (waits for the device)."""
        if self.cuda:
            torch.cuda.synchronize()
        out: dict[str, list[float]] = {}
        for name, a, b in self._open:
            out.setdefault(name, []).append(
                a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
        return out


@contextlib.contextmanager
def wrapped(module, attr: str, make):
    """``module.attr`` replaced by ``make(original)`` inside the block:
    the port's callers look their stage functions up on the module at call
    time."""
    orig = getattr(module, attr)
    setattr(module, attr, make(orig))
    try:
        yield
    finally:
        setattr(module, attr, orig)


# ---------------------------------------------------------------------------
# the profiler window
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160   # a kernel's name in the breakdown, cut to this


class Profile:
    """A bounded ``torch.profiler`` window: ``start()`` and ``stop()``
    around a few steps of the measured window, reduced to what the
    readers need (the trace's device operations with the host time each
    was launched at, the spans' host ranges, the host's operations) once
    the run has ended."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def stop(self):
        self.prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        """{ops: [(name, start_us, end_us, launch_us or None)], spans:
        [(name, start_us, end_us)], host: [(name, start_us, end_us)],
        window: (start_us, end_us)}: the window is the range named
        ``window`` that the driver opens around the profiled steps."""
        with tempfile.TemporaryDirectory() as d:
            path = Path(d) / "trace.json"
            self.prof.export_chrome_trace(str(path))
            events = read_json(path)
        events = events.get("traceEvents", events)
        launch, ext_ts = {}, {}
        ops, spans, host = [], [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args", {}) or {}
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in ("cuda_runtime", "cuda_driver"):
                if "correlation" in args:
                    launch[args["correlation"]] = ts
            elif cat == "user_annotation":
                spans.append((e["name"], ts, ts + dur))
            elif cat == "cpu_op":
                host.append((e["name"], ts, ts + dur))
                if "External id" in args:
                    ext_ts.setdefault(args["External id"], ts)
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            args = e.get("args", {}) or {}
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            at = launch.get(args.get("correlation"))
            if at is None:
                at = ext_ts.get(args.get("External id"))
            ops.append((e["name"], ts, ts + dur, at))
        win = [s for s in spans if s[0] == "window"]
        window = (win[0][1], win[0][2]) if win else (
            min((o[1] for o in ops), default=0.0),
            max((o[2] for o in ops), default=0.0))
        ops.sort(key=lambda o: o[1])
        return dict(ops=ops, spans=spans, host=host, window=window)


# ---------------------------------------------------------------------------
# what the readers read
# ---------------------------------------------------------------------------

class Trace:
    """A traced run's record for the per-layer readers: ``spans`` (ms by
    name over the whole measured window, CUDA events), ``work`` (least
    times in ms by stage, one an instance inside the profiled steps) and
    the reduced profiler window (``ops``, ``span_ranges``, ``host``,
    ``window``)."""

    def __init__(self, spans, work, prof: dict | None):
        self.spans = spans
        self.work = work
        prof = prof or dict(ops=[], spans=[], host=[], window=(0.0, 0.0))
        self.window = prof["window"]
        lo, hi = self.window
        self.ops = [o for o in prof["ops"] if o[2] > lo and o[1] < hi]
        self.span_ranges = prof["spans"]
        self.host = prof["host"]

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals within the
        window, in us."""
        lo, hi = self.window
        out: list[list[float]] = []
        for _, a, b, _ in self.ops:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def device_ms_in(self, name: str) -> float | None:
        """Device milliseconds of every operation launched inside a span
        ``name`` of the profiled steps; None if none was."""
        ranges = sorted((a, b) for n, a, b in self.span_ranges if n == name)
        if not ranges:
            return None
        starts = [a for a, _ in ranges]
        total, found = 0.0, False
        for _, a, b, at in self.ops:
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= ranges[i][1]:
                total += b - a
                found = True
        return total / 1e3 if found else None

    def ops_in_spans(self) -> dict:
        """{span name: [profiled spans, device operations launched in
        them, their device ms]}, for the log: the profiler's kernel
        records set beside the spans that hold them."""
        out = {}
        for name in sorted({n for n, _, _ in self.span_ranges}):
            ranges = sorted((a, b) for n, a, b in self.span_ranges
                            if n == name)
            starts = [a for a, _ in ranges]
            n_ops, ms = 0, 0.0
            for _, a, b, at in self.ops:
                i = bisect.bisect_right(starts, at) - 1 if at is not None \
                    else -1
                if i >= 0 and at <= ranges[i][1]:
                    n_ops += 1
                    ms += (b - a) / 1e3
            out[name] = [len(ranges), n_ops, ms]
        return out

    def span_count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.span_ranges if n == name)

    def breakdown(self) -> dict:
        """The profiled steps' ten device operations that took the most
        time, summed by name, and the ten longest idle gaps, each named by
        the innermost host operation running as it began."""
        by_name: dict[str, float] = {}
        for name, a, b, _ in self.ops:
            name = name[:NAME_CHARS]
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        named = []
        host = sorted(self.host + [s for s in self.span_ranges
                                   if s[0] != "window"], key=lambda h: h[1])
        starts = [h[1] for h in host]
        for a, b in gaps:
            who = "idle host"
            i = bisect.bisect_right(starts, a) - 1
            while i >= 0:
                n, s, e = host[i]
                if e >= a:
                    who = n
                    break
                i -= 1
            named.append([who, (b - a) / 1e6])
        return {"device_ops": [[n, s] for n, s in top], "idle_gaps": named}


def readers() -> dict[str, object]:
    """Every per-layer reader, ``metrics/<metric>.py``, by metric name."""
    out = {}
    for path in sorted((HERE / "metrics").glob("*.py")):
        name = path.name[:-3]
        spec = importlib.util.spec_from_file_location(
            f"slam_bench_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def cell_metrics(cell: str, kind: str) -> list[dict]:
    """BENCHMARK.json's ``end_to_end`` or ``per_layer`` entries that apply
    to ``cell``."""
    return [m for m in benchmark()[kind]
            if "workloads" not in m or cell in m["workloads"]]


def read_per_layer(cell: str, trace: Trace) -> dict:
    mods = readers()
    out = {}
    for m in cell_metrics(cell, "per_layer"):
        value = mods[m["name"]].read(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def end_to_end(cell: str, values: dict) -> dict:
    out = {}
    for m in cell_metrics(cell, "end_to_end"):
        if m["name"] in values:
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def device_block(device, count: int, peak: int, trace=None) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        block = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                 "count": count, "memory_peak_bytes": int(peak)}
    else:
        block = {"platform": "cpu", "kind": "cpu", "count": count,
                 "memory_peak_bytes": int(peak)}
    if trace is not None:
        block["busy_s"] = trace.busy_s()
        block["window_s"] = trace.window_s()
    return block


def verdict(checks: dict) -> bool:
    """Correct when every compared number is finite and within its
    limit."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output (its ``checks`` key last)."""
    for name, c in result["checks"].items():
        say(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)


def summary(values) -> dict:
    """Median and quartiles of a list, for the log."""
    if len(values) < 2:
        return {"n": len(values)}
    q = statistics.quantiles(values, n=4)
    return {"n": len(values), "median": statistics.median(values),
            "q1": q[0], "q3": q[2]}


def thirds(values) -> list:
    """Medians of the first, middle and last third of a list, for the
    log: whether the window sped up or slowed down as it ran."""
    n = len(values)
    if n < 3:
        return []
    return [statistics.median(values[i * n // 3:(i + 1) * n // 3])
            for i in range(3)]


def deltas(readings) -> list:
    """Differences between consecutive tuples of readings, rounded, for
    the log."""
    return [[round(b - a, 3) for a, b in zip(r0, r1)]
            for r0, r1 in zip(readings, readings[1:])]
