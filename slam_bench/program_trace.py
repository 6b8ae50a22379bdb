"""The program's own trace of a ``*.drive`` cell: the drive of ``stream.py``
replayed with the port's tracer, ``utils/profiling.Profiler``, passed as
``profiler=`` to the LIO and the pipeline, reduced to the numbers that the
program's spans and counters measure where the work happens.

    python3 slam_bench/program_trace.py --workload <cell> --seed <n> \\
        --seconds <s> [--tracing 0|1|2]

Set-up as in ``stream.py`` (the stream cast from the seed, the warm-up
scans), then the window: its first ``profile_scans`` scans, then the rest,
timed.  ``--tracing 0`` runs with no tracer; ``1`` with the tracer alone,
switched on in every other block of 10 scans after the first (its cost,
within one process); ``2`` (the default) with the tracer throughout, the
first scans under ``torch.profiler`` with every span annotated and the
tracer's clock anchored on the trace, and the whole window under
``torch.cuda.set_sync_debug_mode(1)``.  It prints one JSON line, the last
on standard output:

- ``scans_per_s``: scans over the window's seconds after the first
  ``profile_scans``; at 1 also ``scans_per_s_tracer_off`` and
  ``scans_per_s_tracer_on``, the scans of each kind of block over their
  own seconds;
- ``metrics`` (from 1): ``lio_host_ms`` (mean host ms of the ``scan``
  spans), ``host_syncs_per_scan`` and ``sync_wait_ms`` (the ``syncs`` and
  ``sync_wait_ms`` of the ``scan`` and ``feed`` spans, a scan),
  ``pgo_pcg_iters`` (mean ``pcg_iters`` of an ``opt`` span), the CUDA
  event ms of ``lio``, ``insert``, ``key_add``, ``opt``, ``scan`` and
  ``feed``, all after the profiled steps; at 2 also ``lio_device_ms`` and
  ``lio_launches`` (the device time and count of the operations launched
  inside the profiled ``scan`` spans, a scan);
- ``idle_by_span`` (2): the device-idle ms of the profiled steps by the
  innermost program span open on the host at the time (``parent>sync.*``
  for a host read), the records placed on the trace's clock through the
  tracer's anchor;
- ``reads`` (2): every synchronizing call the debug mode warns of, counted
  by its innermost span: ``named`` inside a ``sync.*`` span, ``unnamed``
  inside another program span (by source line), ``outside`` outside
  every span;
- ``span_us`` (from 1): the host cost of one empty span, with timing
  events and as a host read, and of a site with no span open.

Nothing of JAX is imported.  The benchmark's result line does not come
from here: this is the program's view beside it.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from slam_bench import gen  # noqa: E402
from slam_bench import harness as H  # noqa: E402
from slam_bench import stream  # noqa: E402


def innermost(records, starts, t_ns: int):
    """The deepest record open at host time ``t_ns``, or None: the last one
    opened by then, or the nearest of its ancestors still open (spans
    nest).  ``starts`` are the records' ``t0_ns``, in order."""
    k = bisect.bisect_right(starts, t_ns) - 1
    while k >= 0 and records[k].t1_ns < t_ns:
        k = records[k].parent
    return k if k >= 0 else None


def depth(records, k) -> int:
    d, p = 0, records[k].parent
    while p >= 0:
        d, p = d + 1, records[p].parent
    return d


def label(records, k) -> str:
    """A record's name; a host read's is ``parent>sync.<site>``."""
    r = records[k]
    if r.name.startswith("sync.") and r.parent >= 0:
        return f"{records[r.parent].name}>{r.name}"
    return r.name


def idle_by_span(trace: H.Trace, records, offset_us: float) -> dict:
    """{label: device-idle ms}: every idle stretch of the trace's window
    split over the innermost program record open on the host, the records
    placed on the trace's clock by ``offset_us``; ``no span`` where none
    is open."""
    lo, hi = trace.window
    edges = [lo] + [x for iv in trace.busy_intervals() for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans = [(r.t0_ns / 1e3 + offset_us, r.t1_ns / 1e3 + offset_us,
              depth(records, k), label(records, k))
             for k, r in enumerate(records)]
    out: dict[str, float] = {}
    for a, b in gaps:
        inside = [s for s in spans if s[1] > a and s[0] < b]
        cuts = sorted({a, b} | {x for s in inside for x in s[:2]
                                if a < x < b})
        for u, v in zip(cuts, cuts[1:]):
            mid = (u + v) / 2
            open_ = [s for s in inside if s[0] <= mid <= s[1]]
            name = max(open_, key=lambda s: s[2])[3] if open_ else "no span"
            out[name] = out.get(name, 0.0) + (v - u) / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


class Reads:
    """The synchronizing calls ``torch.cuda.set_sync_debug_mode(1)`` warns
    of inside the block, each with its host time and source line."""

    def __init__(self, on: bool):
        self.on = on
        self.seen: list[tuple[int, str]] = []

    def __enter__(self):
        if not self.on:
            return self
        self._cw = warnings.catch_warnings()
        self._cw.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._show
        torch.cuda.set_sync_debug_mode(1)
        return self

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if "synchroniz" in str(message):
            self.seen.append((time.perf_counter_ns(), f"{filename}:{lineno}"))

    def __exit__(self, *exc):
        if self.on:
            torch.cuda.set_sync_debug_mode(0)
            self._cw.__exit__(*exc)

    def by_span(self, groups) -> dict:
        """Counts by where each read was made: ``named`` {span label: n},
        ``unnamed`` {span name @ source line: n}, ``outside`` {source line:
        n}; ``groups`` are lists of records from one tracer."""
        out = {"named": {}, "unnamed": {}, "outside": {}}
        starts = [[r.t0_ns for r in recs] for recs in groups]
        for t, where in self.seen:
            kind, key = "outside", Path(where).name
            for recs, st in zip(groups, starts):
                k = innermost(recs, st, t)
                if k is None:
                    continue
                if recs[k].name.startswith("sync."):
                    kind, key = "named", label(recs, k)
                else:
                    kind, key = "unnamed", f"{recs[k].name} @ {key}"
                break
            out[kind][key] = out[kind].get(key, 0) + 1
        return out


def span_cost_us(device, n: int = 2000) -> dict:
    """Host microseconds of one empty span (timing events on a CUDA
    device), one host read's span, and a site with no span open."""
    from fast_lio_sam_qn_tpu_torch.utils import profiling

    prof = profiling.Profiler(device)
    out = {}
    for key, name in (("span", "x"), ("sync_span", "sync.x")):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with prof.span(name):
                pass
        out[key] = (time.perf_counter_ns() - t0) / n / 1e3
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with profiling.sync("x"):
            pass
    out["site_without_span"] = (time.perf_counter_ns() - t0) / n / 1e3
    t0 = time.perf_counter_ns()
    prof.records()
    out["records_read"] = (time.perf_counter_ns() - t0) / (2 * n) / 1e3
    return out


BLOCK = 10      # scans a block, the tracer on in every other one (--tracing 1)


def _mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def run(cell: str, seed: int, seconds: float, tracing: int, device="cuda",
        overrides=None) -> dict:
    from fast_lio_sam_qn_tpu_torch.models.lio import LIO
    from fast_lio_sam_qn_tpu_torch.models.pipeline import FastLioSamQnPipeline
    from fast_lio_sam_qn_tpu_torch.utils import config as prog_config
    from fast_lio_sam_qn_tpu_torch.utils.profiling import Profiler, span

    device = torch.device(device)
    work, cfgj = H.load_cell(cell, overrides)
    cfg = H.pipeline_config(prog_config, cfgj)
    sensor = gen.Sensor(**{k: cfgj["sensor"][k] for k in gen.Sensor._fields})
    route = gen.Route(**work["route"])
    strm = gen.Stream(sensor, route, work["scene"], cfg.lio.extrinsic_R,
                      cfg.lio.extrinsic_T, seed, work["stream_scans"],
                      device, stream.IMU_CAP, log=H.say)
    prof = Profiler(device) if tracing else None
    lio = LIO(cfg.lio, imu_cap=stream.IMU_CAP, device=device, profiler=prof)
    pipe = FastLioSamQnPipeline(cfg, profiler=prof, device=device)
    state = stream.initial_state(lio, route, device)

    def one_scan(state, i):
        inputs = strm.inputs(i)
        with span(lio.profiler, "lio"):
            state, res = lio.process_scan(state, *inputs)
        pipe.feed(res.pose, res.cloud_body, res.cloud_mask, inputs[-1])
        return state

    warm = work["warm_scans"]
    for i in range(warm):
        state = one_scan(state, i)
    H.sync(device)
    setup_s = time.perf_counter() - H.T_PROCESS
    if prof:
        prof.clear()

    n_prof = work["profile_scans"]
    profile = H.Profile(device) if tracing == 2 else None
    reads = Reads(tracing == 2 and device.type == "cuda")
    profiled, times, traced = [], [], []
    i = warm
    with reads:
        t_start = time.perf_counter()
        if profile:
            profile.start()
            prof.annotate = True
            prof.anchor()
            window = torch.profiler.record_function("window")
            window.__enter__()
        while True:
            j = i - warm
            if tracing == 1 and j >= n_prof and (j - n_prof) % BLOCK == 0:
                # the tracer on in every other block of scans
                lio.profiler = pipe.profiler = \
                    prof if (j - n_prof) // BLOCK % 2 else None
            t0 = time.perf_counter()
            state = one_scan(state, i)
            times.append(time.perf_counter() - t0)
            traced.append(lio.profiler is not None)
            i += 1
            if j + 1 == n_prof:
                H.sync(device)
                if profile:
                    window.__exit__(None, None, None)
                    profile.stop()
                    prof.annotate = False
                if prof:
                    profiled = prof.records()
                    prof.clear()
                t_rest = time.perf_counter()
            # at 1, at least one block of each kind
            done = j + 1 - n_prof >= (2 * BLOCK if tracing == 1 else 1)
            if done and time.perf_counter() - t_start >= seconds:
                break
        H.sync(device)
        t_end = time.perf_counter()
    n_rest = len(times) - n_prof
    out = {"cell": cell, "seed": seed, "tracing": tracing,
           "device": H.device_block(device, 1, 0), "setup_s": setup_s,
           "scans": n_rest, "scans_per_s": n_rest / (t_end - t_rest),
           "scan_ms_p95": H.quantile(times[n_prof:], 0.95) * 1e3}
    if not tracing:
        return out
    if tracing == 1:
        rest = list(zip(times, traced))[n_prof:]
        for key, on in (("off", False), ("on", True)):
            t = [dt for dt, tr in rest if tr == on]
            out[f"scans_per_s_tracer_{key}"] = len(t) / sum(t) if t \
                else None

    recs = prof.records()
    scans = [r for r in recs if r.name == "scan" and r.t1_ns]
    feeds = [r for r in recs if r.name == "feed" and r.t1_ns]
    n_scan = max(len(scans), 1)
    m = {
        "lio_host_ms": _mean(r.host_ms for r in scans),
        "host_syncs_per_scan": sum(r.syncs for r in scans + feeds) / n_scan,
        "sync_wait_ms": sum(r.sync_wait_ms for r in scans + feeds) / n_scan,
        "pgo_pcg_iters": _mean(r.pcg_iters for r in recs if r.name == "opt"),
    }
    for name in ("lio", "insert", "key_add", "opt", "scan", "feed"):
        m[f"{name}_event_ms"] = _mean(r.device_ms for r in recs
                                      if r.name == name
                                      and r.device_ms is not None)
    out["metrics"] = m
    out["self_host_ms"] = {
        n: _mean(r.self_ms for r in recs if r.name == n)
        for n in sorted({r.name for r in recs})}
    out["syncs_by_site"] = {
        n: sum(1 for r in recs if r.name == n) / n_scan
        for n in sorted({r.name for r in recs if r.name.startswith("sync.")})}
    out["opt_pcg_iters"] = H.summary([r.pcg_iters for r in recs
                                      if r.name == "opt"])
    out["span_us"] = span_cost_us(device)
    if tracing < 2:
        return out

    tr = H.Trace({}, {}, profile.reduce())
    readers = H.readers()
    for name in ("lio_device_ms", "lio_launches"):
        m[name] = readers[name].read(tr)
    out["ops_in_spans"] = tr.ops_in_spans()
    offset = prof.trace_offset_us(tr.span_ranges)
    if offset is not None:
        starts = [a for n, a, _ in tr.span_ranges if n == "scan"]
        mapped = [r.t0_ns / 1e3 + offset for r in profiled
                  if r.name == "scan"]
        out["anchor_gap_us"] = max((abs(a - b) for a, b in
                                    zip(sorted(starts), mapped)), default=None)
        out["idle_by_span"] = idle_by_span(tr, profiled, offset)
    out["device"] = H.device_block(device, 1, 0, tr)
    out["reads"] = reads.by_span([profiled, recs]) if reads.on else None
    return out


def main(argv=None, device: str = "cuda", overrides=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracing", type=int, choices=(0, 1, 2), default=2)
    args = ap.parse_args(argv)
    if device == "cuda":
        if not torch.cuda.is_available():
            H.say("no CUDA card")
            return 2
        from fast_lio_sam_qn_tpu_torch import kernels

        kernels.build()
        kernels.load_library()
    out = run(args.workload, args.seed, args.seconds, args.tracing, device,
              overrides)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
