"""Stage spans and counters, the port's one tracer: the reference's
hand-rolled chrono spans (fast_lio_sam_qn.cpp:92,123,147,154,172,189,
191-197), named spans with running statistics on the host clock, as the JAX
package's ``utils/profiling.py``, and below them one record a span.

A record holds the span's name, its parent record, the scan it belongs to,
its host start and end (``time.perf_counter_ns``), on a CUDA device a pair
of timing events on the current stream (nothing waits for the device while
spans are open; the events are read once, at ``records()`` or
``summary()``, after one synchronize), and its counters, which include
those of its children:

- ``syncs`` and ``sync_wait_ms``: the host reads made inside it.  Each
  place where the program waits for the device on a card (a read, a
  ``torch.linalg`` error check, a copy from pageable host memory) is a span
  ``sync.<site>`` (host clock only, no events), opened by ``sync(site)``;
  closing it adds 1 and its wait to every open ancestor;
- ``pcg_iters``: the PCG iterations the pose-graph solves inside it ran
  (``add``);
- ``graph_captures``, ``graph_replays``: the CUDA graphs captured and
  replayed inside it (``utils/cuda_graph.py``); the span they count on
  says which work they replay (``insert`` the surfel insert, ``opt`` the
  PCG's blocks);
- the loop closure's: ``reg_lanes`` (registered lanes that have a
  candidate), ``reg_valid`` (of those, the valid ones), ``loop_commits``
  (loop factors added to the graph), ``gicp_iters`` (Gauss-Newton passes
  of the GICP loops, one a pass over all lanes) and ``gn_steps`` (the
  pose-graph solves' Gauss-Newton steps, 2 or 5 a solve);
- ``assoc_rows``: on the point map's span ``assoc``, one plane search's
  padded rows times the candidate slots each gathers.

Each counter is known on the host where it is added: none costs a read.

The op-level sites (``sync``, ``add``) have no profiler handle: they reach
the profiler whose span is open through one module-level slot that
``Profiler.span`` sets and clears.  With no span open a site costs a global
read.  The models open their spans through ``span(profiler, name)``, which
also takes any object with a ``span(name)`` context manager.

The host clock measures a span's enqueue; the events its device time.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

# the profiler whose span is open (the innermost), for the op-level sites
_active: Optional["Profiler"] = None
_NULL = contextlib.nullcontext()
_clock = time.perf_counter_ns
SYNC = "sync."          # the prefix of a host read's span
ANCHOR = "profiling.anchor"
COUNTERS = ("syncs", "sync_wait_ms", "pcg_iters", "graph_captures",
            "graph_replays", "reg_lanes", "reg_valid", "loop_commits",
            "gicp_iters", "gn_steps", "assoc_rows")


@dataclass
class StageStats:
    count: int = 0
    total_ms: float = 0.0
    max_ms: float = 0.0

    @property
    def avg_ms(self) -> float:
        return self.total_ms / max(self.count, 1)


@dataclass(slots=True)
class Record:
    """One span: ``parent`` is the index of the enclosing record (-1 at the
    top), ``scan`` the scan it belongs to (-1 where none was given)."""

    name: str
    parent: int
    scan: int
    t0_ns: int = 0
    t1_ns: int = 0
    child_ns: int = 0             # the host time the children cover
    events: Optional[tuple] = None
    device_ms: Optional[float] = None
    syncs: int = 0
    sync_wait_ms: float = 0.0
    pcg_iters: int = 0
    graph_captures: int = 0
    graph_replays: int = 0
    reg_lanes: int = 0
    reg_valid: int = 0
    loop_commits: int = 0
    gicp_iters: int = 0
    gn_steps: int = 0
    assoc_rows: int = 0

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6

    @property
    def self_ms(self) -> float:
        """The host time not covered by a child span."""
        return (self.t1_ns - self.t0_ns - self.child_ns) / 1e6


@dataclass
class Profiler:
    """``device``: a CUDA device adds a pair of timing events to every span
    but the host reads; None or a CPU device keeps the host clock alone.
    ``annotate``: each span is also a ``torch.profiler.record_function``
    range of its name, so that a profiler trace can tell which device
    operations were launched inside it."""

    device: Optional[torch.device | str] = None
    annotate: bool = False
    stats: Dict[str, StageStats] = field(
        default_factory=lambda: defaultdict(StageStats))

    def __post_init__(self):
        self._cuda = self.device is not None and \
            torch.device(self.device).type == "cuda"
        self.anchor_ns: Optional[int] = None
        self._recs: List[Record] = []
        self._open: List[int] = []

    @contextlib.contextmanager
    def span(self, name: str, scan: Optional[int] = None):
        global _active
        recs, stack = self._recs, self._open
        parent = stack[-1] if stack else -1
        if scan is None:
            scan = recs[parent].scan if parent >= 0 else -1
        rec = Record(name, parent, scan)
        stack.append(len(recs))
        recs.append(rec)
        prev, _active = _active, self
        rf = torch.profiler.record_function(name) if self.annotate else None
        if rf is not None:
            rf.__enter__()
        read = name.startswith(SYNC)
        timed = self._cuda and not read
        rec.t0_ns = _clock()
        if timed:
            # one stream lookup a span: it costs more than the record
            stream = torch.cuda.current_stream()
            a = torch.cuda.Event(enable_timing=True)
            a.record(stream)
        try:
            yield
        finally:
            if timed:
                b = torch.cuda.Event(enable_timing=True)
                b.record(stream)
                rec.events = (a, b)
            if rf is not None:
                rf.__exit__(None, None, None)
            rec.t1_ns = t1 = _clock()
            _active = prev
            stack.pop()
            ns = t1 - rec.t0_ns
            if parent >= 0:
                recs[parent].child_ns += ns
            dt = ns / 1e6
            if read:
                rec.syncs, rec.sync_wait_ms = 1, dt
                for i in stack:
                    recs[i].syncs += 1
                    recs[i].sync_wait_ms += dt
            s = self.stats[name]
            s.count += 1
            s.total_ms += dt
            s.max_ms = max(s.max_ms, dt)

    def add(self, counter: str, n: int) -> None:
        """Add ``n`` to a counter of every open record."""
        for i in self._open:
            rec = self._recs[i]
            setattr(rec, counter, getattr(rec, counter) + n)

    def anchor(self) -> int:
        """Stamp the host clock inside a ``torch.profiler`` range named
        ``ANCHOR``, while a profiler traces: that range's start on the
        trace, less this stamp, maps every record onto the trace's clock
        (``trace_offset_us``).  The stamp is the second of two: a
        process's first range sets up the recording inside it (~1 ms)."""
        for _ in range(2):
            with torch.profiler.record_function(ANCHOR):
                self.anchor_ns = _clock()
        return self.anchor_ns

    def trace_offset_us(self, ranges) -> Optional[float]:
        """Microseconds to add to ``ns / 1e3`` of a record's clock to place
        it on a trace whose user ranges are ``ranges`` [(name, start_us,
        end_us)]; None without the anchor."""
        at = [a for n, a, _ in ranges if n == ANCHOR]
        if not at or self.anchor_ns is None:
            return None
        return max(at) - self.anchor_ns / 1e3

    def records(self) -> List[Record]:
        """Every record, closed or open, in the order opened, with the
        device milliseconds of its events (one synchronize)."""
        pending = [r for r in self._recs
                   if r.events is not None and r.device_ms is None]
        if pending:
            torch.cuda.synchronize(self.device)
            for r in pending:
                r.device_ms = r.events[0].elapsed_time(r.events[1])
                r.events = None
        return list(self._recs)

    def clear(self) -> None:
        """Drop every record and the statistics; no span may be open."""
        if self._open:
            raise RuntimeError(f"{len(self._open)} spans are open")
        self._recs.clear()
        self.stats.clear()

    def report_line(self, names=None) -> str:
        """Reference-style one-liner: 'real: 0.3, key_add: 1.2, ... ms'."""
        names = names or list(self.stats)
        parts = [f"{n}: {self.stats[n].avg_ms:.1f}" for n in names
                 if n in self.stats]
        return ", ".join(parts) + " ms (avg)"

    def summary(self) -> dict:
        """count / avg_ms / max_ms by name on the host clock; with timing
        events also device_avg_ms, and the counters' totals where any is
        nonzero."""
        out = {
            n: {"count": s.count, "avg_ms": round(s.avg_ms, 3),
                "max_ms": round(s.max_ms, 3)}
            for n, s in self.stats.items()
        }
        dev: Dict[str, List[float]] = defaultdict(list)
        totals: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        for r in self.records():
            if r.t1_ns == 0 or r.name not in out:
                continue
            if r.device_ms is not None:
                dev[r.name].append(r.device_ms)
            for k in COUNTERS:
                totals[r.name][k] += getattr(r, k)
        for n, ms in dev.items():
            out[n]["device_avg_ms"] = round(sum(ms) / len(ms), 3)
        for n, t in totals.items():
            out[n].update({k: round(v, 3) for k, v in t.items() if v})
        return out


def span(profiler, name: str, scan: Optional[int] = None):
    """``profiler.span(name)``, a null context without a profiler.  The
    port's ``Profiler`` also takes the scan its record belongs to; any
    other object with a ``span(name)`` context manager gets the name
    alone."""
    if profiler is None:
        return _NULL
    if scan is not None and isinstance(profiler, Profiler):
        return profiler.span(name, scan=scan)
    return profiler.span(name)


def sync(site: str):
    """The span ``sync.<site>`` around one host read, on the profiler whose
    span is open; a null context when none is."""
    p = _active
    return _NULL if p is None else p.span(SYNC + site)


def add(counter: str, n: int) -> None:
    """Add ``n`` to ``counter`` of every open record of the profiler whose
    span is open; nothing when none is."""
    p = _active
    if p is not None:
        p.add(counter, n)
