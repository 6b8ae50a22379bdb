"""Per-stage host timers — the reference's hand-rolled chrono spans
(fast_lio_sam_qn.cpp:92,123,147,154,172,189,191-197): named spans with
running statistics, as the JAX package's ``utils/profiling.py``.

A span measures the host clock; it includes device work only where the
spanned section ends in a host read (the pipeline's ``feed`` and loop
ticks do).
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class StageStats:
    count: int = 0
    total_ms: float = 0.0
    max_ms: float = 0.0

    @property
    def avg_ms(self) -> float:
        return self.total_ms / max(self.count, 1)


@dataclass
class Profiler:
    stats: Dict[str, StageStats] = field(
        default_factory=lambda: defaultdict(StageStats))
    history: List[tuple] = field(default_factory=list)
    keep_history: bool = False

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            s = self.stats[name]
            s.count += 1
            s.total_ms += dt
            s.max_ms = max(s.max_ms, dt)
            if self.keep_history:
                self.history.append((name, dt))

    def report_line(self, names=None) -> str:
        """Reference-style one-liner: 'real: 0.3, key_add: 1.2, ... ms'."""
        names = names or list(self.stats)
        parts = [f"{n}: {self.stats[n].avg_ms:.1f}" for n in names
                 if n in self.stats]
        return ", ".join(parts) + " ms (avg)"

    def summary(self) -> dict:
        return {
            n: {"count": s.count, "avg_ms": round(s.avg_ms, 3),
                "max_ms": round(s.max_ms, 3)}
            for n, s in self.stats.items()
        }
