"""Per-stage wall-clock timers + progress logging.

Equivalent of the reference's TStopwatch instrumentation (ref TEST_2.C:283-284,
308, 1121-1127, 1388-1393, 1424-1428): named stage timers with cumulative
totals and a periodic progress line, plus an optional hook into the JAX
profiler for device traces.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

log = logging.getLogger("npswf")


class StageTimer:
    """Cumulative named timers; safe to use from the executor's stage
    worker threads (mutation of the dicts is lock-guarded).

    Every duration is also recorded, so ``report`` can show the median
    and maximum per call next to the total: a few slow calls (a first-call
    compile, a host hiccup) can dominate the totals while the median
    describes the steady pipeline."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.samples: Dict[str, list] = defaultdict(list)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1
                self.samples[name].append(dt)

    def record(self, name: str, dt: float) -> None:
        """Record an externally measured duration under ``name``."""
        with self._lock:
            self.totals[name] += dt
            self.counts[name] += 1
            self.samples[name].append(dt)

    def median(self, name: str) -> float:
        with self._lock:
            s = sorted(self.samples.get(name, ()))
        return s[len(s) // 2] if s else 0.0

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            s = sorted(self.samples[name])
            med, mx = s[len(s) // 2], s[-1]
            lines.append(
                f"  {name}: {self.totals[name]:.3f}s "
                f"({self.counts[name]} calls, med {med * 1e3:.0f} ms, "
                f"max {mx * 1e3:.0f} ms)")
        return ("stage timers:\n" + "\n".join(lines)
                if lines else "stage timers: none")


@contextlib.contextmanager
def device_trace(outdir: Optional[str]) -> Iterator[None]:
    """JAX profiler trace around a region (xprof-compatible)."""
    if not outdir:
        yield
        return
    import jax
    with jax.profiler.trace(outdir):
        yield
