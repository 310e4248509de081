"""Metrics registry: counters, gauges, and span timers.

A copy of ``spark_agd_tpu/obs/registry.py``, which needs only
the standard library;
``tests/test_torch_obs.py`` holds everything after this docstring
to the original, line for line.

The reference has NO metrics surface of its own — it computes L, theta,
step size, and restart decisions every iteration and discards them all
(reference ``AcceleratedGradientDescent.scala:302-335``; SURVEY §5),
leaning on the Spark UI for anything operational.  The ROADMAP's
production north-star needs first-class metrics: "Understanding and
Optimizing the Performance of Distributed ML Applications on Apache
Spark" (PAPERS.md) shows per-phase timing breakdowns (compute vs.
aggregate vs. overhead) are what drives distributed-optimizer tuning.

This module is the passive half of the telemetry subsystem: named
counters/gauges/span-timer instruments that any layer can write to
cheaply (a dict update under a lock — no I/O), snapshotted on demand.
The active half (events streamed to sinks while a run executes) lives in
``obs.events`` / ``obs.stream``.

Thread-safe: the benches time runs from watchdog threads, and
``jax.debug.callback`` host callbacks may run on a runtime thread.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional


class Counter:
    """Monotonic count (cache hits, records emitted, restarts)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-written value (cache dir size, rows staged, device count)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = None
        self._lock = threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        return self._value


class SpanTimer:
    """Named wall-clock span, used as a context manager::

        with registry.span("compile"):
            lowered.compile()

    Every completed span appends to ``times`` (seconds) and, when the
    registry has an ``on_span`` hook attached (``obs.Telemetry`` wires
    the event bus there), emits one span event as it closes — so phase
    timings stream out live instead of only existing in the end-of-run
    snapshot.
    """

    __slots__ = ("name", "times", "_lock", "_on_span", "_t0")

    def __init__(self, name: str,
                 on_span: Optional[Callable[[str, float], None]] = None):
        self.name = name
        self.times: List[float] = []
        self._lock = threading.Lock()
        self._on_span = on_span

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        with self._lock:
            self.times.append(dt)
        if self._on_span is not None:
            self._on_span(self.name, dt)
        return False

    @property
    def count(self) -> int:
        return len(self.times)

    @property
    def total(self) -> float:
        return sum(self.times)

    @property
    def last(self) -> Optional[float]:
        return self.times[-1] if self.times else None


class MetricsRegistry:
    """Create-on-first-use instrument registry.

    ``counter(name)`` / ``gauge(name)`` / ``span(name)`` return the same
    instrument for the same name; ``snapshot()`` renders everything as
    one flat dict (span timers as ``{name}.count/.total_s/.last_s``),
    suitable for logging or stamping into a run record.
    """

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._spans: Dict[str, SpanTimer] = {}
        self._lock = threading.Lock()
        self._on_span: Optional[Callable[[str, float], None]] = None

    def set_span_hook(self, fn: Optional[Callable[[str, float], None]]):
        """Called ``fn(name, seconds)`` as each span closes (existing
        span timers are rewired too)."""
        with self._lock:
            self._on_span = fn
            for sp in self._spans.values():
                sp._on_span = fn

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name)
            return self._gauges[name]

    def span(self, name: str) -> SpanTimer:
        with self._lock:
            if name not in self._spans:
                self._spans[name] = SpanTimer(name, self._on_span)
            return self._spans[name]

    def snapshot(self) -> dict:
        with self._lock:
            out = {}
            for n, c in self._counters.items():
                out[n] = c.value
            for n, g in self._gauges.items():
                out[n] = g.value
            for n, s in self._spans.items():
                out[f"{n}.count"] = s.count
                out[f"{n}.total_s"] = round(s.total, 6)
                if s.last is not None:
                    out[f"{n}.last_s"] = round(s.last, 6)
            return out


# One process-wide default registry: instrumentation sites that have no
# Telemetry object threaded to them (the compile cache's once-per-process
# census, ad-hoc profiling) still land somewhere inspectable.
_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default
