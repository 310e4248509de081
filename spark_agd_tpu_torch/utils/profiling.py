"""Tracing and profiling hooks: the profiler for device timelines, and wall
timers that wait for the device.

Counterpart of ``spark_agd_tpu/utils/profiling.py``, name for name, over
``torch.profiler`` in place of ``jax.profiler``:

- :func:`trace` records the CPU and, on a machine with CUDA, the CUDA
  activity of its block and writes one Chrome trace (``*.pt.trace.json``,
  readable by Perfetto and ``chrome://tracing``) into ``log_dir``;
- :func:`annotate` is ``torch.profiler.record_function``: a named range
  on the trace's CPU timeline;
- :class:`OneShotTrace` captures the first region it wraps and is a
  no-op after it (``log_dir=None``: always);
- :func:`timed_stats` and :func:`timed` time a callable honestly: where
  its result holds a CUDA tensor, the device is synchronized before each
  clock read, as the JAX package blocks until the result is ready.

``torch`` is imported inside the functions that use the profiler, so
importing this module costs nothing.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, List, NamedTuple, Optional, Tuple


def _activities():
    from torch.profiler import ProfilerActivity
    import torch

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU and CUDA activity) and write its Chrome
    trace into ``log_dir`` as ``trace-<pid>-<n>.pt.trace.json``; the
    context value is the ``torch.profiler.profile`` object.  Usage::

        with profiling.trace("/tmp/agd-trace"):
            api.run(...)
    """
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
    n = len([f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")])
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{n}.pt.trace.json"))


def annotate(name: str):
    """Named region inside a trace (a range on the host's timeline)."""
    from torch.profiler import record_function

    return record_function(name)


class OneShotTrace:
    """Capture the FIRST wrapped region into a profiler trace, then
    become a no-op: traces are large, so an instrumented fit captures
    exactly one timeline per telemetry object.  ``log_dir=None``
    disables (every call is a no-op), letting call sites wrap
    unconditionally::

        capture = profiling.OneShotTrace(telemetry.profile_dir)
        with capture(), telemetry.span("execute"):
            ...

    ``captured`` holds the log dir after the one capture (else None).
    """

    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self.captured: Optional[str] = None
        self._armed = log_dir is not None

    @contextlib.contextmanager
    def __call__(self):
        if not self._armed:
            yield
            return
        self._armed = False
        with trace(self.log_dir):
            yield
        self.captured = self.log_dir


class TimedStats(NamedTuple):
    """Full repeat statistics from :func:`timed_stats` (seconds)."""

    min_s: float
    median_s: float
    max_s: float
    times: List[float]  # per-repeat, in execution order


def _ready(out):
    """Wait for ``out``: synchronize every CUDA device a tensor of it
    (a tensor, or a tuple, list or dict of them, nested) lies on."""
    import torch

    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                visit(v)

    visit(out)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out


def timed_stats(fn: Callable, *args, warmup: int = 1, repeats: int = 3,
                registry=None,
                name: Optional[str] = None) -> Tuple[TimedStats, object]:
    """Wall-clock a callable honestly: ``warmup`` calls absorb first-use
    builds, then ``repeats`` timings, each ending once the result's CUDA
    tensors are ready; returns ``(TimedStats(min, median, max, times),
    last_result)``.

    ``registry`` (an ``obs.MetricsRegistry``; defaults to the process
    registry) records each repeat under the span ``name`` (default
    ``timed.<fn name>``): one span event per repeat streams out live
    when the registry is attached to a ``Telemetry`` bus.
    """
    if registry is None:
        from ..obs.registry import default_registry

        registry = default_registry()
    span = registry.span(name or f"timed.{getattr(fn, '__name__', 'fn')}")
    out = None
    for _ in range(max(0, warmup)):
        out = _ready(fn(*args))
    times = []
    for _ in range(max(1, repeats)):
        with span:
            t0 = time.perf_counter()
            out = _ready(fn(*args))
            times.append(time.perf_counter() - t0)
    ordered = sorted(times)
    return TimedStats(min_s=ordered[0],
                      median_s=ordered[len(ordered) // 2],
                      max_s=ordered[-1], times=times), out


def timed(fn: Callable, *args, warmup: int = 1,
          repeats: int = 3) -> Tuple[float, object]:
    """Median-only wrapper over :func:`timed_stats`: ``(seconds,
    last_result)``."""
    stats, out = timed_stats(fn, *args, warmup=warmup, repeats=repeats)
    return stats.median_s, out
