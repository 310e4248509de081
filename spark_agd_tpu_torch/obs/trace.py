"""Hierarchical trace contexts: causal parentage for every span.

A near-copy of ``spark_agd_tpu/obs/trace.py``: only
``process_index`` differs (it reads the rank of an initialized
``torch.distributed`` group); ``tests/test_torch_obs.py`` holds
every other line after this docstring to the original.

The telemetry stream before this module was FLAT: span timers, attempt
ledgers, and serve latency records all landed in one JSONL with no way
to say *this* retry belongs to *that* supervised run, or *this* engine
call served *that* request.  The per-host timeline diagnosis that
drives distributed-ML tuning (PAPERS.md arXiv 1612.01437: stragglers
and partition skew dominate cost) needs the causal tree.  This module
is the context layer:

- a :class:`SpanContext` is ``(trace_id, span_id, parent_id, process)``
  — one node of one trace's tree, with the emitting host's rank
  stamped;
- **in-thread propagation** is implicit through a ``contextvars``
  context variable: ``Telemetry.trace_span`` opens a span under the
  current context and installs itself as the new current;
- **cross-thread and cross-process propagation is EXPLICIT**: threads
  do not inherit the context variable (each ``threading.Thread`` starts
  with its own context), so a handoff captures
  :func:`current_context` on the submitting side and the worker adopts
  it with :func:`activate` (the serve ``MicroBatchQueue`` does exactly
  this), and a child process receives the wire form
  (:meth:`SpanContext.to_wire`) via the :data:`TRACE_ENV` environment
  variable (``tools/dist_fault_drill.py`` joins two gloo processes into
  one tree this way);
- spans ride the existing ``span`` record kind with OPTIONAL trace
  fields (``trace_id``/``span_id``/``parent_id``/``process``/
  ``t_start_unix``/``status``), so untraced spans and every existing
  consumer keep working unchanged.  Each traced span emits an ``open``
  record when it starts (flushed immediately — a SIGKILLed host leaves
  its open spans on disk, which is how a kill shows up as a TRUNCATED
  span in ``obs.timeline``) and a closing record with the measured
  duration.

Zero overhead when unused: nothing here touches jax tracing or the
compiled program — a fit run with tracing enabled lowers to the
IDENTICAL HLO (pinned by ``tests/test_trace.py``), because spans are
pure host-side bookkeeping around the program, never inside it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import os
from typing import Optional

# the environment variable a parent process hands its context to a
# child through (the drills' cross-process propagation channel)
TRACE_ENV = "AGD_TRACE_CONTEXT"

_current: contextvars.ContextVar = contextvars.ContextVar(
    "agd_trace_context", default=None)


def new_trace_id() -> str:
    """Process-unique random trace id (``t`` + 16 hex chars)."""
    return "t" + os.urandom(8).hex()


def new_span_id() -> str:
    """Random span id (``s`` + 12 hex chars)."""
    return "s" + os.urandom(6).hex()


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` group, 0 when no
    group is initialized (a single process is rank 0 by definition)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:  # noqa: BLE001 — torch.distributed not built
        pass
    return 0


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """One node of a trace tree — immutable, cheap to hand around."""

    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    process: int = 0

    def child(self, process: Optional[int] = None) -> "SpanContext":
        """A fresh span under this one (same trace, new span id)."""
        return SpanContext(
            trace_id=self.trace_id, span_id=new_span_id(),
            parent_id=self.span_id,
            process=self.process if process is None else int(process))

    # -- wire form (cross-process propagation) ---------------------------
    def to_wire(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "process": self.process}

    @classmethod
    def from_wire(cls, d: dict) -> "SpanContext":
        return cls(trace_id=str(d["trace_id"]),
                   span_id=str(d["span_id"]),
                   parent_id=(None if d.get("parent_id") is None
                              else str(d["parent_id"])),
                   process=int(d.get("process", 0)))

    def to_env_value(self) -> str:
        """The :data:`TRACE_ENV` payload (canonical JSON)."""
        return json.dumps(self.to_wire(), sort_keys=True)


def new_root(process: Optional[int] = None) -> SpanContext:
    """A fresh trace's root context."""
    return SpanContext(trace_id=new_trace_id(), span_id=new_span_id(),
                       parent_id=None,
                       process=process_index() if process is None
                       else int(process))


def child_of(ctx: Optional[SpanContext],
             process: Optional[int] = None) -> SpanContext:
    """A span context under ``ctx`` — or a fresh root when ``ctx`` is
    None (an orphan request with no caller trace starts its own)."""
    if ctx is None:
        return new_root(process)
    return ctx.child(process=process_index() if process is None
                     else int(process))


def current_context() -> Optional[SpanContext]:
    """The context the running thread is inside (None outside any
    traced span) — capture this at a thread/queue handoff boundary."""
    return _current.get()


@contextlib.contextmanager
def activate(ctx: Optional[SpanContext]):
    """Adopt ``ctx`` as the current context for the ``with`` body — the
    EXPLICIT propagation primitive for thread handoffs and for child
    processes that parsed :func:`from_env`.  ``activate(None)`` is a
    no-op, so call sites never branch."""
    if ctx is None:
        yield None
        return
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def from_env(environ=None) -> Optional[SpanContext]:
    """The context a parent process published through
    :data:`TRACE_ENV`; None when absent or unparseable (a garbled env
    var must not kill the child it was meant to observe)."""
    raw = (os.environ if environ is None else environ).get(TRACE_ENV)
    if not raw:
        return None
    try:
        return SpanContext.from_wire(json.loads(raw))
    except (ValueError, KeyError, TypeError):
        return None


class TracedSpan:
    """The context manager behind ``Telemetry.trace_span`` — opens a
    span under the current (or explicit ``parent``) context, installs
    itself as current for the body, and emits the open/close record
    pair.  ``__enter__`` returns the span's :class:`SpanContext`;
    :meth:`note` adds fields to the closing record (the supervisor
    stamps attempt outcomes this way)."""

    def __init__(self, telemetry, name: str,
                 parent: Optional[SpanContext] = None, fields=None):
        self._tel = telemetry
        self.name = str(name)
        self._parent = parent
        self._fields = dict(fields or {})
        self.ctx: Optional[SpanContext] = None
        self._token = None
        self._t0 = None
        self._t_start_unix = None

    def note(self, **fields) -> "TracedSpan":
        """Merge ``fields`` into the closing span record."""
        self._fields.update(fields)
        return self

    def _record(self, seconds: float, status: str) -> dict:
        from . import schema

        rec = schema.span_record(self._tel.run_id, self.name,
                                 float(seconds))
        rec.update(trace_id=self.ctx.trace_id, span_id=self.ctx.span_id,
                   parent_id=self.ctx.parent_id,
                   process=int(self.ctx.process), status=status,
                   t_start_unix=round(self._t_start_unix, 6))
        rec.update(self._fields)
        return rec

    def __enter__(self) -> SpanContext:
        import time

        parent = (self._parent if self._parent is not None
                  else current_context())
        self.ctx = child_of(parent)
        self._token = _current.set(self.ctx)
        self._t_start_unix = time.time()
        self._t0 = time.perf_counter()
        # the open record is flushed immediately: if this process dies
        # (SIGKILL, OOM) before closing, the span survives on disk as
        # the TRUNCATED evidence of where death struck
        self._tel.emit(self._record(0.0, "open"))
        self._tel.flush()
        return self.ctx

    def __exit__(self, exc_type, exc, tb):
        import time

        seconds = time.perf_counter() - self._t0
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if exc_type is not None:
            self._fields.setdefault(
                "error", f"{exc_type.__name__}: {exc}")
            status = "error"
        else:
            status = self._fields.pop("status", "ok")
        self._tel.registry.counter("trace.spans").inc()
        self._tel.emit(self._record(seconds, status))
        return False
