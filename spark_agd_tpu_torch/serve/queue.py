"""Dynamic micro-batching queue: coalesce, pad, serve, slice.

Counterpart of ``spark_agd_tpu/serve/queue.py``.  A batch closes when it
holds ``max_batch`` rows OR the oldest queued request has waited
``max_wait_us``, so a quiet queue serves singles at once and a busy
queue converges to full buckets.

Backpressure is a hard row bound: when admitting a request would push
the queued row count past ``max_queue_rows``, ``submit`` raises the
typed :class:`~spark_agd_tpu_torch.resilience.errors.ServeOverloaded`
(classified TRANSIENT — the client backs off and retries; the server
sheds instead of queueing unboundedly).

One worker thread serves the coalesced batches, one engine call at a
time.  It makes the engine's device current in its own thread and runs
every program once there before ``start`` returns (``ServeEngine.warm``),
so the first request does not pay for this thread's handles.  The
engine copies each batch's result to the host before the worker slices
it per request and resolves the futures: one device round trip per
batch, never per request.  ``stop`` serves every admitted request before
the worker exits.

Telemetry (the JAX package's records): one ``serve_request`` record a
request (ok / rejected / error), ``serve_batch`` and ``serve_request``
trace spans, and ``serve_latency`` rollups (QPS, p50/p99, queue depth)
on demand and at shutdown.  Per-op queue depth rides the
``serve.queue_depth.<op>`` gauges; rejects of a named tenant count under
``serve.tenant_rejected`` (and per tenant).  A queue constructed with
``replica=`` stamps that replica index onto every request and latency
record, so the fleet router's per-replica EWMA and ``latency_summary()``
attribute the same numbers to the same replica.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..obs import flight as flight_lib, trace as trace_lib
from ..resilience.errors import ServeOverloaded
from .engine import ServeEngine

DEFAULT_MAX_WAIT_US = 2000


@dataclasses.dataclass
class ServeResult:
    """What a request's future resolves to."""

    value: np.ndarray
    generation: int      # the model generation that served it
    op: str
    rows: int
    bucket: int          # padded batch shape the rows rode in
    batch_rows: int      # total live rows coalesced into that batch
    queue_ms: float      # admission -> dispatch
    latency_ms: float    # admission -> result ready


@dataclasses.dataclass
class _Request:
    rows: np.ndarray
    op: str
    future: Future
    t_submit: float
    squeeze: bool
    # the submitting thread's trace context (obs.trace), captured at
    # admission: the worker thread does NOT inherit the context
    # variable, so the causal request→batch→engine chain is carried
    # across the queue by hand — the explicit cross-thread propagation
    # rule of docs/OBSERVABILITY.md §distributed-tracing
    ctx: Optional[trace_lib.SpanContext] = None
    t_submit_unix: float = 0.0
    tenant: Optional[str] = None


class MicroBatchQueue:
    """See module docstring.  ``start()`` spawns the single worker
    thread; ``stop()`` drains admitted requests, then stops it and
    emits the final ``serve_latency`` rollup.  Context-manager form
    does both."""

    def __init__(self, engine: ServeEngine, *,
                 max_wait_us: int = DEFAULT_MAX_WAIT_US,
                 max_queue_rows: Optional[int] = None,
                 telemetry=None, replica: Optional[int] = None):
        self.engine = engine
        self.max_batch = engine.max_batch
        self.max_wait_s = max(0, int(max_wait_us)) / 1e6
        self.max_queue_rows = (4 * self.max_batch
                               if max_queue_rows is None
                               else int(max_queue_rows))
        self.telemetry = telemetry
        self.replica = None if replica is None else int(replica)
        self._pending: Deque[_Request] = deque()
        self._pending_rows = 0
        self._pending_rows_by_op: Dict[str, int] = {}
        self._cond = threading.Condition()
        self._stopping = False
        self._started = False
        self._worker: Optional[threading.Thread] = None
        self._t_start = time.monotonic()
        # rolled-up serving stats (guarded by _cond); the latency ring
        # is bounded, so percentiles are over the most recent window
        self._latencies_ms: Deque[float] = deque(maxlen=8192)
        self._requests_done = 0
        self._rows_done = 0
        self._rejected = 0
        self._errors = 0
        self._batches = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "MicroBatchQueue":
        with self._cond:
            if self._started:
                return self
            self._started = True
            self._stopping = False
            self._t_start = time.monotonic()
        ready = threading.Event()
        failed: List[BaseException] = []
        self._worker = threading.Thread(
            target=self._run, args=(ready, failed), name="serve-queue",
            daemon=True)
        self._worker.start()
        ready.wait()
        if failed:
            self._worker.join()
            self._worker = None
            with self._cond:
                self._started = False
            raise failed[0]
        return self

    def stop(self) -> None:
        """Drain everything already admitted, then stop the worker and
        emit the final latency rollup.  New submits are rejected from
        the moment stop is called."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        with self._cond:
            self._started = False
        if self.telemetry is not None:
            self.emit_latency()

    def __enter__(self) -> "MicroBatchQueue":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False

    @property
    def batches(self) -> int:
        """Batches served so far (each one engine call)."""
        with self._cond:
            return self._batches

    # -- admission ---------------------------------------------------------
    def _attrib(self, tenant: Optional[str] = None) -> dict:
        """Optional record fields shared by every emit path: the
        replica this queue serves for, and the submitting tenant."""
        extra: dict = {}
        if self.replica is not None:
            extra["replica"] = self.replica
        if tenant is not None:
            extra["tenant"] = tenant
        return extra

    def _note_depth(self, op: str) -> None:
        """Refresh the per-op queue-depth gauge (caller holds _cond)."""
        if self.telemetry is not None:
            self.telemetry.registry.gauge(
                f"serve.queue_depth.{op}").set(
                    self._pending_rows_by_op.get(op, 0))

    def submit(self, x, op: str = "predict",
               tenant: Optional[str] = None) -> Future:
        """Admit one request (a feature row or a row batch); returns a
        future resolving to a :class:`ServeResult`.  Raises
        ``ServeOverloaded`` (TRANSIENT) at capacity, ``ValueError``
        (FATAL) for inadmissible shapes, ``RuntimeError`` once
        stopped."""
        rows = np.asarray(x, dtype=self.engine.spec.dtype)
        squeeze = rows.ndim == 1
        if squeeze:
            rows = rows[None, :]
        if rows.ndim != 2 or rows.shape[1] != self.engine.spec.n_features:
            raise ValueError(
                f"expected ({self.engine.spec.n_features},) or "
                f"(n, {self.engine.spec.n_features}) features, got "
                f"shape {rows.shape}")
        n = rows.shape[0]
        if n < 1 or n > self.max_batch:
            raise ValueError(
                f"request of {n} rows is not admissible (1 <= n <= "
                f"max_batch={self.max_batch}); chunk client-side or "
                "use ServeEngine.predict")
        if op not in self.engine.ops:
            raise ValueError(f"op {op!r} not served (ops: "
                             f"{self.engine.ops})")
        req = _Request(rows, op, Future(), time.monotonic(), squeeze,
                       ctx=trace_lib.current_context(),
                       t_submit_unix=time.time(),
                       tenant=None if tenant is None else str(tenant))
        with self._cond:
            if self._stopping or not self._started:
                raise RuntimeError(
                    "queue is not running (start() it, or submit "
                    "before stop())")
            if self._pending_rows + n > self.max_queue_rows:
                self._rejected += 1
                queued = self._pending_rows
                if self.telemetry is not None:
                    self.telemetry.serve_request(
                        rows=n, op=op, status="rejected",
                        tool="serve.queue", **self._attrib(req.tenant))
                    if req.tenant is not None:
                        self.telemetry.registry.counter(
                            "serve.tenant_rejected").inc()
                        self.telemetry.registry.counter(
                            f"serve.tenant_rejected.{req.tenant}").inc()
                # the overload ships with its last-seconds timeline;
                # rate-limited inside the recorder (one dump per
                # reason per window, not one per rejected request)
                flight_lib.dump_on_failure(self.telemetry,
                                           "serve_overloaded")
                raise ServeOverloaded(queued + n, self.max_queue_rows)
            self._pending.append(req)
            self._pending_rows += n
            self._pending_rows_by_op[op] = (
                self._pending_rows_by_op.get(op, 0) + n)
            self._note_depth(op)
            self._cond.notify_all()
        return req.future

    def predict(self, x, op: str = "predict", timeout: float = 30.0):
        """Blocking convenience: ``submit`` + wait, returning just the
        values array."""
        return self.submit(x, op).result(timeout=timeout).value

    @property
    def depth_rows(self) -> int:
        with self._cond:
            return self._pending_rows

    # -- the worker --------------------------------------------------------
    def _run(self, ready: threading.Event,
             failed: List[BaseException]) -> None:
        try:
            if self.engine.device.type == "cuda":
                torch.cuda.set_device(self.engine.device)
            self.engine.warm()
        except Exception as e:  # noqa: BLE001 — raised by start()
            failed.append(e)
            return
        finally:
            ready.set()
        while True:
            group = self._next_group()
            if group is None:
                return
            self._dispatch(group)

    def _next_group(self) -> Optional[List[_Request]]:
        """Block until a batch is ready under the two-knob admission
        rule, then pop a same-op FIFO prefix of at most ``max_batch``
        rows.  Returns None when stopped and drained."""
        with self._cond:
            while True:
                if self._pending:
                    break
                if self._stopping:
                    return None
                self._cond.wait()
            # wait out the coalescing window (unless already full or
            # draining)
            deadline = self._pending[0].t_submit + self.max_wait_s
            while (not self._stopping
                   and self._pending_rows < self.max_batch):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
                if not self._pending:
                    return self._none_or_retry()
            group: List[_Request] = []
            rows = 0
            op = self._pending[0].op
            while self._pending and self._pending[0].op == op:
                n = self._pending[0].rows.shape[0]
                if rows + n > self.max_batch:
                    break
                req = self._pending.popleft()
                self._pending_rows -= n
                self._pending_rows_by_op[op] = (
                    self._pending_rows_by_op.get(op, 0) - n)
                rows += n
                group.append(req)
            self._note_depth(op)
            return group

    def _none_or_retry(self) -> Optional[List[_Request]]:
        # the queue emptied while we coalesced (only possible on stop
        # paths); loop or exit via _run's next _next_group call
        return None if self._stopping else []

    def _request_contexts(self, group: List[_Request]):
        """One pre-allocated request-span context per request, each a
        child of its SUBMITTER's captured context (or a fresh root for
        an untraced client) — minted before dispatch so the batch span
        can parent under the first request."""
        if self.telemetry is None:
            return None
        return [trace_lib.child_of(req.ctx) for req in group]

    def _dispatch(self, group: List[_Request]) -> None:
        if not group:
            return
        op = group[0].op
        X = (group[0].rows if len(group) == 1
             else np.concatenate([r.rows for r in group], axis=0))
        batch_rows = X.shape[0]
        req_ctxs = self._request_contexts(group)
        # causal chain: request spans hang off their submitters; the
        # coalesced batch span is a SIBLING of the first request's
        # span, parented on its submitter (whose open record is
        # already durable in the caller's stream — a worker killed
        # mid-batch must truncate the tree, never orphan it); the
        # siblings link back via batch_span_id, and the engine call
        # inside inherits the batch context through the context
        # variable (same worker thread)
        batch_span = (self.telemetry.trace_span(
            "serve_batch", parent=group[0].ctx, op=op,
            batch_rows=batch_rows, requests=len(group),
            tool="serve.queue")
            if req_ctxs is not None else None)
        batch_span_id = None
        t_dispatch = time.monotonic()
        try:
            with batch_span if batch_span is not None \
                    else contextlib.nullcontext() as bctx:
                if bctx is not None:
                    batch_span_id = bctx.span_id
                values, generation, bucket = self.engine.serve_batch(
                    X, op)
                if batch_span is not None:
                    batch_span.note(generation=generation,
                                    bucket=bucket)
        except BaseException as e:  # noqa: BLE001 — forwarded to callers
            self._fail_group(group, op, e, req_ctxs, batch_span_id)
            return
        t_done = time.monotonic()
        offset = 0
        results = []
        for req in group:
            n = req.rows.shape[0]
            out = values[offset:offset + n]
            offset += n
            res = ServeResult(
                value=out[0] if req.squeeze else out,
                generation=generation, op=op, rows=n, bucket=bucket,
                batch_rows=batch_rows,
                queue_ms=(t_dispatch - req.t_submit) * 1e3,
                latency_ms=(t_done - req.t_submit) * 1e3)
            results.append((req, res))
        with self._cond:
            self._batches += 1
            for _, res in results:
                self._requests_done += 1
                self._rows_done += res.rows
                self._latencies_ms.append(res.latency_ms)
        for i, (req, res) in enumerate(results):
            if self.telemetry is not None:
                self.telemetry.serve_request(
                    rows=res.rows, op=op, status="ok",
                    bucket=res.bucket, batch_rows=res.batch_rows,
                    generation=res.generation,
                    queue_ms=round(res.queue_ms, 3),
                    latency_ms=round(res.latency_ms, 3),
                    tool="serve.queue", **self._attrib(req.tenant))
                self.telemetry.trace_point(
                    "serve_request", seconds=res.latency_ms / 1e3,
                    ctx=req_ctxs[i], t_start_unix=req.t_submit_unix,
                    rows=res.rows, op=op, bucket=res.bucket,
                    generation=res.generation,
                    batch_span_id=batch_span_id, tool="serve.queue")
            req.future.set_result(res)

    def _fail_group(self, group: List[_Request], op: str,
                    exc: BaseException, req_ctxs=None,
                    batch_span_id=None) -> None:
        with self._cond:
            self._errors += len(group)
        for i, req in enumerate(group):
            if self.telemetry is not None:
                self.telemetry.serve_request(
                    rows=req.rows.shape[0], op=op, status="error",
                    error=f"{type(exc).__name__}: {exc}",
                    tool="serve.queue", **self._attrib(req.tenant))
                if req_ctxs is not None:
                    self.telemetry.trace_point(
                        "serve_request",
                        seconds=time.monotonic() - req.t_submit,
                        ctx=req_ctxs[i],
                        t_start_unix=req.t_submit_unix, status="error",
                        rows=req.rows.shape[0], op=op,
                        error=f"{type(exc).__name__}: {exc}",
                        batch_span_id=batch_span_id,
                        tool="serve.queue")
            req.future.set_exception(exc)

    # -- stats / telemetry -------------------------------------------------
    def latency_summary(self) -> dict:
        """The serving rollup over everything completed so far — the
        ``serve_latency`` record's field set."""
        with self._cond:
            lat = sorted(self._latencies_ms)
            done = self._requests_done
            rows = self._rows_done
            rejected = self._rejected
            errors = self._errors
            depth = self._pending_rows
        window_s = max(time.monotonic() - self._t_start, 1e-9)
        summary = {
            "requests": done, "rows": rows, "rejected": rejected,
            "errors": errors, "queue_depth": depth,
            "qps": round(done / window_s, 3),
            "window_s": round(window_s, 3),
            "hot_swaps": self.engine.hot_swaps,
            "generation": self.engine.generation,
        }
        if self.replica is not None:
            summary["replica"] = self.replica
        if lat:
            summary.update(
                p50_ms=round(_percentile(lat, 0.50), 3),
                p99_ms=round(_percentile(lat, 0.99), 3),
                mean_ms=round(sum(lat) / len(lat), 3),
                max_ms=round(lat[-1], 3))
        return summary

    def recent_latencies(self) -> List[float]:
        """The most recent per-request latencies (ms), oldest first —
        the SAME bounded ring ``latency_summary()`` takes percentiles
        over, exposed so the fleet router's per-replica EWMA and the
        rollup agree on the same numbers."""
        with self._cond:
            return list(self._latencies_ms)

    def emit_latency(self) -> Optional[dict]:
        """Emit (and return) one ``serve_latency`` record with the
        current rollup; no-op without telemetry."""
        if self.telemetry is None:
            return None
        summary = self.latency_summary()
        return self.telemetry.serve_latency(tool="serve.queue",
                                            **summary)


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted non-empty list."""
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q * len(sorted_vals) + 0.5)) - 1))
    return sorted_vals[idx]
