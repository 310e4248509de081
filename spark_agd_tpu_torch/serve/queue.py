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
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Deque, List, Optional

import numpy as np
import torch

from .._later import reject_later
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


class MicroBatchQueue:
    """See module docstring.  ``start()`` spawns the single worker
    thread; ``stop()`` drains admitted requests, then stops it.
    Context-manager form does both."""

    def __init__(self, engine: ServeEngine, *,
                 max_wait_us: int = DEFAULT_MAX_WAIT_US,
                 max_queue_rows: Optional[int] = None,
                 telemetry=None):
        reject_later(telemetry=telemetry)
        self.engine = engine
        self.max_batch = engine.max_batch
        self.max_wait_s = max(0, int(max_wait_us)) / 1e6
        self.max_queue_rows = (4 * self.max_batch
                               if max_queue_rows is None
                               else int(max_queue_rows))
        self._pending: Deque[_Request] = deque()
        self._pending_rows = 0
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
        """Drain everything already admitted, then stop the worker.  New
        submits are rejected from the moment stop is called."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        with self._cond:
            self._started = False

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
    def submit(self, x, op: str = "predict") -> Future:
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
        req = _Request(rows, op, Future(), time.monotonic(), squeeze)
        with self._cond:
            if self._stopping or not self._started:
                raise RuntimeError(
                    "queue is not running (start() it, or submit "
                    "before stop())")
            if self._pending_rows + n > self.max_queue_rows:
                self._rejected += 1
                queued = self._pending_rows
                raise ServeOverloaded(queued + n, self.max_queue_rows)
            self._pending.append(req)
            self._pending_rows += n
            self._cond.notify_all()
        return req.future

    def predict(self, x, op: str = "predict", timeout: float = 30.0):
        """Blocking convenience: ``submit`` + wait, returning just the
        values array."""
        return self.submit(x, op).result(timeout=timeout).value

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
                rows += n
                group.append(req)
            return group

    def _none_or_retry(self) -> Optional[List[_Request]]:
        # the queue emptied while we coalesced (only possible on stop
        # paths); loop or exit via _run's next _next_group call
        return None if self._stopping else []

    def _dispatch(self, group: List[_Request]) -> None:
        if not group:
            return
        op = group[0].op
        X = (group[0].rows if len(group) == 1
             else np.concatenate([r.rows for r in group], axis=0))
        batch_rows = X.shape[0]
        t_dispatch = time.monotonic()
        try:
            values, generation, bucket = self.engine.serve_batch(X, op)
        except BaseException as e:  # noqa: BLE001 — forwarded to callers
            self._fail_group(group, e)
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
        for req, res in results:
            req.future.set_result(res)

    def _fail_group(self, group: List[_Request],
                    exc: BaseException) -> None:
        with self._cond:
            self._errors += len(group)
        for req in group:
            req.future.set_exception(exc)

    # -- stats -------------------------------------------------------------
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
        if lat:
            summary.update(
                p50_ms=round(_percentile(lat, 0.50), 3),
                p99_ms=round(_percentile(lat, 0.99), 3),
                mean_ms=round(sum(lat) / len(lat), 3),
                max_ms=round(lat[-1], 3))
        return summary


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted non-empty list."""
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q * len(sorted_vals) + 0.5)) - 1))
    return sorted_vals[idx]
