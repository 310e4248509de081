"""``Telemetry``: the one object threaded through the serving plane, the
pipeline and the supervised fit as ``telemetry=``.

A near-copy of ``spark_agd_tpu/obs/telemetry.py``.  It bundles:

- a :class:`~spark_agd_tpu_torch.obs.registry.MetricsRegistry` (counters,
  gauges, span timers), the passive accumulator;
- an :class:`~spark_agd_tpu_torch.obs.events.EventBus` over pluggable
  sinks, the active stream.  Spans emit one ``span`` record as they
  close;
- the per-iteration stream: :meth:`Telemetry.iteration_callback` returns
  the host function ``core.agd.run_agd`` calls once an iteration
  (``telemetry_cb=``) with the iteration's scalars (it, loss, L, theta,
  step, restarted), which the port's loop reads on the host already.

``tests/test_torch_telemetry.py`` holds everything after this docstring
to the original, line for line, but for three places: the bus is a
:class:`_StampedBus`, which stamps every record with the process's
``device_kind`` and its torch and CUDA versions (:func:`environment`);
``heartbeat`` reads the process index from ``obs.trace.process_index``
(the rank of an initialized ``torch.distributed`` group) instead of JAX;
and those two pieces are defined here.

``profile_dir=`` is read by the fit entry points' instrumented fit
(``api._make_instrumented_fit``): ``utils.profiling.OneShotTrace`` writes
the first ``execute`` phase there as a ``torch.profiler`` Chrome trace
(the class docstring below, pinned to the original, says "JAX profiler
trace" and ``TraceAnnotation``; the port's are ``torch.profiler`` and
``record_function``).  ``telemetry=None`` everywhere runs the same code
as before, with no callback and no host sync added.
"""

from __future__ import annotations

import math
import re
import time as _time
from typing import Iterable, List, Optional

from . import schema, trace as trace_lib
from .events import EventBus
from .flight import FlightRecorder
from .registry import MetricsRegistry
from .sinks import InMemorySink, Sink


def environment() -> dict:
    """The fields every record of this process carries: ``device_kind``
    (the current CUDA device's name, ``"cpu"`` without CUDA) and the
    torch and CUDA versions."""
    import torch

    cuda = torch.cuda.is_available()
    return {"device_kind": (torch.cuda.get_device_name(
                torch.cuda.current_device()) if cuda else "cpu"),
            "torch_version": str(torch.__version__),
            "cuda_version": str(torch.version.cuda or "none")}


class _StampedBus(EventBus):
    """The event bus, with :func:`environment`'s fields (read at the
    first emit) added to every record that does not carry them yet."""

    _env: Optional[dict] = None

    def emit(self, record: dict) -> None:
        if self._env is None:
            self._env = environment()
        for key, value in self._env.items():
            record.setdefault(key, value)
        super().emit(record)


# callback kwarg -> canonical record field (the cores pass their
# internal names; records use the schema's)
_FIELD_NAMES = {"big_l": "L"}


def _scalar(v):
    """Host-side normalize one callback value (np scalar -> python)."""
    try:
        v = v.item()
    except AttributeError:
        pass
    if isinstance(v, bool):
        return v
    if isinstance(v, int):
        return v
    return float(v)


class Telemetry:
    """See module docstring.  With no ``sinks`` argument an in-memory
    sink is created so :attr:`records` / :meth:`iterations` work out of
    the box; pass explicit sinks (``JSONLSink``, ``CSVSink``,
    ``LoggingSink``, ``TensorBoardSink``) to stream elsewhere.

    ``host_mode``: ``"all"`` (default; single-host no-op) or
    ``"primary"`` (rank-0-only emission on multihost jobs) — see
    ``obs.events.EventBus``.

    ``profile_dir``: when set, the FIRST instrumented ``execute`` phase
    of a ``telemetry=`` fit is captured as a JAX profiler trace into
    this directory (``utils.profiling`` one-shot capture), with every
    span phase wrapped in a matching ``TraceAnnotation`` so the span
    timers and the device timeline line up.  One-shot by design:
    traces are large and ``start_trace`` cannot nest.

    ``flight``: the always-on crash flight recorder (``obs.flight``) —
    a bounded in-memory ring of the last N records, dumped by failure
    paths so every ``SupervisorGivingUp`` / ``QuorumLost`` /
    ``ServeOverloaded`` ships with its last-seconds timeline.  True
    (default) attaches a fresh :class:`~spark_agd_tpu.obs.flight.
    FlightRecorder`; pass a configured recorder, or ``False`` to opt
    out.  ``flight_dir`` is where automatic failure dumps land —
    without it the ring exists but ``dump_on_failure`` writes nothing
    (no surprise files).
    """

    def __init__(self, sinks: Optional[Iterable[Sink]] = None, *,
                 registry: Optional[MetricsRegistry] = None,
                 every: int = 1, host_mode: str = "all",
                 run_id: Optional[str] = None,
                 profile_dir: Optional[str] = None,
                 flight=True, flight_dir: Optional[str] = None):
        self.run_id = run_id or schema.new_run_id()
        self.profile_dir = profile_dir
        self.registry = registry or MetricsRegistry()
        self._mem: Optional[InMemorySink] = None
        if sinks is None:
            self._mem = InMemorySink()
            sinks = [self._mem]
        else:
            sinks = list(sinks)
            for s in sinks:
                if isinstance(s, InMemorySink):
                    self._mem = s
                    break
        self.flight: Optional[FlightRecorder] = None
        for s in sinks:
            if isinstance(s, FlightRecorder):
                self.flight = s
                break
        if self.flight is None and flight:
            self.flight = (flight if isinstance(flight, FlightRecorder)
                           else FlightRecorder(directory=flight_dir))
            sinks = list(sinks) + [self.flight]
        if self.flight is not None and flight_dir is not None \
                and self.flight.directory is None:
            self.flight.directory = flight_dir
        self.bus = _StampedBus(sinks, host_mode=host_mode)
        self.every = max(1, int(every))
        self.registry.set_span_hook(self._on_span)

    # -- spans ------------------------------------------------------------
    def _on_span(self, name: str, seconds: float) -> None:
        self.bus.emit(schema.span_record(self.run_id, name, seconds))

    def span(self, name: str):
        """Context manager timing a phase; the duration lands in the
        registry AND streams one ``span`` record as it closes."""
        return self.registry.span(name)

    # -- causal tracing (obs.trace / obs.timeline) -------------------------
    def trace_span(self, name: str, *, parent=None, **fields):
        """Context manager opening one CAUSAL span (``obs.trace``):
        parented to the current thread's context (or the explicit
        ``parent`` :class:`~spark_agd_tpu.obs.trace.SpanContext`),
        installed as current for the body, emitted as an ``open``
        record immediately (flushed — a killed host leaves a truncated
        span on disk) and a closing ``span`` record with the measured
        duration, trace ids, rank, and ``fields``.  ``__enter__``
        returns the span's context; the handle's ``note(**fields)``
        adds outcome fields to the closing record."""
        return trace_lib.TracedSpan(self, name, parent, fields)

    def trace_point(self, name: str, *, seconds: float, ctx=None,
                    parent=None, status: str = "ok",
                    t_start_unix: Optional[float] = None,
                    **fields) -> dict:
        """Emit (and return) one already-measured CLOSED span record —
        the non-context-manager member for latencies measured
        elsewhere (the serve queue's per-request spans).  ``ctx`` is
        the span's own context when pre-allocated; otherwise a fresh
        child of ``parent`` (or of the current context) is minted."""
        if ctx is None:
            ctx = trace_lib.child_of(
                parent if parent is not None
                else trace_lib.current_context())
        rec = schema.span_record(self.run_id, name, float(seconds))
        rec.update(trace_id=ctx.trace_id, span_id=ctx.span_id,
                   parent_id=ctx.parent_id, process=int(ctx.process),
                   status=str(status))
        if t_start_unix is not None:
            rec["t_start_unix"] = round(float(t_start_unix), 6)
        rec.update(fields)
        self.registry.counter("trace.spans").inc()
        self.bus.emit(rec)
        return rec

    def trace_summary(self, *, trace_id: str, spans: int,
                      **fields) -> dict:
        """Emit (and return) a ``trace_summary`` record — one trace's
        analysis rollup (``obs.timeline.analyze(...).summary_fields()``)
        — mirroring the straggler score into the
        ``trace.straggler_score`` gauge so skew rides the run
        summary's metrics snapshot."""
        score = fields.get("straggler_score")
        if isinstance(score, (int, float)) and not isinstance(score,
                                                              bool):
            self.registry.gauge("trace.straggler_score").set(score)
        rec = schema.trace_summary_record(self.run_id, trace_id,
                                          spans, **fields)
        self.bus.emit(rec)
        return rec

    # -- the live in-loop stream ------------------------------------------
    def iteration_callback(self, algorithm: str = "agd"):
        """The host function the fused loops call via
        ``jax.debug.callback`` — one call per executed iteration, kwargs
        are the per-iteration scalars.  ``accepted=False`` calls (an
        L-BFGS iteration whose line search failed — not an executed
        iteration) are counted but not emitted, preserving the
        one-record-per-iteration contract."""
        emitted = self.registry.counter(f"{algorithm}.iterations")
        rejected = self.registry.counter(f"{algorithm}.rejected_steps")
        every = self.every
        run_id = self.run_id
        bus = self.bus
        nonfinite_seen = []  # one numerics_failure per run, not per iter

        def on_iteration(**fields):
            accepted = fields.pop("accepted", None)
            if accepted is not None and not bool(accepted):
                rejected.inc()
                return
            it = int(fields.pop("it"))
            emitted.inc()
            vals = {_FIELD_NAMES.get(k, k): _scalar(v)
                    for k, v in fields.items()}
            loss = vals.get("loss")
            if (not nonfinite_seen and isinstance(loss, float)
                    and not math.isfinite(loss)):
                # the in-loop sanitizer's cheap twin: the streamed loss
                # went non-finite — land the failure in the same JSONL
                # as the metrics instead of only aborting the loop
                nonfinite_seen.append(it)
                self.numerics_failure(
                    f"{algorithm}: non-finite loss in compiled loop",
                    iter=it, algorithm=algorithm, source="iteration")
            if every > 1 and it % every:
                return
            bus.emit(schema.iteration_record(run_id, algorithm, it,
                                             **vals))

        return on_iteration

    # -- records ----------------------------------------------------------
    def emit(self, record: dict) -> None:
        self.bus.emit(record)

    def program_cost(self, cost, **fields) -> dict:
        """Emit (and return) a ``program_cost`` record for one compiled
        program — ``cost`` is an ``obs.introspect.ProgramCost``.  The
        headline numbers also land as registry gauges
        (``program.<label>.flops`` / ``.peak_hbm_bytes`` /
        ``.collectives``) so they ride every ``run_summary`` snapshot."""
        rec = cost.record(self.run_id, **fields)
        for g, v in (("flops", cost.flops),
                     ("peak_hbm_bytes", cost.peak_hbm_bytes),
                     ("collectives", cost.n_collectives)):
            if v is not None:
                self.registry.gauge(f"program.{cost.label}.{g}").set(v)
        self.bus.emit(rec)
        return rec

    def numerics_failure(self, message: str, *, leaf=None,
                         **fields) -> dict:
        """Emit (and return) a ``numerics_failure`` record — a
        sanitizer hit (``utils.debug``) or an in-loop non-finite loss —
        and count it (``numerics.failures``), so the failure lands in
        the same JSONL as the metrics it poisoned."""
        if leaf is None:
            # checkify messages name the failing quantity; surface it
            # as a first-class field when present
            m = re.search(r"leaf (.+?) non-finite", message)
            leaf = m.group(1) if m else None
        self.registry.counter("numerics.failures").inc()
        rec = schema.numerics_failure_record(
            self.run_id, str(message),
            **({"leaf": leaf} if leaf is not None else {}), **fields)
        self.bus.emit(rec)
        return rec

    def attempt(self, *, attempt: int, outcome: str, **fields) -> dict:
        """Emit (and return) an ``attempt`` record — one supervised fit
        attempt (``resilience.supervisor``) — and count it
        (``resilience.attempts``; failures also land in
        ``resilience.failed_attempts``)."""
        self.registry.counter("resilience.attempts").inc()
        if outcome != "ok":
            self.registry.counter("resilience.failed_attempts").inc()
        rec = schema.attempt_record(self.run_id, attempt, outcome,
                                    **fields)
        self.bus.emit(rec)
        return rec

    def heartbeat(self, *, process: Optional[int] = None,
                  **fields) -> dict:
        """Emit (and return) a ``heartbeat`` record — one liveness beat
        of this SPMD process (``resilience.distributed``) — and count it
        (``resilience.heartbeats``).  ``process`` defaults to this
        process's rank in its ``torch.distributed`` group (0 without
        one)."""
        if process is None:
            process = trace_lib.process_index()
        self.registry.counter("resilience.heartbeats").inc()
        fields.setdefault("timestamp_unix", round(_time.time(), 3))
        rec = schema.heartbeat_record(self.run_id, int(process), **fields)
        self.bus.emit(rec)
        return rec

    def chaos(self, *, fault: str, **fields) -> dict:
        """Emit (and return) a ``chaos`` record — one injected fault of
        a chaos campaign (``resilience.chaos``) — counted per kind
        (``chaos.<fault>``) so the campaign census rides the metrics
        snapshot."""
        self.registry.counter(f"chaos.{fault}").inc()
        fields.setdefault("timestamp_unix", round(_time.time(), 3))
        rec = schema.chaos_record(self.run_id, fault, **fields)
        self.bus.emit(rec)
        return rec

    def journal_replay(self, *, records: int, **fields) -> dict:
        """Emit (and return) a ``journal_replay`` record — one
        recovery-journal replay/repair (``resilience.journal``) — and
        count it (``resilience.journal_replays``)."""
        self.registry.counter("resilience.journal_replays").inc()
        rec = schema.journal_replay_record(self.run_id, records,
                                           **fields)
        self.bus.emit(rec)
        return rec

    def degraded(self, *, surviving: int, **fields) -> dict:
        """Emit (and return) a ``degraded`` record — one quorum-gated
        degraded continuation (``resilience.degrade``) — and count it
        (``resilience.degraded``), so a degraded tail is visible in
        every run summary."""
        self.registry.counter("resilience.degraded").inc()
        rec = schema.degraded_record(self.run_id, surviving, **fields)
        self.bus.emit(rec)
        return rec

    def recovery(self, *, action: str, **fields) -> dict:
        """Emit (and return) a ``recovery`` record — one resilience
        action (retry / rollback / preemption_flush / checkpoint /
        checkpoint_fallback / resume) — counted per action
        (``resilience.<action>``), so the run summary's metrics
        snapshot carries the recovery census."""
        self.registry.counter(f"resilience.{action}").inc()
        fields.setdefault("timestamp_unix", round(_time.time(), 3))
        rec = schema.recovery_record(self.run_id, action, **fields)
        self.bus.emit(rec)
        return rec

    def metrics_snapshot(self, *, tool: Optional[str] = None,
                         **extra_metrics) -> dict:
        """Emit (and return) a ``metrics`` record carrying the current
        registry snapshot (plus any ``extra_metrics``) — a mid-run
        checkpoint of the counters/gauges, where ``run_summary``
        attaches the FINAL snapshot at end of run."""
        metrics = self.registry.snapshot()
        metrics.update(extra_metrics)
        rec = schema.metrics_record(self.run_id, metrics, tool=tool)
        self.bus.emit(rec)
        return rec

    def contract_pin(self, *, contract: str, ok: bool,
                     **fields) -> dict:
        """Emit (and return) a ``contract_pin`` record — one
        compiled-program contract check (``analysis.contracts``:
        constant-bytes / donation / collective-census) — counting
        failures (``contracts.violations``), so a pin broken mid-run
        surfaces in the run summary."""
        if not ok:
            self.registry.counter("contracts.violations").inc()
        rec = schema.contract_pin_record(self.run_id, contract, ok,
                                         **fields)
        self.bus.emit(rec)
        return rec

    def serve_request(self, *, rows: int, **fields) -> dict:
        """Emit (and return) a ``serve_request`` record — one inference
        request through the serving plane (``serve.queue``) — counting
        requests and rows (``serve.requests`` / ``serve.rows``), with
        non-ok statuses additionally landing in ``serve.rejected`` /
        ``serve.errors`` so shed load is visible in every run
        summary."""
        self.registry.counter("serve.requests").inc()
        self.registry.counter("serve.rows").inc(int(rows))
        status = fields.get("status")
        if status == "rejected":
            self.registry.counter("serve.rejected").inc()
        elif status == "error":
            self.registry.counter("serve.errors").inc()
        rec = schema.serve_request_record(self.run_id, rows, **fields)
        self.bus.emit(rec)
        return rec

    def serve_latency(self, *, requests: int, **fields) -> dict:
        """Emit (and return) a ``serve_latency`` record — one serving
        rollup (``serve.queue.latency_summary``) — mirroring the
        headline numbers into gauges (``serve.qps`` / ``serve.p50_ms``
        / ``serve.p99_ms`` / ``serve.queue_depth``) so dashboards read
        them off the registry snapshot."""
        for g in ("qps", "p50_ms", "p99_ms", "queue_depth"):
            v = fields.get(g)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.registry.gauge(f"serve.{g}").set(v)
        rec = schema.serve_latency_record(self.run_id, requests,
                                          **fields)
        self.bus.emit(rec)
        return rec

    def scaling_curve(self, *, name: str, points: list,
                      **fields) -> dict:
        """Emit (and return) a ``scaling_curve`` record — one
        weak-scaling ladder (``obs.scaling`` / ``benchmarks.run.
        run_ladder``) — mirroring the headline shape numbers into
        gauges (``scaling.<name>.efficiency_floor`` — the curve's
        worst point — and ``scaling.<name>.serial_fraction``) and
        counting contention-contaminated points
        (``scaling.contended_points``), so a ladder's trust story
        rides every run summary."""
        eff = [e for e in (fields.get("efficiency") or [])
               if isinstance(e, (int, float)) and not isinstance(e, bool)]
        if eff:
            self.registry.gauge(
                f"scaling.{name}.efficiency_floor").set(min(eff))
        s = fields.get("serial_fraction")
        if isinstance(s, (int, float)) and not isinstance(s, bool):
            self.registry.gauge(f"scaling.{name}.serial_fraction").set(s)
        flagged = fields.get("contention_flagged")
        if isinstance(flagged, int) and flagged:
            self.registry.counter("scaling.contended_points").inc(flagged)
        rec = schema.scaling_curve_record(self.run_id, name, points,
                                          **fields)
        self.bus.emit(rec)
        return rec

    def skew_estimate(self, *, skew: float, **fields) -> dict:
        """Emit (and return) a ``skew_estimate`` record — one skew sync
        of the straggler scheduler (``resilience.scheduler``) —
        mirroring the skew into the ``sched.skew`` gauge so per-host
        imbalance rides every run summary's metrics snapshot."""
        self.registry.gauge("sched.skew").set(float(skew))
        rec = schema.skew_estimate_record(self.run_id, skew, **fields)
        self.bus.emit(rec)
        return rec

    def rebalance(self, *, at_iter: int, **fields) -> dict:
        """Emit (and return) a ``rebalance`` record — one applied
        generation-boundary rebalance decision
        (``resilience.scheduler``) — and count it
        (``sched.rebalances``)."""
        self.registry.counter("sched.rebalances").inc()
        rec = schema.rebalance_record(self.run_id, at_iter, **fields)
        self.bus.emit(rec)
        return rec

    def canary(self, *, generation: int, verdict: str,
               **fields) -> dict:
        """Emit (and return) a ``canary`` record — one shadow-served
        candidate evaluation (``pipeline.canary``) — counted overall
        (``pipeline.canaries``) and per verdict
        (``pipeline.canary.<verdict>``)."""
        self.registry.counter("pipeline.canaries").inc()
        self.registry.counter(f"pipeline.canary.{verdict}").inc()
        rec = schema.canary_record(self.run_id, generation, verdict,
                                   **fields)
        self.bus.emit(rec)
        return rec

    def promotion(self, *, decision: str, **fields) -> dict:
        """Emit (and return) a ``promotion`` record — one typed
        promotion decision (``pipeline.promote``: promoted / rejected /
        rolled_back) — counted per decision
        (``pipeline.<decision>``)."""
        self.registry.counter(f"pipeline.{decision}").inc()
        rec = schema.promotion_record(self.run_id, decision, **fields)
        self.bus.emit(rec)
        return rec

    def fleet_route(self, *, decision: str, **fields) -> dict:
        """Emit (and return) a ``fleet_route`` record — one routing
        decision of the serve fleet router (``serve.router``: route /
        hedge / retry / shed_tenant) — counted overall
        (``fleet.routes``) and per decision
        (``fleet.route.<decision>``)."""
        self.registry.counter("fleet.routes").inc()
        self.registry.counter(f"fleet.route.{decision}").inc()
        fields.setdefault("timestamp_unix", round(_time.time(), 3))
        rec = schema.fleet_route_record(self.run_id, decision, **fields)
        self.bus.emit(rec)
        return rec

    def replica_verdict(self, *, replica: int, verdict: str,
                        **fields) -> dict:
        """Emit (and return) a ``replica_verdict`` record — one
        replica-health classification change (``serve.router``, from
        ``HostMonitor.verdicts()``: ok / slow / lost) — counted per
        verdict (``fleet.verdict.<verdict>``)."""
        self.registry.counter(f"fleet.verdict.{verdict}").inc()
        fields.setdefault("timestamp_unix", round(_time.time(), 3))
        rec = schema.replica_verdict_record(self.run_id, replica,
                                            verdict, **fields)
        self.bus.emit(rec)
        return rec

    def shard_quarantine(self, *, shard: str, **fields) -> dict:
        """Emit (and return) a ``shard_quarantine`` record — one
        poisoned-shard quarantine decision of the streaming data plane
        (``data.streaming``) — and count it (``stream.quarantined``),
        so a degraded epoch is visible in every run summary."""
        self.registry.counter("stream.quarantined").inc()
        fields.setdefault("timestamp_unix", round(_time.time(), 3))
        rec = schema.shard_quarantine_record(self.run_id, shard,
                                             **fields)
        self.bus.emit(rec)
        return rec

    def stream_epoch(self, *, epoch: int, batches: int,
                     **fields) -> dict:
        """Emit (and return) a ``stream_epoch`` record — one completed
        streamed pass (``data.streaming.make_streaming_smooth``) —
        counting passes and batches (``stream.epochs`` /
        ``stream.batches``) and mirroring the prefetch stall fraction
        into the ``stream.stall_fraction`` gauge so overlap health
        rides the metrics snapshot."""
        self.registry.counter("stream.epochs").inc()
        self.registry.counter("stream.batches").inc(int(batches))
        sf = fields.get("stall_fraction")
        if isinstance(sf, (int, float)) and not isinstance(sf, bool):
            self.registry.gauge("stream.stall_fraction").set(sf)
        fields.setdefault("timestamp_unix", round(_time.time(), 3))
        rec = schema.stream_epoch_record(self.run_id, epoch, batches,
                                         **fields)
        self.bus.emit(rec)
        return rec

    def run_summary(self, *, tool: str, **fields) -> dict:
        """Emit (and return) the end-of-run ``run`` record, with the
        registry snapshot attached under ``metrics``."""
        rec = schema.run_record(tool=tool, run_id=self.run_id,
                                metrics=self.registry.snapshot(),
                                **fields)
        self.bus.emit(rec)
        return rec

    @property
    def records(self) -> List[dict]:
        """Everything the in-memory sink collected (empty when explicit
        sinks were passed without one)."""
        return list(self._mem.records) if self._mem is not None else []

    def iterations(self, algorithm: Optional[str] = None) -> List[dict]:
        """The in-memory iteration records, in iter order."""
        recs = [r for r in self.records if r.get("kind") == "iteration"
                and (algorithm is None or r.get("algorithm") == algorithm)]
        return sorted(recs, key=lambda r: r["iter"])

    def spans(self, name: Optional[str] = None) -> List[dict]:
        return [r for r in self.records if r.get("kind") == "span"
                and (name is None or r.get("name") == name)]

    # -- lifecycle --------------------------------------------------------
    def flush(self) -> None:
        self.bus.flush()

    def close(self) -> None:
        self.bus.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
