"""The canonical run-record JSONL schema.

A copy of ``spark_agd_tpu/obs/schema.py``, which needs only the
standard library; ``tests/test_torch_logging.py`` holds everything
after this docstring to the original, line for line.

Before this module every producer serialized its own incompatible JSON:
``benchmarks/run.py`` emitted bare config records, ``bench.py`` emitted
its ladder/bank shapes, and ``utils/logging.py`` emitted ad-hoc
per-iteration dicts — three artifact families no one tool could read.
This module defines ONE record family every producer stamps and every
consumer (``tools/agd_report.py``, future round comparisons of
``BENCH_*`` artifacts) can parse:

- every record carries ``schema_version``, ``kind``, ``run_id``;
- ``kind`` is one of ``run`` (one completed fit/benchmark), ``iteration``
  (one optimizer iteration, live-streamed or post-hoc), ``span`` (one
  timed phase: trace/compile/execute/h2d), ``metrics`` (a registry
  snapshot);
- required and known-optional fields are typed (validated by
  :func:`validate_record`); unknown extra fields are ALLOWED — producers
  keep their tool-specific columns, consumers ignore what they don't
  know.  Existing artifact readers (e.g. ``bench.py``'s replay path)
  keep working because stamping only ADDS keys.

Deliberately dependency-free (stdlib only): ``bench.py`` stamps its
one-line contract through here and must never grow a heavy import, and
``python -m spark_agd_tpu.obs --selfcheck`` validates an example record
in CI without touching a backend.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

SCHEMA_VERSION = 1

KINDS = ("run", "iteration", "span", "metrics", "program_cost",
         "numerics_failure", "attempt", "recovery", "heartbeat",
         "chaos", "journal_replay", "degraded", "contract_pin",
         "serve_request", "serve_latency", "trace_summary",
         "scaling_curve", "skew_estimate", "rebalance",
         "canary", "promotion", "fleet_route", "replica_verdict",
         "shard_quarantine", "stream_epoch")

# the recovery actions the resilience layer emits; validation accepts
# any string (producers may grow new actions), this tuple documents the
# canonical set for consumers.  ``hot_swap`` is the serving registry's
# generation swap (serve.registry); ``flight_dump`` records a flight-
# recorder dump written by a failure path (obs.flight); ``rebalance``
# and ``speculative_exec`` are the straggler scheduler's actions
# (resilience.scheduler); ``rollback_generation`` is the continuous-
# learning pipeline repointing serving HEAD back to the prior
# generation after a failed promotion (pipeline.promote);
# ``replica_evict``/``request_hedge``/``request_retry`` are the fleet
# router's actions (serve.router): a LOST replica removed from the
# candidate set, a tail request re-issued to a second replica, and an
# in-flight request transparently re-served on a survivor;
# ``native_fallback`` is the one-time typed record of the data plane
# dropping to the Python parser because the native .so is missing or
# ABI-mismatched (native/__init__.py); ``stream_resume`` records a
# streamed pass resuming mid-epoch from a persisted StreamCursor
# (data.streaming.StreamCheckpoint).
RECOVERY_ACTIONS = ("retry", "rollback", "preemption_flush",
                    "checkpoint", "checkpoint_fallback", "resume",
                    "host_lost", "elastic_resume", "degraded_continue",
                    "hot_swap", "flight_dump", "rebalance",
                    "speculative_exec", "rollback_generation",
                    "replica_evict", "request_hedge", "request_retry",
                    "native_fallback", "stream_resume")

_NUM = (int, float)
_OPT_NUM = _NUM + (type(None),)

# kind -> {field: allowed types}; None in a tuple permits JSON null
_REQUIRED: Dict[str, dict] = {
    "run": {"run_id": str, "tool": str, "timestamp_unix": _NUM},
    "iteration": {"run_id": str, "algorithm": str, "iter": int,
                  "loss": _NUM},
    "span": {"run_id": str, "name": str, "seconds": _NUM},
    "metrics": {"run_id": str, "metrics": dict},
    # one compiled program's cost/memory/collective accounting
    # (obs.introspect.ProgramCost); ``label`` is the pairing key the
    # perf gate matches baseline/candidate programs on
    "program_cost": {"run_id": str, "label": str, "collectives": dict},
    # a sanitizer hit (utils.debug) or an in-loop non-finite loss,
    # landed in the same JSONL as the metrics it poisoned
    "numerics_failure": {"run_id": str, "message": str},
    # one supervised fit attempt (resilience.supervisor): outcome is
    # "ok" | "failed" | "aborted_non_finite"
    "attempt": {"run_id": str, "attempt": int, "outcome": str},
    # one recovery action (resilience layer): action is one of
    # RECOVERY_ACTIONS (open set — consumers ignore unknown actions)
    "recovery": {"run_id": str, "action": str},
    # one liveness beat of one SPMD process (resilience.distributed.
    # HeartbeatWriter); ``process`` is the jax process index — the
    # host-loss monitor reads staleness from these
    "heartbeat": {"run_id": str, "process": int},
    # one injected fault of a chaos campaign (resilience.chaos);
    # ``fault`` is the kind (chaos.FAULT_KINDS — open set)
    "chaos": {"run_id": str, "fault": str},
    # one recovery-journal replay/repair (resilience.journal.Journal):
    # ``records`` committed records recovered from the WAL
    "journal_replay": {"run_id": str, "records": int},
    # one quorum-gated degraded continuation (resilience.degrade):
    # ``surviving`` processes keep training without their dead peers
    "degraded": {"run_id": str, "surviving": int},
    # one compiled-program contract check (analysis.contracts):
    # ``contract`` is constant-bytes / donation / collective-census,
    # ``ok`` whether the pin held against the real XLA program
    "contract_pin": {"run_id": str, "contract": str, "ok": bool},
    # one inference request through the serving plane (serve.queue):
    # ``rows`` is the request's row count; ``status`` ok/rejected/error
    "serve_request": {"run_id": str, "rows": int},
    # one serving-latency rollup (serve.queue.latency_summary):
    # ``requests`` completed in the window; QPS and percentile fields
    # ride as optionals
    "serve_latency": {"run_id": str, "requests": int},
    # one trace's analysis rollup (obs.timeline.analyze): ``spans``
    # reconstructed span count; hosts/critical path/straggler score
    # ride as optionals
    "trace_summary": {"run_id": str, "trace_id": str, "spans": int},
    # one weak-scaling ladder (obs.scaling / benchmarks.run.run_ladder):
    # ``points`` is the ordered per-mesh-shape measurement list (each a
    # dict with devices/wall/sec_per_iter/program cost/contention);
    # efficiency, serial fraction, and the environment fingerprint ride
    # as optionals — the record family obs.perfgate gates on curve
    # SHAPE, not single numbers
    "scaling_curve": {"run_id": str, "name": str, "points": list},
    # one skew sync of the straggler scheduler (resilience.scheduler.
    # SkewTracker): ``skew`` is max per-host boundary cost over the
    # median (1.0 balanced); speeds/straggler/hysteresis ride as
    # optionals
    "skew_estimate": {"run_id": str, "skew": _NUM},
    # one applied generation-boundary rebalance decision (resilience.
    # scheduler.StragglerScheduler): ``at_iter`` is the boundary it was
    # decided at; the before/after per-host partition counts ride as
    # optionals
    "rebalance": {"run_id": str, "at_iter": int},
    # one shadow-served canary evaluation of a candidate generation
    # (pipeline.canary): ``generation`` is the candidate, ``verdict``
    # is "pass" | "fail" | "refused"; slice fraction, quality delta,
    # and per-leg latency evidence ride as optionals
    "canary": {"run_id": str, "generation": int, "verdict": str},
    # one typed promotion decision (pipeline.promote): ``decision`` is
    # "promoted" | "rejected" | "rolled_back"; from/to generation and
    # the gate evidence ride as optionals
    "promotion": {"run_id": str, "decision": str},
    # one routing decision of the serve fleet router (serve.router):
    # ``decision`` is "route" | "hedge" | "retry" | "shed_tenant";
    # replica/tenant/latency evidence rides as optionals
    "fleet_route": {"run_id": str, "decision": str},
    # one replica-health classification change (serve.router, from
    # HostMonitor.verdicts()): ``verdict`` is "ok" | "slow" | "lost"
    "replica_verdict": {"run_id": str, "replica": int,
                        "verdict": str},
    # one poisoned-shard quarantine decision (data.streaming.
    # StreamingDataset): ``shard`` names the part that failed parse/
    # validation/CRC after its retries; the streamed epoch continues
    # degraded on the survivors — the data-plane analogue of
    # resilience.degrade
    "shard_quarantine": {"run_id": str, "shard": str},
    # one completed streamed pass over a StreamingDataset
    # (data.streaming.make_streaming_smooth): ``epoch`` is the pass
    # ordinal, ``batches`` how many macro-batches the fold consumed;
    # stall/overlap evidence rides as optionals — the record family
    # obs.perfgate.gate_stream bounds prefetch stall fraction on
    "stream_epoch": {"run_id": str, "epoch": int, "batches": int},
}

# JSON value types the contract-pin observed/expected fields may carry
_JSON_VAL = (int, float, str, dict, list, bool, type(None))

_OPTIONAL: Dict[str, dict] = {
    "run": {
        "algorithm": str, "name": str, "platform": str,
        "device_kind": str, "n_devices": int, "iters": int,
        "final_loss": _OPT_NUM, "converged": bool,
        "iters_per_sec": _OPT_NUM,
        "wall_s": _NUM, "compile_s": _NUM,
        "error": (str, type(None)), "metrics": dict,
        # environment provenance (obs.introspect.environment_
        # fingerprint) — the fields the perf gate refuses to compare
        # across
        "jax_version": str, "jaxlib_version": str,
        "n_processes": int, "mesh_shape": dict,
        # serving soak summaries (tools/serve_drill.py): the fields the
        # perf gate's latency metrics pair on
        "requests": int, "rejected": int, "hot_swaps": int,
        "qps": _OPT_NUM, "p50_ms": _OPT_NUM, "p99_ms": _OPT_NUM,
        # per-host skew (obs.timeline.straggler_score over the run's
        # trace): the perf gate's lower-is-better skew metric
        "straggler_score": _OPT_NUM, "hosts": int,
        # hardened host-environment provenance (obs.scaling.
        # host_fingerprint, merged into environment_fingerprint):
        # identity fields enter the history env_key; loadavg_1m is
        # measurement-time state for the contention sentinel
        "cpu_count": (int, type(None)), "loadavg_1m": _NUM,
        "cpu_governor": str, "cpu_turbo": str,
        "cgroup_cpu_quota": (_NUM + (str,)), "env_key": str,
        # which weight-update execution mode the run used:
        # "replicated" (full update everywhere) or "sharded"
        # (reduce-scatter → 1/N prox → allgather,
        # parallel.sharded_update)
        "update_mode": str,
    },
    "iteration": {"L": _NUM, "theta": _NUM, "step": _NUM,
                  "restarted": bool, "accepted": bool,
                  "timestamp_unix": _NUM},
    # the trace fields (obs.trace) are OPTIONAL: untraced phase spans
    # carry none of them; a traced span carries all of trace_id/
    # span_id/process/status/t_start_unix (parent_id None at a root).
    # ``status`` is "open" for the flushed start marker, then "ok"/
    # "error" (or a producer status) on the closing record — an "open"
    # with no close is a TRUNCATED span (the emitting host died).
    "span": {"timestamp_unix": _NUM, "trace_id": str, "span_id": str,
             "parent_id": (str, type(None)), "process": int,
             "status": str, "t_start_unix": _NUM,
             "error": (str, type(None)), "tool": str},
    "metrics": {"timestamp_unix": _NUM, "tool": str},
    "program_cost": {
        "flops": _OPT_NUM, "transcendentals": _OPT_NUM,
        "bytes_accessed": _OPT_NUM,
        "argument_bytes": _OPT_NUM, "output_bytes": _OPT_NUM,
        "temp_bytes": _OPT_NUM, "alias_bytes": _OPT_NUM,
        "generated_code_bytes": _OPT_NUM, "peak_hbm_bytes": _OPT_NUM,
        "hlo_bytes": int, "backend": str, "algorithm": str,
        # per-collective result bytes (obs.introspect.collective_bytes):
        # the all-reduce-bytes-collapse signature of the sharded update
        "collective_bytes": (dict, type(None)),
        "tool": str, "timestamp_unix": _NUM,
    },
    "numerics_failure": {
        "leaf": (str, type(None)), "iter": int, "evaluation": int,
        "source": str, "algorithm": str, "tool": str,
        "timestamp_unix": _NUM,
    },
    "attempt": {
        "start_iter": int, "iters": int, "seconds": _NUM,
        "error": (str, type(None)),
        "failure_kind": (str, type(None)), "algorithm": str,
        "tool": str, "timestamp_unix": _NUM,
    },
    "recovery": {
        "reason": str, "failure_kind": str, "attempt": int,
        "backoff_s": _NUM, "from_iter": int, "to_iter": int,
        "big_l": _NUM, "path": str, "generation": int,
        "process": int, "process_count": int, "saved_process_count": int,
        # the speculative_exec action's accounting (resilience.
        # scheduler.resolve_speculation)
        "outcome": str, "matched": bool, "iters": int,
        "seconds": _NUM, "fleet_seconds": _NUM, "max_diff": _NUM,
        "straggler": int,
        "source": str, "algorithm": str, "tool": str,
        "timestamp_unix": _NUM,
    },
    "heartbeat": {
        "process_count": int, "iter": int, "phase": str, "pid": int,
        "algorithm": str, "tool": str, "timestamp_unix": _NUM,
    },
    "chaos": {
        "at_iter": int, "fired_iter": int,
        "process": (int, type(None)), "seed": int,
        "campaign": (int, str), "payload": _NUM, "outcome": str,
        "algorithm": str, "tool": str, "timestamp_unix": _NUM,
    },
    "journal_replay": {
        "path": str, "torn_bytes": int, "last_seq": int,
        "repaired": bool, "reason": (str, type(None)),
        "tool": str, "timestamp_unix": _NUM,
    },
    "degraded": {
        "saved_process_count": int, "lost": list, "quorum": _NUM,
        "min_quorum": _NUM, "generation": int, "to_iter": int,
        "process": int, "dropped_partitions": int, "source": str,
        "tool": str, "timestamp_unix": _NUM,
    },
    "contract_pin": {
        "label": str, "message": str, "observed": _JSON_VAL,
        "expected": _JSON_VAL, "budget_bytes": int, "algorithm": str,
        "tool": str, "timestamp_unix": _NUM,
    },
    "serve_request": {
        "op": str, "status": str, "bucket": int, "batch_rows": int,
        "queue_ms": _NUM, "latency_ms": _NUM, "generation": int,
        "model": str, "error": (str, type(None)), "algorithm": str,
        # fleet attribution (serve.router / serve.fleet): which tenant
        # submitted the request and which replica served it
        "tenant": str, "replica": int,
        "tool": str, "timestamp_unix": _NUM,
    },
    "serve_latency": {
        "rows": int, "qps": _OPT_NUM, "p50_ms": _OPT_NUM,
        "p99_ms": _OPT_NUM, "mean_ms": _OPT_NUM, "max_ms": _OPT_NUM,
        "queue_depth": int, "rejected": int, "errors": int,
        "hot_swaps": int, "generation": int, "window_s": _NUM,
        # which replica's latency ring the rollup summarizes — the
        # attribution the router's EWMA pairs its numbers against
        "replica": int,
        "model": str, "tool": str, "timestamp_unix": _NUM,
    },
    "trace_summary": {
        "hosts": int, "roots": int, "truncated": int,
        "connected": bool, "critical_path_s": _OPT_NUM,
        "critical_path": list, "straggler_score": _OPT_NUM,
        "slowest_host": (int, type(None)), "step_span": str,
        "algorithm": str, "tool": str, "timestamp_unix": _NUM,
    },
    "scaling_curve": {
        "n_points": int, "max_devices": int, "efficiency": list,
        "serial_fraction": _OPT_NUM, "contention_flagged": int,
        "rows_per_device": int, "iters": int, "ladder": str,
        "spin_baseline_s": _NUM, "env_key": str,
        # the environment fingerprint rides flat so the gate's refusal
        # logic reads curves and runs identically
        "platform": str, "device_kind": str, "n_devices": int,
        "jax_version": str, "jaxlib_version": str, "n_processes": int,
        "mesh_shape": dict, "cpu_count": (int, type(None)),
        "loadavg_1m": _NUM, "cpu_governor": str, "cpu_turbo": str,
        "cgroup_cpu_quota": (_NUM + (str,)),
        # the update-mode gate (obs.perfgate.gate_update_modes) pairs
        # replicated-vs-sharded curves on this field
        "update_mode": str,
        "algorithm": str, "tool": str, "timestamp_unix": _NUM,
    },
    "skew_estimate": {
        "speeds": dict, "straggler": (int, type(None)),
        "consecutive": int, "persistent": bool, "iter": int,
        "window_segments": int, "threshold": _NUM,
        "hb_slow": list, "process": int, "source": str,
        "algorithm": str, "tool": str, "timestamp_unix": _NUM,
    },
    "rebalance": {
        "speeds": dict, "skew": _NUM, "straggler": (int, type(None)),
        "before": dict, "after": dict, "moved": int,
        "generation": int, "process": int, "reason": str,
        "source": str, "algorithm": str, "tool": str,
        "timestamp_unix": _NUM,
    },
    "canary": {
        # which generation the candidate shadowed, and what fraction of
        # live traffic was mirrored to it
        "baseline_generation": int, "slice_fraction": _NUM,
        "shadow_requests": int, "epoch": int,
        # quality leg: held-out loss of baseline vs candidate
        # (models.evaluation.log_loss) and the relative threshold the
        # gate applied
        "quality_baseline": _OPT_NUM, "quality_candidate": _OPT_NUM,
        "quality_delta": _OPT_NUM, "quality_threshold": _NUM,
        "quality_verdict": str, "quality_fault_injected": bool,
        # latency leg: candidate shadow percentiles vs HEAD's
        "p50_ms": _OPT_NUM, "p99_ms": _OPT_NUM,
        "baseline_p50_ms": _OPT_NUM, "baseline_p99_ms": _OPT_NUM,
        "latency_verdict": str, "contention_flagged": bool,
        # refusal evidence (spec mismatch, torn target, thin traffic)
        "refusals": list, "baseline_spec": dict, "candidate_spec": dict,
        "reason": str, "source": str, "algorithm": str, "tool": str,
        "timestamp_unix": _NUM,
    },
    "promotion": {
        "from_generation": (int, type(None)), "to_generation": int,
        "candidate_generation": int, "epoch": int,
        # the gate evidence the decision was made on: the canary
        # verdict, perfgate status, and any refusal strings
        "gate_status": str, "evidence": dict, "refusals": list,
        "reason": str, "source": str, "algorithm": str, "tool": str,
        "timestamp_unix": _NUM,
    },
    "fleet_route": {
        # the replica the decision targeted (for hedges: the SECOND
        # replica the request was re-issued to; ``winner`` which one
        # answered first)
        "replica": int, "winner": (int, type(None)),
        "op": str, "tenant": str, "rows": int, "attempt": int,
        # the evidence the decision was made on: the request's elapsed
        # latency, the replica's EWMA estimate, the fleet median, the
        # replica's outstanding in-flight count, and its verdict
        "latency_ms": _NUM, "ewma_ms": _OPT_NUM, "median_ms": _OPT_NUM,
        "outstanding": int, "verdict": str, "generation": int,
        "error": (str, type(None)), "reason": str,
        "source": str, "algorithm": str, "tool": str,
        "timestamp_unix": _NUM,
    },
    "replica_verdict": {
        # staleness/phase evidence behind the classification, and the
        # verdict it transitioned from (absent on the first sighting)
        "age_s": _OPT_NUM, "phase": (str, type(None)),
        "previous": (str, type(None)), "generation": int,
        "source": str, "tool": str, "timestamp_unix": _NUM,
    },
    "shard_quarantine": {
        # why the shard was expelled, how many read attempts it got,
        # and the surviving data fraction the policy judged
        "reason": str, "attempts": int, "shard_index": int,
        "rows_lost": (int, type(None)), "healthy": int, "total": int,
        "data_fraction": _NUM, "epoch": int,
        "source": str, "algorithm": str, "tool": str,
        "timestamp_unix": _NUM,
    },
    "stream_epoch": {
        # pass accounting: rows folded, wall time of the pass, and the
        # consumer-side prefetch stall it spent waiting on the reader
        "rows": int, "pass_s": _NUM, "stall_s": _NUM,
        "stall_fraction": _NUM,
        # resume evidence: the batch index a StreamCursor restarted the
        # pass from (None/absent on an uninterrupted pass)
        "resumed_from_batch": (int, type(None)), "skipped_batches": int,
        "quarantined": int, "prefetch": int,
        "contention_flagged": bool,
        "source": str, "algorithm": str, "tool": str,
        "timestamp_unix": _NUM,
    },
}

_run_counter = itertools.count()


def new_run_id() -> str:
    """Process-unique, time-sortable id: ms timestamp + pid + counter."""
    return (f"r{int(time.time() * 1000):x}"
            f"-{os.getpid():x}-{next(_run_counter):x}")


def _type_ok(value, types) -> bool:
    if not isinstance(types, tuple):
        types = (types,)
    # bool is an int subclass in Python; an int-typed field (e.g.
    # ``iter``) must not silently accept True
    if isinstance(value, bool):
        return bool in types
    # a float-typed field accepts ints (JSON has one number type)
    return isinstance(value, types)


def validate_record(rec) -> List[str]:
    """Errors for one record against the schema; ``[]`` means valid.

    Checks the canonical keys and the typed known-optional keys; extra
    unknown keys are allowed by design (see module docstring).
    """
    errors: List[str] = []
    if not isinstance(rec, dict):
        return [f"record must be a dict, got {type(rec).__name__}"]
    sv = rec.get("schema_version")
    if sv != SCHEMA_VERSION:
        errors.append(f"schema_version must be {SCHEMA_VERSION}, "
                      f"got {sv!r}")
    kind = rec.get("kind")
    if kind not in KINDS:
        errors.append(f"kind must be one of {KINDS}, got {kind!r}")
        return errors
    for field, types in _REQUIRED[kind].items():
        if field not in rec:
            errors.append(f"{kind} record missing required field "
                          f"{field!r}")
        elif not _type_ok(rec[field], types):
            errors.append(
                f"{field!r} must be "
                f"{getattr(types, '__name__', types)}, got "
                f"{type(rec[field]).__name__}")
    for field, types in _OPTIONAL[kind].items():
        if field in rec and not _type_ok(rec[field], types):
            errors.append(
                f"{field!r} must be "
                f"{getattr(types, '__name__', types)}, got "
                f"{type(rec[field]).__name__}")
    if kind == "iteration" and isinstance(rec.get("iter"), int) \
            and rec["iter"] < 1:
        errors.append("iter is 1-based (the reference's nIter); got "
                      f"{rec['iter']}")
    return errors


def stamp(rec: dict, *, tool: str, kind: str = "run",
          run_id: Optional[str] = None) -> dict:
    """A COPY of ``rec`` with the canonical fields added (existing keys
    are never overwritten, so re-stamping and legacy producers with
    their own ``run_id`` are both safe)."""
    out = dict(rec)
    out.setdefault("schema_version", SCHEMA_VERSION)
    out.setdefault("kind", kind)
    out.setdefault("run_id", run_id or new_run_id())
    out.setdefault("tool", tool)
    out.setdefault("timestamp_unix", round(time.time(), 3))
    return out


def run_record(*, tool: str, run_id: Optional[str] = None,
               **fields) -> dict:
    return stamp(fields, tool=tool, kind="run", run_id=run_id)


def iteration_record(run_id: str, algorithm: str, it: int,
                     **fields) -> dict:
    return {"schema_version": SCHEMA_VERSION, "kind": "iteration",
            "run_id": run_id, "algorithm": algorithm, "iter": int(it),
            **fields}


def span_record(run_id: str, name: str, seconds: float) -> dict:
    return {"schema_version": SCHEMA_VERSION, "kind": "span",
            "run_id": run_id, "name": name,
            "seconds": float(seconds)}


def metrics_record(run_id: str, metrics: dict, *,
                   tool: Optional[str] = None) -> dict:
    rec = {"schema_version": SCHEMA_VERSION, "kind": "metrics",
           "run_id": run_id, "metrics": dict(metrics)}
    if tool is not None:
        rec["tool"] = tool
    return rec


def program_cost_record(run_id: str, label: str, collectives: dict,
                        **fields) -> dict:
    """One compiled program's cost accounting; ``collectives`` maps
    collective op name -> count (``obs.introspect.collective_census``)."""
    return {"schema_version": SCHEMA_VERSION, "kind": "program_cost",
            "run_id": run_id, "label": label,
            "collectives": dict(collectives), **fields}


def numerics_failure_record(run_id: str, message: str,
                            **fields) -> dict:
    """A non-finite hit: ``leaf`` names the first failing quantity when
    known, ``iter``/``evaluation`` locate it in the run."""
    return {"schema_version": SCHEMA_VERSION, "kind": "numerics_failure",
            "run_id": run_id, "message": message, **fields}


def attempt_record(run_id: str, attempt: int, outcome: str,
                   **fields) -> dict:
    """One supervised fit attempt (``resilience.supervisor``):
    ``outcome`` is ``ok`` / ``failed`` / ``aborted_non_finite``;
    ``start_iter``/``iters``/``seconds``/``error``/``failure_kind``
    locate and explain it."""
    return {"schema_version": SCHEMA_VERSION, "kind": "attempt",
            "run_id": run_id, "attempt": int(attempt),
            "outcome": str(outcome), **fields}


def recovery_record(run_id: str, action: str, **fields) -> dict:
    """One recovery action of the resilience layer — ``action`` is one
    of :data:`RECOVERY_ACTIONS` (retry, rollback, preemption_flush,
    checkpoint, checkpoint_fallback, resume, host_lost,
    elastic_resume)."""
    return {"schema_version": SCHEMA_VERSION, "kind": "recovery",
            "run_id": run_id, "action": str(action), **fields}


def heartbeat_record(run_id: str, process: int, **fields) -> dict:
    """One liveness beat of one SPMD process — ``process`` is the jax
    process index; ``iter``/``phase`` locate the beat in the run, and
    the host-loss monitor derives staleness from ``timestamp_unix``."""
    return {"schema_version": SCHEMA_VERSION, "kind": "heartbeat",
            "run_id": run_id, "process": int(process), **fields}


def chaos_record(run_id: str, fault: str, **fields) -> dict:
    """One injected fault of a chaos campaign (``resilience.chaos``) —
    ``fault`` names the kind, ``at_iter``/``fired_iter`` locate the
    scripted vs actual firing boundary, ``seed`` ties the record to its
    deterministic campaign."""
    return {"schema_version": SCHEMA_VERSION, "kind": "chaos",
            "run_id": run_id, "fault": str(fault), **fields}


def journal_replay_record(run_id: str, records: int, **fields) -> dict:
    """One recovery-journal replay (``resilience.journal``): how many
    committed records were recovered, ``torn_bytes`` dropped from the
    tail, and whether the file was repaired in place."""
    return {"schema_version": SCHEMA_VERSION, "kind": "journal_replay",
            "run_id": run_id, "records": int(records), **fields}


def degraded_record(run_id: str, surviving: int, **fields) -> dict:
    """One quorum-gated degraded continuation (``resilience.degrade``):
    ``surviving`` of ``saved_process_count`` processes keep training on
    the surviving data partitions (``dropped_partitions`` lost with the
    dead hosts)."""
    return {"schema_version": SCHEMA_VERSION, "kind": "degraded",
            "run_id": run_id, "surviving": int(surviving), **fields}


def contract_pin_record(run_id: str, contract: str, ok: bool,
                        **fields) -> dict:
    """One compiled-program contract check (``analysis.contracts``):
    ``contract`` names the pin (constant-bytes / donation /
    collective-census), ``ok`` whether it held; ``label`` names the
    program, ``observed``/``expected`` carry the mismatch."""
    return {"schema_version": SCHEMA_VERSION, "kind": "contract_pin",
            "run_id": run_id, "contract": str(contract),
            "ok": bool(ok), **fields}


def serve_request_record(run_id: str, rows: int, **fields) -> dict:
    """One inference request through the serving plane
    (``serve.queue``): ``rows`` the request's row count, ``status``
    ok/rejected/error, ``bucket``/``batch_rows`` the padded shape and
    coalesced batch it rode in, ``generation`` the model generation
    that served it."""
    return {"schema_version": SCHEMA_VERSION, "kind": "serve_request",
            "run_id": run_id, "rows": int(rows), **fields}


def serve_latency_record(run_id: str, requests: int, **fields) -> dict:
    """One serving-latency rollup (``serve.queue.latency_summary``):
    ``requests`` completed in the window, with QPS, p50/p99/mean/max
    latency, queue depth, reject/error counts, and the hot-swap census
    as optional fields."""
    return {"schema_version": SCHEMA_VERSION, "kind": "serve_latency",
            "run_id": run_id, "requests": int(requests), **fields}


def trace_summary_record(run_id: str, trace_id: str, spans: int,
                         **fields) -> dict:
    """One trace's analysis rollup (``obs.timeline.analyze``):
    ``spans`` reconstructed, with host/truncation counts, the critical
    path, and the straggler score as optional fields — the record the
    drills pin their causal-tree acceptance on."""
    return {"schema_version": SCHEMA_VERSION, "kind": "trace_summary",
            "run_id": run_id, "trace_id": str(trace_id),
            "spans": int(spans), **fields}


def scaling_curve_record(run_id: str, name: str, points: list,
                         **fields) -> dict:
    """One weak-scaling ladder (``obs.scaling`` + ``benchmarks.run.
    run_ladder``): ``points`` is the ordered per-mesh-shape measurement
    list; efficiency/serial-fraction/contention and the environment
    fingerprint ride as optional fields — what ``obs.perfgate.
    gate_scaling`` gates on curve shape."""
    return {"schema_version": SCHEMA_VERSION, "kind": "scaling_curve",
            "run_id": run_id, "name": str(name),
            "points": list(points), **fields}


def skew_estimate_record(run_id: str, skew: float, **fields) -> dict:
    """One skew sync of the straggler scheduler
    (``resilience.scheduler``): ``skew`` is the max per-host boundary
    cost over the fleet median (1.0 = balanced); ``speeds`` the
    relative per-host estimates, ``straggler``/``consecutive``/
    ``persistent`` the hysteresis state."""
    return {"schema_version": SCHEMA_VERSION, "kind": "skew_estimate",
            "run_id": run_id, "skew": float(skew), **fields}


def rebalance_record(run_id: str, at_iter: int, **fields) -> dict:
    """One applied generation-boundary rebalance
    (``resilience.scheduler``): ``at_iter`` the boundary it was decided
    at; ``before``/``after`` the per-host partition counts, ``moved``
    how many partitions changed hands, ``generation`` the manifest
    generation the new assignment commits under."""
    return {"schema_version": SCHEMA_VERSION, "kind": "rebalance",
            "run_id": run_id, "at_iter": int(at_iter), **fields}


def canary_record(run_id: str, generation: int, verdict: str,
                  **fields) -> dict:
    """One shadow-served canary evaluation (``pipeline.canary``):
    ``generation`` is the candidate, ``verdict`` pass/fail/refused;
    ``slice_fraction``/``shadow_requests`` size the shadow leg,
    ``quality_*`` and ``p50_ms``/``p99_ms`` carry the two gate legs'
    evidence, ``refusals`` why the gate refused to judge."""
    return {"schema_version": SCHEMA_VERSION, "kind": "canary",
            "run_id": run_id, "generation": int(generation),
            "verdict": str(verdict), **fields}


def promotion_record(run_id: str, decision: str, **fields) -> dict:
    """One typed promotion decision (``pipeline.promote``):
    ``decision`` is promoted/rejected/rolled_back;
    ``from_generation``/``to_generation`` the HEAD movement,
    ``evidence`` the canary/gate record the decision rode on."""
    return {"schema_version": SCHEMA_VERSION, "kind": "promotion",
            "run_id": run_id, "decision": str(decision), **fields}


def fleet_route_record(run_id: str, decision: str, **fields) -> dict:
    """One routing decision of the serve fleet router
    (``serve.router``): ``decision`` is route/hedge/retry/shed_tenant;
    ``replica``/``tenant``/``op`` locate the request,
    ``latency_ms``/``ewma_ms``/``median_ms``/``outstanding`` carry the
    evidence the router acted on."""
    return {"schema_version": SCHEMA_VERSION, "kind": "fleet_route",
            "run_id": run_id, "decision": str(decision), **fields}


def replica_verdict_record(run_id: str, replica: int, verdict: str,
                           **fields) -> dict:
    """One replica-health classification change (``serve.router``, from
    ``HostMonitor.verdicts()``): ``verdict`` is ok/slow/lost;
    ``age_s``/``phase`` the staleness evidence, ``previous`` the
    verdict it transitioned from."""
    return {"schema_version": SCHEMA_VERSION, "kind": "replica_verdict",
            "run_id": run_id, "replica": int(replica),
            "verdict": str(verdict), **fields}


def shard_quarantine_record(run_id: str, shard: str, **fields) -> dict:
    """One poisoned-shard quarantine decision (``data.streaming``):
    ``shard`` names the part expelled after its read retries;
    ``reason``/``attempts`` explain it, ``healthy``/``total``/
    ``data_fraction`` carry the degraded-continuation evidence the
    minimum-data-fraction policy judged."""
    return {"schema_version": SCHEMA_VERSION, "kind": "shard_quarantine",
            "run_id": run_id, "shard": str(shard), **fields}


def stream_epoch_record(run_id: str, epoch: int, batches: int,
                        **fields) -> dict:
    """One completed streamed pass over a ``StreamingDataset``
    (``data.streaming.make_streaming_smooth``): ``epoch`` is the pass
    ordinal, ``batches`` the macro-batches folded; ``stall_s``/
    ``pass_s``/``stall_fraction`` carry the prefetch-overlap evidence
    ``obs.perfgate.gate_stream`` bounds, ``resumed_from_batch`` the
    StreamCursor resume point when the pass restarted mid-epoch."""
    return {"schema_version": SCHEMA_VERSION, "kind": "stream_epoch",
            "run_id": run_id, "epoch": int(epoch),
            "batches": int(batches), **fields}


def read_jsonl(path: str) -> List[dict]:
    """Parse one record per non-blank line; raises ``ValueError`` naming
    the line on malformed JSON (consumers wanting tolerance — the report
    CLI — catch per line themselves)."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: not valid JSON: {e}")
    return out


EXAMPLE_RUN_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "run",
    "run_id": "r18c2d3e4-1a2b-0", "tool": "benchmarks.run",
    "timestamp_unix": 1754000000.0, "algorithm": "agd",
    "name": "logistic_l2_rcv1like", "platform": "cpu", "n_devices": 1,
    "iters": 20, "final_loss": 0.3217, "converged": False,
    "iters_per_sec": 412.5, "update_mode": "sharded", "error": None,
}

EXAMPLE_ITERATION_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "iteration",
    "run_id": "r18c2d3e4-1a2b-0", "algorithm": "agd", "iter": 1,
    "loss": 0.6931, "L": 1.0, "theta": 1.0, "step": 1.0,
    "restarted": False,
}

EXAMPLE_SPAN_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "span",
    "run_id": "r18c2d3e4-1a2b-0", "name": "compile", "seconds": 1.25,
    "trace_id": "t9f2ab34c11d0e8a7", "span_id": "s1a2b3c4d5e6f",
    "parent_id": "s0f0e0d0c0b0a", "process": 1, "status": "ok",
    "t_start_unix": 1754000000.0,
}

EXAMPLE_METRICS_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "metrics",
    "run_id": "r18c2d3e4-1a2b-0", "tool": "bench",
    "metrics": {"compile.hits": 3, "compile.misses": 1,
                "resilience.attempts": 1},
    "timestamp_unix": 1754000000.0,
}

EXAMPLE_PROGRAM_COST_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "program_cost",
    "run_id": "r18c2d3e4-1a2b-0", "label": "agd", "algorithm": "agd",
    "flops": 528383.0, "bytes_accessed": 65580.0,
    "argument_bytes": 16384, "output_bytes": 4, "temp_bytes": 16400,
    "peak_hbm_bytes": 32788, "backend": "cpu",
    "collectives": {"all-reduce": 3, "all-gather": 0,
                    "reduce-scatter": 0, "collective-permute": 0,
                    "all-to-all": 0},
    "collective_bytes": {"all-reduce": 96, "all-gather": 0,
                         "reduce-scatter": 0, "collective-permute": 0,
                         "all-to-all": 0},
}

EXAMPLE_NUMERICS_FAILURE_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "numerics_failure",
    "run_id": "r18c2d3e4-1a2b-0",
    "message": "smooth: gradient leaf ['w'] non-finite",
    "leaf": "['w']", "evaluation": 3, "source": "smooth",
}

EXAMPLE_ATTEMPT_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "attempt",
    "run_id": "r18c2d3e4-1a2b-0", "attempt": 2, "outcome": "failed",
    "start_iter": 10, "iters": 0, "seconds": 0.41,
    "error": "SimulatedDeviceLoss: injected device loss at iteration 10",
    "failure_kind": "transient", "algorithm": "agd",
}

EXAMPLE_RECOVERY_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "recovery",
    "run_id": "r18c2d3e4-1a2b-0", "action": "rollback",
    "reason": "non-finite loss in segment", "failure_kind": "numeric",
    "from_iter": 10, "to_iter": 10, "big_l": 64.0,
    "source": "supervisor",
}

EXAMPLE_HEARTBEAT_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "heartbeat",
    "run_id": "r18c2d3e4-1a2b-0", "process": 1, "process_count": 2,
    "iter": 12, "phase": "segment", "pid": 4242,
    "timestamp_unix": 1754000000.0,
}

EXAMPLE_CHAOS_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "chaos",
    "run_id": "r18c2d3e4-1a2b-0", "fault": "device_loss",
    "at_iter": 8, "fired_iter": 8, "process": None, "seed": 17,
}

EXAMPLE_JOURNAL_REPLAY_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "journal_replay",
    "run_id": "r18c2d3e4-1a2b-0", "records": 23,
    "path": "run.journal", "torn_bytes": 11, "last_seq": 22,
    "repaired": True, "reason": "torn payload at byte 2048",
}

EXAMPLE_DEGRADED_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "degraded",
    "run_id": "r18c2d3e4-1a2b-0", "surviving": 1,
    "saved_process_count": 2, "lost": [1], "quorum": 0.5,
    "min_quorum": 0.5, "generation": 3, "to_iter": 12, "process": 0,
    "dropped_partitions": 2, "source": "degrade",
}

EXAMPLE_CONTRACT_PIN_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "contract_pin",
    "run_id": "r18c2d3e4-1a2b-0", "contract": "collective-census",
    "ok": False, "label": "agd",
    "message": "all-reduce: compiled program has 4, pin says 3",
    "observed": {"all-reduce": 4}, "expected": {"all-reduce": 3},
    "tool": "graft_lint",
}

EXAMPLE_SERVE_REQUEST_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "serve_request",
    "run_id": "r18c2d3e4-1a2b-0", "rows": 3, "op": "predict_proba",
    "status": "ok", "bucket": 8, "batch_rows": 7, "generation": 2,
    "queue_ms": 1.8, "latency_ms": 4.2, "tool": "serve.queue",
}

EXAMPLE_TRACE_SUMMARY_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "trace_summary",
    "run_id": "r18c2d3e4-1a2b-0", "trace_id": "t9f2ab34c11d0e8a7",
    "spans": 42, "hosts": 2, "roots": 1, "truncated": 1,
    "connected": True, "critical_path_s": 1.84,
    "critical_path": [{"name": "supervised_run", "process": 0,
                       "seconds": 1.84, "truncated": False}],
    "straggler_score": 1.62, "slowest_host": 0,
    "step_span": "segment", "tool": "agd_trace",
}

EXAMPLE_SERVE_LATENCY_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "serve_latency",
    "run_id": "r18c2d3e4-1a2b-0", "requests": 240, "rows": 1913,
    "qps": 412.5, "p50_ms": 2.1, "p99_ms": 9.7, "mean_ms": 2.9,
    "max_ms": 14.0, "queue_depth": 0, "rejected": 3, "errors": 0,
    "hot_swaps": 1, "generation": 2, "window_s": 0.582,
    "tool": "serve.queue",
}

EXAMPLE_SCALING_CURVE_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "scaling_curve",
    "run_id": "r18c2d3e4-1a2b-0", "name": "logistic_l2_rcv1like",
    "algorithm": "agd", "tool": "benchmarks.run",
    "points": [
        {"devices": 1, "rows": 256, "iters": 8, "wall_s": 0.41,
         "sec_per_iter": 0.0512, "iters_per_sec": 19.5,
         "converged": False, "flops": 528383.0,
         "bytes_accessed": 65580.0, "peak_hbm_bytes": 32788,
         "collectives": {"all-reduce": 0},
         "contention": {"flagged": False, "spin_score": 0.02,
                        "steal_ticks": 0, "loadavg_before": 0.4,
                        "loadavg_during_max": 0.5}},
        {"devices": 2, "rows": 512, "iters": 8, "wall_s": 0.44,
         "sec_per_iter": 0.0550, "iters_per_sec": 18.2,
         "converged": False, "flops": 528383.0,
         "bytes_accessed": 65580.0, "peak_hbm_bytes": 32788,
         "collectives": {"all-reduce": 3},
         "contention": {"flagged": False, "spin_score": 0.03,
                        "steal_ticks": 0, "loadavg_before": 0.5,
                        "loadavg_during_max": 0.5}},
    ],
    "n_points": 2, "max_devices": 2, "efficiency": [1.0, 0.9309],
    "serial_fraction": 0.0742, "contention_flagged": 0,
    "update_mode": "replicated",
    "rows_per_device": 256, "iters": 8, "ladder": "1,2",
    "env_key": "env-9f2ab34c11d0", "platform": "cpu", "n_devices": 8,
    "cpu_count": 8, "loadavg_1m": 0.42, "cgroup_cpu_quota": 8.0,
    "timestamp_unix": 1754000000.0,
}

EXAMPLE_SKEW_ESTIMATE_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "skew_estimate",
    "run_id": "r18c2d3e4-1a2b-0", "skew": 4.82,
    "speeds": {"0": 1.0, "1": 0.21}, "straggler": 1,
    "consecutive": 2, "persistent": False, "iter": 12,
    "window_segments": 1, "threshold": 1.5, "hb_slow": [1],
    "process": 0, "source": "scheduler",
}

EXAMPLE_REBALANCE_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "rebalance",
    "run_id": "r18c2d3e4-1a2b-0", "at_iter": 12,
    "speeds": {"0": 1.0, "1": 0.21}, "skew": 4.82, "straggler": 1,
    "before": {"0": 6, "1": 6}, "after": {"0": 11, "1": 1},
    "moved": 5, "generation": 4, "process": 0,
    "source": "scheduler",
}

EXAMPLE_CANARY_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "canary",
    "run_id": "r18c2d3e4-1a2b-0", "generation": 5, "verdict": "pass",
    "baseline_generation": 4, "slice_fraction": 0.25,
    "shadow_requests": 64, "epoch": 3,
    "quality_baseline": 0.3217, "quality_candidate": 0.3105,
    "quality_delta": -0.0348, "quality_threshold": 0.05,
    "quality_verdict": "pass", "quality_fault_injected": False,
    "p50_ms": 2.4, "p99_ms": 10.1,
    "baseline_p50_ms": 2.1, "baseline_p99_ms": 9.7,
    "latency_verdict": "pass", "contention_flagged": False,
    "refusals": [], "source": "pipeline.canary", "tool": "pipeline",
}

EXAMPLE_PROMOTION_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "promotion",
    "run_id": "r18c2d3e4-1a2b-0", "decision": "rolled_back",
    "from_generation": 5, "to_generation": 4,
    "candidate_generation": 5, "epoch": 3, "gate_status": "failed",
    "evidence": {"verdict": "pass", "post_check": "holdout loss "
                 "regressed 412% after repoint"},
    "refusals": [], "reason": "post-promotion quality check failed",
    "source": "pipeline.promote", "tool": "pipeline",
}

EXAMPLE_FLEET_ROUTE_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "fleet_route",
    "run_id": "r18c2d3e4-1a2b-0", "decision": "hedge",
    "replica": 2, "winner": 2, "op": "predict", "tenant": "acme",
    "rows": 3, "attempt": 1, "latency_ms": 18.4, "ewma_ms": 3.1,
    "median_ms": 2.9, "outstanding": 1, "verdict": "ok",
    "generation": 5, "error": None, "source": "serve.router",
    "tool": "serve.router",
}

EXAMPLE_REPLICA_VERDICT_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "replica_verdict",
    "run_id": "r18c2d3e4-1a2b-0", "replica": 1, "verdict": "slow",
    "age_s": 0.8, "phase": "slow", "previous": "ok", "generation": 5,
    "source": "serve.router", "tool": "serve.router",
}

EXAMPLE_SHARD_QUARANTINE_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "shard_quarantine",
    "run_id": "r18c2d3e4-1a2b-0", "shard": "parts/part-00003.txt",
    "shard_index": 3, "reason": "ValueError: malformed LIBSVM line",
    "attempts": 3, "rows_lost": None, "healthy": 7, "total": 8,
    "data_fraction": 0.875, "epoch": 2, "source": "streaming",
    "tool": "stream_drill",
}

EXAMPLE_STREAM_EPOCH_RECORD = {
    "schema_version": SCHEMA_VERSION, "kind": "stream_epoch",
    "run_id": "r18c2d3e4-1a2b-0", "epoch": 5, "batches": 12,
    "rows": 1536, "pass_s": 0.412, "stall_s": 0.031,
    "stall_fraction": 0.0752, "resumed_from_batch": 7,
    "skipped_batches": 7, "quarantined": 1, "prefetch": 2,
    "contention_flagged": False, "source": "streaming",
    "tool": "stream_drill",
}

# the kind-keyed table selfcheck iterates — graftlint's schema-drift
# rule cross-checks that EVERY registered kind appears here (and has a
# Telemetry helper), so a new kind cannot land without selfcheck
# coverage
EXAMPLES: Dict[str, dict] = {
    "run": EXAMPLE_RUN_RECORD,
    "iteration": EXAMPLE_ITERATION_RECORD,
    "span": EXAMPLE_SPAN_RECORD,
    "metrics": EXAMPLE_METRICS_RECORD,
    "program_cost": EXAMPLE_PROGRAM_COST_RECORD,
    "numerics_failure": EXAMPLE_NUMERICS_FAILURE_RECORD,
    "attempt": EXAMPLE_ATTEMPT_RECORD,
    "recovery": EXAMPLE_RECOVERY_RECORD,
    "heartbeat": EXAMPLE_HEARTBEAT_RECORD,
    "chaos": EXAMPLE_CHAOS_RECORD,
    "journal_replay": EXAMPLE_JOURNAL_REPLAY_RECORD,
    "degraded": EXAMPLE_DEGRADED_RECORD,
    "contract_pin": EXAMPLE_CONTRACT_PIN_RECORD,
    "serve_request": EXAMPLE_SERVE_REQUEST_RECORD,
    "serve_latency": EXAMPLE_SERVE_LATENCY_RECORD,
    "trace_summary": EXAMPLE_TRACE_SUMMARY_RECORD,
    "scaling_curve": EXAMPLE_SCALING_CURVE_RECORD,
    "skew_estimate": EXAMPLE_SKEW_ESTIMATE_RECORD,
    "rebalance": EXAMPLE_REBALANCE_RECORD,
    "canary": EXAMPLE_CANARY_RECORD,
    "promotion": EXAMPLE_PROMOTION_RECORD,
    "fleet_route": EXAMPLE_FLEET_ROUTE_RECORD,
    "replica_verdict": EXAMPLE_REPLICA_VERDICT_RECORD,
    "shard_quarantine": EXAMPLE_SHARD_QUARANTINE_RECORD,
    "stream_epoch": EXAMPLE_STREAM_EPOCH_RECORD,
}


def selfcheck() -> Tuple[bool, List[str]]:
    """Validate every example record (one per registered kind), a JSON
    round-trip, and an automatic negative sweep (every required field
    of every kind, when deleted, MUST fail validation).  Returns
    ``(ok, messages)`` — the ``python -m spark_agd_tpu.obs --selfcheck``
    body."""
    msgs: List[str] = []
    ok = True
    missing = [k for k in KINDS if k not in EXAMPLES]
    if missing:
        ok = False
        msgs.append(f"FAIL: kinds without an example record: {missing}")
    for name, rec in EXAMPLES.items():
        errs = validate_record(json.loads(json.dumps(rec)))
        if errs:
            ok = False
            msgs.append(f"FAIL example {name} record: {errs}")
        else:
            msgs.append(f"ok: example {name} record validates "
                        f"(round-tripped through JSON)")
    # negative sweep: deleting ANY required field must be rejected
    for name, rec in EXAMPLES.items():
        for field in _REQUIRED[name]:
            bad = dict(rec)
            del bad[field]
            if validate_record(bad):
                msgs.append(f"ok: negative control ({name} missing "
                            f"{field}) rejected")
            else:
                ok = False
                msgs.append(f"FAIL: {name} record missing {field} "
                            "passed validation")
    stamped = stamp({"value": 1.0}, tool="selfcheck")
    errs = validate_record(stamped)
    if errs:
        ok = False
        msgs.append(f"FAIL: stamp() output invalid: {errs}")
    else:
        msgs.append("ok: stamp() emits a valid run record")
    msgs.append("selfcheck " + ("PASSED" if ok else "FAILED"))
    return ok, msgs
