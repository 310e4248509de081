"""Canary controller — shadow-serve a candidate beside HEAD and grade it.

Counterpart of ``spark_agd_tpu/pipeline/canary.py``.  A published
candidate generation must EARN serving HEAD.  The controller binds the
candidate into a second ``ServeEngine`` (on HEAD's device, with HEAD's
``max_batch``) fed by its own ``MicroBatchQueue``, and mirrors a
deterministic slice of live traffic to it: callers submit through
:meth:`CanaryController.submit`, every request serves from HEAD as
usual, and ``slice_fraction`` of them is ALSO enqueued on the shadow
leg.  The shadow futures are never returned to callers — a slow or
broken candidate can never touch a live response.

The verdict comes from ``obs.perfgate.gate_promotion`` (a copy of the
JAX package's) over the evidence the window collected: held-out loss of
candidate vs HEAD (``models.evaluation.log_loss``, relative threshold)
AND shadow p50/p99 vs HEAD's percentiles.  Torn candidates
(``CheckpointCorruptError``), spec mismatches (checked BEFORE a shadow
engine is built) and thin shadow traffic all refuse rather than
judge.  Every window's record is built by
``obs.schema.canary_record`` and passes its validator.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional

from .._later import reject_later
from ..models.evaluation import log_loss
from ..obs import perfgate, schema
from ..serve.engine import ServeEngine, spec_of
from ..serve.queue import MicroBatchQueue
from ..utils.checkpoint import CheckpointCorruptError


@dataclasses.dataclass
class CanaryReport:
    """One canary window's outcome — what ``Promoter.decide`` acts on."""

    generation: int                # the candidate
    baseline_generation: Optional[int]
    verdict: str                   # "pass" | "fail" | "refused"
    record: dict                   # the canary record
    gate: Optional[perfgate.PromotionGateResult]
    refusals: List[str]
    epoch: Optional[int] = None


class CanaryController:
    """See module docstring.

    ``holdout=(Xv, yv)`` is the quality leg's held-out set.
    """

    def __init__(self, registry, engine, queue, *, telemetry=None,
                 holdout=None,
                 slice_fraction: float = 0.25,
                 quality_threshold: float =
                 perfgate.DEFAULT_QUALITY_THRESHOLD,
                 thresholds: Optional[dict] = None,
                 min_shadow_requests: int =
                 perfgate.DEFAULT_MIN_SHADOW_REQUESTS):
        reject_later(telemetry=telemetry)
        if not 0.0 < slice_fraction <= 1.0:
            raise ValueError(
                f"slice_fraction must be in (0, 1], got {slice_fraction}")
        self.registry = registry
        self.engine = engine
        self.queue = queue
        self.holdout = holdout
        self.slice_fraction = float(slice_fraction)
        self.quality_threshold = float(quality_threshold)
        self.thresholds = dict(thresholds or {})
        self.min_shadow_requests = int(min_shadow_requests)
        self._lock = threading.Lock()
        self._reset_window()

    def _reset_window(self) -> None:
        self._candidate = None          # LoadedModel under canary
        self._shadow_engine = None
        self._shadow_queue = None
        self._shadow_futures: List = []
        self._seen = 0
        self._mirrored = 0
        self._epoch: Optional[int] = None
        self._quality_override: Optional[float] = None
        self._preflight_refusals: List[str] = []

    @property
    def active(self) -> bool:
        return self._shadow_queue is not None

    @property
    def shadow_count(self) -> int:
        """Requests mirrored to the shadow leg so far this window —
        what a caller polls to know the window has enough evidence
        (``min_shadow_requests``) to close."""
        with self._lock:
            return self._mirrored

    # -- the live traffic path --------------------------------------------
    def submit(self, x, op: str = "predict"):
        """Submit one live request: always served from HEAD (the
        returned future), and mirrored to the active shadow leg when
        the deterministic slice counter says so.  Shadow admission
        failures (``ServeOverloaded``) silently drop the MIRROR — the
        live request is already admitted and must not feel the
        candidate."""
        future = self.queue.submit(x, op)
        with self._lock:
            sq = self._shadow_queue
            if sq is not None:
                self._seen += 1
                # mirror when the running fraction falls behind the
                # target slice — deterministic, no RNG in the hot path
                if self._mirrored < self._seen * self.slice_fraction:
                    try:
                        self._shadow_futures.append(sq.submit(x, op))
                        self._mirrored += 1
                    except (RuntimeError, ValueError):
                        pass
        return future

    # -- the canary window -------------------------------------------------
    def start_canary(self, generation: int, *,
                     epoch: Optional[int] = None,
                     quality_override: Optional[float] = None) -> bool:
        """Open a canary window for ``generation``: load and verify the
        candidate, refuse torn targets and spec mismatches pre-flight
        (no shadow engine is built for them), else bind a shadow
        engine+queue and start mirroring.  Returns True when shadow
        serving actually started; False means the window is already
        decided (``finish_canary`` will build the refused record).

        ``quality_override`` (drills only) replaces the candidate's
        measured held-out loss in the EVIDENCE, stamped
        ``quality_fault_injected`` — how a drill slips a bad candidate
        past the canary to exercise the post-promotion rollback."""
        if self.active or self._candidate is not None:
            raise RuntimeError("a canary window is already open — "
                               "finish_canary() first")
        self._epoch = epoch
        self._quality_override = quality_override
        try:
            loaded = self.registry.load(int(generation))
        except (LookupError, CheckpointCorruptError) as e:
            self._preflight_refusals.append(
                f"candidate g{generation} failed verification: "
                f"{str(e)[:160]}")
            self._candidate = ("refused", int(generation), None)
            return False
        cand_spec = spec_of(loaded.model)
        if cand_spec != self.engine.spec:
            self._preflight_refusals.append(
                f"candidate g{generation} spec mismatch vs serving "
                "HEAD — refusing to shadow-serve a different model "
                "family")
            self._candidate = ("refused", int(generation),
                               dataclasses.asdict(cand_spec))
            return False
        self._candidate = loaded
        self._shadow_engine = ServeEngine(
            loaded.model, generation=loaded.generation,
            max_batch=self.engine.max_batch, device=self.engine.device)
        with self._lock:
            self._shadow_queue = MicroBatchQueue(
                self._shadow_engine).start()
        return True

    def finish_canary(self) -> CanaryReport:
        """Close the window: drain the shadow leg (each shadow future
        waited on for at most 30 s), collect both legs' latency
        summaries and the held-out quality of candidate vs HEAD,
        grade everything through ``gate_promotion``, and build the
        ``canary`` record.  The report carries the gate result for
        ``Promoter.decide``."""
        if self._candidate is None:
            raise RuntimeError("no canary window open")
        baseline = self.registry.current
        base_gen = baseline.generation if baseline is not None else None
        fields: dict = {
            "slice_fraction": self.slice_fraction,
            "quality_threshold": self.quality_threshold,
            "source": "pipeline.canary", "tool": "pipeline",
        }
        if base_gen is not None:
            fields["baseline_generation"] = int(base_gen)
        if self._epoch is not None:
            fields["epoch"] = int(self._epoch)

        if isinstance(self._candidate, tuple):
            # pre-flight refusal: no shadow leg ever ran
            _, generation, cand_spec = self._candidate
            fields.update(shadow_requests=0,
                          refusals=list(self._preflight_refusals))
            if cand_spec is not None:
                fields["candidate_spec"] = cand_spec
                fields["baseline_spec"] = dataclasses.asdict(
                    self.engine.spec)
            return self._close("refused", generation, fields, None)

        loaded = self._candidate
        with self._lock:
            sq, self._shadow_queue = self._shadow_queue, None
            futures = self._shadow_futures
        for f in futures:
            try:
                f.result(timeout=30.0)
            except Exception:  # noqa: BLE001
                pass  # the summary's error count carries the evidence
        shadow = sq.latency_summary()
        sq.stop()
        head = self.queue.latency_summary()

        fields["shadow_requests"] = int(shadow.get("requests", 0))
        for metric in ("p50_ms", "p99_ms"):
            if metric in shadow:
                fields[metric] = shadow[metric]
            if metric in head:
                fields[f"baseline_{metric}"] = head[metric]
        if self.holdout is not None and baseline is not None:
            Xv, yv = self.holdout
            qb = float(log_loss(
                baseline.model.predict_proba(Xv), yv))
            qc = float(log_loss(
                loaded.model.predict_proba(Xv), yv))
            if self._quality_override is not None:
                qc = float(self._quality_override)
                fields["quality_fault_injected"] = True
            fields.update(quality_baseline=qb, quality_candidate=qc,
                          quality_delta=(qc - qb))

        gate = perfgate.gate_promotion(
            [dict(fields, kind="canary",
                  generation=int(loaded.generation))],
            quality_threshold=self.quality_threshold,
            thresholds=self.thresholds,
            min_shadow_requests=self.min_shadow_requests)
        verdict = ("refused" if gate.refused
                   else "fail" if gate.failures else "pass")
        if gate.refusals:
            fields["refusals"] = list(gate.refusals)
        fields["quality_verdict"] = self._leg_verdict(
            gate, ("holdout_loss",))
        fields["latency_verdict"] = self._leg_verdict(
            gate, perfgate.PROMOTION_LATENCY_METRICS)
        return self._close(verdict, loaded.generation, fields, gate)

    @staticmethod
    def _leg_verdict(gate, metrics) -> str:
        legs = [d for d in gate.deltas if d.metric in metrics]
        if not legs:
            return "refused"
        return ("fail" if any(d.status == "regression" for d in legs)
                else "pass")

    def _close(self, verdict: str, generation: int, fields: dict,
               gate) -> CanaryReport:
        refusals = list(fields.get("refusals", []))
        rec = schema.canary_record("(untracked)", int(generation),
                                   verdict, **fields)
        report = CanaryReport(
            generation=int(generation),
            baseline_generation=fields.get("baseline_generation"),
            verdict=verdict, record=rec, gate=gate,
            refusals=refusals, epoch=self._epoch)
        self._reset_window()
        return report
