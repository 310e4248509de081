"""Typed promotion decisions — the last stage of the pipeline loop.

Counterpart of ``spark_agd_tpu/pipeline/promote.py``.
``Promoter.decide(report)`` turns one :class:`~.canary.CanaryReport`
into exactly one of three decisions, each with a ``promotion`` record
built by ``obs.schema.promotion_record``:

- ``rejected``: the canary verdict was not a pass (gate failure or
  refusal) — serving HEAD never moves, the evidence rides the record;
- ``promoted``: the gate passed, ``serve.registry.repoint`` moved HEAD
  to the candidate (atomic manifest repoint + engine hot swap), and
  the optional ``post_check`` against the LIVE generation held;
- ``rolled_back``: the post-repoint check FAILED — the promoter repoints
  HEAD back to the generation that served before (or walks
  ``registry.previous()`` back to the prior verifiable generation).

``post_check(loaded) -> (ok, reason)`` is the promoter's last line of
defense — it runs AFTER the repoint, against the generation that is
actually serving, so evidence the canary could not see (a fault-
injected quality lie, a torn read that only manifests on load) still
cannot stay in production.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from .._later import reject_later
from ..obs import schema
from ..utils.checkpoint import CheckpointCorruptError
from .canary import CanaryReport


@dataclasses.dataclass
class PromotionDecision:
    """One typed decision: what happened and where HEAD ended up."""

    decision: str                       # promoted | rejected | rolled_back
    candidate_generation: int
    from_generation: Optional[int]      # HEAD before the decision
    to_generation: Optional[int]        # HEAD after (None: never moved
    #                                     and nothing to roll back to)
    gate_status: str
    record: dict                        # the promotion record


class Promoter:
    """See module docstring."""

    def __init__(self, registry, engine=None, *, telemetry=None,
                 post_check: Optional[
                     Callable[..., Tuple[bool, str]]] = None):
        reject_later(telemetry=telemetry)
        self.registry = registry
        self.engine = engine
        self.post_check = post_check

    def decide(self, report: CanaryReport) -> PromotionDecision:
        current = self.registry.current
        from_gen = current.generation if current is not None else None
        evidence = {
            "verdict": report.verdict,
            "canary_refusals": list(report.refusals),
        }
        if report.gate is not None:
            evidence["gate_failures"] = list(report.gate.failures)

        if report.verdict != "pass":
            gate_status = ("refused" if report.verdict == "refused"
                           else "failed")
            return self._emit("rejected", report, from_gen, from_gen,
                              gate_status, evidence,
                              reason="canary verdict was "
                                     f"{report.verdict!r}")

        self.registry.repoint(report.generation, engine=self.engine)
        ok, reason = (True, "")
        if self.post_check is not None:
            ok, reason = self.post_check(self.registry.current)
        if ok:
            return self._emit("promoted", report, from_gen,
                              report.generation, "passed", evidence,
                              reason="canary gate and post-promotion "
                                     "check passed")

        # the candidate is LIVE and bad: prefer the generation that was
        # serving before the repoint, else walk back to the previous
        # verifiable generation, skipping targets that fail to load
        evidence["post_check"] = reason
        target = (from_gen if from_gen and from_gen != report.generation
                  else self.registry.previous(report.generation))
        rolled_to = None
        while target is not None:
            try:
                self.registry.repoint(target, engine=self.engine)
                rolled_to = target
                break
            except (LookupError, CheckpointCorruptError):
                target = self.registry.previous(target)
        return self._emit("rolled_back", report, from_gen, rolled_to,
                          "failed", evidence,
                          reason="post-promotion check failed: "
                                 + reason[:160])

    def _emit(self, decision: str, report: CanaryReport,
              from_gen: Optional[int], to_gen: Optional[int],
              gate_status: str, evidence: dict,
              *, reason: str) -> PromotionDecision:
        fields = {
            "candidate_generation": int(report.generation),
            "from_generation": from_gen,
            "gate_status": gate_status, "evidence": evidence,
            "reason": reason, "source": "pipeline.promote",
            "tool": "pipeline",
        }
        if to_gen is not None:
            fields["to_generation"] = int(to_gen)
        if report.epoch is not None:
            fields["epoch"] = int(report.epoch)
        if report.refusals:
            fields["refusals"] = list(report.refusals)
        rec = schema.promotion_record("(untracked)", decision, **fields)
        return PromotionDecision(
            decision=decision,
            candidate_generation=int(report.generation),
            from_generation=from_gen, to_generation=to_gen,
            gate_status=gate_status, record=rec)
