"""The continuous-learning pipeline: train → publish → canary →
promote/rollback as ONE supervised loop.

Counterpart of ``spark_agd_tpu/pipeline/``:

- :class:`~.trainer.ContinuousTrainer` runs warm-started, preemption-
  safe epochs over minibatches and publishes every epoch's weights as
  a candidate generation;
- :class:`~.canary.CanaryController` shadow-serves the candidate on a
  slice of live traffic (a second ``ServeEngine`` beside HEAD) and
  grades it on held-out quality AND shadow latency
  (``obs.perfgate.gate_promotion``);
- :class:`~.promote.Promoter` turns the canary verdict into a typed
  decision — ``promoted`` / ``rejected`` / ``rolled_back`` — where a
  post-repoint failure rolls HEAD back to the previous verifiable
  generation (``serve.registry.repoint``).
"""

from .trainer import ContinuousTrainer, EpochResult
from .canary import CanaryController, CanaryReport
from .promote import Promoter, PromotionDecision

__all__ = [
    "ContinuousTrainer", "EpochResult",
    "CanaryController", "CanaryReport",
    "Promoter", "PromotionDecision",
]
