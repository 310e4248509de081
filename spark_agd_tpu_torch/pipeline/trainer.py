"""Continuous epoch trainer — the training half of the pipeline loop.

Counterpart of ``spark_agd_tpu/pipeline/trainer.py``.  One
:class:`ContinuousTrainer` owns a long-lived supervised fit broken into
epochs: each ``run_epoch(X, y)`` call warm-starts from the previous
epoch's weights, runs ``run_agd_supervised`` over that epoch's
minibatch (preemption-safe via ``AutoCheckpointer``), and publishes the
result to ``serve.registry`` as a CANDIDATE generation through the
manifest commit protocol — published means durably committed, NOT
serving; the canary/promotion half decides whether serving HEAD moves
(``pipeline.canary`` / ``pipeline.promote``).

Each epoch stages its own data (``core.smooth.make_smooth_staged``, so
``gradient.prepare`` runs once an epoch) and hands the supervisor a
fresh ``staged`` pair; the one shared ``seg_cache`` rebuilds a segment's
smooth when ``staged`` changes, so epoch 2 fits epoch 2's data.  With
``FusedLogisticGradient`` every evaluation is one launch of the margin
kernel.  The epoch's data and the weights go to the trainer's device
(the current CUDA device unless the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core import agd
from ..core import smooth as smooth_lib
from ..core import tvec
from ..resilience.autockpt import AutoCheckpointer
from ..resilience.supervisor import (ResiliencePolicy,
                                     run_agd_supervised)


@dataclasses.dataclass
class EpochResult:
    """One epoch's outcome: the published candidate and its fit."""

    epoch: int
    generation: int        # the published candidate generation
    final_loss: float
    weights: Any           # the CLEAN post-epoch weights (warm start)
    result: Any            # the epoch's SupervisedResult ledger


def _on(a, device):
    """``a`` on ``device``: tensors and CSR matrices move, anything numpy
    takes becomes a tensor, None stays None."""
    if a is None:
        return None
    if not hasattr(a, "to"):
        a = torch.as_tensor(np.asarray(a))
    return a.to(device)


class ContinuousTrainer:
    """See module docstring.

    ``make_model(weights)`` turns an epoch's weight vector into the
    servable model the registry publishes.  ``weight_fault(epoch,
    weights)`` (optional, drills only) corrupts the PUBLISHED candidate
    of matching epochs while the warm-start chain keeps the clean
    weights.
    """

    def __init__(self, registry, gradient, *,
                 prox: Callable, reg_value: Callable,
                 w0, config: Optional[agd.AGDConfig] = None,
                 make_model: Callable[[Any], Any],
                 policy: Optional[ResiliencePolicy] = None,
                 telemetry=None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: Optional[int] = None,
                 checkpoint_keep: int = 2,
                 weight_fault: Optional[Callable] = None,
                 device=None):
        self.device = resolve_device(device)
        self.registry = registry
        self.gradient = gradient
        self.prox = prox
        self.reg_value = reg_value
        self.config = config or agd.AGDConfig()
        self.make_model = make_model
        self.policy = policy
        self.telemetry = telemetry
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.checkpoint_keep = max(1, int(checkpoint_keep))
        self.weight_fault = weight_fault
        self.weights = tvec.tmap(lambda a: _on(a, self.device), w0)
        self.epoch = 0
        self.total_iters = 0
        self._build = None            # the first epoch's build
        self._seg_cache: dict = {}    # one cache, every epoch

    def run_epoch(self, X, y, mask=None) -> EpochResult:
        """Run one warm-started epoch over ``(X, y)`` and publish the
        result as the next candidate generation.  Returns the epoch's
        :class:`EpochResult`; the supervisor's failure taxonomy
        (transient retry, numeric rollback, preemption resume) applies
        unchanged inside the epoch."""
        self.epoch += 1
        epoch = self.epoch
        span = (self.telemetry.trace_span("pipeline_epoch",
                                          epoch=epoch, tool="pipeline")
                if self.telemetry is not None else None)
        with span if span is not None else contextlib.nullcontext():
            build, dargs = smooth_lib.make_smooth_staged(
                self.gradient, _on(X, self.device), _on(y, self.device),
                _on(mask, self.device))
            if self._build is None:
                self._build = build
            checkpointer = self._checkpointer(epoch)
            result = run_agd_supervised(
                prox=self.prox, reg_value=self.reg_value,
                w0=self.weights, config=self.config,
                policy=self.policy, telemetry=self.telemetry,
                checkpointer=checkpointer,
                staged=(self._build, dargs),
                seg_cache=self._seg_cache,
                stream_iterations=False)
            return self._publish(epoch, span, result)

    def run_epoch_streamed(self, dataset, *, prefetch: int = 0,
                           stream_every_batches: Optional[int] = None,
                           mesh=None, pad_to: Optional[int] = None,
                           on_commit: Optional[Callable] = None
                           ) -> EpochResult:
        """Run one warm-started epoch over a ``data.streaming.
        StreamingDataset``: the smooth streams macro-batches
        (``make_streaming_smooth``) and the supervisor drives the host
        AGD loop (``driver="host"``).

        ``stream_every_batches`` (with ``checkpoint_path`` set) arms
        mid-epoch checkpointing: a ``StreamCheckpoint`` commits the
        fold's cursor every N batches, so a preemption mid-pass resumes
        from the last committed batch instead of the epoch boundary.
        ``on_commit(count)`` is a drill's kill hook.  ``prefetch`` is
        the background ingest depth of ``fold_stream``.  With a
        ``telemetry``, the streamed smooth adds its own records (a
        ``stream_epoch`` a pass)."""
        from ..data import streaming

        self.epoch += 1
        epoch = self.epoch
        span = (self.telemetry.trace_span(
            "pipeline_epoch", epoch=epoch, tool="pipeline",
            streamed=True) if self.telemetry is not None else None)
        with span if span is not None else contextlib.nullcontext():
            checkpointer = self._checkpointer(epoch)
            stream_ckpt = None
            if checkpointer is not None and stream_every_batches:
                stream_ckpt = streaming.StreamCheckpoint(
                    checkpointer, every_batches=int(stream_every_batches),
                    on_commit=on_commit)
            sm, sl = streaming.make_streaming_smooth(
                self.gradient, dataset, mesh=mesh, pad_to=pad_to,
                prefetch=prefetch, stream_ckpt=stream_ckpt,
                telemetry=self.telemetry,
                device=None if mesh is not None else self.device)
            result = run_agd_supervised(
                smooth=sm, smooth_loss=sl, prox=self.prox,
                reg_value=self.reg_value, w0=self.weights,
                config=self.config, policy=self.policy,
                telemetry=self.telemetry, checkpointer=checkpointer,
                driver="host", stream_iterations=False)
            return self._publish(epoch, span, result)

    def _checkpointer(self, epoch: int) -> Optional[AutoCheckpointer]:
        if self.checkpoint_path is None:
            return None
        return AutoCheckpointer(
            f"{self.checkpoint_path}.e{epoch:03d}.npz",
            every_iters=(self.checkpoint_every
                         or self.config.num_iterations),
            keep=self.checkpoint_keep,
            telemetry=self.telemetry)

    def _publish(self, epoch: int, span, result) -> EpochResult:
        """The shared epoch tail: warm-start carry, the candidate's
        publish through the manifest commit protocol, span
        annotation."""
        self.weights = result.weights
        self.total_iters += result.num_iters
        final_loss = (float(result.loss_history[-1])
                      if len(result.loss_history) else float("nan"))
        publish_w = result.weights
        if self.weight_fault is not None:
            publish_w = self.weight_fault(epoch, publish_w)
        generation = self.registry.publish(
            self.make_model(publish_w),
            converged=result.converged,
            prior_iters=self.total_iters)
        if span is not None:
            span.note(generation=generation, final_loss=final_loss,
                      iters=result.num_iters,
                      retries=result.retries,
                      rollbacks=result.rollbacks)
        return EpochResult(epoch=epoch, generation=generation,
                           final_loss=final_loss,
                           weights=result.weights, result=result)
