"""The fault-aware driver: supervised AGD fits with retry, rollback and
auto-checkpointing.

Counterpart of ``spark_agd_tpu/resilience/supervisor.py``.  The AGD
carry is two weight trees plus three scalars (``core.agd.AGDWarmState``),
so rerunning from the last good state costs a small copy, not a lineage
graph.  A fit runs in segments of ``policy.segment_iters`` iterations,
each one attempt under the shared failure taxonomy
(``resilience.errors``):

- TRANSIENT (device loss, runtime and IO errors, watchdog timeouts,
  ``torch.cuda.OutOfMemoryError``): retry the same segment from the same
  warm state after backoff, at most ``max_attempts`` tries a segment;
- NUMERIC (a non-finite loss: the loop's abort flag, or a
  ``NumericsFailureError``): roll back to the last good warm state with
  its Lipschitz estimate multiplied by ``rollback_l_factor`` (the step is
  ``1/L``), at most ``max_rollbacks`` times, the poisoned segment's work
  discarded;
- PREEMPTED: the checkpointer's handler has flushed; re-raise, so the
  process exits and the next one resumes;
- FATAL: raise :class:`SupervisorGivingUp` at once, with the ledger.

No segment writes into the tensors of the warm state it started from
(the optimizer loop updates nothing in place), so a failed segment is
retried from an intact anchor.  The ``attempt`` ledger has the JAX
package's entries; its ``attempt``/``recovery`` records come with the
observability slice, as does ``telemetry=``, which raises
``NotImplementedError``.  A ``staged`` build with ``make_agd_run`` (the
sharded update) runs each segment through that hook.  ``heartbeat=``,
``monitor=`` and
``scheduler=`` (``resilience.distributed``, ``resilience.scheduler``)
run as the JAX package wires them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from .._later import reject_later
from ..core import agd, tvec
from ..core.agd import AGDConfig, AGDWarmState
from ..utils import checkpoint as ckpt
from . import errors, faults as faults_lib, retry as retry_lib


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy(retry_lib.RetryPolicy):
    """The supervisor's knobs: the retry engine's fields
    (``max_attempts``, ``backoff_*``, ``jitter``, ``seed``,
    ``attempt_timeout``) plus the rollback and segmentation policy.

    ``segment_iters=None`` runs the whole remaining budget as one
    attempt; smaller segments bound the work one fault can destroy and
    set the granularity of checkpoints, fault injection and preemption
    points.  ``max_wall_seconds`` (None = unbounded) is the run's
    wall-clock budget, checked at segment boundaries: past it the
    supervisor stops retrying, with a ``deadline`` entry in the ledger
    and :class:`SupervisorGivingUp`."""

    max_rollbacks: int = 3
    rollback_l_factor: float = 4.0
    segment_iters: Optional[int] = None
    max_wall_seconds: Optional[float] = None

    def __post_init__(self):
        super().__post_init__()
        if self.max_rollbacks < 0:
            raise ValueError("max_rollbacks must be >= 0")
        if self.rollback_l_factor <= 1.0:
            raise ValueError(
                "rollback_l_factor must be > 1 (a rollback must CUT "
                "the step, or the retried segment fails identically)")
        if self.segment_iters is not None and self.segment_iters < 1:
            raise ValueError("segment_iters must be >= 1")
        if self.max_wall_seconds is not None and self.max_wall_seconds <= 0:
            raise ValueError("max_wall_seconds must be > 0")


class SupervisedResult(NamedTuple):
    weights: Any
    loss_history: np.ndarray
    num_iters: int            # executed iterations that COUNT (rolled-
    #                           back segments' work is discarded)
    converged: bool
    aborted_non_finite: bool  # True only when rollbacks were exhausted
    #                           and the policy said to return, not raise
    retries: int              # transient re-attempts across the run
    rollbacks: int            # numeric rollbacks across the run
    resumed_from: int         # iterations already checkpointed at start
    attempts: List[dict]      # the full ledger, one dict per attempt


def _rollback(warm: AGDWarmState, factor: float) -> AGDWarmState:
    """The last good carry with the step cut: multiplying the Lipschitz
    estimate by ``factor`` shrinks the next step ``1/L`` as much;
    ``bts=True`` re-arms backtracking so the estimate can grow back."""
    return warm._replace(big_l=float(warm.big_l) * float(factor),
                         bts=True)


def _as_tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))


def _compute_stream(w0):
    """The current CUDA stream of the first CUDA leaf of ``w0`` (None
    for CPU weights), read on the calling thread."""
    for leaf in tvec.leaves(w0):
        if leaf.device.type == "cuda":
            return torch.cuda.current_stream(leaf.device)
    return None


def run_agd_supervised(
    smooth: Optional[Callable] = None,
    prox: Callable = None,
    reg_value: Callable = None,
    w0: Any = None,
    config: AGDConfig = None,
    *,
    policy: Optional[ResiliencePolicy] = None,
    telemetry=None,
    checkpointer=None,
    staged=None,
    driver: str = "fused",
    smooth_loss: Optional[Callable] = None,
    faults: Optional["faults_lib.FaultScript"] = None,
    place_w: Optional[Callable] = None,
    heartbeat=None,
    monitor=None,
    scheduler=None,
    seg_cache: Optional[dict] = None,
    stream_iterations: bool = True,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
) -> SupervisedResult:
    """Run one AGD fit to completion under the supervision policy.

    ``staged=(build, data_args)`` (``core.smooth.make_smooth_staged``)
    builds the smooth from prepared operands; ``smooth``/``smooth_loss``
    closures work too.  ``place_w`` (optional) maps the initial weights
    (numpy arrays become CPU tensors first) before the first segment.
    Each segment runs ``core.agd.run_agd``, which launches the kernels
    of the gradient it was given; a kernel that fails inside a segment
    is that segment's classified failure.  ``driver`` ("fused" or
    "host") is checked as the JAX package checks it (``staged`` is
    fused-only, ``"host"`` needs ``smooth``), and both run that one
    loop.

    ``checkpointer`` (an :class:`~spark_agd_tpu_torch.resilience.
    autockpt.AutoCheckpointer`): resume from its surviving generation,
    each completed segment offered for a cadence save, its signal
    handlers installed for the run, terminal states force-flushed.

    ``faults`` (a ``FaultScript`` or ``chaos.ChaosSchedule``: any object
    with ``before_segment``/``take_poison``): consulted at segment
    boundaries, for tests and drills.

    ``policy.attempt_timeout`` runs each attempt on a worker thread
    (``retry.run_with_watchdog``); the attempt stays on the caller's
    current CUDA stream, so a timed-out attempt that is still launching
    and its retry are ordered on one stream, and every launch allocates
    its own scratch.  Over a streamed smooth, a pass opened while
    another is still open stages through pinned buffers of its own, and
    each attempt tells the checkpointer it started
    (``begin_attempt``), so a ``data.streaming.StreamCheckpoint``
    counts the retry's passes from the boundary and stops the abandoned
    attempt at its next pass or commit.

    ``seg_cache`` (a dict, default private): the built ``(smooth,
    smooth_loss)`` pair per ``(segment length, poisoned)``, beside the
    ``staged`` pair it was built over (a pair built over other data is
    built anew); share one dict only across calls of one problem.

    ``stream_iterations`` is taken as the JAX package takes it (whether
    the per-iteration telemetry callback runs); it has no effect while
    ``telemetry=`` is refused, so every value runs the same fit.

    ``heartbeat`` (a :class:`~spark_agd_tpu_torch.resilience.
    distributed.HeartbeatWriter`): beaten at every segment boundary and
    once at exit, and bound to a ``faults`` schedule that has
    ``bind_heartbeat`` (an injected straggler sleep beats ``"slow"``).
    ``monitor`` (a :class:`~spark_agd_tpu_torch.resilience.distributed.
    HostMonitor`): checked at each boundary; a stale peer raises
    ``HostLost``, classified TRANSIENT and retried with backoff.  A
    process inside a collective against a dead peer does not reach its
    next boundary (the collective fails or waits for the group's
    timeout): whoever launched the group reads the loss from the
    heartbeats and reaps it.

    ``scheduler`` (a :class:`~spark_agd_tpu_torch.resilience.scheduler.
    StragglerScheduler`): each successful segment's boundary seconds
    (the hooks above, this process's own work) feed
    ``scheduler.after_segment``; a returned decision is applied at the
    generation boundary: ``staged`` becomes the rebuilt pair (the
    smooths built over the old data are dropped) and the checkpointer
    force-commits a generation carrying the new partition list."""
    reject_later(telemetry=telemetry)
    if w0 is None or config is None:
        raise ValueError("w0 and config are required")
    if staged is None and smooth is None:
        raise ValueError("pass smooth=... or staged=(build, data_args)")
    if driver not in ("fused", "host"):
        raise ValueError(
            f"driver must be 'fused' or 'host'; got {driver!r}")
    if driver == "host":
        if staged is not None:
            raise ValueError(
                "staged=(build, data_args) applies to the fused driver "
                "only; the host driver never embeds data in a program")
        if smooth is None:
            raise ValueError("driver='host' needs smooth=...")
    if scheduler is not None and getattr(scheduler, "rebuild", None) \
            is not None and staged is None:
        raise ValueError(
            "scheduler rebalancing swaps the staged data arguments: "
            "pass staged=(build, data_args), not a closure smooth")
    policy = policy or ResiliencePolicy()
    w0 = tvec.tmap(_as_tensor, w0)
    if place_w is not None:
        w0 = place_w(w0)
    stream = _compute_stream(w0)

    seg_fns = {} if seg_cache is None else seg_cache

    def segment_smooth(k: int, poisoned: bool):
        key = (k, poisoned)
        entry = seg_fns.get(key)
        # a built smooth closes over the data it was built from: after a
        # rebalance swaps ``staged``, it is built anew
        if entry is None or entry[0] is not staged:
            sm, sl = (staged[0](*staged[1]) if staged is not None
                      else (smooth, smooth_loss))
            if poisoned:
                sm = faults_lib.poison_smooth(sm)
            entry = seg_fns[key] = (staged, sm, sl)
        return entry[1:]

    begin_attempt = getattr(checkpointer, "begin_attempt", None)

    def run_segment(warm: AGDWarmState, k: int, poisoned: bool):
        cfg_k = dataclasses.replace(config, num_iterations=k)
        agd_run = None if staged is None else getattr(
            staged[0], "make_agd_run", None)
        if agd_run is not None:
            # the sharded update (parallel.sharded_update): the segment's
            # whole loop runs on 1/N shards and speaks full trees at entry
            # and exit, so the warm carry, rollback and checkpoints below
            # work unchanged; a rebalance still swaps only the data
            key = ("sharded", k, poisoned)
            entry = seg_fns.get(key)
            if entry is None or entry[0] is not staged:
                entry = seg_fns[key] = (staged, agd_run(
                    prox, reg_value, cfg_k, poison=poisoned,
                    warm_entry=True), None)
            return entry[1](warm, staged[1])
        sm, sl = segment_smooth(k, poisoned)
        return agd.run_agd(sm, prox, reg_value, warm.x, cfg_k,
                           smooth_loss=sl, warm=warm)

    def attempt(warm: AGDWarmState, k: int, poisoned: bool):
        if begin_attempt is not None:
            begin_attempt()  # on the attempt's own thread
        if stream is None:
            return run_segment(warm, k, poisoned)
        # the watchdog's worker thread would start on its own default
        # stream: keep every attempt on the caller's
        with torch.cuda.stream(stream):
            return run_segment(warm, k, poisoned)

    # -- resume ------------------------------------------------------------
    hist: list = []
    warm = None
    if checkpointer is not None:
        loaded = checkpointer.load(w0)
        if loaded is not None:
            if loaded.converged or loaded.aborted:
                # terminal checkpoint: rerunning adds no iterations
                return SupervisedResult(
                    weights=loaded.warm.x,
                    loss_history=np.asarray(loaded.loss_history),
                    num_iters=int(loaded.warm.prior_iters),
                    converged=loaded.converged,
                    aborted_non_finite=loaded.aborted,
                    retries=0, rollbacks=0,
                    resumed_from=int(loaded.warm.prior_iters),
                    attempts=[])
            warm = loaded.warm
            hist = list(np.asarray(loaded.loss_history))
    if warm is None:
        warm = AGDWarmState.initial(w0, config)
    resumed_from = int(warm.prior_iters)

    schedule = policy.backoff_schedule()
    ledger: List[dict] = []
    attempt_no = 0
    seg_failures = 0   # consecutive transient failures of THIS segment
    retries = rollbacks = 0
    converged = aborted = False
    total = int(config.num_iterations)
    t_run0 = clock()

    def record_attempt(outcome: str, start_iter: int, iters: int,
                       seconds: float, error: Optional[str] = None,
                       failure_kind: Optional[str] = None):
        ledger.append({"attempt": attempt_no, "outcome": outcome,
                       "start_iter": start_iter, "iters": iters,
                       "seconds": round(seconds, 6), "error": error,
                       "failure_kind": failure_kind, "algorithm": "agd"})

    def numeric_rollback(reason: str):
        nonlocal warm, rollbacks
        if rollbacks >= policy.max_rollbacks:
            raise errors.SupervisorGivingUp(
                f"non-finite numerics persisted through "
                f"{policy.max_rollbacks} rollbacks (last: {reason})",
                ledger)
        rollbacks += 1
        warm = _rollback(warm, policy.rollback_l_factor)

    def transient(start: int, e: BaseException):
        """Count one transient failure of the segment at ``start``; give
        up past ``max_attempts``, else back off."""
        nonlocal seg_failures, retries
        seg_failures += 1
        retries += 1
        if seg_failures >= policy.max_attempts:
            raise errors.SupervisorGivingUp(
                f"segment at iteration {start} failed {seg_failures} "
                f"times (last: {e})", ledger) from e
        delay = schedule.next_delay(seg_failures)
        if delay:
            sleep(delay)

    if faults is not None and heartbeat is not None \
            and hasattr(faults, "bind_heartbeat"):
        # injected slow_host sleeps beat the heartbeat in sub-intervals,
        # so a monitor reads the process SLOW, not LOST
        faults.bind_heartbeat(heartbeat)

    finished = False
    try:
        if checkpointer is not None:
            checkpointer.install_signal_handlers()
            checkpointer.update(warm, hist)  # generation 0 / post-resume
        while int(warm.prior_iters) < total:
            start = int(warm.prior_iters)
            k = min(policy.segment_iters or total, total - start)
            if policy.max_wall_seconds is not None:
                elapsed = clock() - t_run0
                if elapsed > policy.max_wall_seconds:
                    attempt_no += 1
                    record_attempt(
                        "deadline", start, 0, elapsed,
                        error=(f"wall-clock budget "
                               f"{policy.max_wall_seconds:g}s exceeded"),
                        failure_kind="deadline")
                    raise errors.SupervisorGivingUp(
                        f"DEADLINE: wall-clock budget "
                        f"{policy.max_wall_seconds:g}s exhausted after "
                        f"{elapsed:.3f}s at iteration {start} ({retries} "
                        f"retries, {rollbacks} rollbacks so far); not "
                        "retrying further", ledger)
            # the boundary hooks are this process's own work (no
            # collective): their seconds are what the scheduler folds
            t_bnd = time.perf_counter()
            if heartbeat is not None:
                heartbeat.beat(iter=start, phase="segment")
            if faults is not None or monitor is not None:
                try:
                    if faults is not None:
                        faults.before_segment(start)
                    if monitor is not None:
                        monitor.check()
                except Exception as e:  # noqa: BLE001 (classified below)
                    attempt_no += 1
                    kind = errors.classify_failure(e)
                    record_attempt("failed", start, 0, 0.0,
                                   error=f"{type(e).__name__}: {e}",
                                   failure_kind=kind)
                    if kind == errors.FATAL:
                        # a fatal boundary fault gives up typed, as a
                        # fatal segment failure does
                        raise errors.SupervisorGivingUp(
                            f"fatal failure at iteration {start}: "
                            f"{type(e).__name__}: {e}", ledger) from e
                    if kind != errors.TRANSIENT:
                        raise
                    transient(start, e)
                    continue
            boundary_s = time.perf_counter() - t_bnd
            poisoned = faults is not None and faults.take_poison(start)

            attempt_no += 1
            t0 = time.perf_counter()
            try:
                res = retry_lib.run_with_watchdog(
                    attempt, (warm, k, poisoned), {},
                    policy.attempt_timeout, f"agd@{start}")
            except errors.Preempted:
                raise
            except Exception as e:  # noqa: BLE001 (classified below)
                kind = errors.classify_failure(e)
                record_attempt("failed", start, 0,
                               time.perf_counter() - t0,
                               error=f"{type(e).__name__}: {e}",
                               failure_kind=kind)
                if kind == errors.NUMERIC:
                    numeric_rollback(f"{type(e).__name__}: {e}")
                    seg_failures = 0
                    continue
                if kind == errors.TRANSIENT:
                    transient(start, e)
                    continue
                raise errors.SupervisorGivingUp(
                    f"fatal failure at iteration {start}: "
                    f"{type(e).__name__}: {e}", ledger) from e
            dt = time.perf_counter() - t0

            if bool(res.aborted_non_finite):
                record_attempt("aborted_non_finite", start,
                               int(res.num_iters), dt,
                               failure_kind=errors.NUMERIC)
                numeric_rollback("non-finite loss in segment")
                seg_failures = 0
                continue

            done = int(res.num_iters)
            record_attempt("ok", start, done, dt)
            hist.extend(np.asarray(res.loss_history)[:done].tolist())
            warm = ckpt.warm_from_result(res, start + done)
            converged = bool(res.converged)
            seg_failures = 0
            if checkpointer is not None:
                checkpointer.update(warm, hist, converged=converged)
            if scheduler is not None and not converged and done > 0:
                decision = scheduler.after_segment(
                    start_iter=start, iters=done, boundary_s=boundary_s,
                    segment_s=dt)
                if decision is not None:
                    # the generation-boundary rebalance: swap in the
                    # rebuilt data, then commit a generation that carries
                    # the new assignment
                    new_staged = scheduler.apply(decision,
                                                 checkpointer=checkpointer)
                    if new_staged is not None:
                        for key in [key for key, entry in seg_fns.items()
                                    if entry[0] is staged]:
                            del seg_fns[key]
                        staged = new_staged
                    if checkpointer is not None:
                        checkpointer.update(warm, hist,
                                            converged=converged, force=True)
            if converged or done == 0:
                break
        finished = True
    finally:
        if checkpointer is not None:
            try:
                _final_flush(checkpointer, warm, hist, converged, aborted,
                             finished)
            finally:
                checkpointer.uninstall_signal_handlers()
        if heartbeat is not None:
            try:
                heartbeat.beat(iter=int(warm.prior_iters), phase="exit")
            except OSError:  # a dying filesystem must not mask the
                pass         # real exit path

    return SupervisedResult(
        weights=warm.x, loss_history=np.asarray(hist),
        num_iters=int(warm.prior_iters), converged=converged,
        aborted_non_finite=aborted, retries=retries,
        rollbacks=rollbacks, resumed_from=resumed_from,
        attempts=ledger)


def _final_flush(checkpointer, warm, hist, converged, aborted,
                 finished):
    """The terminal or abandon flush: whatever the exit path, the last
    completed state is on disk before the handlers go.  On an exit by
    an exception the card may be past use (a sticky CUDA error fails
    every later call), so when the carry cannot be copied to the host
    the host copy taken at the last boundary is written instead, and
    the exception in flight goes on."""
    try:
        checkpointer.update(warm, hist, converged=converged,
                            aborted=aborted, force=True)
    except Exception as e:  # noqa: BLE001 (only on the exception path)
        if finished:
            raise
        ckpt.logger.warning("abandon flush from the last boundary's host "
                            "copy (the carry's copy failed: %s: %s)",
                            type(e).__name__, e)
        checkpointer.flush(reason="abandon")


def supervised_call(fn: Callable, *args, policy=None, telemetry=None,
                    label: str = "fit", **kwargs):
    """Wrap any runner's fit (L-BFGS, sweeps, custom drivers) in the
    bounded-retry half of the policy, for results that carry no
    ``AGDWarmState`` to roll back to.  Transient failures retry with
    backoff; NUMERIC and FATAL ones raise at once; the last failure
    raises :class:`SupervisorGivingUp` with the ledger."""
    reject_later(telemetry=telemetry)
    policy = policy or ResiliencePolicy()
    ledger: List[dict] = []
    attempt = [0]

    def attempted(*a, **kw):
        attempt[0] += 1
        t0 = time.perf_counter()
        try:
            out = fn(*a, **kw)
        except Exception as e:
            ledger.append({"attempt": attempt[0], "outcome": "failed",
                           "seconds": round(time.perf_counter() - t0, 6),
                           "error": f"{type(e).__name__}: {e}",
                           "failure_kind": errors.classify_failure(e)})
            raise
        ledger.append({"attempt": attempt[0], "outcome": "ok",
                       "seconds": round(time.perf_counter() - t0, 6)})
        return out

    try:
        return retry_lib.call_with_retry(
            attempted, *args, policy=policy, label=label, **kwargs)
    except Exception as e:
        if isinstance(e, (errors.Preempted, errors.SupervisorGivingUp)):
            raise
        raise errors.SupervisorGivingUp(
            f"{label}: {type(e).__name__}: {e}", ledger) from e
