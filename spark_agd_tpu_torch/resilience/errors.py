"""Failure taxonomy + the ONE classifier every recovery path consults.

A copy of ``spark_agd_tpu/resilience/errors.py``, which needs only the
standard library; ``tests/test_torch_logging.py`` holds everything
after this docstring to the original, line for line.

The reference inherits Spark's implicit taxonomy: a lost executor is
retried by the scheduler, a deterministic exception fails the job, and a
non-finite loss silently terminates the loop (reference
``AcceleratedGradientDescent.scala:309-312``).  Here the taxonomy is
explicit and shared — the supervisor (``resilience.supervisor``), the
retrying IO helper (``resilience.retry``), the sanitizer
(``utils.debug.report_numerics_failure``), and the fault-injection
harness (``resilience.faults``) all speak these kinds:

- ``TRANSIENT`` — worth retrying: simulated/real device loss, runtime/
  IO errors, attempt timeouts, and a lost peer host (``HostLost`` —
  retryable, but possibly on a CHANGED topology via the distributed
  checkpoint's elastic resume).  The supervisor retries with
  exponential backoff; the same attempt is expected to succeed.
- ``NUMERIC`` — the math went non-finite: retrying the identical
  attempt would fail identically.  The supervisor rolls back to the
  last-good ``AGDWarmState`` with a step-size cut instead.
- ``PREEMPTED`` — the host was told to go away (SIGTERM/SIGINT).  The
  auto-checkpointer has already flushed; the supervisor re-raises so
  the process can exit and a NEW process resumes from the checkpoint.
- ``FATAL`` — a programming/config error (ValueError, TypeError, …) or
  a lost quorum (``QuorumLost`` — retrying cannot resurrect hosts):
  retrying is noise; raise immediately with the attempt ledger.

Deliberately stdlib-only (no jax import): ``utils.debug`` and the data
layer import this leaf without dragging in the supervisor.
"""

from __future__ import annotations

from typing import List, Optional

TRANSIENT = "transient"
NUMERIC = "numeric"
PREEMPTED = "preempted"
FATAL = "fatal"

FAILURE_KINDS = (TRANSIENT, NUMERIC, PREEMPTED, FATAL)


class SimulatedDeviceLoss(RuntimeError):
    """A fault-injected stand-in for the runtime losing a device
    mid-run (TPU preemption sibling: the XLA ``DATA_LOSS`` /
    ``UNAVAILABLE`` RuntimeErrors).  Classified TRANSIENT."""


class HostLost(RuntimeError):
    """A PEER process of the SPMD job died or stopped heartbeating
    (``resilience.distributed.HostMonitor``) — the multi-host sibling of
    device loss.  Classified TRANSIENT: the work is retryable, but
    unlike a plain transient the retry may have to happen on a CHANGED
    topology (the dead host is gone), which is exactly what
    ``DistributedCheckpointer.load_for_topology`` resumes onto.  Spark's
    equivalent is a lost executor: the scheduler reruns its partitions
    elsewhere rather than failing the job."""

    def __init__(self, process_index: int, detail: str = "",
                 stale_for_s: Optional[float] = None):
        extra = f" ({detail})" if detail else ""
        if stale_for_s is not None:
            extra += f"; no heartbeat for {stale_for_s:.1f}s"
        super().__init__(
            f"host {process_index} lost{extra}; resume on the surviving "
            "topology via DistributedCheckpointer.load_for_topology")
        self.process_index = int(process_index)
        self.stale_for_s = stale_for_s


class QuorumLost(RuntimeError):
    """Too many peers are gone for a DEGRADED continuation
    (``resilience.degrade.DegradePolicy`` refused): the surviving
    process count is below quorum.  Classified FATAL — unlike a single
    ``HostLost``, retrying cannot resurrect the missing hosts; the run
    needs a full elastic restart on restored capacity (or an operator
    decision), and a supervisor must give up typed rather than back
    off forever."""

    def __init__(self, reason: str):
        super().__init__(
            f"quorum lost: {reason}; degraded continuation refused — "
            "restart elastically on restored capacity")


class StreamDataLoss(RuntimeError):
    """Too many shards of a streamed dataset are quarantined for the
    epoch to be statistically honest (``data.streaming.
    QuarantinePolicy`` refused): the surviving data fraction is below
    the policy's floor.  The data-plane sibling of :class:`QuorumLost`
    and classified FATAL for the same reason — retrying cannot
    un-poison the shards, and silently fitting on a sliver of the data
    would be worse than stopping."""

    def __init__(self, healthy: int, total: int, min_fraction: float):
        frac = healthy / total if total else 0.0
        super().__init__(
            f"stream data loss: {healthy}/{total} shards healthy "
            f"({frac:.3f} < minimum data fraction {min_fraction:g}); "
            "refusing to continue the degraded epoch — restore or "
            "replace the quarantined shards")
        self.healthy = int(healthy)
        self.total = int(total)
        self.min_fraction = float(min_fraction)


class ServeOverloaded(RuntimeError):
    """The serving plane's typed backpressure rejection
    (``serve.queue.MicroBatchQueue``): the micro-batching queue is at
    capacity and admitting the request would let latency grow without
    bound.  Classified TRANSIENT — the overload clears as the queue
    drains, so the client-side remedy is the same backoff-and-retry the
    supervisor applies to a lost device; the SERVER never retries (it
    sheds, which is the point)."""

    def __init__(self, queued_rows: int, limit_rows: int,
                 detail: str = ""):
        extra = f" ({detail})" if detail else ""
        super().__init__(
            f"serving queue overloaded: {queued_rows} rows queued "
            f"against a limit of {limit_rows}{extra}; back off and "
            "retry")
        # kept as attributes so the fleet transport can re-raise the
        # rejection typed on the client side with the numbers intact
        self.queued_rows = int(queued_rows)
        self.limit_rows = int(limit_rows)
        self.detail = detail
        self.queued_rows = int(queued_rows)
        self.limit_rows = int(limit_rows)


class NumericsFailureError(FloatingPointError):
    """The smooth evaluation (or the in-loop loss stream) went
    non-finite — raised by ``utils.debug.report_numerics_failure`` so a
    sanitizer hit enters the SAME rollback path as the fused loop's
    abort flag.  ``FloatingPointError`` parent: classified NUMERIC by
    type, not by message-matching."""


class Preempted(Exception):
    """Raised (from the ``AutoCheckpointer`` signal handler) after the
    preemption flush lands: the process must stop, and a rerun of the
    same call resumes from the flushed checkpoint."""

    def __init__(self, signum: Optional[int] = None):
        super().__init__(
            f"preempted (signal {signum}); final checkpoint flushed"
            if signum is not None else "preempted")
        self.signum = signum


class AttemptTimeout(TimeoutError):
    """The per-attempt wall-clock watchdog fired.  Classified
    TRANSIENT (a hung collective / stuck host looks exactly like a
    lost device from the driver's seat)."""

    def __init__(self, label: str, seconds: float):
        super().__init__(f"{label}: attempt exceeded {seconds:g}s "
                         "wall-clock watchdog")
        self.seconds = seconds


class SupervisorGivingUp(RuntimeError):
    """The policy's budget is exhausted (retries or rollbacks) or the
    failure was FATAL.  Carries the full attempt ledger so the
    post-mortem does not depend on scraping logs."""

    def __init__(self, message: str, ledger: Optional[List[dict]] = None):
        super().__init__(message)
        self.ledger = list(ledger or [])


# message fragments that mark a RuntimeError as the runtime losing its
# backend rather than a code bug (XLA status codes surface as text)
_TRANSIENT_RUNTIME_MARKERS = (
    "data_loss", "unavailable", "deadline_exceeded", "resource_exhausted",
    "device", "socket closed", "connection reset", "aborted",
)
_NUMERIC_MARKERS = ("non-finite", "nan", " inf")


def classify_failure(exc: BaseException) -> str:
    """Map one exception to a failure kind (module constants).

    Typed exceptions classify by type; bare ``RuntimeError`` (how both
    jaxlib's ``XlaRuntimeError`` and checkify's ``JaxRuntimeError``
    reach Python) falls back to message inspection — non-finite text
    means NUMERIC, device/status markers (or no marker at all) mean
    TRANSIENT, matching the issue contract "transient RuntimeError /
    device loss → retry".
    """
    if isinstance(exc, Preempted):
        return PREEMPTED
    if isinstance(exc, (NumericsFailureError, FloatingPointError,
                        ZeroDivisionError)):
        return NUMERIC
    if isinstance(exc, (QuorumLost, StreamDataLoss)):
        # unlike HostLost: retrying cannot bring a QUORUM (or the
        # quarantined shards) back — must be checked before the
        # transient isinstance row (RuntimeError)
        return FATAL
    if isinstance(exc, (SimulatedDeviceLoss, HostLost, ServeOverloaded,
                        TimeoutError, OSError, ConnectionError,
                        BrokenPipeError)):
        return TRANSIENT
    if isinstance(exc, (ValueError, TypeError, KeyError, AttributeError,
                        AssertionError, NotImplementedError)):
        return FATAL
    if isinstance(exc, RuntimeError):
        msg = str(exc).lower()
        if any(m in msg for m in _NUMERIC_MARKERS):
            return NUMERIC
        return TRANSIENT
    return FATAL
