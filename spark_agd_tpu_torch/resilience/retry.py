"""Bounded retry with exponential backoff + deterministic jitter.

A copy of ``spark_agd_tpu/resilience/retry.py``, which needs only the
standard library; ``tests/test_torch_logging.py`` holds everything
after this docstring to the original, line for line.

The ONE retry engine: the supervisor's per-segment attempt loop, the
data layer's flaky-IO wrappers (``data.ingest`` / ``data.streaming``),
and ad-hoc callers (``retrying(...)`` as a decorator) all run through
:func:`call_with_retry`, so backoff arithmetic, failure classification,
and the ``recovery`` record emitted per retry exist exactly once.

Jitter is DETERMINISTIC (seeded ``random.Random``): the fault-injection
drill asserts byte-stable trajectories, and a seeded schedule still
decorrelates thundering-herd restarts across hosts (seed defaults to a
per-process value).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Optional, Tuple

from . import errors


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How hard to try: bounded attempts, exponential backoff, a
    wall-clock watchdog per attempt.

    ``max_attempts`` counts TOTAL tries (1 = no retry).  The sleep
    before retry ``i`` (1-based failure count) is
    ``min(backoff_max, backoff_base * backoff_factor**(i-1))``
    scaled by ``1 ± jitter`` (seeded).  ``attempt_timeout`` (seconds,
    None = off) runs the attempt under a watchdog thread and raises
    :class:`~spark_agd_tpu.resilience.errors.AttemptTimeout`
    (TRANSIENT) when it fires — NOTE the timed-out attempt's thread
    cannot be killed and is left to finish in the background; the
    watchdog bounds the *driver's* wait, not the work."""

    max_attempts: int = 3
    backoff_base: float = 0.05
    backoff_factor: float = 2.0
    backoff_max: float = 5.0
    jitter: float = 0.1
    seed: Optional[int] = None
    attempt_timeout: Optional[float] = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_base < 0 or self.backoff_max < 0:
            raise ValueError("backoff must be >= 0")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")

    def backoff_schedule(self) -> "BackoffSchedule":
        return BackoffSchedule(self)


class BackoffSchedule:
    """Stateful sleep-length generator for ONE retry loop (the rng must
    not be shared across loops or the drill's schedule would depend on
    unrelated callers)."""

    def __init__(self, policy: RetryPolicy):
        self._p = policy
        seed = policy.seed
        if seed is None:
            seed = (id(self) ^ int(time.time() * 1e3)) & 0x7FFFFFFF
        self._rng = random.Random(seed)

    def next_delay(self, failure_index: int) -> float:
        """Sleep before retrying after the ``failure_index``-th (1-based)
        consecutive failure."""
        p = self._p
        base = min(p.backoff_max,
                   p.backoff_base * p.backoff_factor ** (failure_index - 1))
        if p.jitter:
            base *= 1.0 + p.jitter * self._rng.uniform(-1.0, 1.0)
        return max(0.0, base)


def run_with_watchdog(fn: Callable, args: tuple, kwargs: dict,
                      timeout: Optional[float], label: str):
    """Run ``fn(*args, **kwargs)``; raise ``AttemptTimeout`` if it is
    still running after ``timeout`` seconds (None = run inline)."""
    if timeout is None:
        return fn(*args, **kwargs)
    box: list = []

    def target():
        try:
            box.append(("ok", fn(*args, **kwargs)))
        except BaseException as e:  # noqa: BLE001 — relayed to caller
            box.append(("err", e))

    t = threading.Thread(target=target, name=f"attempt:{label}",
                         daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise errors.AttemptTimeout(label, timeout)
    status, payload = box[0]
    if status == "err":
        raise payload
    return payload


def call_with_retry(
    fn: Callable,
    *args,
    policy: Optional[RetryPolicy] = None,
    label: str = "call",
    retry_kinds: Tuple[str, ...] = (errors.TRANSIENT,),
    classify: Callable[[BaseException], str] = errors.classify_failure,
    telemetry=None,
    on_retry: Optional[Callable] = None,
    sleep: Callable[[float], None] = time.sleep,
    **kwargs,
):
    """``fn(*args, **kwargs)`` under ``policy``; retries failures whose
    classified kind is in ``retry_kinds``, re-raises everything else
    (and the last failure once attempts are exhausted).

    Each retry emits one ``recovery`` record (``action="retry"``) when a
    ``telemetry`` is attached, and calls ``on_retry(attempt, exc,
    delay)`` when given — the data layer passes a logger hook here so
    ingest retries are visible even without telemetry.
    """
    policy = policy or RetryPolicy()
    schedule = policy.backoff_schedule()
    failures = 0
    while True:
        try:
            return run_with_watchdog(fn, args, kwargs,
                                     policy.attempt_timeout, label)
        except Exception as e:  # noqa: BLE001 — classified below
            kind = classify(e)
            failures += 1
            if kind not in retry_kinds or failures >= policy.max_attempts:
                raise
            delay = schedule.next_delay(failures)
            if telemetry is not None:
                telemetry.recovery(
                    action="retry", reason=f"{type(e).__name__}: {e}",
                    failure_kind=kind, attempt=failures, backoff_s=delay,
                    source=label)
            if on_retry is not None:
                on_retry(failures, e, delay)
            if delay:
                sleep(delay)


def retrying(policy: Optional[RetryPolicy] = None, *,
             label: Optional[str] = None, telemetry=None,
             on_retry: Optional[Callable] = None,
             retry_kinds: Tuple[str, ...] = (errors.TRANSIENT,),
             **policy_kwargs):
    """Decorator / wrapper factory over :func:`call_with_retry` — the
    "small ``retrying(max_attempts, backoff, timeout)`` helper" the
    data layer wraps file opens in::

        loader = retrying(max_attempts=3, backoff_base=0.05)(open_part)
        part = loader(path)

    Keyword shorthands (``max_attempts=``, ``backoff_base=``,
    ``attempt_timeout=``, …) build the :class:`RetryPolicy` when one is
    not passed explicitly.
    """
    if policy is None:
        policy = RetryPolicy(**policy_kwargs)
    elif policy_kwargs:
        policy = dataclasses.replace(policy, **policy_kwargs)

    def wrap(fn: Callable) -> Callable:
        name = label or getattr(fn, "__name__", "call")

        def wrapped(*args, **kwargs):
            return call_with_retry(
                fn, *args, policy=policy, label=name,
                retry_kinds=retry_kinds, telemetry=telemetry,
                on_retry=on_retry, **kwargs)

        wrapped.__name__ = f"retrying_{name}"
        wrapped.__wrapped__ = fn
        return wrapped

    return wrap
