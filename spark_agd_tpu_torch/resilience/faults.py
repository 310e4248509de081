"""Deterministic, seedable fault injection: the harness that proves the
recovery machinery works.

Counterpart of ``spark_agd_tpu/resilience/faults.py``.  Every fault is
scripted (it fires at an exact iteration or call count), one-shot (it
fires once and disarms, so the retried attempt succeeds: a
permanently poisoned smooth would look FATAL, not TRANSIENT) and seeded
where it draws bytes.

- :func:`poison_smooth`: a smooth whose loss and gradient evaluate
  non-finite, which drives the NUMERIC rollback path.
- :class:`FaultScript`: faults the supervisor consults at segment
  boundaries: a simulated device loss (``device_loss_at_iter``), NaN
  poisoning of the next segment (``nan_at_iter``), a self-delivered
  SIGTERM (``sigterm_at_iter``) that exercises the preemption flush, and
  a self-delivered SIGKILL (``sigkill_at_iter``), which nothing flushes.
- :func:`truncate_file` / :func:`scramble_file`: corrupt a checkpoint on
  disk, which drives the ``.bak`` generation fallback.
- :func:`flaky`: a callable that fails its first N calls with an IO
  error, which drives the ingest retry path.

Sequences of faults against one run are ``resilience.chaos``'s job.  A
``FaultScript`` fires at the first segment boundary at or after its
iteration, so pick ``segment_iters`` to make the scripted iterations
boundaries where exactness matters.
"""

from __future__ import annotations

import os
import signal as signal_lib
import time
from typing import Callable, Optional

import numpy as np

from ..core import tvec
from .errors import SimulatedDeviceLoss  # noqa: F401  (re-export)


def poison_smooth(smooth: Callable, mode: str = "nan") -> Callable:
    """A smooth returning non-finite loss AND gradient (the poison is a
    multiplicative constant applied leafwise, so it works on any weight
    tree and device)."""
    if mode == "nan":
        bad = float("nan")
    elif mode == "inf":
        bad = float("inf")
    else:
        raise ValueError(f"unknown poison mode {mode!r}: 'nan' | 'inf'")

    def poisoned(w):
        loss, grad = smooth(w)
        return loss * bad, tvec.tmap(lambda g: g * bad, grad)

    return poisoned


class FaultScript:
    """Iteration-scripted one-shot faults, consulted by the supervisor.

    Each ``*_at_iter`` arms one fault that fires at the first segment
    boundary whose global iteration count is >= the scripted value,
    then disarms.  ``fired`` records what fired and where, so a drill
    can assert the script actually executed.
    """

    def __init__(self, *, device_loss_at_iter: Optional[int] = None,
                 nan_at_iter: Optional[int] = None,
                 sigterm_at_iter: Optional[int] = None,
                 sigkill_at_iter: Optional[int] = None,
                 signum: int = signal_lib.SIGTERM):
        self._device_loss_at = device_loss_at_iter
        self._nan_at = nan_at_iter
        self._sigterm_at = sigterm_at_iter
        self._sigkill_at = sigkill_at_iter
        self._signum = signum
        self.fired: list = []  # (fault_name, global_iter) in fire order

    def _take(self, attr: str, global_iter: int) -> bool:
        at = getattr(self, attr)
        if at is not None and global_iter >= at:
            setattr(self, attr, None)  # one-shot
            return True
        return False

    # -- hooks the supervisor calls ---------------------------------------
    def before_segment(self, global_iter: int) -> None:
        """May raise / signal.  Called before each segment launches with
        the iterations completed so far."""
        if self._take("_sigkill_at", global_iter):
            # the HOST-DEATH fault: SIGKILL cannot be caught, so there
            # is no preemption flush and no unwind.  fired is appended
            # first only for the (untestable) case the kill fails.
            self.fired.append(("sigkill", global_iter))
            os.kill(os.getpid(), signal_lib.SIGKILL)
        if self._take("_sigterm_at", global_iter):
            self.fired.append(("sigterm", global_iter))
            signal_lib.raise_signal(self._signum)
            # the Python-level handler runs at the next bytecode
            # boundary; give it one (the AutoCheckpointer handler
            # raises Preempted from here)
            time.sleep(0)
        if self._take("_device_loss_at", global_iter):
            self.fired.append(("device_loss", global_iter))
            raise SimulatedDeviceLoss(
                f"injected device loss at iteration {global_iter}")

    def take_poison(self, global_iter: int) -> bool:
        """True exactly once, for the segment that should evaluate
        non-finite."""
        if self._take("_nan_at", global_iter):
            self.fired.append(("nan", global_iter))
            return True
        return False

    @property
    def exhausted(self) -> bool:
        return (self._device_loss_at is None and self._nan_at is None
                and self._sigterm_at is None
                and self._sigkill_at is None)


def truncate_file(path: str, keep_fraction: float = 0.5,
                  keep_bytes: Optional[int] = None) -> int:
    """Byte-truncate ``path`` in place (the classic kill-mid-write /
    torn-volume artifact a checkpoint loader must survive).  Returns
    the new size."""
    size = os.path.getsize(path)
    keep = (int(keep_bytes) if keep_bytes is not None
            else int(size * keep_fraction))
    keep = max(0, min(size - 1, keep))  # strictly smaller: truncation
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep


def scramble_file(path: str, seed: int = 0,
                  n_bytes: Optional[int] = None,
                  offset: int = 0) -> None:
    """Overwrite bytes of ``path`` with seeded garbage — corruption
    that keeps the original length (a bad sector, not a truncation).
    ``offset`` places the bad sector (default 0: the head, which kills
    npz/zip directories outright; a mid-file offset is the journal
    bit-flip case — everything before it must still replay)."""
    rng = np.random.default_rng(seed)
    size = os.path.getsize(path)
    offset = max(0, min(int(offset), size))
    n = (size - offset) if n_bytes is None else min(n_bytes,
                                                    size - offset)
    with open(path, "r+b") as f:
        f.seek(offset)
        f.write(rng.integers(0, 256, n, dtype=np.uint8).tobytes())


def flaky(fn: Callable, fail_times: int, *,
          exc: Callable[[str], Exception] = OSError,
          delay_s: float = 0.0,
          sleep: Callable[[float], None] = time.sleep) -> Callable:
    """``fn`` that raises ``exc`` on its first ``fail_times`` calls
    (after ``delay_s`` — a slow-then-dead read), then behaves normally.
    Deterministic: the failure count is the only state.  The standard
    stand-in for a flaky ingest source in tests and drills."""
    state = {"calls": 0}

    def wrapped(*args, **kwargs):
        state["calls"] += 1
        if state["calls"] <= fail_times:
            if delay_s:
                sleep(delay_s)
            raise exc(f"injected IO failure "
                      f"{state['calls']}/{fail_times} in "
                      f"{getattr(fn, '__name__', 'call')}")
        return fn(*args, **kwargs)

    wrapped.calls = lambda: state["calls"]
    return wrapped
