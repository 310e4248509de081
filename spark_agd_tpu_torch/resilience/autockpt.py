"""Preemption-safe auto-checkpointing over ``utils.checkpoint``.

Counterpart of ``spark_agd_tpu/resilience/autockpt.py``.
``utils.checkpoint.run_agd_checkpointed`` saves at fixed segment
boundaries; this module adds what preemptible capacity needs:

- **cadence**: save every N accumulated iterations and/or every T
  seconds, whichever comes first (``force=True`` always saves);
- **retention**: the last K generations survive as a ``.bak`` chain
  (``path``, ``path.bak``, ``path.bak2``, ...) rotated by renames before
  each write, so one torn write never erases the run;
- **corruption-tolerant load**: :meth:`AutoCheckpointer.load` walks the
  chain newest to oldest and skips corrupt generations;
- **preemption flush**: :meth:`AutoCheckpointer.install_signal_handlers`
  hooks SIGTERM/SIGINT; on delivery the last state handed to
  :meth:`AutoCheckpointer.update` is written and
  :class:`~spark_agd_tpu_torch.resilience.errors.Preempted` is raised
  in the main thread, so drivers unwind and a rerun of the same call
  resumes from the flushed carry.

The carry is copied to the host in :meth:`AutoCheckpointer.update`, at
the segment boundary (2 × D floats, or 2 × K × D for the lanes), so the
signal handler only writes a file: it never waits on the card or copies
from it.  ``copy_seconds`` and ``write_seconds`` keep each copy's and
each write's wall time.
"""

from __future__ import annotations

import os
import signal as signal_lib
import threading
import time
from typing import Any, Optional

import numpy as np

from ..utils import checkpoint as ckpt
from .errors import Preempted


def generation_paths(path: str, keep: int) -> list:
    """Newest-first retention chain: ``path``, ``path.bak``,
    ``path.bak2``, ... (``keep`` entries in all)."""
    out = [path]
    for i in range(1, keep):
        out.append(path + (".bak" if i == 1 else f".bak{i}"))
    return out


class AutoCheckpointer:
    """See the module docstring.  ``telemetry`` (``obs.Telemetry``,
    optional) receives one ``recovery`` record for each checkpoint
    written, generation skipped, resume and preemption flush, as the
    JAX package's does.

    :meth:`update` stores the latest state (its host copy) before it
    tests the cadence, so a signal at any point flushes a state no older
    than the last completed segment, and the atomic write
    (``utils.checkpoint.atomic_savez``) makes the flush itself
    kill-safe.  One lock serialises the held state and every write, so
    an attempt that the watchdog gave up on and still commits a stream
    cursor cannot interleave its rotation with another save (the lock
    is re-entrant: the signal handler runs on the thread it
    interrupts)."""

    def __init__(self, path: str, *,
                 every_iters: Optional[int] = None,
                 every_seconds: Optional[float] = None,
                 keep: int = 2,
                 fingerprint: Optional[str] = None,
                 telemetry=None,
                 clock=time.monotonic):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        if every_iters is not None and every_iters < 1:
            raise ValueError("every_iters must be >= 1")
        if every_seconds is not None and every_seconds <= 0:
            raise ValueError("every_seconds must be > 0")
        self.path = path
        self.every_iters = every_iters
        self.every_seconds = every_seconds
        self.keep = keep
        self.fingerprint = fingerprint
        self.telemetry = telemetry
        self._clock = clock
        self._last_saved_iters: Optional[int] = None
        self._last_saved_t: Optional[float] = None
        self._latest = None  # (host warm, hist, converged, aborted)
        self._prev_handlers = None
        self._lock = threading.RLock()
        self.saves = 0
        self.preempted = False
        # wall seconds of each update's host copy and each file write
        self.copy_seconds: list = []
        self.write_seconds: list = []
        # mid-epoch rider state (data.streaming.StreamCheckpoint): the
        # ``stream_*`` cursor entries the NEXT save carries, the extras
        # that rode the checkpoint :meth:`load` returned, and the hook
        # told about boundary commits and loaded extras
        self._extra = None
        self.loaded_extras = {}
        self.stream_hook = None

    # -- cadence ----------------------------------------------------------
    def _due(self, prior_iters: int) -> bool:
        if self._last_saved_iters is None:
            return True  # the first state seen is generation zero
        if (self.every_iters is not None and
                prior_iters - self._last_saved_iters >= self.every_iters):
            return True
        if (self.every_seconds is not None and
                self._clock() - self._last_saved_t >= self.every_seconds):
            return True
        return False

    def update(self, warm, hist=None, *, converged: bool = False,
               aborted: bool = False, force: bool = False) -> bool:
        """Hand the checkpointer the newest carry (copied to the host
        here); writes when the cadence is due (or ``force``).  Returns
        True when a file was written."""
        t0 = time.perf_counter()
        held = ckpt.host_warm(warm)
        self.copy_seconds.append(time.perf_counter() - t0)
        if self.stream_hook is not None:
            self.stream_hook.on_boundary()
        with self._lock:
            self._latest = (held,
                            None if hist is None else np.array(hist),
                            bool(converged), bool(aborted))
            # a boundary commit supersedes any mid-epoch cursor: the
            # carry is exact here, so the next save must not claim a
            # partial pass
            self._extra = None
            if not (force or self._due(held.prior_iters)):
                return False
            self._save(*self._latest)
            return True

    def begin_attempt(self) -> None:
        """A supervised attempt starts on the calling thread from the
        last boundary carry: the stream hook (if any) rewinds its pass
        counter and takes the thread as its only committer."""
        hook = getattr(self.stream_hook, "on_attempt", None)
        if hook is not None:
            hook()

    def update_stream(self, extra: dict) -> bool:
        """Mid-epoch commit: write the last boundary carry PLUS the
        rider entries (the streaming layer's ``stream_*`` cursor), so a
        preemption after it resumes from the boundary and replays
        forward to the cursor instead of restarting the pass.  False
        (nothing written) before the first boundary state."""
        with self._lock:
            if self._latest is None:
                return False
            self._extra = dict(extra)
            self._save(*self._latest, action="checkpoint")
            return True

    def flush(self, *, reason: str = "flush") -> bool:
        """Write the latest known state (False when none was seen);
        ``reason`` names the action of its ``recovery`` record."""
        with self._lock:
            if self._latest is None:
                return False
            self._save(*self._latest, action=reason)
            return True

    def _save(self, warm, hist, converged, aborted, *,
              action: str = "checkpoint") -> None:
        t0 = time.perf_counter()
        self._rotate()
        ckpt.save_checkpoint(
            self.path, warm, hist, converged=converged, aborted=aborted,
            fingerprint=self.fingerprint, extra=self._extra)
        self.write_seconds.append(time.perf_counter() - t0)
        self._last_saved_iters = int(warm.prior_iters)
        self._last_saved_t = self._clock()
        self.saves += 1
        if self.telemetry is not None:
            self.telemetry.recovery(
                action=action, path=self.path,
                to_iter=int(warm.prior_iters), source="autockpt")

    def _rotate(self) -> None:
        """Shift the retention chain one slot (the oldest generation
        falls off); each shift is a rename, so the chain never holds a
        half-copied file."""
        gens = generation_paths(self.path, self.keep)
        if os.path.exists(gens[-1]) and self.keep > 1:
            os.unlink(gens[-1])
        for newer, older in zip(reversed(gens[:-1]), reversed(gens[1:])):
            if os.path.exists(newer) and self.keep > 1:
                os.replace(newer, older)

    # -- corruption-tolerant load -----------------------------------------
    def load(self, template: Any) -> Optional[ckpt.LoadedCheckpoint]:
        """Walk the generation chain newest to oldest; return the first
        loadable checkpoint (fingerprint-checked, its leaves on
        ``template``'s device), skipping corrupt generations with a
        warning and a ``recovery`` record each.  None when no generation
        exists or survives: a chain of corrupt files resumes from
        scratch."""
        found_any = False
        for gen, path in enumerate(generation_paths(self.path, self.keep)):
            if not os.path.exists(path):
                continue
            found_any = True
            try:
                loaded = ckpt.load_checkpoint(
                    path, template, expect_fingerprint=self.fingerprint,
                    fallback_to_bak=False)
            except ckpt.CheckpointCorruptError as e:
                ckpt.logger.warning("skipping corrupt checkpoint "
                                    "generation %d: %s", gen, e)
                if self.telemetry is not None:
                    self.telemetry.recovery(
                        action="checkpoint_fallback", path=path,
                        generation=gen, reason=str(e), source="autockpt")
                continue
            if loaded is not None:
                if gen > 0 and self.telemetry is not None:
                    self.telemetry.recovery(
                        action="resume", path=path, generation=gen,
                        to_iter=int(loaded.warm.prior_iters),
                        source="autockpt")
                # seed the cadence so the next segment does not save
                # again what was just read
                self._last_saved_iters = int(loaded.warm.prior_iters)
                self._last_saved_t = self._clock()
                self.loaded_extras = dict(loaded.extras or {})
                if self.stream_hook is not None and self.loaded_extras:
                    self.stream_hook.adopt(self.loaded_extras)
                return loaded
        if found_any:
            ckpt.logger.warning(
                "every checkpoint generation at %r was corrupt; "
                "starting from scratch", self.path)
        return None

    # -- preemption -------------------------------------------------------
    def _on_signal(self, signum, frame):
        self.preempted = True
        self.flush(reason="preemption_flush")
        raise Preempted(signum)

    def install_signal_handlers(self, signals=(signal_lib.SIGTERM,
                                               signal_lib.SIGINT)):
        """Install the flush-then-``Preempted`` handler (main thread
        only: Python delivers signals there).  Idempotent; pair with
        :meth:`uninstall_signal_handlers` (or use the instance as a
        context manager)."""
        if self._prev_handlers is not None:
            return
        self._prev_handlers = {}
        for s in signals:
            self._prev_handlers[s] = signal_lib.signal(s, self._on_signal)

    def uninstall_signal_handlers(self):
        if self._prev_handlers is None:
            return
        for s, h in self._prev_handlers.items():
            signal_lib.signal(s, h)
        self._prev_handlers = None

    def __enter__(self):
        self.install_signal_handlers()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.uninstall_signal_handlers()
        return False
