"""The crash flight recorder: the last seconds of telemetry, always on.

A copy of ``spark_agd_tpu/obs/flight.py``, which needs only
the standard library and its sibling copy ``sinks``
(a dump frames its records through ``resilience.journal``, which
comes with the observability slice);
``tests/test_torch_obs.py`` holds everything after this docstring
to the original, line for line.

A post-mortem's first question is "what was this host doing just before
it died?" — and the JSONL stream's answer is whatever the stdio buffer
happened to flush, while the journal (``resilience.journal``) records
only DECISIONS by design.  The flight recorder fills the gap the way
an aircraft FDR does: a bounded in-memory ring of the last N telemetry
records of EVERY kind (cheap: one deque append per record, no I/O),
flushed to a CRC-framed dump file only when something goes wrong.

- :class:`FlightRecorder` is an ``obs.sinks.Sink`` — ``Telemetry``
  attaches one by default (``flight=False`` opts out), so the ring is
  populated on every telemetered run with zero configuration;
- :meth:`FlightRecorder.dump` writes the ring as ``AGDFDR01`` followed
  by the exact per-record frames of ``resilience.journal`` (``<II``
  length+CRC32 over canonical JSON) — so a dump torn by the very crash
  it documents replays bit-identically up to the torn tail, with the
  same stop conditions the journal already proves;
- :func:`dump_on_failure` is the one-point wiring for failure paths:
  the supervisor (``SupervisorGivingUp``), the degrade layer
  (``QuorumLost``), and the serving queue (``ServeOverloaded``) call it
  with a reason; it finds the run's recorder, dumps (rate-limited per
  reason — an overload storm must not write a dump per rejected
  request), and puts the dump itself on record as a ``recovery``
  record with ``action="flight_dump"``.

Dumps only happen when a destination is known: ``Telemetry(flight_dir=
...)`` (the drills set it) or an explicit ``path``.  Without one,
``dump_on_failure`` is a no-op — the ring still exists for programmatic
inspection (:meth:`FlightRecorder.snapshot`), but no file appears
behind the operator's back.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .sinks import Sink

MAGIC = b"AGDFDR01"
DEFAULT_CAPACITY = 512

# a second dump for the same reason within this window is suppressed
# (an overload storm calls dump_on_failure per rejection)
DEFAULT_MIN_INTERVAL_S = 5.0


def _journal():
    """The framing provider (``resilience.journal``), imported lazily:
    ``obs`` must stay importable without dragging the resilience
    package in at module load."""
    from ..resilience import journal

    return journal


class FlightRecorder(Sink):
    """See module docstring.  ``capacity`` bounds host memory (records
    are plain dicts — hundreds of bytes each); ``directory`` is where
    :meth:`dump` lands when no explicit path is given."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, *,
                 directory: Optional[str] = None,
                 min_dump_interval_s: float = DEFAULT_MIN_INTERVAL_S,
                 clock=time.monotonic):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.directory = directory
        self.min_dump_interval_s = float(min_dump_interval_s)
        self._clock = clock
        self._ring: deque = deque(maxlen=self.capacity)
        # emit() appends from every telemetered thread while dump()
        # iterates — an unguarded deque raises "mutated during
        # iteration" exactly when a failure path dumps under live load
        self._ring_lock = threading.Lock()
        self._seen = 0
        self._last_dump_t: Dict[str, float] = {}
        self._dump_counter = 0
        self.dumps: List[str] = []     # every path written, in order
        self.written: List[bytes] = []  # the LAST dump's payload bytes
        #                                 (bit-identity assertions)

    # -- the sink half ----------------------------------------------------
    def emit(self, record: dict) -> None:
        with self._ring_lock:
            self._seen += 1
            self._ring.append(dict(record))

    @property
    def seen(self) -> int:
        """Records observed over the recorder's lifetime (>= ring
        length once the ring has wrapped)."""
        return self._seen

    def snapshot(self) -> List[dict]:
        """The ring's current contents, oldest first."""
        with self._ring_lock:
            return [dict(r) for r in self._ring]

    # -- the dump half ----------------------------------------------------
    def dump(self, path: Optional[str] = None, *,
             reason: Optional[str] = None,
             force: bool = False) -> Optional[str]:
        """Write the ring to ``path`` (or a fresh file in
        ``directory``) and return the path — or None when there is no
        destination, the ring is empty, or the per-reason rate limit
        suppressed a repeat.  The write is tempfile+rename atomic: a
        half-written dump never shadows an older complete one."""
        if not self._ring:
            return None
        key = reason or "manual"
        now = self._clock()
        last = self._last_dump_t.get(key)
        if not force and last is not None \
                and now - last < self.min_dump_interval_s:
            return None
        if path is None:
            if self.directory is None:
                return None
            os.makedirs(self.directory, exist_ok=True)
            self._dump_counter += 1
            path = os.path.join(
                self.directory,
                f"flight-{key}-{os.getpid()}-{self._dump_counter}.bin")
        else:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
        journal = _journal()
        with self._ring_lock:
            ring = list(self._ring)
        frames = [journal.encode_record(rec) for rec in ring]
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            for frame in frames:
                f.write(frame)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._last_dump_t[key] = now
        self.dumps.append(path)
        # the payload bytes (frame minus the 8-byte header) this dump
        # committed — what a replay must reproduce bit-identically
        self.written = [fr[journal.FRAME_SIZE:] for fr in frames]
        return path


def load_dump(path: str):
    """Replay one flight dump — the journal's torn-tail-tolerant walk
    under the flight magic.  Returns a
    ``resilience.journal.JournalReplay``: everything before the first
    torn frame / short payload / CRC mismatch, plus how many bytes of
    tail were unrecoverable and why."""
    return _journal().replay(path, magic=MAGIC)


def find_recorder(telemetry) -> Optional[FlightRecorder]:
    """The recorder attached to ``telemetry``'s bus (None when the run
    opted out)."""
    if telemetry is None:
        return None
    for sink in getattr(telemetry, "bus").sinks:
        if isinstance(sink, FlightRecorder):
            return sink
    return None


def dump_on_failure(telemetry, reason: str, *,
                    path: Optional[str] = None) -> Optional[str]:
    """The failure-path hook: dump ``telemetry``'s flight ring tagged
    with ``reason`` and put the dump on record.  Silently a no-op when
    there is no telemetry, no recorder, no destination, or the
    per-reason rate limit held — a failure path must never fail again
    inside its own post-mortem hook."""
    recorder = find_recorder(telemetry)
    if recorder is None:
        return None
    try:
        out = recorder.dump(path, reason=reason)
    except OSError:
        # a dying filesystem must not mask the real failure
        return None
    if out is not None:
        telemetry.recovery(action="flight_dump", path=out,
                           reason=str(reason), source="flight")
    return out
