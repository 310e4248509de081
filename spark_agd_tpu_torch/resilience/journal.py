"""The crash-safe recovery journal — an append-only, CRC-per-record WAL
of every recovery DECISION a run makes.

A copy of ``spark_agd_tpu/resilience/journal.py``, which needs only
the standard library and its sibling copy ``obs/sinks``;
``tests/test_torch_logging.py`` holds everything after this docstring
to the original, line for line.

The attempt ledger (``SupervisorGivingUp.ledger``) dies with the
process, and the JSONL telemetry stream is line-buffered prose — after
a SIGKILL its tail is whatever the stdio buffer happened to flush.
Post-mortems and exactly-once accounting need something stronger: a log
that (a) survives any kill at any byte, (b) detects its own torn tail
instead of replaying garbage, and (c) continues across resumes so one
file tells the whole multi-attempt story.  This module is that log:

- **Framing**: an 8-byte file header (``AGDWAL01``), then per record an
  8-byte frame ``<II`` (payload length, payload CRC32) followed by the
  payload — one canonical JSON object (``sort_keys=True``) carrying a
  monotonically increasing ``seq``.  Every append is flushed (and
  optionally fsynced) immediately.
- **Torn-tail tolerance**: :func:`replay` walks records until the first
  incomplete frame, short payload, CRC mismatch, or unparseable JSON —
  everything before that point is returned intact, everything after is
  the torn tail (a kill mid-append, a scrambled sector).  Opening a
  :class:`Journal` at an existing path replays, TRUNCATES the torn tail
  in place (the repair), and continues ``seq`` from the last committed
  record — so exactly-once accounting holds across any number of
  resumes.
- **Wiring**: :class:`JournalSink` is an ``obs.sinks.Sink`` — attach it
  to the run's ``Telemetry`` next to the JSONL sink and every decision
  record (``attempt`` / ``recovery`` / ``chaos`` / ``degraded`` /
  ``journal_replay``) the supervisor, the checkpointers
  (``AutoCheckpointer`` / ``DistributedCheckpointer``), the host
  monitor, and the chaos harness emit lands in the journal in emission
  order.  Replaying the journal reconstructs the exact decision
  sequence bit-identically (the drill asserts payload-byte equality).

``segment_accounting`` derives the exactly-once iteration census from a
replayed record list: each segment is counted once by its ``start_iter``
with the LAST occurrence winning — a segment re-run after a rollback or
a checkpoint fallback supersedes, never double-counts.

Deliberately stdlib-only (no jax, no numpy at import): a monitor
process can replay a journal without a backend.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from ..obs.sinks import Sink, _jsonable

MAGIC = b"AGDWAL01"
_FRAME = struct.Struct("<II")  # (payload length, payload CRC32)
FRAME_SIZE = _FRAME.size  # bytes of frame header before each payload

# a frame claiming more than this is torn/garbage, not a real record
MAX_RECORD_BYTES = 1 << 26

# the record kinds that are DECISIONS (what JournalSink keeps by
# default) — the high-rate streams (iteration/span/metrics/heartbeat)
# stay in the JSONL where volume is cheap
DECISION_KINDS = ("attempt", "recovery", "chaos", "degraded",
                  "journal_replay")


class JournalReplay(NamedTuple):
    """What :func:`replay` recovered from one journal file."""

    records: List[dict]     # every committed record, in append order
    payloads: List[bytes]   # the exact payload bytes (bit-identity)
    valid_bytes: int        # offset of the first torn byte (= file size
    #                         when the journal is clean)
    torn_bytes: int         # bytes dropped past valid_bytes
    reason: Optional[str]   # why replay stopped early; None when clean

    @property
    def last_seq(self) -> int:
        """Highest committed ``seq`` (-1 for an empty journal)."""
        if not self.records:
            return -1
        return max(int(r.get("seq", -1)) for r in self.records)


def _encode(record: dict) -> bytes:
    payload = json.dumps(record, sort_keys=True,
                         default=_jsonable).encode("utf-8")
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def encode_record(record: dict) -> bytes:
    """One record's frame (header + canonical-JSON payload) — the
    framing shared with the flight recorder (``obs.flight``), which
    writes the same frames under its own magic."""
    return _encode(record)


def replay(path: str, *, magic: bytes = MAGIC) -> JournalReplay:
    """Recover every committed record from ``path`` — see the module
    docstring for the stop conditions.  A missing file replays empty
    and clean; a file whose header is damaged replays empty with the
    reason (nothing after an unidentifiable header can be trusted).
    ``magic`` selects the file family: the journal's own header by
    default, ``obs.flight.MAGIC`` when replaying a flight-recorder
    dump (same frames, different producer)."""
    if not os.path.exists(path):
        return JournalReplay([], [], 0, 0, None)
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < len(magic):
        return JournalReplay([], [], 0, len(blob),
                             "torn header" if blob else None)
    if blob[:len(magic)] != magic:
        return JournalReplay([], [], 0, len(blob),
                             "bad magic (not a journal, or its header "
                             "was overwritten)")
    records: List[dict] = []
    payloads: List[bytes] = []
    off = len(magic)
    reason = None
    while off < len(blob):
        if off + _FRAME.size > len(blob):
            reason = f"torn frame at byte {off}"
            break
        length, crc = _FRAME.unpack_from(blob, off)
        if length > MAX_RECORD_BYTES:
            reason = (f"frame at byte {off} claims {length} bytes "
                      "(corrupt length)")
            break
        start = off + _FRAME.size
        payload = blob[start:start + length]
        if len(payload) < length:
            reason = f"torn payload at byte {off}"
            break
        if zlib.crc32(payload) != crc:
            reason = (f"CRC mismatch at record {len(records)} "
                      f"(byte {off})")
            break
        try:
            rec = json.loads(payload.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            reason = (f"unparseable payload at record {len(records)} "
                      f"(byte {off}): {e}")
            break
        if not isinstance(rec, dict):
            reason = (f"non-object payload at record {len(records)} "
                      f"(byte {off})")
            break
        records.append(rec)
        payloads.append(payload)
        off = start + length
    return JournalReplay(records, payloads, off, len(blob) - off, reason)


class Journal:
    """One run's decision WAL — see the module docstring.

    Opening an existing path replays it, truncates any torn tail in
    place, and continues ``seq`` from the last committed record
    (``repair=False`` opens for inspection without touching the bytes —
    appends to a torn journal are then unreachable on replay, so only
    repaired journals should be written to).  The replay summary is kept
    on :attr:`replay_summary` — emit it through
    ``Telemetry.journal_replay(**journal.replay_summary)`` (or pass
    ``telemetry=`` here) so the resume decision is itself on record.

    ``fsync=True`` fsyncs every append — required when the writer may
    be SIGKILLed (the chaos drill's children); the default flush-only
    append survives any Python-level death.

    :attr:`written` mirrors the exact payload bytes appended by THIS
    object, so a driver can assert disk replay is bit-identical to what
    the live run decided.
    """

    def __init__(self, path: str, *, fsync: bool = False,
                 repair: bool = True, telemetry=None):
        self.path = path
        self.fsync = bool(fsync)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        rep = replay(path)
        self.recovered: List[dict] = rep.records
        repaired = False
        if rep.torn_bytes and repair:
            with open(path, "r+b") as f:
                f.truncate(rep.valid_bytes)
            repaired = True
        self._next_seq = rep.last_seq + 1
        self.replay_summary = {
            "records": len(rep.records), "path": path,
            "torn_bytes": int(rep.torn_bytes),
            "last_seq": int(rep.last_seq), "repaired": repaired,
            "reason": rep.reason,
        }
        self.written: List[bytes] = []
        new = not os.path.exists(path) or os.path.getsize(path) == 0
        self._f = open(path, "ab")
        if new:
            self._f.write(MAGIC)
            self._f.flush()
        if telemetry is not None:
            telemetry.journal_replay(**self.replay_summary)

    @property
    def next_seq(self) -> int:
        return self._next_seq

    def append(self, record: dict) -> dict:
        """Append one record (a COPY, stamped with the next ``seq``),
        flush, and return the stamped copy."""
        rec = dict(record)
        rec["seq"] = self._next_seq
        frame = _encode(rec)
        self._f.write(frame)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._next_seq += 1
        self.written.append(frame[_FRAME.size:])
        return rec

    def flush(self) -> None:
        if not self._f.closed:
            self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


class JournalSink(Sink):
    """Telemetry sink writing every decision record through a
    :class:`Journal` — the one-point wiring that makes the supervisor,
    both checkpointers, the host monitor, and the chaos harness journal
    their decisions without any of them knowing the journal exists.
    ``kinds=None`` journals everything (including the per-iteration
    stream — only sensible for tiny runs)."""

    def __init__(self, journal: Journal,
                 kinds: Optional[Sequence[str]] = DECISION_KINDS):
        self.journal = journal
        self.kinds = None if kinds is None else frozenset(kinds)

    def emit(self, record: dict) -> None:
        if self.kinds is not None and record.get("kind") not in self.kinds:
            return
        self.journal.append(record)

    def flush(self) -> None:
        self.journal.flush()

    def close(self) -> None:
        self.journal.close()


def decision_sequence(records: Sequence[dict]) -> List[Tuple]:
    """The compact, order-preserving decision tuple list of a record
    stream — the thing two replays (or a replay and a live mirror) are
    compared on.  Non-decision kinds are skipped."""
    out: List[Tuple] = []
    for r in records:
        kind = r.get("kind")
        if kind == "attempt":
            out.append(("attempt", r.get("outcome"), r.get("start_iter"),
                        r.get("iters")))
        elif kind == "recovery":
            out.append(("recovery", r.get("action"), r.get("from_iter"),
                        r.get("to_iter"), r.get("generation")))
        elif kind == "chaos":
            out.append(("chaos", r.get("fault"), r.get("at_iter"),
                        r.get("process")))
        elif kind == "degraded":
            out.append(("degraded", r.get("surviving"),
                        r.get("saved_process_count"), r.get("to_iter")))
        elif kind == "journal_replay":
            out.append(("journal_replay", r.get("records"),
                        r.get("torn_bytes")))
    return out


def segment_accounting(records: Sequence[dict]) -> Dict[int, int]:
    """Exactly-once iteration census over a replayed record stream:
    ``{start_iter: iters}`` from the ``attempt`` records with outcome
    ``ok``, LAST occurrence winning — a segment re-executed after a
    rollback, retry, or checkpoint fallback supersedes its earlier
    entry instead of double-counting.  ``sum(values())`` is the number
    of iterations that COUNT across every resume in the journal."""
    out: Dict[int, int] = {}
    for r in records:
        if r.get("kind") != "attempt" or r.get("outcome") != "ok":
            continue
        start = r.get("start_iter")
        if start is None:
            continue
        out[int(start)] = int(r.get("iters", 0))
    return out
