"""Multi-host resilience: barrier-committed checkpoints, heartbeats,
host-loss detection, and elastic resume onto a changed topology.

Counterpart of ``spark_agd_tpu/resilience/distributed.py``, over
``torch.distributed`` (``parallel.multihost``).  Three pieces:

**Commit-barrier checkpointing** (:class:`DistributedCheckpointer`).
Each process atomically writes its own generation-stamped shard file
(``utils.checkpoint.atomic_savez``: tempfile and rename, a CRC32 an
entry); then every process exchanges ``(generation, file CRC32, size,
warm-state CRC32)`` through one small all-gather
(``multihost.process_allgather_int64``), which is also the barrier: it
returns only once every shard is on disk.  The primary process alone
then writes the ``manifest.json`` commit record (``resilience.manifest``,
a copy of the JAX package's).  A generation without its manifest does
not exist; a manifest whose shards are missing, torn or of another
generation is refused and the loader falls back one generation.  The
exchange also refuses a mixed-generation commit (processes out of
lockstep) and a replica-divergence commit (processes that disagree on
the replicated warm state).  The warm state's CRC runs over the host
copy that ``AutoCheckpointer.update`` takes at each boundary, and gives
the JAX package's CRC for the same carry, so a manifest written by
either package verifies in the other.

**Host health** (:class:`HeartbeatWriter` / :class:`HostMonitor`).
Every process atomically rewrites a small ``heartbeat.hNNN.json`` at
each segment boundary.  A monitor (any process that sees the directory:
a surviving peer between segments, or the launching parent) reads
staleness from the files and raises
:class:`~spark_agd_tpu_torch.resilience.errors.HostLost`, classified
TRANSIENT.  A process inside a collective against a dead peer cannot
poll: its collective fails (gloo sees the peer's socket close) or waits
until the group's timeout, so the parent that launched the group reads
the loss from the heartbeats and reaps what is left.

**Elastic resume** (:func:`load_for_topology`).  On the same process
count each process reads back its own shard's bytes (bit-identical by
construction); on another count the saved partition assignments and
row-sharded extras are gathered and re-split for the new topology
(partitions round-robin as ``data.ingest.local_partitions``, rows by
``parallel.multihost.local_rows_slice``), and the replicated
``AGDWarmState`` comes from the primary's shard.  The shard payload
names (``generation``, ``process_index``, ``process_count``,
``partitions``, ``rowstate::*``) are the JAX package's, so either
package resumes the other's sets.

``telemetry=`` gives the JAX package's records: ``HeartbeatWriter`` a
``heartbeat`` record a beat, ``HostMonitor`` a ``host_lost`` recovery
record, ``load_for_topology`` a ``checkpoint_fallback`` record a refused
generation and ``elastic_resume`` on a changed topology, and
``DistributedCheckpointer`` a causal ``ckpt_commit`` span around each
commit (``obs.trace``) holding the save's recovery record, and
``resume`` on a load onto the same topology.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import logging
import os
import re
import time
import zlib
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np

from ..parallel import multihost
from ..utils import checkpoint as ckpt
from . import manifest as manifest_lib
from .autockpt import AutoCheckpointer
from .errors import HostLost

logger = logging.getLogger("spark_agd_tpu_torch")

# npz entry prefix for row-sharded extras in a shard payload
ROWSTATE_PREFIX = "rowstate::"

_HEARTBEAT_RE = re.compile(r"^heartbeat\.h(\d{3})\.json$")


def _process_defaults(process_index, process_count) -> Tuple[int, int]:
    """Explicit values, else the process group's rank and size (0 and 1
    without a group)."""
    if process_index is None:
        process_index = multihost.process_index()
    if process_count is None:
        process_count = multihost.process_count()
    if not 0 <= int(process_index) < int(process_count):
        raise ValueError(
            f"process_index {process_index} out of range for "
            f"process_count {process_count}")
    return int(process_index), int(process_count)


def _default_exchange(row: np.ndarray) -> np.ndarray:
    """The commit barrier: one int64 all-gather across the group (the
    row itself, with no collective, in a single process)."""
    return multihost.process_allgather_int64(row)


def _warm_crc(warm) -> int:
    """CRC32 over the warm state's leaf bytes and scalars: the replica-
    divergence check exchanged at commit.  ``warm`` is the host copy
    (``utils.checkpoint.host_warm``); the payload is the JAX package's,
    so both packages give one CRC for one carry."""
    crc = 0
    payload = ckpt.warm_payload(warm)
    for name in sorted(payload):
        if name == "loss_history":
            continue  # histories may legitimately be rank-0-only
        crc = zlib.crc32(np.ascontiguousarray(payload[name]).tobytes(),
                         crc)
    return crc


class LoadedDistCheckpoint(NamedTuple):
    """What :func:`load_for_topology` returns: the first five fields of
    ``utils.checkpoint.LoadedCheckpoint`` (which the supervisor reads),
    plus the distributed bookkeeping."""

    warm: Any
    loss_history: np.ndarray
    converged: bool
    aborted: bool
    fingerprint: Optional[str]
    generation: int
    saved_process_count: int
    elastic: bool                       # topology changed on resume
    partitions: Optional[Tuple[str, ...]]  # THIS process's re-split files
    row_state: Dict[str, np.ndarray]    # THIS process's re-split rows
    # namespaced rider entries (the ``stream_*`` mid-epoch cursor), as
    # utils.checkpoint.LoadedCheckpoint.extras
    extras: Dict[str, np.ndarray] = {}


def _check_embedded_generation(path: str, entries: Dict[str, np.ndarray],
                               expect: int) -> None:
    if "generation" not in entries:
        raise ckpt.CheckpointCorruptError(
            path, KeyError("shard carries no generation id"))
    got = int(entries["generation"])
    if got != expect:
        raise ckpt.CheckpointCorruptError(
            path, ValueError(
                f"shard embeds generation {got}, manifest says "
                f"{expect} (mixed-generation set refused)"))


def _shard_partitions(entries: Dict[str, np.ndarray]) -> Optional[List[str]]:
    if "partitions" not in entries:
        return None
    return [str(x) for x in np.atleast_1d(entries["partitions"])]


def _shard_row_state(entries: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k[len(ROWSTATE_PREFIX):]: entries[k]
            for k in entries if k.startswith(ROWSTATE_PREFIX)}


def reshard_partitions(saved: Sequence[Sequence[str]],
                       process_index: int,
                       process_count: int) -> Tuple[str, ...]:
    """Re-split saved per-process partition assignments for a new
    topology: their union, then the sorted round-robin rule of
    ``data.ingest.local_partitions``, so an unchanged topology gets its
    assignment back and a changed one the assignment a fresh ingest
    would compute."""
    union = sorted({p for host in saved for p in host})
    return tuple(union[process_index::process_count])


def load_for_topology(
    directory: str,
    template: Any,
    *,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    fingerprint: Optional[str] = None,
    telemetry=None,
) -> Optional[LoadedDistCheckpoint]:
    """Load the newest verifiable generation for the given topology (see
    the module docstring), its leaves on ``template``'s devices.  Walks
    the committed generations newest to oldest, refusing (with a warning
    each) any whose manifest is unreadable, whose shard files fail the
    manifest's size or CRC32, whose npz entries fail their CRCs, or
    whose shards embed another generation than the manifest's.  None
    when nothing survives.  A fingerprint mismatch raises
    ``ValueError``: that is the wrong problem at a reused path, not
    corruption to fall back from.  With ``telemetry``, each refusal is a
    ``checkpoint_fallback`` recovery record and a resume onto another
    process count an ``elastic_resume`` one."""
    process_index, process_count = _process_defaults(process_index,
                                                     process_count)
    gens = manifest_lib.committed_generations(directory)
    for gen in gens:
        try:
            m = manifest_lib.load_manifest(directory, gen)
        except (ValueError, OSError) as e:
            _fallback(telemetry, directory, gen, f"manifest unreadable: {e}")
            continue
        problems = manifest_lib.verify_manifest(m, directory)
        if problems:
            _fallback(telemetry, directory, gen, "; ".join(problems))
            continue
        try:
            return _load_generation(directory, m, template,
                                    process_index, process_count,
                                    fingerprint, telemetry)
        except ckpt.CheckpointCorruptError as e:
            _fallback(telemetry, directory, gen, str(e))
            continue
    if gens:
        logger.warning(
            "every committed generation under %r failed verification; "
            "resuming from scratch", directory)
    return None


def _fallback(telemetry, directory: str, generation: int,
              reason: str) -> None:
    logger.warning("refusing checkpoint generation %d under %r: %s",
                   generation, directory, reason)
    if telemetry is not None:
        telemetry.recovery(action="checkpoint_fallback", path=directory,
                           generation=generation, reason=reason,
                           source="dist_ckpt")


def _load_generation(directory, m, template, process_index,
                     process_count, fingerprint, telemetry):
    elastic = (m.process_count != process_count)
    if not elastic:
        # unchanged topology: this process reads back exactly its own
        # shard's bytes, so the resume is bit-identical
        path = m.shard_path(directory, process_index)
        entries = ckpt.read_npz_entries(path)
        _check_embedded_generation(path, entries, m.generation)
        lc = ckpt.checkpoint_from_entries(
            path, ckpt._Entries(path, entries), template, fingerprint)
        return LoadedDistCheckpoint(
            *lc[:5], generation=m.generation,
            saved_process_count=m.process_count, elastic=False,
            partitions=(tuple(p) if (p := _shard_partitions(entries))
                        is not None else None),
            row_state=_shard_row_state(entries), extras=lc.extras)

    # changed topology: gather every process's shard, re-split
    per_host = []
    for s in sorted(m.shards, key=lambda s: s.process):
        path = os.path.join(directory, s.path)
        entries = ckpt.read_npz_entries(path)
        _check_embedded_generation(path, entries, m.generation)
        per_host.append((path, entries))
    path0, e0 = per_host[0]
    # the carry is replicated (the commit exchange verified every copy
    # byte-equal): the primary's is canonical
    lc = ckpt.checkpoint_from_entries(
        path0, ckpt._Entries(path0, e0), template, fingerprint)

    saved_parts = [p for _, e in per_host
                   if (p := _shard_partitions(e)) is not None]
    partitions = (reshard_partitions(saved_parts, process_index,
                                     process_count)
                  if saved_parts else None)

    names = sorted({k for _, e in per_host
                    for k in e if k.startswith(ROWSTATE_PREFIX)})
    row_state = {}
    for k in names:
        whole = np.concatenate(
            [e[k] for _, e in per_host if k in e], axis=0)
        row_state[k[len(ROWSTATE_PREFIX):]] = whole[
            multihost.local_rows_slice(whole.shape[0], process_index,
                                       process_count)]

    if telemetry is not None:
        telemetry.recovery(
            action="elastic_resume", path=directory,
            generation=m.generation,
            saved_process_count=m.process_count,
            process_count=process_count, process=process_index,
            to_iter=int(lc.warm.prior_iters), source="dist_ckpt")
    logger.warning(
        "elastic resume: generation %d was saved by %d processes, "
        "resuming as process %d/%d from iteration %d",
        m.generation, m.process_count, process_index, process_count,
        int(lc.warm.prior_iters))
    return LoadedDistCheckpoint(
        *lc[:5], generation=m.generation,
        saved_process_count=m.process_count, elastic=True,
        partitions=partitions, row_state=row_state, extras=lc.extras)


class DistributedCheckpointer(AutoCheckpointer):
    """The multi-process :class:`~spark_agd_tpu_torch.resilience.autockpt.
    AutoCheckpointer`: the same cadence (``every_iters`` /
    ``every_seconds``) and supervisor interface (``load`` / ``update`` /
    signal handlers), but each save is a barrier-committed generation in
    ``directory`` (module docstring) and ``load`` is topology-elastic.

    ``partitions`` (this process's data-partition files, from
    ``data.ingest.local_partitions``) and ``row_state`` (row-sharded
    arrays of this process) ride in every shard, so a resume on another
    process count can re-assign them.  ``mesh_shape`` is stamped into
    the manifest.  ``exchange`` (tests) replaces the all-gather barrier:
    it takes this process's int64 ``(generation, crc32, size,
    warm_crc)`` row and returns the ``(process_count, 4)`` stack once
    every process has given its row.

    Saves are collective: every process must call ``update``/``flush``
    the same number of times with the same cadence state, or the
    exchange waits until the group's timeout; the supervisor saves only
    at segment boundaries, where the processes are in lockstep.

    On one process (no group of several) the barrier has no peer, so a
    save takes the shard's payload on the caller's thread and a writer
    thread writes and commits it while the fit goes on: one generation
    in flight at most (the next save waits for it).  A forced
    ``update``, ``flush`` (the preemption flush too), ``load`` and
    :meth:`wait` return only once it is committed, and a failed write
    raises in the next of them.  A process killed hard loses the
    generation in flight, as if killed just before the boundary.  Over
    several processes the barrier is a collective on the fit's group,
    so the whole save runs on the caller's thread; so it does with
    ``telemetry``, whose records (the ``ckpt_commit`` span and, inside
    it, the save's recovery record) then land in the order the JAX
    package emits them.

    ``write_seconds`` keeps each shard write's wall time,
    ``commit_seconds`` each commit's (the exchange and, on the primary,
    the manifest write), and ``save_seconds`` the time each save held
    the caller."""

    def __init__(self, directory: str, *,
                 every_iters: Optional[int] = None,
                 every_seconds: Optional[float] = None,
                 keep: int = 2,
                 fingerprint: Optional[str] = None,
                 telemetry=None,
                 mesh_shape: Optional[Dict[str, int]] = None,
                 partitions: Optional[Sequence[str]] = None,
                 row_state: Optional[Dict[str, np.ndarray]] = None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 exchange: Optional[Callable] = None,
                 clock=time.monotonic):
        super().__init__(directory, every_iters=every_iters,
                         every_seconds=every_seconds, keep=keep,
                         fingerprint=fingerprint, telemetry=telemetry,
                         clock=clock)
        self.directory = directory
        self.mesh_shape = dict(mesh_shape) if mesh_shape else None
        self.partitions = (None if partitions is None
                           else [str(p) for p in partitions])
        self.row_state = dict(row_state or {})
        self.process_index, self.process_count = _process_defaults(
            process_index, process_count)
        self._exchange = exchange or _default_exchange
        self.commit_seconds: list = []
        self.save_seconds: list = []
        # one process: the commit goes to a writer thread (class
        # docstring), unless its records must keep their place
        self._writer = (concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="generation-commit")
            if self.process_count == 1 and multihost.process_count() <= 1
            and telemetry is None else None)
        self._pending = None
        latest = manifest_lib.committed_generations(directory)
        self._next_generation = (latest[0] + 1) if latest else 0

    # -- save: shard write, barrier, primary commit -----------------------
    def update(self, warm, hist=None, *, converged: bool = False,
               aborted: bool = False, force: bool = False) -> bool:
        saved = super().update(warm, hist, converged=converged,
                               aborted=aborted, force=force)
        if force:
            self.wait()
        return saved

    def flush(self, *, reason: str = "flush") -> bool:
        saved = super().flush(reason=reason)
        self.wait()
        return saved

    def wait(self) -> None:
        """Return once the generation in flight (one process) is
        committed; raise its write's or commit's failure."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def _save(self, warm, hist, converged, aborted, *,
              action: str = "checkpoint") -> None:
        t0 = time.perf_counter()
        self.wait()
        gen = self._next_generation
        payload = ckpt.warm_payload(
            warm, hist, converged=converged, aborted=aborted,
            fingerprint=self.fingerprint, extra=self._extra)
        payload["generation"] = np.asarray(gen)
        payload["process_index"] = np.asarray(self.process_index)
        payload["process_count"] = np.asarray(self.process_count)
        if self.partitions is not None:
            payload["partitions"] = np.asarray(self.partitions)
        for name, arr in self.row_state.items():
            # a copy where the write outlives the call
            payload[ROWSTATE_PREFIX + name] = (
                np.asarray(arr) if self._writer is None else np.array(arr))
        if self._writer is None:
            self._write_and_commit(warm, gen, payload, converged, aborted,
                                   action)
        else:
            self._pending = self._writer.submit(
                self._write_and_commit, warm, gen, payload, converged,
                aborted, action)
        self._next_generation = gen + 1
        self._last_saved_iters = int(warm.prior_iters)
        self._last_saved_t = self._clock()
        self.saves += 1
        self.save_seconds.append(time.perf_counter() - t0)

    def _write_and_commit(self, warm, gen, payload, converged, aborted,
                          action):
        t0 = time.perf_counter()
        shard_path = os.path.join(
            self.directory, manifest_lib.shard_name(gen, self.process_index))
        ckpt.atomic_savez(shard_path, payload)
        t1 = time.perf_counter()
        self.write_seconds.append(t1 - t0)
        # the commit barrier rides as one causal ``ckpt_commit`` span
        # (obs.trace), under the supervisor's run span
        commit_span = (self.telemetry.trace_span(
            "ckpt_commit", generation=int(gen),
            to_iter=int(warm.prior_iters))
            if self.telemetry is not None else contextlib.nullcontext())
        with commit_span:
            self._commit(warm, gen, shard_path, converged, aborted)
            if self.telemetry is not None:
                self.telemetry.recovery(
                    action=action, path=self.directory, generation=gen,
                    to_iter=int(warm.prior_iters),
                    process=self.process_index,
                    process_count=self.process_count, source="dist_ckpt")
        self.commit_seconds.append(time.perf_counter() - t1)

    def _commit(self, warm, gen, shard_path, converged, aborted):
        """The barrier and, on the primary, the manifest."""
        row = np.asarray(
            [gen, manifest_lib.crc32_file(shard_path),
             os.path.getsize(shard_path), _warm_crc(warm)], np.int64)
        gathered = self._exchange(row)  # the commit barrier
        gathered = np.asarray(gathered, np.int64).reshape(
            self.process_count, row.size)
        gens = gathered[:, 0]
        if not (gens == gen).all():
            raise RuntimeError(
                "mixed-generation commit refused: processes are trying to "
                f"commit generations {sorted(set(int(g) for g in gens))} "
                "— the job is out of lockstep; restart from the last "
                "committed manifest")
        warm_crcs = gathered[:, 3]
        if not (warm_crcs == warm_crcs[0]).all():
            raise RuntimeError(
                "replica divergence at checkpoint: the supposedly-"
                "replicated AGDWarmState differs across processes "
                f"(CRC32s {[hex(int(c)) for c in warm_crcs]}); refusing "
                "to commit a checkpoint that would hide it")

        if self.process_index == 0:
            shards = [manifest_lib.ShardEntry(
                path=manifest_lib.shard_name(gen, p), process=p,
                crc32=int(gathered[p, 1]), size=int(gathered[p, 2]))
                for p in range(self.process_count)]
            manifest_lib.write_manifest(self.directory, manifest_lib.Manifest(
                generation=gen, process_count=self.process_count,
                shards=shards, mesh_shape=self.mesh_shape,
                fingerprint=self.fingerprint, converged=bool(converged),
                aborted=bool(aborted),
                prior_iters=int(warm.prior_iters)))
            manifest_lib.gc_generations(self.directory, self.keep)

    # -- load: the newest verifiable generation, topology-elastic ---------
    def load(self, template: Any) -> Optional[LoadedDistCheckpoint]:
        self.wait()
        loaded = load_for_topology(
            self.directory, template,
            process_index=self.process_index,
            process_count=self.process_count,
            fingerprint=self.fingerprint, telemetry=self.telemetry)
        if loaded is not None:
            self._adopt(loaded)
            if self.stream_hook is not None and self.loaded_extras:
                self.stream_hook.adopt(self.loaded_extras)
            if loaded.elastic and loaded.partitions is not None \
                    and self.partitions is None:
                # adopt the re-split assignment, so the next generation
                # records the topology the run resumed onto
                self.partitions = list(loaded.partitions)
            if self.telemetry is not None and not loaded.elastic:
                self.telemetry.recovery(
                    action="resume", path=self.directory,
                    generation=loaded.generation,
                    to_iter=int(loaded.warm.prior_iters),
                    process=self.process_index, source="dist_ckpt")
        return loaded

    def _adopt(self, loaded: LoadedDistCheckpoint) -> None:
        """Seed the generation counter and the cadence from a loaded
        generation, so the next save neither reuses its number nor
        writes again what was just read."""
        self._next_generation = loaded.generation + 1
        self._last_saved_iters = int(loaded.warm.prior_iters)
        self._last_saved_t = self._clock()
        self.loaded_extras = dict(loaded.extras or {})


# ---------------------------------------------------------------------------
# Host health: heartbeat files and the monitor that turns staleness into
# HostLost.
# ---------------------------------------------------------------------------


def heartbeat_name(process: int) -> str:
    return f"heartbeat.h{process:03d}.json"


class HeartbeatWriter:
    """One process's liveness beacon: :meth:`beat` atomically rewrites
    ``heartbeat.hNNN.json`` in ``directory`` (time, pid, iteration,
    phase) and emits a ``heartbeat`` record through the telemetry bus
    when one is attached.  The supervisor beats it at every segment
    boundary (``heartbeat=``) and once at exit."""

    def __init__(self, directory: str, *,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 telemetry=None, clock=time.time):
        self.directory = directory
        self.process_index, self.process_count = _process_defaults(
            process_index, process_count)
        self.telemetry = telemetry
        self._clock = clock
        self.beats = 0

    @property
    def path(self) -> str:
        return os.path.join(self.directory,
                            heartbeat_name(self.process_index))

    def beat(self, *, iter: Optional[int] = None,
             phase: Optional[str] = None) -> dict:
        rec = {"process": self.process_index,
               "process_count": self.process_count,
               "pid": os.getpid(), "time": round(self._clock(), 3)}
        if iter is not None:
            rec["iter"] = int(iter)
        if phase is not None:
            rec["phase"] = str(phase)
        manifest_lib._atomic_write_text(self.path, json.dumps(rec))
        self.beats += 1
        if self.telemetry is not None:
            fields = {k: rec[k] for k in ("process_count", "pid",
                                          "iter", "phase") if k in rec}
            self.telemetry.heartbeat(process=self.process_index,
                                     **fields)
        return rec


class HostMonitor:
    """Reads the heartbeat files and turns staleness into
    :class:`~spark_agd_tpu_torch.resilience.errors.HostLost`.

    A process counts as LOST once it has beaten at least once and its
    file is older than ``stale_after_s``; one that never appeared is
    unseen (still starting, not a loss).  ``expected`` (process indices)
    scopes the check; by default every file counts.  SLOW is a verdict
    of its own (:meth:`verdicts`): a latest beat with ``phase="slow"``
    (a chaos sleep beats so), or an age between ``slow_after_s`` and
    ``stale_after_s``.  Only LOST raises; a slow process is the
    straggler scheduler's (``resilience.scheduler``).  With
    ``telemetry``, the first loss of each process is a ``host_lost``
    ``recovery`` record."""

    def __init__(self, directory: str, *, stale_after_s: float = 30.0,
                 slow_after_s: Optional[float] = None,
                 expected: Optional[Sequence[int]] = None,
                 telemetry=None, clock=time.time):
        if stale_after_s <= 0:
            raise ValueError("stale_after_s must be > 0")
        if slow_after_s is not None and not \
                0 < slow_after_s < stale_after_s:
            raise ValueError("slow_after_s must sit in "
                             "(0, stale_after_s)")
        self.directory = directory
        self.stale_after_s = float(stale_after_s)
        self.slow_after_s = (None if slow_after_s is None
                             else float(slow_after_s))
        self.expected = None if expected is None else sorted(
            int(p) for p in expected)
        self.telemetry = telemetry
        self._clock = clock
        self._reported: set = set()

    def poll(self) -> Dict[int, dict]:
        """Each process's last beat (the parsed file and ``age_s``)."""
        out: Dict[int, dict] = {}
        if not os.path.isdir(self.directory):
            return out
        now = self._clock()
        for name in sorted(os.listdir(self.directory)):
            m = _HEARTBEAT_RE.match(name)
            if not m:
                continue
            p = int(m.group(1))
            if self.expected is not None and p not in self.expected:
                continue
            try:
                with open(os.path.join(self.directory, name)) as f:
                    rec = json.load(f)
            except (ValueError, OSError):
                continue  # mid-rewrite or garbage: unseen
            rec["age_s"] = max(0.0, now - float(rec.get("time", 0.0)))
            out[p] = rec
        return out

    def lost_hosts(self) -> List[int]:
        return [p for p, rec in self.poll().items()
                if rec["age_s"] > self.stale_after_s]

    def verdicts(self) -> Dict[int, str]:
        """Per process ``"ok"``, ``"slow"`` or ``"lost"`` (class
        docstring)."""
        out: Dict[int, str] = {}
        for p, rec in sorted(self.poll().items()):
            age = rec["age_s"]
            if age > self.stale_after_s:
                out[p] = "lost"
            elif rec.get("phase") == "slow" or (
                    self.slow_after_s is not None
                    and age > self.slow_after_s):
                out[p] = "slow"
            else:
                out[p] = "ok"
        return out

    def slow_hosts(self) -> List[int]:
        return [p for p, v in self.verdicts().items() if v == "slow"]

    def check(self) -> None:
        """Raise :class:`HostLost` for the first stale process (one
        ``host_lost`` recovery record a process a monitor, so a retry
        loop does not repeat it)."""
        for p, rec in sorted(self.poll().items()):
            if rec["age_s"] <= self.stale_after_s:
                continue
            if self.telemetry is not None and p not in self._reported:
                self.telemetry.recovery(
                    action="host_lost", process=p,
                    reason=f"no heartbeat for {rec['age_s']:.1f}s "
                           f"(last at iter {rec.get('iter')})",
                    source="host_monitor")
            self._reported.add(p)
            raise HostLost(p, stale_for_s=rec["age_s"])
