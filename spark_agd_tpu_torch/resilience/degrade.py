"""Quorum-based graceful degradation: keep training on the survivors
instead of restarting the world.

Counterpart of ``spark_agd_tpu/resilience/degrade.py``.  When a peer
dies (``HostLost``) and a quorum of processes survives, the run goes on
degraded: the survivors resume from the last committed generation using
only the surviving shards, drop the dead processes' data partitions and
keep training on what remains.  The distributed smooth divides by the
valid-row count after the combine (``parallel.dist_smooth``), so
dropping partitions re-weights by itself: the gradient is the exact mean
over the surviving rows, and the trajectory is the one an uninterrupted
fit over those partitions would take from the same iterate.

A degraded continuation is a relaunch of the survivors as a new process
group of ``len(surviving)`` ranks (``torch.distributed.new_group`` cannot
carve one out of the old group: it needs the dead rank to call it too);
each survivor's new rank is its place among the survivors
(``parallel.multihost.rank_among``).

- :class:`DegradePolicy`: ``min_quorum`` (the fraction of the saving
  topology that must survive) and ``min_processes``;
  :meth:`DegradePolicy.decide` returns a :class:`QuorumDecision`; below
  quorum the answer is :class:`~spark_agd_tpu_torch.resilience.errors.
  QuorumLost` (FATAL).
- :func:`load_degraded`: the newest committed generation whose surviving
  shards verify; the warm state from the lowest survivor's shard; the
  survivors' partitions re-split round-robin among them, row-sharded
  extras likewise.
- :class:`DegradedCheckpointer`: the supervisor's ``checkpointer=`` for
  the continuation: ``load`` is :func:`load_degraded`, saves are barrier
  commits of the surviving topology.

With ``telemetry=``, as in the JAX package: a ``checkpoint_fallback``
recovery record a refused generation, a ``degraded`` record and the
``degraded_continue`` recovery action a degraded resume, and the flight
recorder's dump (``obs.flight``) on a refused quorum.

Quorum matrix (``min_quorum=0.5``, ``min_processes=1``):

======  =========  ========
saved   surviving  decision
======  =========  ========
2       1          degrade (0.50 >= 0.50)
4       2          degrade
4       1          refuse (QuorumLost)
8       3          refuse
======  =========  ========
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..obs import flight as flight_lib
from ..parallel import multihost
from ..utils import checkpoint as ckpt
from . import manifest as manifest_lib
from .distributed import (
    ROWSTATE_PREFIX,
    DistributedCheckpointer,
    LoadedDistCheckpoint,
    _check_embedded_generation,
    _shard_partitions,
    reshard_partitions,
)
from .errors import QuorumLost

logger = logging.getLogger("spark_agd_tpu_torch")


class QuorumDecision(NamedTuple):
    """One quorum evaluation, kept whole so it can be asserted."""

    allowed: bool
    surviving: int
    saved: int
    quorum: float          # surviving / saved
    required: float        # the policy's min_quorum
    reason: str


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """When may a run continue without its dead peers?

    ``min_quorum``: the fraction of the saving topology that must
    survive (0 < q <= 1); ``min_processes``: an absolute floor.  The
    default (0.5, 1) lets a 2-process job degrade to 1 and a 4-process
    job to 2."""

    min_quorum: float = 0.5
    min_processes: int = 1

    def __post_init__(self):
        if not 0.0 < self.min_quorum <= 1.0:
            raise ValueError("min_quorum must be in (0, 1]")
        if self.min_processes < 1:
            raise ValueError("min_processes must be >= 1")

    def decide(self, saved_process_count: int,
               surviving: int) -> QuorumDecision:
        saved = int(saved_process_count)
        alive = int(surviving)
        if not 0 <= alive <= saved:
            raise ValueError(
                f"surviving={alive} out of range for saved topology "
                f"of {saved}")
        quorum = alive / saved if saved else 0.0
        ok = quorum >= self.min_quorum and alive >= self.min_processes
        reason = (f"{alive}/{saved} processes survive "
                  f"(quorum {quorum:.2f} "
                  f"{'>=' if ok else '<'} {self.min_quorum:.2f}"
                  + ("" if alive >= self.min_processes else
                     f"; floor {self.min_processes} unmet") + ")")
        return QuorumDecision(ok, alive, saved, quorum,
                              self.min_quorum, reason)


def _verify_surviving(m: "manifest_lib.Manifest", directory: str,
                      surviving: Sequence[int]) -> List[str]:
    """``manifest.verify_manifest`` over the surviving shards only: a
    dead process's shard may be missing or torn (it may have died
    mid-write); only the shards the degraded resume reads must
    verify."""
    problems = []
    by_process = {s.process: s for s in m.shards}
    for p in surviving:
        s = by_process.get(int(p))
        if s is None:
            problems.append(f"manifest g{m.generation} has no shard "
                            f"for surviving process {p}")
            continue
        path = os.path.join(directory, s.path)
        if not os.path.exists(path):
            problems.append(f"surviving shard {s.path} missing")
            continue
        size = os.path.getsize(path)
        if size != s.size:
            problems.append(f"surviving shard {s.path}: size {size} != "
                            f"manifest {s.size} (torn write)")
            continue
        crc = manifest_lib.crc32_file(path)
        if crc != s.crc32:
            problems.append(
                f"surviving shard {s.path}: CRC32 {crc:#010x} != "
                f"manifest {s.crc32:#010x}")
    return problems


class DegradedResume(NamedTuple):
    """:func:`load_degraded`'s result: the loaded checkpoint (an elastic
    ``LoadedDistCheckpoint``), the quorum decision that allowed it, and
    the data partitions dropped with the dead."""

    loaded: LoadedDistCheckpoint
    decision: QuorumDecision
    dropped_partitions: Tuple[str, ...]


def load_degraded(
    directory: str,
    template: Any,
    *,
    surviving: Sequence[int],
    policy: Optional[DegradePolicy] = None,
    process_index: Optional[int] = None,
    fingerprint: Optional[str] = None,
    telemetry=None,
) -> Optional[DegradedResume]:
    """Load the newest committed generation for a degraded continuation
    on ``surviving`` (original process indices), its leaves on
    ``template``'s devices.  ``process_index`` is the caller's original
    index (in ``surviving``; default the lowest survivor); its new rank
    is its place there.  Raises :class:`QuorumLost` when the policy
    refuses; None when no generation's surviving shards verify (each
    refusal a ``checkpoint_fallback`` record with ``telemetry``)."""
    policy = policy or DegradePolicy()
    survivors = sorted(int(p) for p in surviving)
    if not survivors:
        raise ValueError("surviving must name at least one process")
    if process_index is None:
        process_index = survivors[0]
    if int(process_index) not in survivors:
        raise ValueError(f"process_index {process_index} is not in "
                         f"surviving={survivors}")
    rank = multihost.rank_among(survivors, int(process_index))
    n_surv = len(survivors)

    gens = manifest_lib.committed_generations(directory)
    for gen in gens:
        try:
            m = manifest_lib.load_manifest(directory, gen)
        except (ValueError, OSError) as e:
            _fallback(telemetry, directory, gen,
                      f"manifest unreadable: {e}")
            continue
        decision = policy.decide(m.process_count, n_surv)
        if not decision.allowed:
            # quorum is a property of the topology, not of this
            # generation: no older generation can fix it.  The refusal
            # ships with its last-seconds timeline (obs.flight).
            flight_lib.dump_on_failure(telemetry, "quorum_lost")
            raise QuorumLost(decision.reason)
        problems = _verify_surviving(m, directory, survivors)
        if problems:
            _fallback(telemetry, directory, gen, "; ".join(problems))
            continue
        try:
            return _load_surviving(directory, m, template, survivors,
                                   rank, n_surv, decision, fingerprint,
                                   telemetry)
        except ckpt.CheckpointCorruptError as e:
            _fallback(telemetry, directory, gen, str(e))
            continue
    if gens:
        logger.warning(
            "degraded resume: every committed generation under %r "
            "failed surviving-shard verification", directory)
    return None


def _fallback(telemetry, directory: str, generation: int,
              reason: str) -> None:
    logger.warning("degraded resume refusing generation %d under %r: %s",
                   generation, directory, reason)
    if telemetry is not None:
        telemetry.recovery(action="checkpoint_fallback", path=directory,
                           generation=generation, reason=reason,
                           source="degrade")


def _load_surviving(directory, m, template, survivors, rank, n_surv,
                    decision, fingerprint, telemetry):
    per_host = []
    for p in survivors:
        path = m.shard_path(directory, p)
        entries = ckpt.read_npz_entries(path)
        _check_embedded_generation(path, entries, m.generation)
        per_host.append((p, path, entries))
    _, path0, e0 = per_host[0]
    # the carry is replicated (the commit exchange verified every copy
    # byte-equal before this generation existed): the lowest survivor's
    lc = ckpt.checkpoint_from_entries(
        path0, ckpt._Entries(path0, e0), template, fingerprint)

    saved_parts = [p for _, _, e in per_host
                   if (p := _shard_partitions(e)) is not None]
    partitions = (reshard_partitions(saved_parts, rank, n_surv)
                  if saved_parts else None)
    surviving_union = sorted({p for host in saved_parts for p in host})
    # what died with the dead processes: the saved topology's partitions
    # less what the survivors hold, known only from the dead shards
    dead = sorted(set(range(m.process_count)) - set(survivors))
    dropped: Tuple[str, ...] = ()
    if saved_parts:
        all_parts = set(surviving_union)
        for p in dead:
            try:
                path = m.shard_path(directory, p)
                if os.path.exists(path):
                    lost = _shard_partitions(ckpt.read_npz_entries(path))
                    if lost is not None:
                        all_parts |= set(lost)
            except (ckpt.CheckpointCorruptError, KeyError, OSError):
                pass  # a dead process's shard owes us nothing
        dropped = tuple(sorted(all_parts - set(surviving_union)))

    names = sorted({k for _, _, e in per_host
                    for k in e if k.startswith(ROWSTATE_PREFIX)})
    row_state = {}
    for k in names:
        whole = np.concatenate(
            [e[k] for _, _, e in per_host if k in e], axis=0)
        row_state[k[len(ROWSTATE_PREFIX):]] = whole[
            multihost.local_rows_slice(whole.shape[0], rank, n_surv)]

    if telemetry is not None:
        telemetry.degraded(
            surviving=n_surv, saved_process_count=m.process_count,
            lost=dead, quorum=round(decision.quorum, 4),
            min_quorum=decision.required, generation=m.generation,
            to_iter=int(lc.warm.prior_iters), process=rank,
            dropped_partitions=len(dropped), source="degrade")
        telemetry.recovery(
            action="degraded_continue", path=directory,
            generation=m.generation,
            saved_process_count=m.process_count, process_count=n_surv,
            process=rank, to_iter=int(lc.warm.prior_iters),
            reason=decision.reason, source="degrade")
    logger.warning(
        "DEGRADED resume: generation %d saved by %d processes, "
        "continuing on %d survivor(s) (%s); %d data partition(s) "
        "dropped with the dead processes",
        m.generation, m.process_count, n_surv, decision.reason,
        len(dropped))
    loaded = LoadedDistCheckpoint(
        *lc[:5], generation=m.generation,
        saved_process_count=m.process_count, elastic=True,
        partitions=partitions, row_state=row_state, extras=lc.extras)
    return DegradedResume(loaded, decision, dropped)


class DegradedCheckpointer(DistributedCheckpointer):
    """The degraded continuation's checkpointer: ``load`` reads only the
    surviving shards (:func:`load_degraded`, quorum-gated), and saves go
    on as barrier commits of the surviving topology (``process_count =
    len(surviving)``, this process's rank among the survivors), so a
    later full restart resumes from them elastically."""

    def __init__(self, directory: str, *, surviving: Sequence[int],
                 original_process_index: Optional[int] = None,
                 degrade_policy: Optional[DegradePolicy] = None,
                 **kwargs):
        self.surviving = sorted(int(p) for p in surviving)
        if original_process_index is None:
            original_process_index = self.surviving[0]
        self.original_process_index = int(original_process_index)
        self.degrade_policy = degrade_policy or DegradePolicy()
        rank = multihost.rank_among(self.surviving,
                                    self.original_process_index)
        super().__init__(directory, process_index=rank,
                         process_count=len(self.surviving), **kwargs)
        self.last_decision: Optional[QuorumDecision] = None
        self.dropped_partitions: Tuple[str, ...] = ()
        self._loaded_once: Optional[LoadedDistCheckpoint] = None

    def load(self, template: Any) -> Optional[LoadedDistCheckpoint]:
        # the decision is made once: the caller loads first (it needs the
        # surviving partitions to build the degraded problem), and the
        # supervisor's own load reuses the result
        if self._loaded_once is not None:
            return self._loaded_once
        self.wait()
        resumed = load_degraded(
            self.directory, template, surviving=self.surviving,
            policy=self.degrade_policy,
            process_index=self.original_process_index,
            fingerprint=self.fingerprint, telemetry=self.telemetry)
        if resumed is None:
            return None
        self.last_decision = resumed.decision
        self.dropped_partitions = resumed.dropped_partitions
        loaded = resumed.loaded
        self._adopt(loaded)
        if loaded.partitions is not None and self.partitions is None:
            self.partitions = list(loaded.partitions)
        self._loaded_once = loaded
        return loaded
