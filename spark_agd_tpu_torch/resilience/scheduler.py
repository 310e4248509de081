"""Straggler-aware scheduling: live skew detection, generation-boundary
partition rebalancing, and speculative segment execution.

Counterpart of ``spark_agd_tpu/resilience/scheduler.py``, in three
pieces:

**Detection** (:class:`SkewTracker`).  In lockstep data parallelism a
straggler's delay is absorbed into every peer's next collective, so the
signal that can be attributed is each process's own work at segment
boundaries (where chaos ``slow_host`` sleeps land, and where per-process
work such as ingest and beats happens).  Each process folds its own
boundary seconds; every ``sync_every`` segments the per-process sums
cross one small all-gather (the distributed checkpoint's int64
exchange), so every process holds the same per-process cost estimate,
and the decisions below are the same on every process.  An EWMA smooths
blips; a persistent straggler is one whose skew (max cost over the
interpolating median) stays above the threshold for
``trigger_segments`` consecutive syncs with the same process on top.
Heartbeat files are the second signal.

**Rebalancing** (:func:`assign_weighted` and :class:`StragglerScheduler`).
At a generation boundary, when the straggler is persistent, every
process recomputes the partition assignment from the sorted union
weighted by measured speed (largest-remainder counts over a floor, then
greedy makespan moves, never worse than uniform), rebuilds its staged
data through the caller's ``rebuild`` hook
(``data.ingest.from_partitioned_files(assignment=, pad_to_rows=)``), and
the supervisor force-commits a generation whose shards carry the new
assignment, so a crash mid-rebalance resumes from either side.  The
supervisor's built smooths close over the staged data, so a rebuilt
``staged`` pair is never served a smooth built over the old one.

**Speculation** (:func:`run_speculative_segment` and
:func:`resolve_speculation`).  When the slowest process's segment takes
``speculative_multiple`` times the fleet median
(:func:`speculation_due`), a backup re-executes that segment from the
last committed generation; the carry is replicated and the math
deterministic, so the backup's result is the same bits (a backup on
another topology agrees to reduction-order noise instead).

Every decision is on record, as in the JAX package: a ``skew_estimate``
record at each sync, a ``rebalance`` record and the ``rebalance``
recovery action at each applied decision, and a ``speculative_exec``
recovery record at each resolved speculation.  Without a ``scheduler=``
the supervisor path is unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np

from ..utils import checkpoint as ckpt
from .distributed import (_HEARTBEAT_RE, _default_exchange,
                          _process_defaults)

# costs below this floor are indistinguishable from host noise (a
# sub-millisecond boundary is "idle", not "fast") — without it the
# skew ratio of two idle hosts is garbage
DEFAULT_FLOOR_S = 1e-3


def _median(vals: Sequence[float]) -> float:
    """Interpolating median (the JAX package's ``obs.timeline``
    convention: with two hosts, one slow, a nearest-rank median would
    land entirely on one of them and hide the skew)."""
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


@dataclasses.dataclass(frozen=True)
class ReschedulePolicy:
    """The feedback loop's knob set.

    ``skew_threshold``: skew (max per-host cost / median) at or above
    which a sync counts toward the trigger; ``trigger_segments``: how
    many CONSECUTIVE over-threshold syncs naming the same straggler
    arm a rebalance (the hysteresis — one blip never triggers);
    ``sync_every``: segments between allgather syncs; ``min_shard``:
    the fewest partitions any host may be assigned (0 lets a degraded
    host run data-free while still holding its replicated carry);
    ``max_rebalances``: lifetime cap; ``rebalance=False`` runs the
    tracker observe-only (estimates, no decisions);
    ``speculative_multiple``: how many fleet-median segment times the
    slowest host may take before :func:`speculation_due` says a backup
    execution is warranted; ``ewma_alpha``/``floor_s``: the tracker's
    smoothing and noise floor.
    """

    skew_threshold: float = 1.5
    trigger_segments: int = 3
    sync_every: int = 1
    min_shard: int = 1
    max_rebalances: int = 4
    rebalance: bool = True
    speculative_multiple: float = 3.0
    ewma_alpha: float = 0.5
    floor_s: float = DEFAULT_FLOOR_S

    def __post_init__(self):
        if self.skew_threshold < 1.0:
            raise ValueError("skew_threshold must be >= 1 (skew of 1 "
                             "means perfectly balanced)")
        if self.trigger_segments < 1:
            raise ValueError("trigger_segments must be >= 1")
        if self.sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        if self.min_shard < 0:
            raise ValueError("min_shard must be >= 0")
        if self.max_rebalances < 0:
            raise ValueError("max_rebalances must be >= 0")
        if self.speculative_multiple <= 1.0:
            raise ValueError("speculative_multiple must be > 1")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.floor_s <= 0:
            raise ValueError("floor_s must be > 0")


class SkewSnapshot(NamedTuple):
    """One sync's view of the fleet — what :meth:`SkewTracker.fold`
    returns."""

    skew: float
    straggler: Optional[int]     # argmax-cost host (None when balanced)
    consecutive: int             # over-threshold syncs naming it in a row
    persistent: bool             # consecutive >= trigger_segments
    speeds: Dict[int, float]     # host -> relative speed (1.0 typical)
    costs: Dict[int, float]      # host -> floored EWMA seconds/segment


class SkewTracker:
    """Online per-host speed estimate with hysteresis — see the module
    docstring.  Feed it per-host boundary seconds (:meth:`observe` /
    :meth:`fold`); read the skew, the straggler, and the relative
    speeds the weighted re-split consumes.  Heartbeat files are the
    second signal (:meth:`observe_heartbeats`)."""

    def __init__(self, *, alpha: float = 0.5,
                 floor_s: float = DEFAULT_FLOOR_S,
                 skew_threshold: float = 1.5,
                 trigger_segments: int = 3):
        self.alpha = float(alpha)
        self.floor_s = float(floor_s)
        self.skew_threshold = float(skew_threshold)
        self.trigger_segments = int(trigger_segments)
        self._ewma: Dict[int, float] = {}
        self._straggler: Optional[int] = None
        self.consecutive = 0
        self.hb_ages: Dict[int, float] = {}
        self.hb_slow: List[int] = []

    # -- the primary signal: host-local boundary seconds ------------------
    def observe(self, process: int, seconds: float) -> None:
        p = int(process)
        s = max(0.0, float(seconds))
        prev = self._ewma.get(p)
        self._ewma[p] = s if prev is None else (
            self.alpha * s + (1.0 - self.alpha) * prev)

    def costs(self) -> Dict[int, float]:
        """Floored EWMA seconds of host-local work per segment."""
        return {p: max(e, self.floor_s)
                for p, e in sorted(self._ewma.items())}

    def skew(self) -> Optional[float]:
        costs = self.costs()
        if not costs:
            return None
        return max(costs.values()) / _median(list(costs.values()))

    def straggler(self) -> Optional[int]:
        costs = self.costs()
        if not costs:
            return None
        worst = max(costs.values())
        if worst <= self.floor_s:
            return None  # everyone is idle-fast: no straggler
        return min(p for p, c in costs.items() if c == worst)

    def speeds(self) -> Dict[int, float]:
        """Relative per-host speed: the typical (median-cost) host is
        1.0, a 5×-slower host ~0.2 — the weights the re-split uses."""
        costs = self.costs()
        if not costs:
            return {}
        med = _median(list(costs.values()))
        return {p: med / c for p, c in costs.items()}

    def fold(self, costs: Dict[int, float]) -> SkewSnapshot:
        """One sync: fold every host's per-segment seconds, update the
        hysteresis counter, and return the snapshot.  The counter
        advances only while the SAME host stays on top of an
        over-threshold skew; any below-threshold sync (or a change of
        straggler) resets it — a blip cannot accumulate into a
        trigger."""
        for p, s in costs.items():
            self.observe(p, s)
        skew = self.skew() or 1.0
        straggler = self.straggler()
        if skew >= self.skew_threshold and straggler is not None:
            if straggler == self._straggler:
                self.consecutive += 1
            else:
                self._straggler = straggler
                self.consecutive = 1
        else:
            self._straggler = None
            self.consecutive = 0
        return SkewSnapshot(
            skew=skew, straggler=self._straggler,
            consecutive=self.consecutive,
            persistent=self.consecutive >= self.trigger_segments,
            speeds=self.speeds(), costs=self.costs())

    # -- the second signal: heartbeat files -------------------------------
    def observe_heartbeats(self, directory: str, *,
                           clock: Callable[[], float] = time.time
                           ) -> Dict[int, dict]:
        """Read the heartbeat files of ``directory`` (the
        ``resilience.distributed.HeartbeatWriter`` convention): per
        host, the file's age (mtime — a host that stopped rewriting is
        falling behind even if its content lies) and the last recorded
        phase.  Hosts whose latest beat is ``phase="slow"`` (the chaos
        sub-interval beats during an injected sleep) land in
        :attr:`hb_slow` — corroboration for the timing estimate."""
        out: Dict[int, dict] = {}
        slow: List[int] = []
        if os.path.isdir(directory):
            now = clock()
            for name in sorted(os.listdir(directory)):
                m = _HEARTBEAT_RE.match(name)
                if not m:
                    continue
                path = os.path.join(directory, name)
                try:
                    age = max(0.0, now - os.path.getmtime(path))
                    with open(path) as f:
                        rec = json.load(f)
                except (ValueError, OSError):
                    continue  # mid-rewrite: skip this poll
                p = int(m.group(1))
                out[p] = {"age_s": age, "phase": rec.get("phase")}
                if rec.get("phase") == "slow":
                    slow.append(p)
        self.hb_ages = {p: v["age_s"] for p, v in out.items()}
        self.hb_slow = slow
        return out


# ---------------------------------------------------------------------------
# Weighted partition re-split
# ---------------------------------------------------------------------------


def modeled_makespan(counts: Sequence[int],
                     speeds: Sequence[float]) -> float:
    """The makespan the speed model predicts for an assignment: the
    slowest host's (partitions / speed).  The quantity the weighted
    split minimizes and the property tests compare against uniform."""
    return max(c / max(float(s), 1e-9)
               for c, s in zip(counts, speeds)) if counts else 0.0


def uniform_counts(n_parts: int, n_hosts: int) -> List[int]:
    """The round-robin baseline: ``union[p::n]`` block sizes."""
    return [len(range(p, n_parts, n_hosts)) for p in range(n_hosts)]


def weighted_counts(n_parts: int, speeds: Sequence[float], *,
                    min_shard: int = 1) -> List[int]:
    """Integer per-host partition counts ∝ measured speed: a
    largest-remainder split over min-shard floors, then greedy moves
    from the modeled-slowest host to the host that can absorb one more
    cheapest, and a final never-worse-than-uniform guard.  Fully
    deterministic (ties break on host index)."""
    n_hosts = len(speeds)
    if n_hosts == 0:
        raise ValueError("speeds must name at least one host")
    if n_parts < 0:
        raise ValueError("n_parts must be >= 0")
    v = [max(float(s), 1e-9) for s in speeds]
    floor = min(int(min_shard), n_parts // n_hosts)
    total_v = sum(v)
    spare = n_parts - floor * n_hosts
    ideal = [spare * s / total_v for s in v]
    counts = [floor + int(i) for i in ideal]
    remainders = sorted(range(n_hosts),
                        key=lambda p: (-(ideal[p] - int(ideal[p])), p))
    for p in remainders[:spare - sum(int(i) for i in ideal)]:
        counts[p] += 1

    # greedy improvement: move one partition off the modeled-slowest
    # host while it strictly reduces the makespan (bounded by n_parts)
    for _ in range(n_parts):
        donor = max(range(n_hosts), key=lambda p: (counts[p] / v[p], p))
        if counts[donor] <= floor:
            break
        recv = min(range(n_hosts),
                   key=lambda p: ((counts[p] + 1) / v[p], p))
        if recv == donor:
            break
        trial = list(counts)
        trial[donor] -= 1
        trial[recv] += 1
        if modeled_makespan(trial, v) < modeled_makespan(counts, v):
            counts = trial
        else:
            break

    uniform = uniform_counts(n_parts, n_hosts)
    if modeled_makespan(counts, v) > modeled_makespan(uniform, v):
        counts = uniform  # the guard: weighted is NEVER worse
    return counts


def assign_weighted(union: Sequence[str], speeds: Sequence[float], *,
                    min_shard: int = 1) -> Tuple[Tuple[str, ...], ...]:
    """Per-host partition assignment: the sorted union cut into
    contiguous blocks sized by :func:`weighted_counts`.  Covers every
    partition exactly once; deterministic in its inputs — every SPMD
    host computing this from the same allgathered speeds derives the
    same table."""
    union = sorted(str(p) for p in union)
    counts = weighted_counts(len(union), speeds, min_shard=min_shard)
    out: List[Tuple[str, ...]] = []
    at = 0
    for c in counts:
        out.append(tuple(union[at:at + c]))
        at += c
    return tuple(out)


class RebalanceDecision(NamedTuple):
    """One committed-through-the-manifest rebalance decision — pure
    data so it can be journaled and asserted whole."""

    at_iter: int
    assignments: Tuple[Tuple[str, ...], ...]  # per host, full table
    mine: Tuple[str, ...]                     # this host's new row
    speeds: Dict[int, float]
    skew: float
    straggler: Optional[int]
    before: Tuple[int, ...]                   # per-host counts
    after: Tuple[int, ...]

    @property
    def moved(self) -> int:
        return sum(abs(a - b)
                   for a, b in zip(self.after, self.before)) // 2


# ---------------------------------------------------------------------------
# The scheduler the supervisor drives
# ---------------------------------------------------------------------------


class StragglerScheduler:
    """The feedback loop behind ``run_agd_supervised(scheduler=...)``.

    The supervisor calls :meth:`after_segment` at every successful
    segment boundary with the process's own boundary seconds; every
    ``policy.sync_every`` segments the per-process sums cross the
    ``exchange`` all-gather (default: the distributed checkpoint's int64
    exchange; the row itself in a single process), the
    :class:`SkewTracker` folds them, and when the straggler is
    persistent under the policy's hysteresis a
    :class:`RebalanceDecision` is returned for the supervisor to
    :meth:`apply` at the generation boundary.

    ``rebuild(decision) -> staged`` is the caller's data hook: re-ingest
    this process's new partition list (``decision.mine``) and return the
    new ``(build, data_args)`` staged pair
    (``ingest.from_partitioned_files(assignment=, pad_to_rows=)`` keeps
    every process's block the same height).  The supervisor then builds
    its segment smooths anew over the rebuilt data, so the JAX package's
    ``retrace`` (its switch to drop compiled programs) has no
    counterpart here.

    The sync is collective: every process must reach the same successful
    boundaries in lockstep.  The exchange refuses a mixed-iteration sync
    as the commit refuses mixed generations.  ``telemetry``: a
    ``skew_estimate`` record a sync, a ``rebalance`` record and
    recovery action an applied decision.
    """

    def __init__(self, partitions: Sequence[str], *,
                 policy: Optional[ReschedulePolicy] = None,
                 rebuild: Optional[Callable[[RebalanceDecision], Any]] = None,
                 telemetry=None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 exchange: Optional[Callable] = None,
                 heartbeat_dir: Optional[str] = None):
        self.union: Tuple[str, ...] = tuple(
            sorted(str(p) for p in partitions))
        if not self.union:
            raise ValueError("partitions must name at least one file")
        self.policy = policy or ReschedulePolicy()
        self.rebuild = rebuild
        self.telemetry = telemetry
        self.process_index, self.process_count = _process_defaults(
            process_index, process_count)
        self._exchange = exchange or _default_exchange
        self.heartbeat_dir = heartbeat_dir
        self.tracker = SkewTracker(
            alpha=self.policy.ewma_alpha, floor_s=self.policy.floor_s,
            skew_threshold=self.policy.skew_threshold,
            trigger_segments=self.policy.trigger_segments)
        # initial table = the round-robin ingest.local_partitions rule
        self.assignments: Tuple[Tuple[str, ...], ...] = tuple(
            tuple(self.union[p::self.process_count])
            for p in range(self.process_count))
        self.rebalances = 0
        self.last_snapshot: Optional[SkewSnapshot] = None
        self._segments = 0
        self._window_us = 0
        self._window_segments = 0

    @property
    def assignment(self) -> Tuple[str, ...]:
        """This host's current partition list."""
        return self.assignments[self.process_index]

    # -- the supervisor hook ----------------------------------------------
    def after_segment(self, *, start_iter: int, iters: int,
                      boundary_s: float,
                      segment_s: Optional[float] = None
                      ) -> Optional[RebalanceDecision]:
        """Fold one successful segment's host-local boundary seconds;
        on a sync boundary, exchange, estimate, emit, and possibly
        decide.  Returns the decision to apply, or None."""
        self._segments += 1
        self._window_us += max(0, int(float(boundary_s) * 1e6))
        self._window_segments += 1
        if self._segments % self.policy.sync_every:
            return None
        done_iter = int(start_iter) + int(iters)
        row = np.asarray(
            [done_iter, self._window_us, self._window_segments],
            np.int64)
        gathered = np.asarray(self._exchange(row), np.int64).reshape(
            self.process_count, row.size)
        self._window_us = 0
        self._window_segments = 0
        iters_seen = gathered[:, 0]
        if not (iters_seen == iters_seen[0]).all():
            raise RuntimeError(
                "scheduler sync out of lockstep: hosts report "
                f"iterations {sorted(set(int(i) for i in iters_seen))} "
                "at the same boundary — refusing a skew estimate that "
                "mixes different segments")
        costs = {p: (float(gathered[p, 1]) / 1e6
                     / max(1, int(gathered[p, 2])))
                 for p in range(self.process_count)}
        snap = self.tracker.fold(costs)
        self.last_snapshot = snap
        if self.heartbeat_dir is not None:
            self.tracker.observe_heartbeats(self.heartbeat_dir)
        if self.telemetry is not None:
            fields = {
                "speeds": {str(p): round(v, 4)
                           for p, v in snap.speeds.items()},
                "consecutive": int(snap.consecutive),
                "persistent": bool(snap.persistent),
                "iter": done_iter,
                "window_segments": int(self.policy.sync_every),
                "threshold": float(self.policy.skew_threshold),
                "process": self.process_index,
                "source": "scheduler",
            }
            if snap.straggler is not None:
                fields["straggler"] = int(snap.straggler)
            if self.tracker.hb_slow:
                fields["hb_slow"] = list(self.tracker.hb_slow)
            self.telemetry.skew_estimate(skew=round(snap.skew, 4),
                                         **fields)

        if not (self.policy.rebalance and snap.persistent
                and self.rebalances < self.policy.max_rebalances):
            return None
        speeds_list = [snap.speeds.get(p, 1.0)
                       for p in range(self.process_count)]
        table = assign_weighted(self.union, speeds_list,
                                min_shard=self.policy.min_shard)
        if table == self.assignments:
            # nothing to move: re-arm the hysteresis instead of
            # re-deciding the same assignment every sync
            self.tracker.consecutive = 0
            return None
        return RebalanceDecision(
            at_iter=done_iter, assignments=table,
            mine=table[self.process_index], speeds=snap.speeds,
            skew=snap.skew, straggler=snap.straggler,
            before=tuple(len(a) for a in self.assignments),
            after=tuple(len(a) for a in table))

    def apply(self, decision: RebalanceDecision, *,
              checkpointer=None) -> Any:
        """Adopt the decision: update the assignment table, point the
        checkpointer's next generation at the NEW partition list (the
        manifest-commit that makes the rebalance durable is the
        supervisor's forced save right after), emit the ``rebalance``
        record and recovery action, and return the caller's rebuilt
        staged data (None without a ``rebuild`` hook)."""
        self.rebalances += 1
        self.tracker.consecutive = 0
        self.assignments = decision.assignments
        if checkpointer is not None and hasattr(checkpointer,
                                                "partitions"):
            checkpointer.partitions = list(decision.mine)
        if self.telemetry is not None:
            fields = {
                "speeds": {str(p): round(v, 4)
                           for p, v in decision.speeds.items()},
                "skew": round(float(decision.skew), 4),
                "before": {str(p): int(c)
                           for p, c in enumerate(decision.before)},
                "after": {str(p): int(c)
                          for p, c in enumerate(decision.after)},
                "moved": int(decision.moved),
                "process": self.process_index,
                "source": "scheduler",
            }
            if decision.straggler is not None:
                fields["straggler"] = int(decision.straggler)
            gen = getattr(checkpointer, "_next_generation", None)
            if gen is not None:
                fields["generation"] = int(gen)
            self.telemetry.rebalance(at_iter=int(decision.at_iter),
                                     **fields)
            self.telemetry.recovery(
                action="rebalance", from_iter=int(decision.at_iter),
                reason=(f"persistent straggler h{decision.straggler} "
                        f"(skew {decision.skew:.2f}); moved "
                        f"{decision.moved} partition(s)"),
                process=self.process_index, source="scheduler")
        if self.rebuild is not None:
            return self.rebuild(decision)
        return None


# ---------------------------------------------------------------------------
# Speculative segment execution
# ---------------------------------------------------------------------------


def speculation_due(elapsed_s: float, median_segment_s: float,
                    multiple: float = 3.0) -> bool:
    """Spark's speculation rule at segment granularity: the slowest
    host's in-flight segment has taken ``multiple`` × the fleet-median
    segment time — a backup execution is warranted.  False while the
    median is unknown (never speculate on the first segment)."""
    return (median_segment_s > 0.0
            and float(elapsed_s) >= float(multiple)
            * float(median_segment_s))


class SpeculationResult(NamedTuple):
    """One backup execution: the segment result, the re-derived warm
    carry, and its timing — kept whole for :func:`resolve_speculation`."""

    result: Any
    warm: Any
    seconds: float
    from_iter: int
    iters: int


def run_speculative_segment(run_segment: Callable[[Any, int], Any],
                            warm: Any, k: int, *,
                            from_iter: Optional[int] = None,
                            clock: Callable[[], float] = time.perf_counter
                            ) -> SpeculationResult:
    """Execute the backup: ``run_segment(warm, k)`` from the COMMITTED
    warm carry (never a live one — the committed generation is the
    only state both the primary and the straggler provably share).
    Deterministic math means a same-program backup reproduces the
    straggler's pending result bit-for-bit."""
    start = int(from_iter if from_iter is not None
                else warm.prior_iters)
    t0 = clock()
    res = run_segment(warm, int(k))
    seconds = clock() - t0
    new_warm = ckpt.warm_from_result(res, start + int(res.num_iters))
    return SpeculationResult(result=res, warm=new_warm,
                             seconds=seconds, from_iter=start,
                             iters=int(res.num_iters))


def warm_max_diff(a: Any, b: Any) -> float:
    """Max absolute elementwise difference across two warm carries'
    payload arrays (loss histories excluded — they may be rank-0-only,
    exactly like the commit barrier's replica-divergence CRC)."""
    pa, pb = ckpt.warm_payload(a), ckpt.warm_payload(b)
    worst = 0.0
    for name in sorted(set(pa) & set(pb)):
        if name == "loss_history":
            continue
        worst = max(worst, float(np.max(np.abs(
            np.asarray(pa[name], np.float64)
            - np.asarray(pb[name], np.float64)), initial=0.0)))
    return worst


def resolve_speculation(spec: SpeculationResult, committed_warm: Any, *,
                        fleet_seconds: Optional[float] = None,
                        tol: float = 0.0,
                        straggler: Optional[int] = None,
                        telemetry=None) -> dict:
    """First-result-wins accounting: compare the backup's warm carry
    against the (eventually) committed one: ``tol=0.0`` demands
    bit-identity (the same-program guarantee); a cross-topology backup
    passes a small f64 tolerance instead.  ``won`` means the backup
    finished before the fleet's own result for the segment
    (``fleet_seconds``, when known) — either way the results MATCH, so
    taking whichever lands first is safe; with ``telemetry``, emit the
    ``speculative_exec`` recovery record."""
    diff = warm_max_diff(spec.warm, committed_warm)
    matched = bool(diff <= tol) if tol > 0 else bool(diff == 0.0)
    won = bool(fleet_seconds is not None
               and spec.seconds < float(fleet_seconds))
    out = {"outcome": "won" if won else "lost", "matched": matched,
           "from_iter": int(spec.from_iter), "iters": int(spec.iters),
           "seconds": round(float(spec.seconds), 6),
           "max_diff": float(diff)}
    if fleet_seconds is not None:
        out["fleet_seconds"] = round(float(fleet_seconds), 6)
    if telemetry is not None:
        fields = dict(out)
        if straggler is not None:
            fields["straggler"] = int(straggler)
        telemetry.recovery(action="speculative_exec",
                           source="scheduler", **fields)
    return out
