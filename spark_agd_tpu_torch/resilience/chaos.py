"""Chaos campaigns: seeded, composable multi-fault schedules and the
campaign executor that proves recovery against fault sequences.

Counterpart of ``spark_agd_tpu/resilience/chaos.py``; the campaign
executor is single-process, a schedule serves any process of a group.
``resilience.faults.FaultScript`` arms one fault of each kind; this
module generalizes it:

- :class:`ScheduledFault`: one scripted fault: a kind, the iteration it
  arms at, the process it targets (``None`` = every process) and a
  kind-specific payload.
- :class:`ChaosSchedule`: an ordered sequence of one-shot faults behind
  the supervisor interface of ``FaultScript`` (``before_segment`` /
  ``take_poison`` / ``fired`` / ``exhausted``), so it drops into
  ``run_agd_supervised(faults=...)`` unchanged.
- :class:`ChaosCampaign`: a whole scenario, deterministic from one
  seed: the in-run faults and the file faults (checkpoint truncation or
  scrambling) the driver applies at relaunches.
  ``ChaosCampaign.generate(seed, ...)`` draws the JAX package's
  campaigns (the same numpy draws).
- :func:`run_campaign`: run the supervised fit under the schedule,
  relaunch on preemption (applying due file faults to the checkpoint
  chain first) and classify the outcome: ``converged`` (the baseline's
  loss), ``gave_up`` (a typed ``SupervisorGivingUp``), or the failures
  ``mismatch`` and ``stalled``.

Fault kinds (:data:`FAULT_KINDS`): ``nan`` (poison the next segment:
NUMERIC, rollback), ``device_loss`` (TRANSIENT, retry), ``slow_host``
(sleep at the boundary), ``sigterm`` (preemption flush, relaunch),
``sigkill`` (a dead host), ``fatal`` (:class:`InjectedFatalError`, FATAL,
a typed give-up), ``truncate_ckpt`` and ``scramble_ckpt`` (corrupt the
newest checkpoint at the next relaunch), the replica kinds
``slow_replica`` (sleep before serving a request, one-shot or
persistent) and ``kill_replica`` (SIGKILL at a request boundary), which
a serving replica (``serve.fleet``) fires through
``before_request(request_index)`` (``at_iter`` = the request index),
and the reader kinds
``slow_reader``, ``corrupt_shard`` and ``hang_reader``, which
``data.streaming.StreamingDataset.from_libsvm_parts(chaos=)`` fires
through ``before_shard(visit, path=...)`` inside each retried shard
load (``at_iter`` = the cumulative shard visit).

Iterations, targets, payloads and corruption bytes all derive from the
campaign seed.  ``telemetry=`` emits one ``chaos`` record a fired fault
(flushed before a kill, so the kill is on record).
"""

from __future__ import annotations

import dataclasses
import os
import signal as signal_lib
import time
from typing import (Any, Callable, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np

from . import faults as faults_lib
from .autockpt import AutoCheckpointer, generation_paths
from .errors import Preempted, SimulatedDeviceLoss, SupervisorGivingUp

IN_RUN_KINDS = ("nan", "device_loss", "slow_host", "sigterm", "sigkill",
                "fatal")
FILE_KINDS = ("truncate_ckpt", "scramble_ckpt")
# replica-scoped serve-fleet faults, fired per admitted request via
# ChaosSchedule.before_request (``at_iter`` = request index); appended
# AFTER the existing kinds so FAULT_KINDS.index-based sort keys (and
# every seeded campaign that derives from them) are unchanged
REPLICA_KINDS = ("slow_replica", "kill_replica")
# reader-scoped streaming faults, fired per shard visit via
# ChaosSchedule.before_shard (``at_iter`` = shard visit index); same
# append-only contract — AFTER every existing kind
READER_KINDS = ("slow_reader", "corrupt_shard", "hang_reader")
FAULT_KINDS = IN_RUN_KINDS + FILE_KINDS + REPLICA_KINDS + READER_KINDS

# the kinds persist=True is meaningful for: a degraded host/replica
# that stays degraded (kills and poisons are one-shot by nature)
_PERSISTABLE_KINDS = ("slow_host", "slow_replica")


class InjectedFatalError(ValueError):
    """A scripted configuration-class error (classified FATAL): the
    chaos pool's give-up leg — the supervisor must answer with a typed
    ``SupervisorGivingUp``, never a retry loop or a bare traceback."""


@dataclasses.dataclass(frozen=True)
class ScheduledFault:
    """One scripted fault of a campaign — see the module docstring.

    ``persist=True`` (``slow_host`` only) turns the one-shot boundary
    sleep into a PERSISTENT per-segment delay: the fault fires at
    EVERY boundary at or past ``at_iter``, sleeping ``payload *
    decay**n`` seconds on its n-th firing: a degraded host
    (``decay=1``: steady degradation; ``decay<1``: a host that slowly
    recovers)."""

    kind: str
    at_iter: int
    process: Optional[int] = None  # None = every process
    payload: float = 0.0           # slow_host: seconds; truncate_ckpt:
    #                                keep fraction; scramble_ckpt: bytes
    persist: bool = False          # slow_host only: fire every boundary
    decay: float = 1.0             # persistent per-firing multiplier

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        if self.at_iter < 0:
            raise ValueError("at_iter must be >= 0")
        if self.persist and self.kind not in _PERSISTABLE_KINDS:
            raise ValueError(
                f"persist=True is a {'/'.join(_PERSISTABLE_KINDS)} "
                f"modifier; a persistent {self.kind!r} has no meaning "
                "(kills and poisons are one-shot by nature)")
        if not 0.0 < self.decay <= 1.0:
            raise ValueError("decay must be in (0, 1]")


class ChaosSchedule:
    """A sequence of one-shot in-run faults behind the ``FaultScript``
    supervisor interface.  Faults fire in ``at_iter`` order at the
    first segment boundary at or past their iteration; one
    interrupting fault fires per boundary visit (the supervisor comes
    back after handling it, and the next due fault fires then).

    PERSISTENT ``slow_host`` faults (``ScheduledFault(persist=True)``)
    fire at every boundary at or past their iteration, never exhaust,
    and never interrupt.  ``slow_scale`` (optional callable returning a
    float) scales every slow-host sleep when it fires: wired to the
    process's current share of the data, a rebalance that moves
    partitions off the slow process shrinks its delay.  A bound
    heartbeat (:meth:`bind_heartbeat`; the supervisor binds its own
    writer) is beaten ``phase="slow"`` at the start of every injected
    sleep and every ``beat_interval_s`` during it, so a sleep longer
    than a monitor's staleness window reads as SLOW, not LOST
    (``distributed.HostMonitor.verdicts``).

    ``telemetry`` (optional): one ``chaos`` record a fired fault,
    flushed before a sigkill or kill_replica is delivered, so the kill
    itself is on record.  The replica kinds fire at request boundaries
    (:meth:`before_request`), never at segment boundaries."""

    def __init__(self, faults: Sequence[ScheduledFault], *,
                 telemetry=None, seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 slow_scale: Optional[Callable[[], float]] = None,
                 beat_interval_s: float = 0.25):
        for f in faults:
            if f.kind in FILE_KINDS:
                raise ValueError(
                    f"{f.kind!r} is a FILE fault — applied by the "
                    "campaign driver at relaunch boundaries, not by "
                    "the in-run schedule (ChaosCampaign.file_faults)")
        ordered = sorted(faults, key=lambda f: (f.at_iter,
                                                FAULT_KINDS.index(f.kind)))
        self._poison = [f for f in ordered if f.kind == "nan"]
        self._persistent = [f for f in ordered
                            if f.kind == "slow_host" and f.persist]
        self._persist_fired = [0] * len(self._persistent)
        # replica-scoped faults fire at REQUEST boundaries
        # (before_request), never at segment boundaries: keeping them
        # out of _pending keeps before_segment's interrupt loop exact
        self._replica_persistent = [f for f in ordered
                                    if f.kind == "slow_replica"
                                    and f.persist]
        self._replica_fired = [0] * len(self._replica_persistent)
        self._replica_pending = [f for f in ordered
                                 if f.kind in REPLICA_KINDS
                                 and not f.persist]
        # reader-scoped faults fire at SHARD visits (before_shard),
        # never at segment boundaries
        self._reader_pending = [f for f in ordered
                                if f.kind in READER_KINDS]
        self._pending = [f for f in ordered
                         if f.kind != "nan" and not f.persist
                         and f.kind not in READER_KINDS
                         and f.kind not in REPLICA_KINDS]
        self._telemetry = telemetry
        self.seed = seed  # the campaign's
        self._sleep = sleep
        self._slow_scale = slow_scale
        self._beat_interval_s = float(beat_interval_s)
        self._heartbeat = None
        self.fired: List[Tuple[str, int]] = []  # (kind, boundary iter)

    def bind_heartbeat(self, heartbeat) -> None:
        """Attach the process's ``HeartbeatWriter`` (the supervisor
        does), so injected sleeps keep beating (class docstring)."""
        self._heartbeat = heartbeat

    def _emit(self, fault: ScheduledFault, global_iter: int,
              payload: Optional[float] = None) -> None:
        self.fired.append((fault.kind, global_iter))
        if self._telemetry is not None:
            fields = {"at_iter": int(fault.at_iter),
                      "fired_iter": int(global_iter)}
            if fault.process is not None:
                fields["process"] = int(fault.process)
            eff = fault.payload if payload is None else payload
            if eff:
                fields["payload"] = float(eff)
            if self.seed is not None:
                fields["seed"] = int(self.seed)
            self._telemetry.chaos(fault=fault.kind, **fields)

    def _scale(self) -> float:
        return (max(0.0, float(self._slow_scale()))
                if self._slow_scale is not None else 1.0)

    def _slow_sleep(self, seconds: float, global_iter: int) -> None:
        """One injected straggler sleep: with a bound heartbeat, in
        sub-intervals with a ``phase="slow"`` beat before each, so the
        process's heartbeat file never goes stale mid-sleep; without
        one, a single call."""
        if self._heartbeat is None:
            self._sleep(seconds)
            return
        remaining = float(seconds)
        while remaining > 0:
            try:
                self._heartbeat.beat(iter=global_iter, phase="slow")
            except OSError:
                pass  # a dying filesystem must not mask the drill
            chunk = min(remaining, self._beat_interval_s)
            self._sleep(chunk)
            remaining -= chunk

    # -- the supervisor hooks (FaultScript interface) ---------------------
    def before_segment(self, global_iter: int) -> None:
        for i, f in enumerate(self._persistent):
            if f.at_iter > global_iter:
                continue
            eff = float(f.payload) * (float(f.decay)
                                      ** self._persist_fired[i])
            eff *= self._scale()
            self._persist_fired[i] += 1
            if eff > 1e-9:
                # a straggler rebalanced fully away, or fully decayed,
                # goes quiet
                self._emit(f, global_iter, payload=eff)
                self._slow_sleep(eff, global_iter)
        while self._pending and self._pending[0].at_iter <= global_iter:
            f = self._pending.pop(0)
            self._emit(f, global_iter)
            if f.kind == "slow_host":
                self._slow_sleep((float(f.payload) or 0.25)
                                 * self._scale(), global_iter)
                continue  # a straggler interrupts nothing
            if f.kind == "sigkill":
                if self._telemetry is not None:
                    self._telemetry.flush()  # the kill must be on record
                os.kill(os.getpid(), signal_lib.SIGKILL)
            if f.kind == "sigterm":
                signal_lib.raise_signal(signal_lib.SIGTERM)
                time.sleep(0)  # let the Python-level handler run
                return
            if f.kind == "device_loss":
                raise SimulatedDeviceLoss(
                    f"injected device loss at iteration {global_iter}")
            if f.kind == "fatal":
                raise InjectedFatalError(
                    f"injected fatal config error at iteration "
                    f"{global_iter}")

    def before_request(self, request_index: int) -> None:
        """The serve-fleet mirror of :meth:`before_segment`: a replica
        calls this once per admitted request (``at_iter`` for replica
        kinds = request index).  Persistent ``slow_replica`` faults
        sleep at every request at or past their index (with the same
        ``phase="slow"`` heartbeat sub-beats, so a slowed replica reads
        SLOW and never LOST); one-shot ``slow_replica`` sleeps once;
        ``kill_replica`` flushes telemetry and self-delivers SIGKILL."""
        for i, f in enumerate(self._replica_persistent):
            if f.at_iter > request_index:
                continue
            eff = float(f.payload) * (float(f.decay)
                                      ** self._replica_fired[i])
            eff *= self._scale()
            self._replica_fired[i] += 1
            if eff > 1e-9:
                self._emit(f, request_index, payload=eff)
                self._slow_sleep(eff, request_index)
        while self._replica_pending \
                and self._replica_pending[0].at_iter <= request_index:
            f = self._replica_pending.pop(0)
            self._emit(f, request_index)
            if f.kind == "slow_replica":
                self._slow_sleep(float(f.payload) or 0.25,
                                 request_index)
                continue
            if f.kind == "kill_replica":
                if self._telemetry is not None:
                    self._telemetry.flush()  # the kill must be on record
                os.kill(os.getpid(), signal_lib.SIGKILL)

    def before_shard(self, visit_index: int,
                     path: Optional[str] = None) -> None:
        """The streaming data plane's mirror of :meth:`before_segment`:
        the shard loader calls this once per shard visit, INSIDE the
        retried attempt, so a fault that raises (or corrupts) is
        absorbed by the same retry/quarantine machinery a real flaky
        source would exercise.  ``visit_index`` counts shard visits
        cumulatively across passes; ``path`` is the shard file a
        ``corrupt_shard`` fault overwrites (the fault still fires — on
        record — when the caller cannot name a file).

        ``slow_reader`` and ``hang_reader`` both just sleep their
        payload: the difference is the contract with the caller's
        watchdog — a slow reader's payload is sized BELOW the attempt
        timeout (degraded throughput, same result), a hung reader's
        ABOVE it (the watchdog fires ``AttemptTimeout``, the retry
        comes back, and the popped fault lets the attempt succeed)."""
        while self._reader_pending \
                and self._reader_pending[0].at_iter <= visit_index:
            f = self._reader_pending.pop(0)
            self._emit(f, visit_index)
            if f.kind in ("slow_reader", "hang_reader"):
                self._sleep(float(f.payload) or 0.25)
                continue
            # corrupt_shard: stomp the file's leading bytes with text no
            # LIBSVM parser (native or Python) can read — the epoch must
            # quarantine the shard typed, not crash or silently skip
            if path is not None:
                size = os.path.getsize(path)
                garbage = b"\x00<chaos:corrupt_shard>\x00 not : libsvm\n"
                with open(path, "r+b") as fh:
                    fh.write(garbage[:max(1, size)])

    def take_poison(self, global_iter: int) -> bool:
        if self._poison and self._poison[0].at_iter <= global_iter:
            f = self._poison.pop(0)
            self._emit(f, global_iter)
            return True
        return False

    @property
    def exhausted(self) -> bool:
        """True once every ONE-SHOT fault has fired.  Persistent
        slow-host/slow-replica faults are deliberately excluded: they
        re-fire at every boundary by design, so counting them would
        make a degraded-host campaign read as eternally unfinished."""
        return (not self._pending and not self._poison
                and not self._reader_pending
                and not self._replica_pending)


@dataclasses.dataclass(frozen=True)
class ChaosCampaign:
    """One whole chaos scenario — a seed, its fault set, and the run
    shape it was drawn for.  Pure data: :meth:`schedule_for` builds the
    per-process in-run schedule, :meth:`file_faults` lists the
    driver-applied corruption faults."""

    seed: int
    faults: Tuple[ScheduledFault, ...]
    iters: int
    process_count: int = 1

    @classmethod
    def generate(cls, seed: int, *, iters: int = 48,
                 process_count: int = 1, max_faults: int = 4,
                 p_fatal: float = 0.15) -> "ChaosCampaign":
        """Draw one normalized random campaign, deterministic in
        ``seed``.  Normalization rules (so every campaign is a FAIR
        drill, not a guaranteed wedge): faults arm in the first ~70% of
        the budget (a late rollback must still have room to
        re-converge); at most two ``nan`` faults; file faults only ride
        along with an earlier ``sigterm`` (the relaunch they are
        applied at); in multi-process campaigns numeric/transient
        faults target every process (collective lockstep) while
        kill-class faults pick one victim; with probability ``p_fatal``
        the last fault becomes ``fatal`` — the typed give-up leg.
        About half the drawn ``slow_host`` faults come out PERSISTENT
        (``persist=True`` with a sub-1 decay, so the total injected
        delay stays bounded) — the genuinely-degraded-host scenario
        the straggler scheduler rebalances away from."""
        rng = np.random.default_rng(int(seed))
        pool = ["nan", "device_loss", "slow_host", "sigterm",
                "truncate_ckpt", "scramble_ckpt"]
        n = int(rng.integers(1, max(2, max_faults + 1)))
        hi = max(3, int(iters * 0.7))
        iters_at = sorted(rng.choice(
            np.arange(2, hi), size=min(n, hi - 2), replace=False))
        kinds = [str(pool[int(rng.integers(0, len(pool)))])
                 for _ in iters_at]
        # cap numeric faults at two (each costs a rollback's worth of
        # re-convergence headroom)
        while kinds.count("nan") > 2:
            kinds[kinds.index("nan")] = "device_loss"
        # file faults need a relaunch to be applied at: ensure a
        # sigterm precedes the first one
        file_idx = [i for i, k in enumerate(kinds) if k in FILE_KINDS]
        if file_idx and "sigterm" not in kinds[:file_idx[0]]:
            if file_idx[0] == 0:
                kinds[0] = "sigterm"
                file_idx = [i for i, k in enumerate(kinds)
                            if k in FILE_KINDS]
            else:
                kinds[file_idx[0] - 1] = "sigterm"
        if float(rng.random()) < p_fatal:
            kinds[-1] = "fatal"
        victim = int(rng.integers(0, process_count))
        out = []
        for k, at in zip(kinds, iters_at):
            payload = 0.0
            process: Optional[int] = None
            persist = False
            decay = 1.0
            if k == "slow_host":
                payload = float(rng.uniform(0.02, 0.08))
                if process_count > 1:
                    process = int(rng.integers(0, process_count))
                if float(rng.random()) < 0.5:
                    # the degraded-host variant: per-segment delay with
                    # a sub-1 decay so the total stays bounded (geometric
                    # sum <= payload / (1 - decay))
                    persist = True
                    payload = float(rng.uniform(0.01, 0.04))
                    decay = float(rng.uniform(0.5, 0.85))
            elif k == "truncate_ckpt":
                payload = float(rng.uniform(0.2, 0.7))
            elif k == "scramble_ckpt":
                payload = float(rng.integers(16, 128))
            elif k in ("sigterm", "sigkill", "fatal") \
                    and process_count > 1:
                process = victim
            out.append(ScheduledFault(kind=k, at_iter=int(at),
                                      process=process, payload=payload,
                                      persist=persist, decay=decay))
        return cls(seed=int(seed), faults=tuple(out), iters=int(iters),
                   process_count=int(process_count))

    @classmethod
    def generate_fleet(cls, seed: int, *, requests: int = 64,
                       replica_count: int = 3, max_faults: int = 2,
                       p_kill: float = 0.5) -> "ChaosCampaign":
        """Draw one normalized replica-scoped fleet campaign,
        deterministic in ``seed`` and equal to the JAX package's draw
        (a separate draw path from :meth:`generate`).  Faults arm in the
        first ~70% of the request budget; every fault targets ONE
        replica (``process`` = replica index) and no replica is hit
        twice, so at least one replica always stays healthy; with
        probability ``p_kill`` a fault is ``kill_replica``, otherwise a
        persistent ``slow_replica`` with a sub-1 decay."""
        if replica_count < 2:
            raise ValueError("a fleet campaign needs >= 2 replicas "
                             "(one fault victim plus one survivor)")
        rng = np.random.default_rng(int(seed))
        n = int(rng.integers(1, max(2, max_faults + 1)))
        n = min(n, replica_count - 1)  # one survivor, always
        hi = max(3, int(requests * 0.7))
        req_at = sorted(rng.choice(
            np.arange(1, hi), size=min(n, hi - 1), replace=False))
        victims = rng.choice(np.arange(replica_count),
                             size=len(req_at), replace=False)
        out = []
        for at, victim in zip(req_at, victims):
            if float(rng.random()) < p_kill:
                out.append(ScheduledFault(
                    kind="kill_replica", at_iter=int(at),
                    process=int(victim)))
            else:
                out.append(ScheduledFault(
                    kind="slow_replica", at_iter=int(at),
                    process=int(victim),
                    payload=float(rng.uniform(0.05, 0.2)),
                    persist=True,
                    decay=float(rng.uniform(0.85, 1.0))))
        return cls(seed=int(seed), faults=tuple(out),
                   iters=int(requests),
                   process_count=int(replica_count))

    @property
    def expects_giveup(self) -> bool:
        return any(f.kind == "fatal" for f in self.faults)

    def schedule_for(self, process: int = 0, *, telemetry=None,
                     sleep: Callable[[float], None] = time.sleep,
                     ) -> ChaosSchedule:
        """The in-run schedule of ``process``: the in-run faults that
        target it or every process."""
        mine = [f for f in self.faults if f.kind in IN_RUN_KINDS
                and (f.process is None or f.process == int(process))]
        return ChaosSchedule(mine, telemetry=telemetry, seed=self.seed,
                             sleep=sleep)

    def schedule_for_replica(self, replica: int, *, telemetry=None,
                             sleep: Callable[[float], None] = time.sleep,
                             ) -> ChaosSchedule:
        """The per-replica in-run schedule of a fleet campaign: the
        REPLICA_KINDS faults targeting ``replica`` (a ``process`` of
        None means every replica), behind the same ChaosSchedule
        interface; the replica drives it via ``before_request``."""
        mine = [f for f in self.faults if f.kind in REPLICA_KINDS
                and (f.process is None or f.process == int(replica))]
        return ChaosSchedule(mine, telemetry=telemetry, seed=self.seed,
                             sleep=sleep)

    def file_faults(self) -> Tuple[ScheduledFault, ...]:
        return tuple(f for f in self.faults if f.kind in FILE_KINDS)

    def describe(self) -> str:
        return (f"seed={self.seed} "
                + " ".join(f"{f.kind}"
                           + ("~persist" if f.persist else "")
                           + f"@{f.at_iter}"
                           + (f"/p{f.process}" if f.process is not None
                              else "")
                           for f in self.faults))


class CampaignResult(NamedTuple):
    outcome: str              # converged | gave_up | mismatch | stalled
    final_loss: Optional[float]
    diff: Optional[float]     # |final - baseline| (converged/mismatch)
    relaunches: int
    fired: List[Tuple[str, int]]   # every in-run fault that fired
    file_applied: List[str]        # file faults applied at relaunches
    giveup_message: Optional[str]  # SupervisorGivingUp text
    num_iters: int = 0        # iterations that COUNT at exit — the
    #                           journal's exactly-once census must match
    weights: Any = None       # the final weights (converged/mismatch)


def _apply_file_fault(fault: ScheduledFault, ckpt_path: str, keep: int,
                      seed: int, telemetry=None) -> Optional[str]:
    """Corrupt the newest EXISTING generation of the checkpoint chain
    per the fault's kind/payload; returns what was done (None when no
    checkpoint file exists yet to corrupt)."""
    target = next((p for p in generation_paths(ckpt_path, keep)
                   if os.path.exists(p)), None)
    if target is None:
        return None
    if fault.kind == "truncate_ckpt":
        kept = faults_lib.truncate_file(
            target, keep_fraction=float(fault.payload) or 0.4)
        what = f"truncate_ckpt:{os.path.basename(target)}:{kept}B"
    else:
        n = int(fault.payload) or 64
        faults_lib.scramble_file(target, seed=seed ^ fault.at_iter,
                                 n_bytes=n)
        what = f"scramble_ckpt:{os.path.basename(target)}:{n}B"
    if telemetry is not None:
        telemetry.chaos(fault=fault.kind, at_iter=int(fault.at_iter),
                        outcome=what, seed=int(seed))
    return what


def run_campaign(
    campaign: ChaosCampaign,
    *,
    staged,
    prox,
    reg_value,
    w0,
    config,
    policy,
    workdir: str,
    baseline_loss: float,
    telemetry=None,
    seg_cache: Optional[dict] = None,
    tol: float = 1e-6,
    keep: int = 4,
) -> CampaignResult:
    """Execute one SINGLE-process campaign to its terminal outcome —
    see the module docstring.  The relaunch loop is bounded by the
    fault count (every in-run fault is one-shot), so a campaign can
    never spin: exceeding the bound is reported as ``stalled``, which
    the drill counts as a failure (it would have been a hang).
    ``telemetry`` reaches the checkpointer, the supervisor and the
    schedule, and records each applied file fault."""
    from .supervisor import run_agd_supervised

    ckpt_path = os.path.join(workdir, "chaos_ckpt.npz")
    schedule = campaign.schedule_for(0, telemetry=telemetry)
    file_queue = list(campaign.file_faults())
    file_applied: List[str] = []
    relaunches = 0
    max_relaunches = len(campaign.faults) + 2
    while True:
        ck = AutoCheckpointer(ckpt_path,
                              every_iters=policy.segment_iters,
                              keep=keep, telemetry=telemetry)
        try:
            res = run_agd_supervised(
                prox=prox, reg_value=reg_value, w0=w0, config=config,
                policy=policy, staged=staged, telemetry=telemetry,
                checkpointer=ck, faults=schedule, seg_cache=seg_cache,
                stream_iterations=False)
        except Preempted:
            relaunches += 1
            if relaunches > max_relaunches:
                return CampaignResult("stalled", None, None, relaunches,
                                      schedule.fired, file_applied, None)
            if file_queue:
                what = _apply_file_fault(
                    file_queue.pop(0), ckpt_path, keep, campaign.seed,
                    telemetry=telemetry)
                if what is not None:
                    file_applied.append(what)
            continue
        except SupervisorGivingUp as e:
            return CampaignResult("gave_up", None, None, relaunches,
                                  schedule.fired, file_applied, str(e))
        final = float(res.loss_history[-1])
        diff = abs(final - float(baseline_loss))
        outcome = "converged" if diff <= tol else "mismatch"
        return CampaignResult(outcome, final, diff, relaunches,
                              schedule.fired, file_applied, None,
                              num_iters=int(res.num_iters),
                              weights=res.weights)
