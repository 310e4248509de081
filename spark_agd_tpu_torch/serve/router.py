"""Fleet router: latency-aware spreading, verdict-driven failover,
tail hedging, and per-tenant admission over a replica fleet.

A copy of ``spark_agd_tpu/serve/router.py``, which needs only
the standard library, ``obs/trace`` and ``resilience/errors``;
``tests/test_torch_router.py`` holds everything after this docstring
to the original, line for line.

One request in, one answer out — and every robustness decision the
router takes on the way is a typed schema record:

- **spread** — each replica carries an EWMA of its observed request
  latency (:class:`ReplicaLatencyTracker`, the request-routing
  generalization of ``resilience.scheduler.SkewTracker``'s per-host
  segment EWMA); a request goes to the candidate minimizing
  ``ewma_ms * (1 + outstanding)`` — cheapest queue-adjusted cost, the
  same "move work toward fast hosts" math as partition rebalancing
  (arXiv 1612.01437 §straggler), applied per request instead of per
  generation.
- **verdicts** — ``HostMonitor.verdicts()`` (the PR-10 heartbeat
  machinery; replicas beat with a serve phase) classifies replicas
  ok/slow/lost.  SLOW is deprioritized but kept *warm*: every
  ``warm_every``-th request trickles to a slow replica so its EWMA
  stays current and recovery is observed, but the bulk of traffic
  shifts away.  Only LOST is evicted (``replica_evict`` recovery,
  once per replica); its in-flight requests are transparently
  retried on a survivor (``request_retry``) — safe by construction,
  predict is pure.
- **hedge** — a request stuck past ``hedge_multiple ×`` the fleet
  median is re-issued to the next-best replica; first answer wins,
  the loser is ignored (``request_hedge`` recovery; the
  ``fleet_route`` record's ``winner`` says who won the race).
- **shed** — per-tenant outstanding caps on top of the queue's typed
  ``ServeOverloaded``: one flooding tenant degrades to *typed
  shedding* (``fleet_route`` decision ``shed_tenant``) while other
  tenants keep their latency budget.  Degrade by shedding — never by
  dropping: an admitted request either returns a value or raises a
  typed error; it is never silently lost.

The router is transport-agnostic: a replica backend is anything with
``predict(rows, op=..., tenant=..., timeout=...) -> dict`` that raises
``ConnectionError`` when the replica is gone and ``ServeOverloaded``
when it sheds (``serve.fleet.ReplicaHandle`` is the TCP one; tests use
in-process fakes).  Elastic membership: :meth:`FleetRouter.refresh_membership`
adopts joins/leaves discovered from the fleet directory.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..obs import trace as trace_lib
from ..resilience.errors import ServeOverloaded

DEFAULT_ALPHA = 0.3
DEFAULT_FLOOR_MS = 0.05
DEFAULT_HEDGE_MULTIPLE = 4.0
DEFAULT_HEDGE_FLOOR_MS = 5.0
DEFAULT_MIN_HEDGE_SAMPLES = 8
DEFAULT_WARM_EVERY = 16
DEFAULT_TENANT_OUTSTANDING = 8
DEFAULT_SPREAD_TOLERANCE = 2.0


class NoReplicasLeft(ConnectionError):
    """Every replica is lost or evicted.  A ``ConnectionError`` so the
    resilience taxonomy classifies it TRANSIENT — the caller backs off
    and retries once membership recovers; nothing is silently dropped.
    """

    def __init__(self, detail: str = ""):
        super().__init__(
            "no live replicas" + (f" ({detail})" if detail else ""))


def _median(sorted_vals: List[float]) -> float:
    """Interpolating median of an already-sorted non-empty list (the
    same convention as ``resilience.scheduler``'s)."""
    n = len(sorted_vals)
    mid = n // 2
    if n % 2:
        return sorted_vals[mid]
    return 0.5 * (sorted_vals[mid - 1] + sorted_vals[mid])


class ReplicaLatencyTracker:
    """Per-replica EWMA of observed request latency (ms) — the
    request-scale twin of ``SkewTracker``'s per-host segment EWMA.
    ``alpha`` weighs the newest sample; ``floor_ms`` keeps costs
    positive so ratios stay meaningful; an unobserved replica costs
    the floor (optimistic: new joiners get traffic until measured)."""

    def __init__(self, *, alpha: float = DEFAULT_ALPHA,
                 floor_ms: float = DEFAULT_FLOOR_MS):
        if not 0 < alpha <= 1:
            raise ValueError("alpha must sit in (0, 1]")
        self.alpha = float(alpha)
        self.floor_ms = float(floor_ms)
        self._ewma: Dict[int, float] = {}
        self._samples: Dict[int, int] = {}

    def observe(self, replica: int, latency_ms: float) -> None:
        r = int(replica)
        s = max(float(latency_ms), 0.0)
        prev = self._ewma.get(r)
        self._ewma[r] = s if prev is None else (
            self.alpha * s + (1.0 - self.alpha) * prev)
        self._samples[r] = self._samples.get(r, 0) + 1

    def forget(self, replica: int) -> None:
        self._ewma.pop(int(replica), None)
        self._samples.pop(int(replica), None)

    def cost(self, replica: int) -> float:
        return max(self._ewma.get(int(replica), self.floor_ms),
                   self.floor_ms)

    def costs(self) -> Dict[int, float]:
        return {r: max(v, self.floor_ms)
                for r, v in sorted(self._ewma.items())}

    def samples(self, replica: int) -> int:
        return self._samples.get(int(replica), 0)

    def median_ms(self) -> Optional[float]:
        """Fleet-median EWMA latency — the hedging yardstick.  None
        until at least one replica has been observed."""
        if not self._ewma:
            return None
        return _median(sorted(max(v, self.floor_ms)
                              for v in self._ewma.values()))


@dataclass
class RouteResult:
    """What :meth:`FleetRouter.request` returns."""

    values: list
    generation: int
    replica: int          # the replica whose answer won
    latency_ms: float     # client-observed, admission -> answer
    attempt: int = 1      # 1 = first try; >1 means retried after evict
    hedged: bool = False  # a hedge was launched for this request
    retried: bool = False


@dataclass
class FleetStats:
    """Router-side counters — the drill's quick verdict numbers; the
    authoritative story is the ``fleet_route`` record stream."""

    requests: int = 0
    retries: int = 0
    hedges: int = 0
    hedges_won: int = 0   # the hedge replica answered first
    evictions: int = 0
    shed: Dict[str, int] = field(default_factory=dict)
    per_replica: Dict[int, int] = field(default_factory=dict)


class FleetRouter:
    """See module docstring.  ``replicas`` maps replica index ->
    backend; ``monitor`` is a ``HostMonitor`` over the fleet heartbeat
    directory (optional: without one every member is assumed ok)."""

    def __init__(self, replicas: Dict[int, object], *,
                 monitor=None, telemetry=None,
                 alpha: float = DEFAULT_ALPHA,
                 floor_ms: float = DEFAULT_FLOOR_MS,
                 hedge_multiple: float = DEFAULT_HEDGE_MULTIPLE,
                 hedge_floor_ms: float = DEFAULT_HEDGE_FLOOR_MS,
                 min_hedge_samples: int = DEFAULT_MIN_HEDGE_SAMPLES,
                 warm_every: int = DEFAULT_WARM_EVERY,
                 spread_tolerance: float = DEFAULT_SPREAD_TOLERANCE,
                 tenant_max_outstanding: int = DEFAULT_TENANT_OUTSTANDING,
                 request_timeout_s: float = 30.0,
                 max_workers: Optional[int] = None):
        if hedge_multiple <= 1:
            raise ValueError("hedge_multiple must be > 1")
        if warm_every < 2:
            raise ValueError("warm_every must be >= 2")
        if spread_tolerance < 1:
            raise ValueError("spread_tolerance must be >= 1")
        if tenant_max_outstanding < 1:
            raise ValueError("tenant_max_outstanding must be >= 1")
        self.monitor = monitor
        self.telemetry = telemetry
        self.tracker = ReplicaLatencyTracker(alpha=alpha,
                                             floor_ms=floor_ms)
        self.hedge_multiple = float(hedge_multiple)
        self.hedge_floor_ms = float(hedge_floor_ms)
        self.min_hedge_samples = int(min_hedge_samples)
        self.warm_every = int(warm_every)
        self.spread_tolerance = float(spread_tolerance)
        self.tenant_max_outstanding = int(tenant_max_outstanding)
        self.request_timeout_s = float(request_timeout_s)
        self.stats = FleetStats()
        self._lock = threading.Lock()
        self._replicas: Dict[int, object] = {
            int(r): b for r, b in replicas.items()}
        self._evicted: set = set()
        self._outstanding: Dict[int, int] = {}
        self._tenant_outstanding: Dict[str, int] = {}
        self._verdicts: Dict[int, str] = {}
        self._warm_tick = 0
        self._pool = ThreadPoolExecutor(
            max_workers=(max_workers if max_workers is not None
                         else 2 * max(len(self._replicas), 1) + 4),
            thread_name_prefix="fleet-router")

    # -- membership --------------------------------------------------------
    @property
    def members(self) -> List[int]:
        with self._lock:
            return sorted(self._replicas)

    def refresh_membership(self, replicas: Dict[int, object]) -> dict:
        """Adopt a freshly-discovered membership map: new replicas
        join (optimistic floor cost — they get traffic immediately),
        absent ones leave.  An EVICTED index is sticky: it only
        rejoins on proof of life — a monitor verdict of ``"ok"`` from
        a fresh heartbeat (a crashed replica's leftover membership
        file reads "slow" while its last beat ages toward stale, and
        must never resurrect it).  The elastic-resume analogue:
        membership changes ride generation boundaries, the caller
        decides when."""
        joined, left = [], []
        verdicts = (self.monitor.verdicts()
                    if self.monitor is not None else {})
        with self._lock:
            incoming = {int(r): b for r, b in replicas.items()}
            for r, backend in incoming.items():
                if r not in self._replicas:
                    if r in self._evicted and verdicts.get(r) != "ok":
                        continue
                    self._replicas[r] = backend
                    self._evicted.discard(r)
                    self.tracker.forget(r)
                    joined.append(r)
            for r in [r for r in self._replicas if r not in incoming]:
                del self._replicas[r]
                self.tracker.forget(r)
                left.append(r)
        if self.telemetry is not None:
            for r in joined:
                self.telemetry.fleet_route(
                    decision="route", replica=r, reason="join",
                    source="serve.router", tool="serve.router")
        return {"joined": joined, "left": left}

    # -- verdicts ----------------------------------------------------------
    def verdict_sync(self) -> Dict[int, str]:
        """Read the monitor's ok/slow/lost verdicts, emit one
        ``replica_verdict`` record per *change*, and evict newly-lost
        replicas (``replica_evict`` recovery, once each).  Called at
        the top of every request; cheap — a directory stat."""
        if self.monitor is None:
            return {r: "ok" for r in self.members}
        raw = self.monitor.verdicts()
        with self._lock:
            verdicts = {r: raw.get(r, "ok") for r in self._replicas}
            changed = [(r, v, self._verdicts.get(r))
                       for r, v in verdicts.items()
                       if self._verdicts.get(r) != v]
            self._verdicts = dict(verdicts)
        for r, v, prev in changed:
            if self.telemetry is not None:
                self.telemetry.replica_verdict(
                    replica=r, verdict=v, previous=prev,
                    source="serve.router", tool="serve.router")
            if v == "lost":
                self._evict(r, reason="heartbeat stale")
        return verdicts

    def _evict(self, replica: int, *, reason: str) -> None:
        with self._lock:
            if replica in self._evicted:
                return
            self._evicted.add(replica)
            self._replicas.pop(replica, None)
            self.tracker.forget(replica)
            self.stats.evictions += 1
        if self.telemetry is not None:
            self.telemetry.recovery(
                action="replica_evict", process=int(replica),
                reason=reason, source="serve.router")

    # -- candidate selection ----------------------------------------------
    def _candidates(self, exclude: set) -> List[int]:
        """Live replicas ranked by queue-adjusted EWMA cost.  OK
        replicas first; SLOW ones appended (kept warm, deprioritized)
        — and every ``warm_every``-th pick deliberately leads with the
        most *expensive* member (by EWMA, not verdict: verdicts can
        flap while the cost stays high) so its estimate keeps
        breathing and a recovered replica can rejoin the spread band.

        Within ``spread_tolerance`` × the cheapest cost, OK replicas
        are ranked least-served-first instead of strictly by cost:
        pure min-cost routing self-reinforces (only the replica that
        gets traffic gets fresh samples) and collapses onto one host;
        the band spreads statistically-equal replicas evenly while a
        genuinely slow one — whose EWMA leaves the band — still loses
        its traffic, which is exactly the shift ``gate_fleet``
        measures."""
        with self._lock:
            verdicts = dict(self._verdicts)
            live = [r for r in self._replicas if r not in exclude]
            outstanding = dict(self._outstanding)
            served = dict(self.stats.per_replica)
            self._warm_tick += 1
            warm_turn = (self._warm_tick % self.warm_every == 0)

        def cost(r: int) -> float:
            return self.tracker.cost(r) * (1 + outstanding.get(r, 0))

        ok = sorted((r for r in live
                     if verdicts.get(r, "ok") == "ok"), key=cost)
        if len(ok) > 1:
            band = cost(ok[0]) * self.spread_tolerance
            near = sorted((r for r in ok if cost(r) <= band),
                          key=lambda r: (served.get(r, 0), cost(r)))
            ok = near + [r for r in ok if r not in near]
        slow = sorted((r for r in live
                       if verdicts.get(r, "ok") == "slow"), key=cost)
        ranked = ok + slow
        if warm_turn and len(ranked) > 1:
            probe = max(ranked, key=self.tracker.cost)
            if probe != ranked[0]:
                ranked = [probe] + [r for r in ranked if r != probe]
        return ranked

    # -- the request path --------------------------------------------------
    def request(self, rows, op: str = "predict",
                tenant: Optional[str] = None,
                timeout: Optional[float] = None) -> RouteResult:
        """Route one request; returns a :class:`RouteResult` or raises
        typed: ``ServeOverloaded`` (tenant cap / fleet-wide shed),
        ``NoReplicasLeft`` (every replica gone — TRANSIENT)."""
        timeout = self.request_timeout_s if timeout is None else timeout
        tenant_key = None if tenant is None else str(tenant)
        self._admit_tenant(tenant_key, rows, op)
        try:
            return self._routed(rows, op, tenant_key, timeout)
        finally:
            self._release_tenant(tenant_key)

    def _admit_tenant(self, tenant: Optional[str], rows, op: str):
        if tenant is None:
            return
        with self._lock:
            n = self._tenant_outstanding.get(tenant, 0)
            if n >= self.tenant_max_outstanding:
                self.stats.shed[tenant] = (
                    self.stats.shed.get(tenant, 0) + 1)
                shed_count = self.stats.shed[tenant]
            else:
                self._tenant_outstanding[tenant] = n + 1
                return
        if self.telemetry is not None:
            self.telemetry.fleet_route(
                decision="shed_tenant", tenant=tenant, op=op,
                rows=int(getattr(rows, "shape", [len(rows)])[0]),
                outstanding=n, reason="tenant admission cap",
                source="serve.router", tool="serve.router")
            self.telemetry.registry.counter(
                "serve.tenant_rejected").inc()
            self.telemetry.registry.counter(
                f"serve.tenant_rejected.{tenant}").inc()
        raise ServeOverloaded(
            n, self.tenant_max_outstanding,
            detail=f"tenant {tenant!r} at admission cap "
                   f"(shed #{shed_count})")

    def _release_tenant(self, tenant: Optional[str]) -> None:
        if tenant is None:
            return
        with self._lock:
            n = self._tenant_outstanding.get(tenant, 0)
            if n > 0:
                self._tenant_outstanding[tenant] = n - 1

    def _issue(self, replica: int, rows, op: str,
               tenant: Optional[str], timeout: float, ctx=None):
        backend = self._replicas.get(replica)
        if backend is None:
            raise ConnectionError(f"replica {replica} left the fleet")
        with self._lock:
            self._outstanding[replica] = (
                self._outstanding.get(replica, 0) + 1)
        try:
            # re-activate the caller's trace context: _issue runs on a
            # pool thread, where the thread-local context is empty
            t0 = time.monotonic()
            with trace_lib.activate(ctx):
                payload = backend.predict(rows, op=op, tenant=tenant,
                                          timeout=timeout)
            # observe the CLIENT-measured wall (includes any injected
            # stall the replica's own queue clock never sees), and do
            # it here — not on the winner in _routed — so a hedged
            # race's LOSER still teaches the tracker its true cost
            self.tracker.observe(
                replica, (time.monotonic() - t0) * 1e3)
            return payload
        finally:
            with self._lock:
                self._outstanding[replica] = max(
                    0, self._outstanding.get(replica, 1) - 1)

    def _hedge_wait_s(self) -> Optional[float]:
        """How long to let the primary run before hedging; None
        disables hedging (not enough samples to trust a median)."""
        med = self.tracker.median_ms()
        if med is None:
            return None
        total = sum(self.tracker.samples(r) for r in self.members)
        if total < self.min_hedge_samples:
            return None
        return max(self.hedge_multiple * med,
                   self.hedge_floor_ms) / 1e3

    def _routed(self, rows, op: str, tenant: Optional[str],
                timeout: float) -> RouteResult:
        t0 = time.monotonic()
        deadline = t0 + timeout
        tried: set = set()
        attempt = 0
        hedged = False
        while True:
            self.verdict_sync()
            candidates = self._candidates(tried)
            if not candidates:
                raise NoReplicasLeft(
                    f"tried {sorted(tried)}" if tried else "empty fleet")
            primary = candidates[0]
            attempt += 1
            tried.add(primary)
            try:
                result = self._race(primary, candidates[1:], rows, op,
                                    tenant, deadline)
            except ConnectionError as e:
                # the replica died under us: evict once, retry the
                # request on a survivor — transparently, because
                # predict is pure (idempotent by construction)
                self._evict(primary, reason=f"{type(e).__name__}: {e}")
                with self._lock:
                    self.stats.retries += 1
                if self.telemetry is not None:
                    self.telemetry.recovery(
                        action="request_retry", process=int(primary),
                        reason=f"replica {primary} unreachable; "
                               f"re-routing (attempt {attempt + 1})",
                        source="serve.router")
                    self.telemetry.fleet_route(
                        decision="retry", replica=primary, op=op,
                        rows=int(getattr(rows, "shape",
                                         [len(rows)])[0]),
                        attempt=attempt,
                        error=f"{type(e).__name__}: {e}",
                        source="serve.router", tool="serve.router",
                        **({} if tenant is None else
                           {"tenant": tenant}))
                continue
            winner, payload, was_hedged = result
            hedged = hedged or was_hedged
            latency_ms = (time.monotonic() - t0) * 1e3
            with self._lock:
                self.stats.requests += 1
                self.stats.per_replica[winner] = (
                    self.stats.per_replica.get(winner, 0) + 1)
                verdict = self._verdicts.get(winner, "ok")
            if self.telemetry is not None:
                self.telemetry.fleet_route(
                    decision="hedge" if was_hedged else "route",
                    replica=primary, winner=winner, op=op,
                    rows=int(getattr(rows, "shape", [len(rows)])[0]),
                    attempt=attempt,
                    latency_ms=round(latency_ms, 3),
                    ewma_ms=round(self.tracker.cost(winner), 3),
                    median_ms=self.tracker.median_ms(),
                    verdict=verdict,
                    generation=int(payload.get("generation", -1)),
                    source="serve.router", tool="serve.router",
                    **({} if tenant is None else {"tenant": tenant}))
            return RouteResult(
                values=payload["values"],
                generation=int(payload.get("generation", -1)),
                replica=winner,
                latency_ms=latency_ms,
                attempt=attempt,
                hedged=hedged,
                retried=attempt > 1)

    def _race(self, primary: int, alternates: List[int], rows, op,
              tenant, deadline):
        """Issue to the primary; if it outlives the hedge window and an
        alternate exists, race a hedge — first answer wins, the loser
        is ignored (predict is pure, an extra answer is just heat).
        Returns ``(winner, payload, hedged)``; raises the primary's
        ``ConnectionError`` only when no hedge answer saved the
        request."""
        remaining = max(deadline - time.monotonic(), 1e-3)
        ctx = trace_lib.current_context()
        fut = self._pool.submit(self._issue, primary, rows, op,
                                tenant, remaining, ctx)
        hedge_wait = self._hedge_wait_s()
        if hedge_wait is not None and alternates:
            done, _ = wait([fut], timeout=min(hedge_wait, remaining))
            if not done:
                hedge_to = alternates[0]
                with self._lock:
                    self.stats.hedges += 1
                if self.telemetry is not None:
                    self.telemetry.recovery(
                        action="request_hedge", process=int(hedge_to),
                        reason=f"primary {primary} exceeded "
                               f"{self.hedge_multiple:g}x fleet "
                               "median; racing a second copy",
                        source="serve.router")
                remaining = max(deadline - time.monotonic(), 1e-3)
                hfut = self._pool.submit(self._issue, hedge_to, rows,
                                         op, tenant, remaining, ctx)
                return self._first_of(primary, fut, hedge_to, hfut,
                                      deadline)
        return primary, fut.result(
            timeout=max(deadline - time.monotonic(), 1e-3)), False

    def _first_of(self, primary, fut, hedge_to, hfut, deadline):
        pending = {fut: primary, hfut: hedge_to}
        first_err = None
        while pending:
            done, _ = wait(list(pending), timeout=max(
                deadline - time.monotonic(), 1e-3),
                return_when=FIRST_COMPLETED)
            if not done:
                raise TimeoutError("request deadline during hedge race")
            for f in done:
                who = pending.pop(f)
                try:
                    payload = f.result()
                except (ConnectionError, ServeOverloaded, OSError) as e:
                    first_err = first_err or e
                    continue
                if who == hedge_to:
                    with self._lock:
                        self.stats.hedges_won += 1
                return who, payload, True
        # both sides failed: surface as ConnectionError so the retry
        # path evicts and re-routes
        if isinstance(first_err, ServeOverloaded):
            raise first_err
        raise ConnectionError(
            f"both primary {primary} and hedge {hedge_to} failed: "
            f"{first_err}")

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
