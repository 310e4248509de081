"""The port's fleet router against the JAX package's, on the CPU.

``serve/router.py`` and ``serve/fleet.py`` are copies: everything after
their module docstrings equals the originals, line for line.  The same
scripted in-process fake backends then drive both packages' routers
through the same request sequences: the spread band's choices, the warm
turn's probe, a flooding tenant's typed sheds, a dead primary's
eviction and transparent retry, ``NoReplicasLeft``, a hedge raced
against a slow primary, and the heartbeat verdicts' evictions and sticky
rejoin.  Each case compares the answers, the router's counters and the
records (``tests/torch_records.py``), which must pass both packages'
schema validators.  Every wait has a timeout."""

import ast
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from spark_agd_tpu.obs import Telemetry as JTelemetry
from spark_agd_tpu.obs import schema as jschema
from spark_agd_tpu.resilience.errors import ServeOverloaded as JOverloaded
from spark_agd_tpu.serve import router as jrouter
from spark_agd_tpu_torch.obs import Telemetry as TTelemetry
from spark_agd_tpu_torch.obs import schema as tschema
from spark_agd_tpu_torch.resilience.errors import ServeOverloaded
from spark_agd_tpu_torch.serve import router as trouter
from torch_records import comparable

ROOT = Path(__file__).resolve().parents[1]
D = 5
WAIT = 10.0

# (router module, telemetry class, the package's ServeOverloaded)
PACKAGES = {"jax": (jrouter, JTelemetry, JOverloaded),
            "torch": (trouter, TTelemetry, ServeOverloaded)}


def _after_docstring(path: Path) -> list:
    src = path.read_text()
    first = ast.parse(src).body[0]
    return src.splitlines(keepends=True)[first.end_lineno:]


@pytest.mark.parametrize("name", ["router", "fleet"])
def test_copied_module_equals_the_original(name):
    mine = ROOT / "spark_agd_tpu_torch" / "serve" / f"{name}.py"
    theirs = ROOT / "spark_agd_tpu" / "serve" / f"{name}.py"
    assert _after_docstring(mine) == _after_docstring(theirs)
    assert f"A copy of ``spark_agd_tpu/serve/{name}.py``" in \
        ast.get_docstring(ast.parse(mine.read_text()))


class FakeBackend:
    """The ``predict`` contract of ``ReplicaHandle`` without a socket:
    the values are a numpy sigmoid of the rows' sums (so an answer names
    its rows), ``latency_s`` sleeps, ``gate`` blocks until set, ``fail``
    raises ``ConnectionError`` (a dead replica)."""

    def __init__(self, replica, *, latency_s=0.0, generation=1,
                 fail=False, gate=None):
        self.replica = int(replica)
        self.latency_s = float(latency_s)
        self.generation = int(generation)
        self.fail = fail
        self.gate = gate
        self.calls = 0
        self.in_flight = 0
        self._lock = threading.Lock()

    def predict(self, rows, op="predict", tenant=None, timeout=30.0):
        with self._lock:
            self.calls += 1
            self.in_flight += 1
        try:
            if self.fail:
                raise ConnectionError(
                    f"fake replica {self.replica} is dead")
            if self.gate is not None:
                self.gate.wait(min(timeout, WAIT))
            if self.latency_s:
                time.sleep(self.latency_s)
            z = np.asarray(rows, np.float64).sum(axis=1)
            return {"values": (1.0 / (1.0 + np.exp(-z))).tolist(),
                    "generation": self.generation,
                    "replica": self.replica,
                    "latency_ms": self.latency_s * 1e3}
        finally:
            with self._lock:
                self.in_flight -= 1


class FakeMonitor:
    """A scripted ``HostMonitor.verdicts()``."""

    def __init__(self, verdicts=None):
        self._verdicts = dict(verdicts or {})

    def set(self, replica, verdict):
        self._verdicts[int(replica)] = verdict

    def verdicts(self):
        return dict(self._verdicts)


def _rows(i, n=2):
    return np.random.default_rng(i).normal(size=(n, D))


def _result(res):
    return (res.replica, res.generation, res.attempt, res.hedged,
            res.retried, [round(v, 12) for v in res.values])


def _stats(router):
    s = router.stats
    return (s.requests, s.retries, s.hedges, s.hedges_won, s.evictions,
            dict(s.shed), dict(s.per_replica), router.members)


# each case drives one package's router and returns what it observed;
# every measured cost below floor_ms (FLOOR_MS where a case's choices
# must not depend on timing) reads as the floor, so the fast fakes tie
# and the router's own order decides, however loaded the host
FLOOR_MS = 1000.0


def _spread(mod, tel, overloaded):
    out = []
    with mod.FleetRouter({r: FakeBackend(r) for r in range(3)},
                         telemetry=tel, floor_ms=FLOOR_MS) as router:
        for i in range(30):
            out.append(_result(router.request(_rows(i), tenant="acme")))
        out.append(_stats(router))
    return out


def _warm(mod, tel, overloaded):
    router = mod.FleetRouter({r: FakeBackend(r) for r in range(3)},
                             telemetry=tel, warm_every=4, floor_ms=5.0)
    router.tracker.observe(0, 50.0)
    out = [router._candidates(set()) for _ in range(8)]
    router.close()
    return out


def _shed(mod, tel, overloaded):
    gate = threading.Event()
    slow = FakeBackend(0, gate=gate)
    out = []
    with mod.FleetRouter({0: slow}, telemetry=tel,
                         tenant_max_outstanding=1) as router:
        held = {}
        t = threading.Thread(target=lambda: held.update(
            alice=router.request(_rows(1, 1), tenant="alice")))
        t.start()
        for _ in range(400):
            if slow.in_flight >= 1:
                break
            time.sleep(0.005)
        for i in range(3):
            with pytest.raises(overloaded) as ei:
                router.request(_rows(2, 1), tenant="alice")
            out.append((str(ei.value), ei.value.queued_rows,
                        ei.value.limit_rows))
        gate.set()
        t.join(timeout=WAIT)
        out.append(_result(held["alice"]))
        out.append(_result(router.request(_rows(3, 1), tenant="bob")))
        out.append(_stats(router))
    out.append((tel.registry.counter("serve.tenant_rejected").value,
                tel.registry.counter("serve.tenant_rejected.alice").value))
    return out


def _evict_retry(mod, tel, overloaded):
    backends = {0: FakeBackend(0, fail=True), 1: FakeBackend(1),
                2: FakeBackend(2)}
    with mod.FleetRouter(backends, telemetry=tel,
                         floor_ms=FLOOR_MS) as router:
        # all tie: the dead replica 0 leads the candidates
        out = [_result(router.request(_rows(i), tenant="t"))
               for i in range(4)]
        out.append(_stats(router))
    return out


def _no_replicas(mod, tel, overloaded):
    backends = {r: FakeBackend(r, fail=True) for r in range(3)}
    with mod.FleetRouter(backends, telemetry=tel) as router:
        with pytest.raises(mod.NoReplicasLeft) as ei:
            router.request(_rows(0))
        out = [str(ei.value), isinstance(ei.value, ConnectionError),
               _stats(router)]
        with pytest.raises(mod.NoReplicasLeft, match="empty fleet"):
            router.request(_rows(1))
    return out


def _hedge(mod, tel, overloaded):
    backends = {0: FakeBackend(0, latency_s=0.4), 1: FakeBackend(1)}
    with mod.FleetRouter(backends, telemetry=tel, hedge_multiple=2.0,
                         hedge_floor_ms=5.0, min_hedge_samples=2,
                         spread_tolerance=1.5) as router:
        router.tracker.observe(0, 1.0)
        router.tracker.observe(1, 5.0)
        out = [_result(router.request(_rows(7)))]
        out.append(_stats(router))
    return out


def _verdicts(mod, tel, overloaded):
    monitor = FakeMonitor({0: "ok", 1: "slow", 2: "ok"})
    b = {r: FakeBackend(r) for r in range(3)}
    router = mod.FleetRouter(dict(b), monitor=monitor, telemetry=tel,
                             floor_ms=FLOOR_MS)
    out = [router.verdict_sync(), router._candidates(set())]
    monitor.set(2, "lost")
    out += [router.verdict_sync(), router.members]
    monitor.set(2, "slow")  # a dead replica's file ageing: no rejoin
    out.append(router.refresh_membership(dict(b)))
    monitor.set(2, "ok")    # a fresh beat: proof of life
    out.append(router.refresh_membership(dict(b)))
    out.append(router.refresh_membership({0: b[0], 2: b[2]}))
    out.append(_result(router.request(_rows(4))))
    out.append(_stats(router))
    router.close()
    return out


CASES = {"spread": _spread, "warm": _warm, "shed": _shed,
         "evict_retry": _evict_retry, "no_replicas": _no_replicas,
         "hedge": _hedge, "verdicts": _verdicts}


@pytest.mark.parametrize("case", sorted(CASES))
def test_router_decisions_equal_jax(case):
    got = {}
    for pkg, (mod, tel_cls, overloaded) in PACKAGES.items():
        tel = tel_cls()
        got[pkg] = (CASES[case](mod, tel, overloaded), tel.records)
    (jout, jrecs), (tout, trecs) = got["jax"], got["torch"]
    assert tout == jout
    # ewma_ms and median_ms are measured costs: timing, not decisions
    drop = ("ewma_ms", "median_ms")
    assert comparable(trecs, drop) == comparable(jrecs, drop)
    for rec in trecs:
        assert tschema.validate_record(rec) == [], rec
        assert jschema.validate_record(rec) == [], rec
    if case == "hedge":
        assert tout[0][0] == 1 and tout[0][3] is True   # hedge won
        assert tout[1][2:4] == (1, 1)
    if case == "evict_retry":
        assert tout[0][2] == 2 and tout[0][4] is True   # retried
        assert 0 not in tout[-1][-1]


def test_latency_tracker_equals_jax():
    mine, theirs = trouter.ReplicaLatencyTracker(alpha=0.3), \
        jrouter.ReplicaLatencyTracker(alpha=0.3)
    r = np.random.default_rng(4)
    for _ in range(40):
        rep, ms = int(r.integers(0, 4)), float(r.exponential(3.0))
        mine.observe(rep, ms)
        theirs.observe(rep, ms)
    assert mine.costs() == theirs.costs()
    assert mine.median_ms() == theirs.median_ms()
    mine.forget(2)
    theirs.forget(2)
    assert mine.costs() == theirs.costs() and mine.samples(2) == 0
