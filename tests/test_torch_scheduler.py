"""The port's straggler scheduler (``resilience/scheduler.py``), the
supervisor's ``scheduler=`` and the chaos schedule's heartbeat binding
and ``slow_scale=`` against the JAX package's, on the CPU.

``weighted_counts``, ``assign_weighted`` and ``SkewTracker.fold`` give
JAX's values on seeded inputs; ``StragglerScheduler`` decides as JAX's
under the same fed exchange; the speculation helpers resolve as JAX's on
an f64 problem.  In the supervisor ``scheduler=None`` gives the bits of
no scheduler, a rebalance commits a generation carrying the new
assignment, and the segment after a rebalance computes on the rebuilt
data (the supervisor's built smooths close over the data they were
built from).  A persistent slow host sleeps, scales and beats as JAX's
schedule does."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu.core import agd as jagd, smooth as jsmooth
from spark_agd_tpu.ops import losses as jlosses, prox as jprox
from spark_agd_tpu.resilience import chaos as jchaos, scheduler as jsched
from spark_agd_tpu_torch.core import agd, smooth as tsmooth
from spark_agd_tpu_torch.ops import losses, prox
from spark_agd_tpu_torch.resilience import (
    ChaosSchedule,
    DistributedCheckpointer,
    RebalanceDecision,
    ReschedulePolicy,
    ResiliencePolicy,
    ScheduledFault,
    SkewTracker,
    StragglerScheduler,
    assign_weighted,
    manifest,
    resolve_speculation,
    run_agd_supervised,
    run_speculative_segment,
    scheduler as tsched,
    speculation_due,
)
from spark_agd_tpu_torch.utils import checkpoint as ckpt


# ---------------------------------------------------------------------------
# the weighted re-split and the tracker


def _speed_cases(seed=0, n=40):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        hosts = int(rng.integers(1, 7))
        speeds = list(rng.uniform(0.05, 2.0, hosts))
        if rng.random() < 0.3:
            speeds[int(rng.integers(hosts))] = 0.0
        yield int(rng.integers(0, 40)), speeds, int(rng.integers(0, 3))


def test_weighted_counts_and_assignments_match_jax():
    for n_parts, speeds, floor in _speed_cases():
        mine = tsched.weighted_counts(n_parts, speeds, min_shard=floor)
        assert mine == jsched.weighted_counts(n_parts, speeds,
                                              min_shard=floor)
        assert sum(mine) == n_parts
        assert tsched.modeled_makespan(mine, speeds) \
            <= tsched.modeled_makespan(
                tsched.uniform_counts(n_parts, len(speeds)), speeds)
        union = [f"part-{i:03d}" for i in range(n_parts)][::-1]
        table = assign_weighted(union, speeds, min_shard=floor)
        assert table == jsched.assign_weighted(union, speeds,
                                               min_shard=floor)
        assert sorted(p for row in table for p in row) == sorted(union)
    with pytest.raises(ValueError, match="at least one host"):
        tsched.weighted_counts(3, [])


def test_skew_tracker_fold_matches_jax():
    rng = np.random.default_rng(3)
    mine = SkewTracker(alpha=0.4, floor_s=1e-3, skew_threshold=1.5,
                       trigger_segments=2)
    theirs = jsched.SkewTracker(alpha=0.4, floor_s=1e-3,
                                skew_threshold=1.5, trigger_segments=2)
    for step in range(30):
        costs = {p: float(rng.uniform(0.0, 0.01))
                 * (5.0 if p == 2 and step % 7 < 5 else 1.0)
                 for p in range(4)}
        a, b = mine.fold(costs), theirs.fold(costs)
        assert a == b
    assert mine.speeds() == theirs.speeds() and mine.skew() == theirs.skew()


def test_observe_heartbeats_matches_jax(tmp_path):
    from spark_agd_tpu_torch.resilience import HeartbeatWriter

    for p, phase in ((0, "segment"), (1, "slow"), (2, None)):
        HeartbeatWriter(str(tmp_path), process_index=p,
                        process_count=3).beat(iter=4, phase=phase)
    (tmp_path / "heartbeat.h009.json").write_text("{torn")
    now = 1e12
    mine, theirs = SkewTracker(), jsched.SkewTracker()
    assert mine.observe_heartbeats(str(tmp_path), clock=lambda: now) \
        == theirs.observe_heartbeats(str(tmp_path), clock=lambda: now)
    assert mine.hb_slow == theirs.hb_slow == [1]


def test_policy_validation_matches_jax():
    for bad in (dict(skew_threshold=0.5), dict(trigger_segments=0),
                dict(sync_every=0), dict(min_shard=-1),
                dict(max_rebalances=-1), dict(speculative_multiple=1.0),
                dict(ewma_alpha=0.0), dict(floor_s=0.0)):
        with pytest.raises(ValueError):
            ReschedulePolicy(**bad)
        with pytest.raises(ValueError):
            jsched.ReschedulePolicy(**bad)
    assert dataclasses.asdict(ReschedulePolicy()) == dataclasses.asdict(
        jsched.ReschedulePolicy())


# ---------------------------------------------------------------------------
# the scheduler's decisions under a fed exchange


def _fed_exchange(slow_us, lockstep=True):
    """This process's row beside a fabricated peer whose boundary
    seconds are ``slow_us`` (and whose iteration is off by 4 when
    ``lockstep`` is False)."""
    def exchange(row):
        other = row.copy()
        other[1] = slow_us
        if not lockstep:
            other[0] = row[0] + 4
        return np.stack([row, other])
    return exchange


def _drive(s, segments, boundary_s=0.0002, start=0, k=4):
    out = []
    for i in range(segments):
        d = s.after_segment(start_iter=start + i * k, iters=k,
                            boundary_s=boundary_s)
        out.append(d)
        if d is not None:
            s.apply(d)
    return out


@pytest.mark.parametrize("policy", [
    dict(trigger_segments=2, min_shard=0),
    dict(trigger_segments=3, min_shard=1, sync_every=2),
    dict(trigger_segments=1, max_rebalances=2),
    dict(trigger_segments=2, rebalance=False),
    dict(trigger_segments=2, max_rebalances=0)], ids=str)
def test_scheduler_decisions_match_jax(policy):
    parts = [f"p{i:02d}" for i in range(12)]
    runs = []
    for mod in (tsched, jsched):
        s = mod.StragglerScheduler(
            parts, policy=mod.ReschedulePolicy(**policy), process_index=0,
            process_count=2, exchange=_fed_exchange(400_000))
        decisions = _drive(s, 10)
        runs.append(([None if d is None else d._asdict() for d in decisions],
                     s.assignments, s.rebalances, s.last_snapshot))
    assert runs[0] == runs[1]
    if policy.get("rebalance", True) and policy.get("max_rebalances", 4):
        made = [d for d in runs[0][0] if d is not None]
        assert made and made[0]["straggler"] == 1
        assert made[0]["after"][0] > made[0]["after"][1]


def test_scheduler_initial_table_lockstep_and_single_process():
    s = StragglerScheduler([f"p{i}" for i in range(5)], process_index=1,
                           process_count=2)
    assert s.assignment == ("p1", "p3")
    bad = StragglerScheduler(["a", "b"], process_index=0, process_count=2,
                             exchange=_fed_exchange(1, lockstep=False))
    with pytest.raises(RuntimeError, match="lockstep"):
        bad.after_segment(start_iter=0, iters=4, boundary_s=0.001)
    one = StragglerScheduler(["a", "b", "c"], policy=ReschedulePolicy(
        trigger_segments=1))
    assert all(d is None for d in _drive(one, 4, boundary_s=0.5))
    with pytest.raises(ValueError, match="at least one"):
        StragglerScheduler([])
    # telemetry= is ported (its records: tests/test_torch_telemetry.py)
    from spark_agd_tpu_torch.obs import Telemetry

    tel = Telemetry()
    assert StragglerScheduler(["a"], telemetry=tel).telemetry is tel
    d = RebalanceDecision(0, (("a",), ("b", "c")), ("a",), {}, 2.0, 1,
                          (2, 1), (1, 2))
    assert d.moved == 1


# ---------------------------------------------------------------------------
# the supervisor with scheduler=


def _data(n=96, d=5, seed=5, flip=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    w_true = np.linspace(-1.0, 1.0, d)
    y = ((X @ w_true > 0) != flip).astype(np.float64)
    return X, y


def _staged(X, y):
    return tsmooth.make_smooth_staged(losses.LogisticGradient(),
                                      torch.from_numpy(X),
                                      torch.from_numpy(y))


@pytest.fixture(scope="module")
def problem():
    X, y = _data()
    px, rv = tsmooth.make_prox(prox.L2Prox(), 0.1)
    return dict(staged=_staged(X, y), px=px, rv=rv,
                w0=torch.zeros(5, dtype=torch.float64),
                cfg=agd.AGDConfig(convergence_tol=0.0, num_iterations=24))


def _supervised(p, **kw):
    kw.setdefault("staged", p["staged"])
    return run_agd_supervised(
        prox=p["px"], reg_value=p["rv"], w0=p["w0"], config=p["cfg"],
        policy=ResiliencePolicy(segment_iters=4, max_attempts=2,
                                backoff_base=0.0, jitter=0.0, seed=0),
        **kw)


def _scheduler(rebuild=None, **policy):
    return StragglerScheduler(
        [f"p{i}" for i in range(8)],
        policy=ReschedulePolicy(**{"trigger_segments": 2, **policy}),
        process_index=0, process_count=2, exchange=_fed_exchange(400_000),
        rebuild=rebuild)


def test_scheduler_none_and_observe_only_are_bit_identical(problem):
    plain = _supervised(problem)
    for s in (None, _scheduler(rebalance=False)):
        res = _supervised(problem, scheduler=s)
        assert torch.equal(res.weights, plain.weights)
        assert np.array_equal(res.loss_history, plain.loss_history)
        assert res.attempts == [] or [e["outcome"] for e in res.attempts] \
            == [e["outcome"] for e in plain.attempts]


def test_a_rebalance_commits_the_new_assignment(problem, tmp_path):
    plain = _supervised(problem)
    rebuilt = []

    def rebuild(decision):
        rebuilt.append(decision.mine)
        return problem["staged"]  # the same data: the math is unmoved

    s = _scheduler(rebuild, min_shard=1)
    ck = DistributedCheckpointer(str(tmp_path), every_iters=4, keep=32,
                                 partitions=[f"p{i}" for i in range(0, 8, 2)])
    res = _supervised(problem, scheduler=s, checkpointer=ck)
    assert torch.equal(res.weights, plain.weights)
    assert s.rebalances == 1 and rebuilt == [s.assignment]
    assert ck.partitions == list(s.assignment) != ["p0", "p2", "p4", "p6"]
    # the forced commit right after the rebalance: two generations at
    # iteration 8, the second carrying the new assignment
    by_gen = {g: manifest.load_manifest(str(tmp_path), g)
              for g in manifest.committed_generations(str(tmp_path))}
    at8 = sorted(g for g, m in by_gen.items() if m.prior_iters == 8)
    assert len(at8) == 2
    parts = [list(ckpt.read_npz_entries(
        by_gen[g].shard_path(str(tmp_path), 0))["partitions"]) for g in at8]
    assert parts[0] == ["p0", "p2", "p4", "p6"] and parts[1] == list(
        s.assignment)


def test_after_a_rebalance_segments_compute_on_the_rebuilt_data(problem):
    """The supervisor caches the smooths it builds per segment length;
    they close over the staged data.  After a rebalance swaps ``staged``
    the next segment must see the rebuilt data, as if the fit had
    switched data by hand at that boundary."""
    X2, y2 = _data(seed=6, flip=True)
    other = _staged(X2, y2)
    seg_cache, ats = {}, []
    s = _scheduler(lambda d: ats.append(d.at_iter) or other, min_shard=1)
    res = _supervised(problem, scheduler=s, seg_cache=seg_cache)
    assert s.rebalances == 1 and ats == [8]
    at = ats[0]

    # by hand: `at` iterations on the first data, the rest on the other
    sm, sl = problem["staged"][0](*problem["staged"][1])
    first = agd.run_agd(sm, problem["px"], problem["rv"], problem["w0"],
                        dataclasses.replace(problem["cfg"],
                                            num_iterations=at),
                        smooth_loss=sl)
    warm = ckpt.warm_from_result(first, at)
    sm2, sl2 = other[0](*other[1])
    rest = agd.run_agd(sm2, problem["px"], problem["rv"], warm.x,
                       dataclasses.replace(problem["cfg"],
                                           num_iterations=24 - at),
                       smooth_loss=sl2, warm=warm)
    assert torch.equal(res.weights, rest.weights)
    np.testing.assert_array_equal(
        res.loss_history[at:], rest.loss_history[:24 - at].numpy())
    # and every cached smooth is one built over the rebuilt data
    assert seg_cache and all(entry[0] is other
                             for entry in seg_cache.values())


def test_rebuild_requires_staged(problem):
    X, y = _data(n=8)
    sm = tsmooth.make_smooth(losses.LogisticGradient(), torch.from_numpy(X),
                             torch.from_numpy(y))
    with pytest.raises(ValueError, match="staged"):
        _supervised(problem, staged=None, smooth=sm,
                    scheduler=StragglerScheduler(["a"],
                                                 rebuild=lambda d: None))


# ---------------------------------------------------------------------------
# speculative segments


def test_speculation_due_matches_jax():
    for elapsed, median, mult in ((1.0, 0.0, 3.0), (0.2, 0.1, 3.0),
                                  (0.5, 0.1, 3.0), (0.3, 0.1, 3.0)):
        assert speculation_due(elapsed, median, mult) \
            == jsched.speculation_due(elapsed, median, mult)


def _jax_segment(X, y, n_iters):
    staged = jsmooth.make_smooth_staged(jlosses.LogisticGradient(),
                                        jnp.asarray(X), jnp.asarray(y))
    px, rv = jsmooth.make_prox(jprox.L2Prox(), 0.1)
    cfg = jagd.AGDConfig(convergence_tol=0.0, num_iterations=n_iters)

    def run_segment(ws, k):
        sm, sl = staged[0](*staged[1])
        return jagd.run_agd(sm, px, rv, ws.x,
                            dataclasses.replace(cfg, num_iterations=k),
                            smooth_loss=sl, warm=ws)
    return run_segment, cfg


def test_speculation_resolves_as_jax(problem):
    X, y = _data()
    sm, sl = problem["staged"][0](*problem["staged"][1])

    def run_segment(ws, k):
        return agd.run_agd(sm, problem["px"], problem["rv"], ws.x,
                           dataclasses.replace(problem["cfg"],
                                               num_iterations=k),
                           smooth_loss=sl, warm=ws)

    jrun, jcfg = _jax_segment(X, y, 24)
    clock = iter(np.arange(0.0, 100.0, 0.5)).__next__
    jclock = iter(np.arange(0.0, 100.0, 0.5)).__next__
    warm = agd.AGDWarmState.initial(problem["w0"], problem["cfg"])
    jwarm = jagd.AGDWarmState.initial(jnp.zeros(5), jcfg)
    a = run_speculative_segment(run_segment, warm, 4, clock=clock)
    b = run_speculative_segment(run_segment, warm, 4, clock=clock)
    ja = jsched.run_speculative_segment(jrun, jwarm, 4, clock=jclock)
    assert (a.seconds, a.from_iter, a.iters) == (ja.seconds, ja.from_iter,
                                                ja.iters) == (0.5, 0, 4)
    np.testing.assert_allclose(a.warm.x.numpy(), np.asarray(ja.warm.x),
                               rtol=3e-7, atol=1e-12)
    # the same segment from the same committed carry: the same bits
    same = resolve_speculation(a, b.warm, fleet_seconds=999.0)
    assert same == jsched.resolve_speculation(ja, ja.warm,
                                              fleet_seconds=999.0)
    assert same["matched"] and same["max_diff"] == 0.0
    assert same["outcome"] == "won"
    # a moved carry is caught, and a slow backup lost
    moved = b.warm._replace(x=b.warm.x + 1e-3)
    jmoved = ja.warm._replace(x=ja.warm.x + 1e-3)
    out = resolve_speculation(a, moved, fleet_seconds=0.0, tol=1e-9)
    jout = jsched.resolve_speculation(ja, jmoved, fleet_seconds=0.0,
                                      tol=1e-9)
    assert {k: v for k, v in out.items() if k != "max_diff"} == {
        k: v for k, v in jout.items() if k != "max_diff"}
    assert not out["matched"] and out["outcome"] == "lost"
    np.testing.assert_allclose(out["max_diff"], 1e-3, rtol=1e-9)
    assert tsched.warm_max_diff(a.warm, b.warm) == 0.0


# ---------------------------------------------------------------------------
# the chaos schedule: persistent slow hosts, slow_scale=, heartbeats


class _Beats:
    def __init__(self):
        self.beats = []

    def beat(self, **kw):
        self.beats.append(kw)


@pytest.mark.parametrize("case", ["decay", "scale", "one_shot", "beats"])
def test_slow_host_schedule_matches_jax(case):
    runs = []
    for SF, CS in ((ScheduledFault, ChaosSchedule),
                   (jchaos.ScheduledFault, jchaos.ChaosSchedule)):
        naps, scale, hb = [], [1.0], _Beats()
        kw = dict(sleep=naps.append)
        if case == "decay":
            faults = [SF("slow_host", 4, payload=1.0, persist=True,
                         decay=0.5)]
        elif case == "scale":
            faults = [SF("slow_host", 0, payload=0.5, persist=True)]
            kw["slow_scale"] = lambda: scale[0]
        elif case == "one_shot":
            faults = [SF("slow_host", 2, payload=0.03)]
            kw["slow_scale"] = lambda: 2.0
        else:
            faults = [SF("slow_host", 0, payload=1.0, persist=True),
                      SF("slow_host", 6, payload=0.6)]
            kw["beat_interval_s"] = 0.25
        s = CS(faults, **kw)
        if case == "beats":
            s.bind_heartbeat(hb)
        for it in (0, 4, 8, 12):
            if case == "scale" and it == 8:
                scale[0] = 0.0  # the rebalance took all of its data
            s.before_segment(it)
        runs.append((naps, s.fired, hb.beats, s.exhausted))
    assert runs[0] == runs[1]
    if case == "beats":
        assert runs[0][2] and all(b["phase"] == "slow" for b in runs[0][2])


def test_a_bound_heartbeat_keeps_a_long_sleep_slow_not_lost(tmp_path):
    from spark_agd_tpu_torch.resilience import HeartbeatWriter, HostMonitor

    t = [0.0]
    hb = HeartbeatWriter(str(tmp_path), process_index=0, process_count=1,
                         clock=lambda: t[0])
    mon = HostMonitor(str(tmp_path), stale_after_s=1.0, clock=lambda: t[0])
    verdicts = []

    def sleep(dt):
        t[0] += dt
        verdicts.append(mon.verdicts()[0])

    s = ChaosSchedule([ScheduledFault("slow_host", 0, payload=5.0)],
                      sleep=sleep, beat_interval_s=0.5)
    s.bind_heartbeat(hb)
    s.before_segment(0)
    assert t[0] == 5.0 and verdicts == ["slow"] * 10
    t[0] += 2.0
    assert mon.verdicts() == {0: "lost"}
