"""The port's chaos campaigns (``resilience/chaos.py``) and the reader
faults of ``from_libsvm_parts(chaos=)`` against the JAX package's, on the
CPU.

The same seeds give the JAX package's campaigns (faults, iterations,
payloads); ``run_campaign`` over a seeded problem gives JAX's outcomes,
fired faults, file faults and relaunch counts at f64; the reader kinds
fire inside each retried shard read (``slow_reader`` gives the same
bits, ``hang_reader`` trips the watchdog and the retry succeeds,
``corrupt_shard`` lands in quarantine); and a streamed fit killed mid
pass and resumed through ``AutoCheckpointer`` + ``StreamCheckpoint``
gives the uninterrupted fit's bits (``tests/test_stream_resilience.py``'s
pin, f64)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu.core import agd as jagd, smooth as jsmooth
from spark_agd_tpu.data import libsvm as jlibsvm, streaming as jstreaming
from spark_agd_tpu.ops import losses as jlosses, prox as jprox
from spark_agd_tpu.resilience import chaos as jchaos
from spark_agd_tpu.resilience import ResiliencePolicy as JResiliencePolicy
from spark_agd_tpu.resilience.retry import RetryPolicy as JRetryPolicy
from spark_agd_tpu_torch.core import agd, smooth as tsmooth
from spark_agd_tpu_torch.data import streaming
from spark_agd_tpu_torch.ops import losses, prox
from spark_agd_tpu_torch.resilience import (
    AutoCheckpointer,
    ChaosCampaign,
    ChaosSchedule,
    ResiliencePolicy,
    RetryPolicy,
    ScheduledFault,
    SimulatedDeviceLoss,
    chaos,
    run_agd_supervised,
    run_campaign,
)

D = 6


# ---------------------------------------------------------------------------
# the schedule and the campaign draw


def test_fault_kinds_are_jaxs():
    assert chaos.FAULT_KINDS == jchaos.FAULT_KINDS
    assert chaos.READER_KINDS == jchaos.READER_KINDS
    with pytest.raises(ValueError, match="unknown fault kind"):
        ScheduledFault("meteor", 3)
    with pytest.raises(ValueError, match="at_iter"):
        ScheduledFault("nan", -1)
    with pytest.raises(ValueError, match="FILE fault"):
        ChaosSchedule([ScheduledFault("truncate_ckpt", 4)])
    with pytest.raises(ValueError, match="persist"):
        ScheduledFault("nan", 3, persist=True)


def test_the_schedule_fires_in_order_one_interrupt_per_boundary():
    naps = []
    faults = [ScheduledFault("device_loss", 8), ScheduledFault("fatal", 4),
              ScheduledFault("slow_host", 2, payload=0.03),
              ScheduledFault("nan", 4)]
    sched = ChaosSchedule(faults, seed=11, sleep=naps.append)
    jsched = jchaos.ChaosSchedule(
        [jchaos.ScheduledFault(**dataclasses.asdict(f)) for f in faults],
        seed=11, sleep=lambda s: None)
    for s in (sched, jsched):
        s.before_segment(0)
        s.before_segment(3)  # the straggler sleeps and interrupts nothing
        with pytest.raises(ValueError, match="injected fatal"):
            s.before_segment(5)
        assert s.take_poison(5) and not s.take_poison(5)
        with pytest.raises(SimulatedDeviceLoss if s is sched
                           else jchaos.SimulatedDeviceLoss):
            s.before_segment(9)
        assert s.exhausted
    assert sched.fired == jsched.fired
    assert naps == [0.03]
    assert isinstance(chaos.InjectedFatalError("x"), ValueError)


def _as_jax(campaign):
    return jchaos.ChaosCampaign(
        seed=campaign.seed, iters=campaign.iters,
        process_count=campaign.process_count,
        faults=tuple(jchaos.ScheduledFault(**dataclasses.asdict(f))
                     for f in campaign.faults))


@pytest.mark.parametrize("seeds", [range(0, 60), range(60, 120)],
                         ids=["0-59", "60-119"])
def test_generate_draws_the_jax_campaigns(seeds):
    for seed in seeds:
        for kw in (dict(iters=48), dict(iters=40, max_faults=6),
                   dict(iters=32, process_count=2, p_fatal=0.5)):
            mine = ChaosCampaign.generate(seed, **kw)
            theirs = jchaos.ChaosCampaign.generate(seed, **kw)
            assert _as_jax(mine) == theirs, (seed, kw)
            assert mine.describe() == theirs.describe()
            assert mine.expects_giveup == theirs.expects_giveup


def test_schedule_for_targets_processes_and_lists_file_faults():
    c = ChaosCampaign(
        seed=1, iters=20, process_count=2,
        faults=(ScheduledFault("nan", 4),
                ScheduledFault("sigkill", 8, process=1),
                ScheduledFault("truncate_ckpt", 10, payload=0.4)))
    s0, s1 = c.schedule_for(0), c.schedule_for(1)
    assert s0.take_poison(4) and s1.take_poison(4)
    assert s0.exhausted and not s1.exhausted
    assert [f.kind for f in c.file_faults()] == ["truncate_ckpt"]
    # telemetry= is ported (a chaos record a fired fault), and so are
    # the replica kinds: they fire at request boundaries only
    from spark_agd_tpu_torch.obs import Telemetry

    tel = Telemetry()
    s = ChaosSchedule([ScheduledFault("nan", 2)], telemetry=tel, seed=9)
    assert s.take_poison(3)
    assert [(r["kind"], r["fault"], r["fired_iter"], r["seed"])
            for r in tel.records] == [("chaos", "nan", 3, 9)]
    assert chaos.REPLICA_KINDS == jchaos.REPLICA_KINDS
    for kind in chaos.REPLICA_KINDS:
        s = ChaosSchedule([ScheduledFault(kind, 3)])
        s.before_segment(10)  # never at a segment boundary
        assert s.fired == [] and not s.exhausted


# ---------------------------------------------------------------------------
# campaigns run: the port's outcomes are JAX's


def _campaign_data():
    rng = np.random.default_rng(5)
    X = np.concatenate([rng.standard_normal((240, 1)), np.ones((240, 1))],
                       axis=1)
    y = (rng.random(240) < 1 / (1 + np.exp(-(2.0 * X[:, 0] - 1.5)))
         ).astype(np.float64)
    return X, y


CFG = dict(convergence_tol=0.0, num_iterations=32)
POLICY = dict(max_attempts=3, backoff_base=0.0, jitter=0.0, seed=0,
              segment_iters=4)


@pytest.fixture(scope="module")
def campaign_problem():
    X, y = _campaign_data()
    staged = tsmooth.make_smooth_staged(
        losses.LogisticGradient(), torch.from_numpy(X), torch.from_numpy(y))
    px, rv = tsmooth.make_prox(prox.L2Prox(), 0.1)
    w0 = torch.zeros(2, dtype=torch.float64)
    policy = ResiliencePolicy(**POLICY)
    cfg = agd.AGDConfig(**CFG)
    seg_cache = {}
    base = run_agd_supervised(prox=px, reg_value=rv, w0=w0, config=cfg,
                              policy=policy, staged=staged,
                              seg_cache=seg_cache)
    return dict(staged=staged, prox=px, reg_value=rv, w0=w0, config=cfg,
                policy=policy, seg_cache=seg_cache,
                baseline_loss=float(base.loss_history[-1]))


@pytest.fixture(scope="module")
def jax_campaign_problem():
    X, y = _campaign_data()
    staged = jsmooth.make_smooth_staged(
        jlosses.LogisticGradient(), jnp.asarray(X), jnp.asarray(y))
    px, rv = jsmooth.make_prox(jprox.L2Prox(), 0.1)
    policy = JResiliencePolicy(**POLICY)
    cfg = jagd.AGDConfig(**CFG)
    seg_cache = {}
    from spark_agd_tpu.resilience import run_agd_supervised as jsup

    base = jsup(prox=px, reg_value=rv, w0=jnp.zeros(2), config=cfg,
                policy=policy, staged=staged, seg_cache=seg_cache,
                stream_iterations=False)
    return dict(staged=staged, prox=px, reg_value=rv, w0=jnp.zeros(2),
                config=cfg, policy=policy, seg_cache=seg_cache,
                baseline_loss=float(base.loss_history[-1]))


SCRIPTED = {
    "torn": (ScheduledFault("sigterm", 10),
             ScheduledFault("truncate_ckpt", 12, payload=0.4)),
    "nan_loss": (ScheduledFault("nan", 6), ScheduledFault("device_loss", 14)),
    "fatal": (ScheduledFault("fatal", 8),),
    "scramble": (ScheduledFault("nan", 5), ScheduledFault("sigterm", 12),
                 ScheduledFault("scramble_ckpt", 14, payload=32)),
}


def _both(campaign, campaign_problem, jax_campaign_problem, tmp_path, tag):
    os.makedirs(tmp_path / f"{tag}_port")
    os.makedirs(tmp_path / f"{tag}_jax")
    mine = run_campaign(campaign, workdir=str(tmp_path / f"{tag}_port"),
                        **campaign_problem)
    theirs = jchaos.run_campaign(
        _as_jax(campaign), workdir=str(tmp_path / f"{tag}_jax"),
        **jax_campaign_problem)
    return mine, theirs


def _hold_campaign(mine, theirs):
    assert mine.outcome == theirs.outcome, (mine, theirs)
    assert mine.relaunches == theirs.relaunches
    assert mine.fired == theirs.fired
    assert mine.file_applied == theirs.file_applied
    # num_iters is not compared: after a rollback these fits reach the
    # f64 floor before iteration 32, where the exact-zero-step stop
    # follows the last bit of each package's rounding (31 or 32)
    assert (mine.giveup_message is None) == (theirs.giveup_message is None)
    if mine.final_loss is not None:
        np.testing.assert_allclose(mine.final_loss, theirs.final_loss,
                                   rtol=1e-9)


@pytest.mark.parametrize("name", list(SCRIPTED))
def test_scripted_campaigns_end_as_jaxs(name, campaign_problem,
                                        jax_campaign_problem, tmp_path):
    campaign = ChaosCampaign(seed=900 + len(name), iters=32,
                             faults=SCRIPTED[name])
    mine, theirs = _both(campaign, campaign_problem, jax_campaign_problem,
                         tmp_path, name)
    _hold_campaign(mine, theirs)
    assert mine.outcome == ("gave_up" if name == "fatal" else "converged")
    if name == "fatal":
        assert "InjectedFatalError" in mine.giveup_message
    else:
        assert mine.diff <= 1e-6


@pytest.mark.parametrize("seed", [3, 9, 17, 21, 33])
def test_seeded_campaigns_end_as_jaxs(seed, campaign_problem,
                                      jax_campaign_problem, tmp_path):
    campaign = ChaosCampaign.generate(seed, iters=32)
    # the seeded stragglers sleep 0.01-0.08 s; the outcome does not wait
    # on them
    mine, theirs = _both(campaign, campaign_problem, jax_campaign_problem,
                         tmp_path, f"s{seed}")
    _hold_campaign(mine, theirs)
    assert mine.outcome in ("converged", "gave_up")


# ---------------------------------------------------------------------------
# the reader kinds through from_libsvm_parts(chaos=)


def _write_parts(tmp_path, n_shards=4, rows=24, seed=0):
    rng = np.random.default_rng(seed)
    w_true = np.linspace(-1.0, 1.0, D)
    paths = []
    for k in range(n_shards):
        X = rng.standard_normal((rows, D)).astype(np.float32)
        y = np.where(X @ w_true > 0, 1.0, -1.0)
        p = str(tmp_path / f"part-{k}.libsvm")
        jlibsvm.save_libsvm(p, X, y)
        paths.append(p)
    return paths


def _fast_retries(cls=RetryPolicy, **over):
    kw = dict(max_attempts=3, backoff_base=0.01, backoff_max=0.02,
              jitter=0.0, seed=0)
    kw.update(over)
    return cls(**kw)


def _rows_of(ds):
    n, digest = 0, 0.0
    for X, yb, mb in ds:
        n += int(np.asarray(mb).sum())
        digest += float(np.asarray(yb).sum()) + float(
            np.asarray(X.values, np.float64).sum())
    return n, digest


def test_slow_reader_gives_the_same_bits_and_exhausts(tmp_path):
    paths = _write_parts(tmp_path)
    clean = streaming.StreamingDataset.from_libsvm_parts(
        paths, n_features=D, batch_rows=12, nnz_pad=128)
    sched = ChaosSchedule([ScheduledFault(kind="slow_reader", at_iter=0,
                                          payload=0.05)])
    slow = streaming.StreamingDataset.from_libsvm_parts(
        paths, n_features=D, batch_rows=12, nnz_pad=128,
        retries=_fast_retries(), chaos=sched)
    assert _rows_of(slow) == _rows_of(clean)
    assert ("slow_reader", 0) in sched.fired and sched.exhausted


def test_hang_reader_trips_the_watchdog_and_the_retry_reads(tmp_path):
    paths = _write_parts(tmp_path, n_shards=2)
    sched = ChaosSchedule([ScheduledFault(kind="hang_reader", at_iter=1,
                                          payload=0.6)])
    ds = streaming.StreamingDataset.from_libsvm_parts(
        paths, n_features=D, batch_rows=12, nnz_pad=128,
        retries=_fast_retries(), read_timeout=0.2, chaos=sched)
    n, _ = _rows_of(ds)
    assert n == 2 * 24 and ds.quarantined == {}
    assert sched.fired == [("hang_reader", 1)]
    jsched = jchaos.ChaosSchedule([jchaos.ScheduledFault(
        kind="hang_reader", at_iter=1, payload=0.6)])
    jds = jstreaming.StreamingDataset.from_libsvm_parts(
        paths, n_features=D, batch_rows=12, nnz_pad=128,
        retries=_fast_retries(JRetryPolicy), read_timeout=0.2,
        chaos=jsched)
    list(jds)
    assert jsched.fired == sched.fired


def test_corrupt_shard_lands_in_quarantine_like_jax(tmp_path):
    paths = _write_parts(tmp_path)
    sched = ChaosSchedule([ScheduledFault(kind="corrupt_shard",
                                          at_iter=2)])
    ds = streaming.StreamingDataset.from_libsvm_parts(
        paths, n_features=D, batch_rows=12, nnz_pad=128,
        retries=_fast_retries(), quarantine=True, chaos=sched)
    n, _ = _rows_of(ds)
    assert n == 3 * 24 and list(ds.quarantined) == [paths[2]]
    with open(paths[2], "rb") as f:
        assert b"chaos:corrupt_shard" in f.read(64)
    # the JAX package quarantines the same shard on the same visit
    os.makedirs(tmp_path / "jax")
    jpaths = _write_parts(tmp_path / "jax")
    jds = jstreaming.StreamingDataset.from_libsvm_parts(
        jpaths, n_features=D, batch_rows=12, nnz_pad=128,
        retries=_fast_retries(JRetryPolicy), quarantine=True,
        chaos=jchaos.ChaosSchedule([jchaos.ScheduledFault(
            kind="corrupt_shard", at_iter=2)]))
    list(jds)
    assert [os.path.basename(p) for p in jds.quarantined] == [
        os.path.basename(p) for p in ds.quarantined]


# ---------------------------------------------------------------------------
# a streamed fit killed mid-pass resumes to the uninterrupted bits


def _stream_fit(paths, *, ck=None, on_commit=None, iters=6):
    ds = streaming.StreamingDataset.from_libsvm_parts(
        paths, n_features=D, batch_rows=12, nnz_pad=128,
        retries=_fast_retries(), quarantine=True)
    stream_ckpt = (None if ck is None else streaming.StreamCheckpoint(
        ck, every_batches=2, on_commit=on_commit))
    stats = []
    sm, sl = streaming.make_streaming_smooth(
        losses.LogisticGradient(), ds, stream_ckpt=stream_ckpt,
        device="cpu", pass_stats=stats)
    px, rv = tsmooth.make_prox(prox.L2Prox(), 0.1)
    res = run_agd_supervised(
        smooth=sm, smooth_loss=sl, prox=px, reg_value=rv,
        w0=torch.zeros(D, dtype=torch.float64),
        config=agd.AGDConfig(convergence_tol=0.0, num_iterations=iters),
        policy=ResiliencePolicy(max_attempts=2, backoff_base=0.01,
                                backoff_max=0.02, jitter=0.0, seed=0,
                                segment_iters=2),
        checkpointer=ck, driver="host")
    return res, stats


def test_a_streamed_fit_killed_mid_pass_resumes_bit_identical(tmp_path):
    paths = _write_parts(tmp_path)
    base, _ = _stream_fit(paths)
    ckpt_path = str(tmp_path / "ck.npz")

    class Killed(BaseException):
        """Not an Exception: nothing may catch or retry it."""

    ck = AutoCheckpointer(ckpt_path, every_iters=2, keep=3)

    # 8 batches a pass, a commit every 2: 4 commits a pass, 2 passes an
    # iteration, so commit 18 lands mid-pass in the second segment.  A
    # killed process never reaches the abandon flush, so the kill
    # suppresses it too.
    def kill(count):
        if count >= 18:
            ck.update = lambda *a, **kw: False
            raise Killed

    with pytest.raises(Killed):
        _stream_fit(paths, ck=ck, on_commit=kill)
    res, stats = _stream_fit(
        paths, ck=AutoCheckpointer(ckpt_path, every_iters=2, keep=3))
    assert res.resumed_from > 0
    assert torch.equal(res.weights, base.weights)
    assert list(map(float, res.loss_history)) == \
        list(map(float, base.loss_history))
    # the cursor was consumed, not merely stored
    assert any(s.get("resumed_from_batch") for s in stats)
    assert sum(s.get("skipped_batches", 0) for s in stats) > 0


# ---------------------------------------------------------------------------
# a retried attempt over a streamed smooth: the retry counts its passes
# from the boundary, and an attempt the watchdog gave up on is stopped


def _hooked_dataset(hook, n=60, batch_rows=12, seed=5):
    """``from_arrays`` batches of a seeded problem, ``hook(pass, batch)``
    called before each batch is handed out; returns the dataset and the
    list of passes begun (one entry a pass)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D))
    y = (rng.random(n) < 0.5).astype(np.float64)
    base = streaming.StreamingDataset.from_arrays(X, y, batch_rows)
    passes = []

    def factory():
        passes.append(1)
        p = len(passes)
        for i, b in enumerate(base):
            hook(p, i)
            yield b

    return streaming.StreamingDataset(factory, batch_rows), passes


def _supervised_stream(ds, *, ck=None, every=1, on_commit=None, iters=4,
                       stats=None, **policy):
    stream_ckpt = (None if ck is None else streaming.StreamCheckpoint(
        ck, every_batches=every, on_commit=on_commit))
    sm, sl = streaming.make_streaming_smooth(
        losses.LogisticGradient(), ds, stream_ckpt=stream_ckpt,
        device="cpu", pass_stats=stats)
    px, rv = tsmooth.make_prox(prox.L2Prox(), 0.1)
    return run_agd_supervised(
        smooth=sm, smooth_loss=sl, prox=px, reg_value=rv,
        w0=torch.zeros(D, dtype=torch.float64),
        config=agd.AGDConfig(convergence_tol=0.0, num_iterations=iters),
        policy=ResiliencePolicy(max_attempts=3, backoff_base=0.0,
                                jitter=0.0, seed=0, segment_iters=2,
                                **policy),
        checkpointer=ck, driver="host")


def _join_attempt_threads():
    import threading

    for t in threading.enumerate():
        if t.name.startswith("attempt:"):
            t.join(timeout=30)
            assert not t.is_alive()


def test_a_timed_out_streamed_attempt_is_stopped_and_the_retry_exact(
        tmp_path):
    """The first attempt sleeps past ``attempt_timeout`` inside its
    second pass; the retry claims the ``StreamCheckpoint``, so the
    abandoned attempt stops at its next commit (two passes begun, no
    more) and the fit has the straight streamed fit's bits."""
    import time

    straight_ds, straight_passes = _hooked_dataset(lambda p, i: None)
    straight = _supervised_stream(straight_ds)

    def hook(p, i):
        if (p, i) == (2, 3):
            time.sleep(1.5)

    ds, passes = _hooked_dataset(hook)
    ck = AutoCheckpointer(str(tmp_path / "ck.npz"), every_iters=2)
    res = _supervised_stream(ds, ck=ck, attempt_timeout=0.5)
    _join_attempt_threads()
    assert res.retries == 1 and "AttemptTimeout" in res.attempts[0]["error"]
    assert torch.equal(res.weights, straight.weights)
    assert list(map(float, res.loss_history)) == \
        list(map(float, straight.loss_history))
    assert len(passes) == len(straight_passes) + 2
    kept = AutoCheckpointer(str(tmp_path / "ck.npz")).load(
        torch.zeros(D, dtype=torch.float64))
    assert torch.equal(kept.warm.x, res.weights)


def test_a_retried_segment_counts_its_passes_from_the_boundary(tmp_path):
    """A transient failure in the second pass of the first attempt; the
    retry's cursors carry pass ordinals from 0 again, so a process
    killed inside the retry's second pass resumes to the uninterrupted
    bits."""
    base_ds, _ = _hooked_dataset(lambda p, i: None)
    base = _supervised_stream(base_ds)
    failed = []

    def hook(p, i):
        if (p, i) == (2, 2) and not failed:
            failed.append(1)
            raise SimulatedDeviceLoss("injected mid-pass")

    class Killed(BaseException):
        """Not an Exception: nothing may catch or retry it."""

    ckpt_path = str(tmp_path / "ck.npz")
    ck = AutoCheckpointer(ckpt_path, every_iters=2, keep=3)

    # 5 batches a pass, a commit every 2 (at batches 2 and 4): the first
    # attempt commits twice in pass 0 and once in pass 1 before it
    # fails, the retry twice in its pass 0, so commit 6 lands inside the
    # retry's pass 1
    def kill(count):
        if count >= 6:
            ck.update = lambda *a, **kw: False
            raise Killed

    ds, _ = _hooked_dataset(hook)
    with pytest.raises(Killed):
        _supervised_stream(ds, ck=ck, every=2, on_commit=kill)
    assert failed
    saved = AutoCheckpointer(ckpt_path, keep=3)
    saved.load(torch.zeros(D, dtype=torch.float64))
    cursor = streaming.cursor_from_extras(saved.loaded_extras)
    assert (cursor.pass_offset, cursor.batch_index) == (1, 2)

    stats = []
    resume_ds, _ = _hooked_dataset(lambda p, i: None)
    res = _supervised_stream(
        resume_ds, ck=AutoCheckpointer(ckpt_path, every_iters=2, keep=3),
        every=2, stats=stats)
    assert res.resumed_from == 0
    assert any(s.get("resumed_from_batch") == 2 for s in stats)
    assert torch.equal(res.weights, base.weights)
    assert list(map(float, res.loss_history)) == \
        list(map(float, base.loss_history))
