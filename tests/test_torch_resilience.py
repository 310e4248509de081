"""The port's single-device resilience layer (``resilience/faults.py``,
``autockpt.py``, ``supervisor.py``, ``api.run(resilience=,
checkpointer=)``) against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both packages: a
clean supervised run gives the unsegmented ``run_agd``'s bits; a NaN
rolls back, a device loss retries to identical bits, exhaustion gives up
typed with a ledger; the attempt ledger (attempt, outcome, kind, start
iteration, iterations) is JAX's on the same problem and ``FaultScript``
at f64; SIGTERM flushes and raises ``Preempted``; the checkpointer's
cadence, rotation and corrupt-generation skip are JAX's; the watchdog
times an attempt out and the retry gives the straight bits; and the two
real CUDA failure messages classify as the copied rules say."""

import dataclasses
import logging
import os
import signal
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu.core import agd as jagd, smooth as jsmooth
from spark_agd_tpu.ops import losses as jlosses, prox as jprox
from spark_agd_tpu.resilience import (
    FaultScript as JFaultScript,
    ResiliencePolicy as JResiliencePolicy,
    SupervisorGivingUp as JSupervisorGivingUp,
    classify_failure as jclassify,
    run_agd_supervised as jrun_agd_supervised,
)
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.parallel import mesh as tmesh
from spark_agd_tpu_torch.core import agd, host_agd, smooth as tsmooth
from spark_agd_tpu_torch.ops import losses, prox
from spark_agd_tpu_torch.resilience import (
    AutoCheckpointer,
    FaultScript,
    Preempted,
    ResiliencePolicy,
    SimulatedDeviceLoss,
    SupervisorGivingUp,
    classify_failure,
    errors,
    faults,
    generation_paths,
    run_agd_supervised,
    supervised_call,
)
from spark_agd_tpu_torch.utils import checkpoint as ckpt


def _data(n=300, seed=42, dtype=np.float64):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.standard_normal((n, 1)), np.ones((n, 1))],
                       axis=1).astype(dtype)
    y = (rng.random(n) < 1 / (1 + np.exp(-(2.0 * X[:, 0] - 1.5)))
         ).astype(dtype)
    return X, y


@pytest.fixture(scope="module", params=["f64", "f32"])
def problem(request):
    dtype = np.float64 if request.param == "f64" else np.float32
    X, y = _data(dtype=dtype)
    build, dargs = tsmooth.make_smooth_staged(
        losses.LogisticGradient(), torch.from_numpy(X), torch.from_numpy(y))
    px, rv = tsmooth.make_prox(prox.L2Prox(), 0.1)
    w0 = torch.zeros(2, dtype=torch.from_numpy(X).dtype)
    return build, dargs, px, rv, w0, (X, y)


def _policy(cls=ResiliencePolicy, **kw):
    base = dict(max_attempts=3, backoff_base=0.0, jitter=0.0, seed=0,
                segment_iters=5)
    base.update(kw)
    return cls(**base)


def _supervise(problem, cfg, **kw):
    build, dargs, px, rv, w0, _ = problem
    return run_agd_supervised(prox=px, reg_value=rv, w0=w0, config=cfg,
                              staged=(build, dargs), **kw)


def _plain(problem, n):
    build, dargs, px, rv, w0, _ = problem
    sm, sl = build(*dargs)
    return agd.run_agd(sm, px, rv, w0, agd.AGDConfig(
        convergence_tol=0.0, num_iterations=n), smooth_loss=sl)


def _jax_supervise(cfg, faults_=None, **kw):
    X, y = _data()
    staged = jsmooth.make_smooth_staged(jlosses.LogisticGradient(),
                                        jnp.asarray(X), jnp.asarray(y))
    px, rv = jsmooth.make_prox(jprox.L2Prox(), 0.1)
    return jrun_agd_supervised(
        prox=px, reg_value=rv, w0=jnp.zeros(2), config=cfg,
        staged=staged, faults=faults_, stream_iterations=False,
        policy=_policy(JResiliencePolicy, **kw))


def _ledger(entries):
    """A ledger without its wall seconds."""
    return [{k: v for k, v in e.items() if k != "seconds"}
            for e in entries]


# ---------------------------------------------------------------------------
# the failure taxonomy on the card's own errors


CUDA_MESSAGES = {
    "oom": "CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 has a "
           "total capacity of 79.19 GiB of which 1.06 GiB is free. Of the "
           "allocated memory 75.01 GiB is allocated by PyTorch, and 2.48 "
           "GiB is reserved by PyTorch but unallocated. If reserved but "
           "unallocated memory is large try setting PYTORCH_CUDA_ALLOC_CONF"
           "=expandable_segments:True to avoid fragmentation.  See "
           "documentation for Memory Management",
    "illegal_address": "CUDA error: an illegal memory access was "
                       "encountered\nCUDA kernel errors might be "
                       "asynchronously reported at some other API call, so "
                       "the stacktrace below might be incorrect.\nFor "
                       "debugging consider passing CUDA_LAUNCH_BLOCKING=1\n"
                       "Compile with `TORCH_USE_CUDA_DSA` to enable "
                       "device-side assertions.",
    "kernel_launch": "margin_loss_grad launch failed: CUDA error 700 (an "
                     "illegal memory access was encountered)",
}


@pytest.mark.parametrize("name", list(CUDA_MESSAGES))
def test_real_cuda_failures_classify_transient_like_jax(name):
    msg = CUDA_MESSAGES[name]
    exc = (torch.cuda.OutOfMemoryError(msg) if name == "oom"
           else RuntimeError(msg))
    assert isinstance(exc, RuntimeError)
    assert classify_failure(exc) == errors.TRANSIENT
    assert jclassify(RuntimeError(msg)) == errors.TRANSIENT


def test_a_sticky_cuda_error_gives_up_typed_with_its_ledger(problem,
                                                          tmp_path):
    """An illegal address poisons the CUDA context: every retry in the
    process fails again, so the supervisor gives up after
    ``max_attempts`` with the ledger, and the checkpoint on disk stays
    good for the relaunch."""
    build, dargs, px, rv, w0, _ = problem
    calls = []

    def sticky(*da):
        sm, sl = build(*da)

        def broken(w):
            calls.append(1)
            if len(calls) > 12:  # from inside the second segment on
                raise RuntimeError(CUDA_MESSAGES["illegal_address"])
            return sm(w)
        return broken, sl

    path = str(tmp_path / "c.npz")
    with pytest.raises(SupervisorGivingUp) as ei:
        run_agd_supervised(prox=px, reg_value=rv, w0=w0,
                           config=agd.AGDConfig(num_iterations=10),
                           policy=_policy(max_attempts=3),
                           staged=(sticky, dargs),
                           checkpointer=AutoCheckpointer(path))
    assert [e["outcome"] for e in ei.value.ledger] == ["ok"] + [
        "failed"] * 3
    assert [e["failure_kind"] for e in ei.value.ledger[1:]] == [
        errors.TRANSIENT] * 3
    assert "illegal memory access" in str(ei.value)
    kept = AutoCheckpointer(path).load(w0)
    assert kept.warm.prior_iters == 5 and not kept.aborted


def test_a_failing_carry_copy_still_gives_up_typed_and_uninstalls(
        problem, tmp_path, monkeypatch):
    """After a sticky CUDA error the carry's copy to the host fails too:
    the exit flush then writes the host copy taken at the last boundary,
    ``SupervisorGivingUp`` comes out with its ledger, and the signal
    handlers are removed."""
    build, dargs, px, rv, w0, _ = problem
    msg = CUDA_MESSAGES["illegal_address"]
    calls, copies = [], []
    real_host_warm = ckpt.host_warm

    def sticky(*da):
        sm, sl = build(*da)

        def broken(w):
            calls.append(1)
            if len(calls) > 12:  # from inside the second segment on
                raise RuntimeError(msg)
            return sm(w)
        return broken, sl

    def host_warm(warm):
        copies.append(int(warm.prior_iters))
        if len(copies) > 2:  # generation zero and the first segment
            raise RuntimeError(msg)
        return real_host_warm(warm)

    monkeypatch.setattr(ckpt, "host_warm", host_warm)
    before = signal.getsignal(signal.SIGTERM)
    path = str(tmp_path / "c.npz")
    with pytest.raises(SupervisorGivingUp) as ei:
        run_agd_supervised(prox=px, reg_value=rv, w0=w0,
                           config=agd.AGDConfig(num_iterations=10),
                           policy=_policy(max_attempts=2),
                           staged=(sticky, dargs),
                           checkpointer=AutoCheckpointer(path))
    assert copies == [0, 5, 5]  # the exit flush tried the device first
    assert [e["outcome"] for e in ei.value.ledger] == ["ok", "failed",
                                                       "failed"]
    assert "illegal memory access" in str(ei.value)
    assert signal.getsignal(signal.SIGTERM) is before
    monkeypatch.undo()
    kept = AutoCheckpointer(path).load(w0)
    assert kept.warm.prior_iters == 5 and not kept.aborted


# ---------------------------------------------------------------------------
# faults


def test_fault_script_fires_once_and_poisons_once():
    fs = FaultScript(device_loss_at_iter=10, nan_at_iter=3)
    fs.before_segment(5)
    with pytest.raises(SimulatedDeviceLoss):
        fs.before_segment(10)
    fs.before_segment(10)
    assert not fs.take_poison(0)
    assert fs.take_poison(4) and not fs.take_poison(4)
    assert fs.fired == [("device_loss", 10), ("nan", 4)] and fs.exhausted


def test_poison_smooth_goes_non_finite_leafwise():
    sm = faults.poison_smooth(lambda w: (torch.sum(w["a"] ** 2),
                                         {"a": 2.0 * w["a"]}))
    loss, grad = sm({"a": torch.ones(3)})
    assert not torch.isfinite(loss)
    assert not torch.isfinite(grad["a"]).any()
    with pytest.raises(ValueError, match="poison mode"):
        faults.poison_smooth(sm, mode="zero")


def test_file_faults_and_flaky(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"x" * 1000)
    assert faults.truncate_file(str(p), keep_fraction=0.5) == 500
    assert p.stat().st_size == 500
    faults.scramble_file(str(p), seed=3, n_bytes=16, offset=100)
    data = p.read_bytes()
    assert len(data) == 500 and data[:100] == b"x" * 100
    assert data[100:116] != b"x" * 16
    fn = faults.flaky(lambda: 7, 2)
    for _ in range(2):
        with pytest.raises(OSError):
            fn()
    assert fn() == 7 and fn.calls() == 3


# ---------------------------------------------------------------------------
# the checkpointer


def _warm(problem, iters):
    return ckpt.warm_from_result(_plain(problem, iters), iters)


def test_checkpointer_cadence_and_host_copy(problem, tmp_path):
    ck = AutoCheckpointer(str(tmp_path / "c.npz"), every_iters=4, keep=2)
    assert ck.update(_warm(problem, 3), [1.0])       # generation zero
    assert not ck.update(_warm(problem, 5), [1.0])   # 2 iterations since
    assert ck.update(_warm(problem, 8), [1.0])       # 5 since: due
    assert ck.saves == 2
    assert len(ck.copy_seconds) == 3 and len(ck.write_seconds) == 2
    # the held carry is a host copy, written later without the tensors
    held = ck._latest[0]
    assert isinstance(held.x, np.ndarray) and held.prior_iters == 8


def test_checkpointer_rotates_and_skips_a_corrupt_generation(problem,
                                                             tmp_path):
    path = str(tmp_path / "c.npz")
    ck = AutoCheckpointer(path, keep=3)
    for it in (2, 4, 6, 8):
        ck.update(_warm(problem, it), [0.0], force=True)
    gens = generation_paths(path, 3)
    assert [int(ckpt.load_checkpoint(g, problem[4]).warm.prior_iters)
            for g in gens] == [8, 6, 4]
    faults.truncate_file(path, keep_fraction=0.3)
    loaded = AutoCheckpointer(path, keep=3).load(problem[4])
    assert int(loaded.warm.prior_iters) == 6
    for g in gens[1:]:
        faults.scramble_file(g, seed=0)
    assert AutoCheckpointer(path, keep=3).load(problem[4]) is None


def test_sigterm_flushes_and_raises_preempted(problem, tmp_path):
    path = str(tmp_path / "c.npz")
    with AutoCheckpointer(path) as ck:
        ck.update(_warm(problem, 4), [0.5], force=False)
        os.unlink(path)  # only the flush may write it now
        with pytest.raises(Preempted):
            signal.raise_signal(signal.SIGTERM)
    assert os.path.exists(path) and ck.preempted
    assert int(ckpt.load_checkpoint(path,
                                    problem[4]).warm.prior_iters) == 4
    assert signal.getsignal(signal.SIGTERM) is not ck._on_signal


# ---------------------------------------------------------------------------
# the supervisor


def test_clean_supervised_run_gives_the_unsegmented_bits(problem):
    cfg = agd.AGDConfig(convergence_tol=0.0, num_iterations=30)
    plain = _plain(problem, 30)
    sup = _supervise(problem, cfg, policy=_policy())
    assert sup.num_iters == int(plain.num_iters) == 30
    assert torch.equal(sup.weights, plain.weights)
    np.testing.assert_allclose(sup.loss_history,
                               plain.loss_history.numpy(), rtol=0, atol=0)
    assert [a["outcome"] for a in sup.attempts] == ["ok"] * 6


@pytest.mark.parametrize("driver", ["fused", "host"])
def test_a_segment_never_writes_into_its_warm_state(problem, driver):
    """The rollback anchor: a poisoned segment leaves the tensors of the
    warm state it started from as they were."""
    build, dargs, px, rv, w0, _ = problem
    sm, sl = build(*dargs)
    warm = _warm(problem, 4)
    before = (warm.x.clone(), warm.z.clone())
    run = agd.run_agd if driver == "fused" else host_agd.run_agd_host
    res = run(faults.poison_smooth(sm), px, rv, warm.x,
              agd.AGDConfig(num_iterations=5), smooth_loss=sl, warm=warm)
    assert bool(res.aborted_non_finite)
    assert torch.equal(warm.x, before[0]) and torch.equal(warm.z, before[1])
    tree = {"w": warm.x, "v": warm.z}
    twarm = warm._replace(x=tree, z=tree)
    before = {k: v.clone() for k, v in tree.items()}
    run(faults.poison_smooth(lambda t: (sm(t["w"])[0] + sm(t["v"])[0],
                                        {"w": sm(t["w"])[1],
                                         "v": sm(t["v"])[1]})),
        lambda z, g, s: ({k: z[k] - s * g[k] for k in z}, 0.0),
        lambda t: 0.0, tree, agd.AGDConfig(num_iterations=3),
        warm=twarm)
    assert all(torch.equal(tree[k], before[k]) for k in tree)


def test_nan_rollback_resumes_and_converges(problem):
    cfg = agd.AGDConfig(convergence_tol=0.0, num_iterations=30)
    ref = _supervise(problem, cfg, policy=_policy())
    fs = FaultScript(nan_at_iter=10)
    res = _supervise(problem, cfg, policy=_policy(), faults=fs)
    assert fs.fired == [("nan", 10)] and res.rollbacks == 1
    assert [a["outcome"] for a in res.attempts][2] == "aborted_non_finite"
    assert np.isfinite(res.loss_history).all()
    assert abs(res.loss_history[-1] - ref.loss_history[-1]) < 1e-6


def test_device_loss_is_retried_to_identical_bits(problem):
    cfg = agd.AGDConfig(convergence_tol=0.0, num_iterations=20)
    ref = _supervise(problem, cfg, policy=_policy())
    res = _supervise(problem, cfg, policy=_policy(),
                     faults=FaultScript(device_loss_at_iter=10))
    assert res.retries == 1
    assert torch.equal(res.weights, ref.weights)


def test_exhaustion_and_fatal_give_up_typed(problem):
    build, dargs, px, rv, w0, _ = problem
    cfg = agd.AGDConfig(num_iterations=10)
    fs = FaultScript(device_loss_at_iter=0)
    fs._take = lambda attr, it: attr == "_device_loss_at"  # never disarm
    with pytest.raises(SupervisorGivingUp) as ei:
        _supervise(problem, cfg, policy=_policy(max_attempts=3), faults=fs)
    assert [e["failure_kind"] for e in ei.value.ledger] == [
        errors.TRANSIENT] * 3
    poisoned = lambda *da: (faults.poison_smooth(build(*da)[0]),
                            build(*da)[1])
    with pytest.raises(SupervisorGivingUp, match="rollback"):
        run_agd_supervised(prox=px, reg_value=rv, w0=w0, config=cfg,
                           policy=_policy(max_rollbacks=2),
                           staged=(poisoned, dargs))

    def bad_build(*da):
        raise ValueError("config bug")

    with pytest.raises(SupervisorGivingUp, match="fatal"):
        run_agd_supervised(prox=px, reg_value=rv, w0=w0, config=cfg,
                           policy=_policy(), staged=(bad_build, dargs))


SCRIPTS = {
    "clean": {},
    "nan": dict(nan_at_iter=10),
    "device_loss": dict(device_loss_at_iter=5),
    "nan_and_loss": dict(nan_at_iter=5, device_loss_at_iter=10),
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_attempt_ledger_equals_jax(script):
    X, y = _data()
    build, dargs = tsmooth.make_smooth_staged(
        losses.LogisticGradient(), torch.from_numpy(X), torch.from_numpy(y))
    px, rv = tsmooth.make_prox(prox.L2Prox(), 0.1)
    cfg = dict(convergence_tol=0.0, num_iterations=20)
    mine = run_agd_supervised(
        prox=px, reg_value=rv, w0=torch.zeros(2, dtype=torch.float64),
        config=agd.AGDConfig(**cfg), staged=(build, dargs),
        policy=_policy(), faults=FaultScript(**SCRIPTS[script]))
    theirs = _jax_supervise(jagd.AGDConfig(**cfg),
                            JFaultScript(**SCRIPTS[script]))
    assert _ledger(mine.attempts) == _ledger(theirs.attempts)
    assert (mine.retries, mine.rollbacks, mine.num_iters) == (
        theirs.retries, theirs.rollbacks, theirs.num_iters)
    np.testing.assert_allclose(mine.loss_history, theirs.loss_history,
                               rtol=1e-9)
    np.testing.assert_allclose(mine.weights.numpy(),
                               np.asarray(theirs.weights), rtol=3e-7)


def test_give_up_ledger_equals_jax():
    X, y = _data()
    build, dargs = tsmooth.make_smooth_staged(
        losses.LogisticGradient(), torch.from_numpy(X), torch.from_numpy(y))
    px, rv = tsmooth.make_prox(prox.L2Prox(), 0.1)
    fs, jfs = FaultScript(device_loss_at_iter=5), \
        JFaultScript(device_loss_at_iter=5)
    for f in (fs, jfs):
        f._take = lambda attr, it: attr == "_device_loss_at"
    with pytest.raises(SupervisorGivingUp) as mine:
        run_agd_supervised(
            prox=px, reg_value=rv, w0=torch.zeros(2, dtype=torch.float64),
            config=agd.AGDConfig(num_iterations=20),
            staged=(build, dargs), policy=_policy(), faults=fs)
    with pytest.raises(JSupervisorGivingUp) as theirs:
        _jax_supervise(jagd.AGDConfig(num_iterations=20), jfs)
    assert _ledger(mine.value.ledger) == _ledger(theirs.value.ledger)
    assert str(mine.value) == str(theirs.value)


def test_sigterm_preempts_and_the_checkpointer_resumes(problem, tmp_path):
    cfg = agd.AGDConfig(convergence_tol=0.0, num_iterations=20)
    ref = _supervise(problem, cfg, policy=_policy())
    path = str(tmp_path / "c.npz")
    fs = FaultScript(sigterm_at_iter=10)
    with pytest.raises(Preempted):
        _supervise(problem, cfg, policy=_policy(),
                   checkpointer=AutoCheckpointer(path, every_iters=5,
                                                 keep=2), faults=fs)
    res = _supervise(problem, cfg, policy=_policy(),
                     checkpointer=AutoCheckpointer(path, every_iters=5,
                                                   keep=2))
    assert res.resumed_from == 10 and res.num_iters == ref.num_iters
    assert torch.equal(res.weights, ref.weights)
    np.testing.assert_array_equal(res.loss_history, ref.loss_history)
    again = _supervise(problem, cfg, policy=_policy(),
                       checkpointer=AutoCheckpointer(path))
    assert again.resumed_from == 20 and again.attempts == []


@pytest.mark.parametrize("torn", [1, 2])
def test_torn_generations_resume_from_what_survives(problem, tmp_path,
                                                    torn):
    """The preemption flush and the abandon flush each rotate the newest
    carry into the chain (as in the JAX package), so after a SIGTERM at
    15 both generations hold 15: one torn file resumes from ``.bak`` at
    15, two resume from scratch, and both end on the uninterrupted
    bits."""
    cfg = agd.AGDConfig(convergence_tol=0.0, num_iterations=20)
    ref = _supervise(problem, cfg, policy=_policy())
    path = str(tmp_path / "c.npz")
    with pytest.raises(Preempted):
        _supervise(problem, cfg, policy=_policy(),
                   checkpointer=AutoCheckpointer(path, every_iters=5,
                                                 keep=2),
                   faults=FaultScript(sigterm_at_iter=15))
    gens = generation_paths(path, 2)
    assert [int(ckpt.load_checkpoint(g, problem[4],
                                     fallback_to_bak=False)
                .warm.prior_iters) for g in gens] == [15, 15]
    for g in gens[:torn]:
        faults.truncate_file(g, keep_fraction=0.4)
    res = _supervise(problem, cfg, policy=_policy(),
                     checkpointer=AutoCheckpointer(path, every_iters=5,
                                                   keep=2))
    assert res.resumed_from == (15 if torn == 1 else 0)
    assert torch.equal(res.weights, ref.weights)
    np.testing.assert_array_equal(res.loss_history, ref.loss_history)


def test_the_watchdog_times_out_and_the_retry_gives_the_same_bits(problem):
    build, dargs, px, rv, w0, _ = problem
    cfg = agd.AGDConfig(convergence_tol=0.0, num_iterations=10)
    ref = _plain(problem, 10)
    calls = []

    def slow_first(*da):
        sm, sl = build(*da)

        def smooth(w):
            calls.append(1)
            if len(calls) == 1:
                time.sleep(1.0)  # past the watchdog: the attempt times out
            return sm(w)
        return smooth, sl

    res = run_agd_supervised(
        prox=px, reg_value=rv, w0=w0, config=cfg,
        policy=_policy(attempt_timeout=0.3), staged=(slow_first, dargs))
    assert res.retries == 1
    assert res.attempts[0]["failure_kind"] == errors.TRANSIENT
    assert "AttemptTimeout" in res.attempts[0]["error"]
    assert torch.equal(res.weights, ref.weights)
    for t in threading.enumerate():  # the timed-out attempt runs on
        if t.name.startswith("attempt:"):
            t.join(timeout=30)
            assert not t.is_alive()


def test_later_slice_options_raise(problem, tmp_path):
    build, dargs, px, rv, w0, _ = problem
    cfg = agd.AGDConfig(num_iterations=2)
    # telemetry= is ported: the fit is the same, and streams one
    # iteration record an iteration
    from spark_agd_tpu_torch.obs import Telemetry

    tel = Telemetry()
    res = _supervise(problem, cfg, telemetry=tel)
    bare = _supervise(problem, cfg)
    assert torch.equal(res.weights, bare.weights)
    assert [r["iter"] for r in tel.iterations("agd")] == [1, 2]
    # the multi-host slice's options run: a heartbeat, a monitor and a
    # scheduler leave a single-process fit's bits as they were
    from spark_agd_tpu_torch.resilience import (HeartbeatWriter,
                                                HostMonitor,
                                                StragglerScheduler)

    cfg = agd.AGDConfig(num_iterations=12, convergence_tol=0.0)
    plain = _supervise(problem, cfg, policy=_policy())
    hb = HeartbeatWriter(str(tmp_path))
    res = _supervise(problem, cfg, policy=_policy(), heartbeat=hb,
                     monitor=HostMonitor(str(tmp_path)),
                     scheduler=StragglerScheduler(["a", "b"]))
    assert torch.equal(res.weights, plain.weights)
    assert np.array_equal(res.loss_history, plain.loss_history)
    assert hb.beats == 12 // 5 + 2  # a beat a segment, and one at exit

    # a sharded-update build runs its segments through make_agd_run: the
    # same fit as the replicated one, within the parity standard
    from spark_agd_tpu_torch.parallel import sharded_update as tsu

    X, y = problem[-1]
    staged = tsu.make_sharded_staged(
        losses.LogisticGradient(), torch.from_numpy(X), torch.from_numpy(y),
        mesh=tmesh.make_mesh({"data": 2}, devices=["cpu"] * 2))
    res = run_agd_supervised(prox=px, reg_value=rv, w0=w0, config=cfg,
                             policy=_policy(), staged=staged)
    tol = 1e-9 if X.dtype == np.float64 else 1e-5
    assert res.num_iters == plain.num_iters
    np.testing.assert_allclose(res.loss_history, plain.loss_history,
                               rtol=tol)
    # the checkpointer's and supervised_call's telemetry= are ported
    tel = Telemetry()
    ck = AutoCheckpointer(str(tmp_path / "c.npz"), telemetry=tel)
    _supervise(problem, cfg, policy=_policy(), checkpointer=ck)
    assert supervised_call(lambda: 1, telemetry=tel) == 1
    assert {r["action"] for r in tel.records
            if r["kind"] == "recovery"} == {"checkpoint"}
    assert [r["outcome"] for r in tel.records
            if r["kind"] == "attempt"][-1] == "ok"


def test_policy_validation():
    with pytest.raises(ValueError, match="rollback_l_factor"):
        ResiliencePolicy(rollback_l_factor=1.0)
    with pytest.raises(ValueError, match="segment_iters"):
        ResiliencePolicy(segment_iters=0)
    with pytest.raises(ValueError, match="max_rollbacks"):
        ResiliencePolicy(max_rollbacks=-1)
    assert dataclasses.asdict(ResiliencePolicy()) == dataclasses.asdict(
        JResiliencePolicy())


def test_supervised_call_retries_and_gives_up():
    assert supervised_call(faults.flaky(lambda: 0.1, 1), policy=_policy(
        max_attempts=3)) == 0.1
    with pytest.raises(SupervisorGivingUp) as ei:
        supervised_call(faults.flaky(lambda: 1, 9),
                        policy=_policy(max_attempts=2))
    assert [e["outcome"] for e in ei.value.ledger] == ["failed", "failed"]


# ---------------------------------------------------------------------------
# api.run(resilience=, checkpointer=)


def test_run_with_resilience_equals_the_plain_run(problem, caplog):
    _, _, _, _, w0, (X, y) = problem
    kw = dict(reg_param=0.1, initial_weights=np.zeros(2, X.dtype),
              num_iterations=25, device="cpu")
    wp, hp = port.run((X, y), port.LogisticGradient(), port.L2Prox(), **kw)
    with caplog.at_level(logging.INFO, logger="spark_agd_tpu"):
        ws, hs, sres = port.run(
            (X, y), port.LogisticGradient(), port.L2Prox(),
            resilience=ResiliencePolicy(segment_iters=7, jitter=0.0,
                                        seed=0),
            return_result=True, verbose=True, **kw)
    assert torch.equal(wp, ws)
    np.testing.assert_allclose(hp, hs, rtol=0, atol=0)
    assert sres.rollbacks == 0 and sres.retries == 0
    assert any(r.getMessage().startswith(
        f"supervised run: {len(hs)} iterations, 0 retries")
        for r in caplog.records)
    ws2, hs2 = port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                        resilience=True, **kw)
    assert torch.equal(ws2, wp)


def test_run_checkpointer_needs_resilience_and_resumes(problem, tmp_path):
    _, _, _, _, _, (X, y) = problem
    kw = dict(reg_param=0.1, initial_weights=np.zeros(2, X.dtype),
              num_iterations=12, device="cpu", convergence_tol=0.0)
    with pytest.raises(ValueError, match="resilience"):
        port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                 checkpointer=AutoCheckpointer(str(tmp_path / "c.npz")),
                 **kw)
    path = str(tmp_path / "r.npz")
    first = port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                     resilience=_policy(),
                     checkpointer=AutoCheckpointer(path), **kw)
    again, hist, sres = port.run(
        (X, y), port.LogisticGradient(), port.L2Prox(),
        resilience=_policy(), checkpointer=AutoCheckpointer(path),
        return_result=True, **kw)
    assert sres.resumed_from == 12 and torch.equal(again, first[0])
    # journal= and telemetry= are ported: the journal holds the run's
    # decisions, the telemetry its iterations and its run record
    from spark_agd_tpu_torch.obs import Telemetry
    from spark_agd_tpu_torch.resilience import journal as tjournal

    tel = Telemetry()
    jpath = str(tmp_path / "j.wal")
    w, h = port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                    resilience=_policy(), journal=jpath, telemetry=tel,
                    checkpointer=AutoCheckpointer(str(tmp_path / "j.npz")),
                    **kw)
    assert torch.equal(w, first[0])
    assert [r["loss"] for r in tel.records
            if r["kind"] == "iteration"] == h.tolist()
    assert [r["kind"] for r in tel.records].count("run") == 1
    replayed = tjournal.replay(jpath)
    assert replayed.reason is None and replayed.records
    assert replayed.records[0]["kind"] == "journal_replay"
    # a mesh with a model axis runs supervised: its one data slot sums
    # what the single-device fit sums
    mw, mh = port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                      resilience=_policy(), **kw,
                      mesh=tmesh.make_mesh({"data": 1, "model": 2},
                                           devices=["cpu"] * 2))
    assert torch.equal(mw, first[0])
    np.testing.assert_array_equal(mh, first[1])


SINGLE_HOST_NAMES = [
    "AutoCheckpointer", "generation_paths", "ResiliencePolicy",
    "SupervisedResult", "run_agd_supervised", "supervised_call", "faults",
    "FaultScript", "chaos", "ChaosCampaign", "ChaosSchedule",
    "ScheduledFault", "run_campaign"]


@pytest.mark.parametrize("name", SINGLE_HOST_NAMES)
def test_single_host_resilience_names_are_exported_like_jax(name):
    import spark_agd_tpu.resilience as jres
    import spark_agd_tpu_torch.resilience as res

    assert hasattr(jres, name) and hasattr(res, name)
    if name in ("AutoCheckpointer", "ChaosCampaign", "FaultScript",
                "ResiliencePolicy", "SupervisedResult",
                "run_agd_supervised"):
        assert getattr(port, name) is getattr(res, name)
