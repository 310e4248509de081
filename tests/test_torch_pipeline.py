"""The port's continuous-learning pipeline against the JAX package's, on
the CPU: ``ContinuousTrainer`` epochs step for step at f64 (losses
1e-9, weights 3e-7, the same iteration counts, in memory and streamed),
the canary's and promoter's scripted decisions (promoted, rejected,
refused, rolled back) equal to JAX's on the same registry contents,
their records valid under both packages' ``obs/schema.py``, and the
re-run ``gate_promotion`` agreeing with the recorded verdicts; and the
supervisor's ``stream_iterations=`` repair (its signature held to
JAX's).  Every wait on a future has a timeout."""

import inspect

import numpy as np
import pytest
import torch

from spark_agd_tpu.core import agd as jagd, smooth as jsmooth
from spark_agd_tpu.data import streaming as jstreaming
from spark_agd_tpu.models import glm as jglm
from spark_agd_tpu.models.evaluation import log_loss as jlog_loss
from spark_agd_tpu.obs import perfgate as jperfgate, schema as jschema
from spark_agd_tpu.ops.losses import LogisticGradient as JLogistic
from spark_agd_tpu.ops.prox import L2Prox as JL2
from spark_agd_tpu import pipeline as jpipeline
from spark_agd_tpu.resilience import supervisor as jsupervisor
from spark_agd_tpu import serve as jserve
from spark_agd_tpu_torch import pipeline as tpipeline
from spark_agd_tpu_torch import serve as tserve
from spark_agd_tpu_torch.core import agd as tagd, smooth as tsmooth
from spark_agd_tpu_torch.data import streaming as tstreaming
from spark_agd_tpu_torch.models import glm as tglm
from spark_agd_tpu_torch.models.evaluation import log_loss as tlog_loss
from spark_agd_tpu_torch.obs import perfgate as tperfgate, schema as tschema
from spark_agd_tpu_torch.ops.losses import LogisticGradient as TLogistic
from spark_agd_tpu_torch.ops.prox import L2Prox as TL2
from spark_agd_tpu_torch.resilience import supervisor as tsupervisor

D = 6
WAIT = 30


def _rng(seed=0):
    return np.random.default_rng(seed)


def _data(seed=0, n=64, dtype=np.float32):
    r = _rng(seed)
    X = r.normal(size=(n, D)).astype(dtype)
    w = _rng(99).normal(size=D).astype(dtype)
    y = (r.random(n) < 1.0 / (1.0 + np.exp(-(X @ w)))).astype(dtype)
    return X, y


# ---------------------------------------------------------------------------
# the supervisor's stream_iterations= (the repair)


def test_run_agd_supervised_takes_every_keyword_of_jax():
    jparams = inspect.signature(jsupervisor.run_agd_supervised).parameters
    tparams = inspect.signature(tsupervisor.run_agd_supervised).parameters
    assert list(tparams) == list(jparams)
    for name, p in jparams.items():
        if p.default is not inspect.Parameter.empty:
            assert tparams[name].default == p.default, name


def test_stream_iterations_has_no_effect_while_telemetry_is_refused():
    X, y = _data(seed=1, dtype=np.float64)
    prox, reg_value = tsmooth.make_prox(TL2(), 0.01)
    staged = tsmooth.make_smooth_staged(TLogistic(), torch.from_numpy(X),
                                        torch.from_numpy(y))
    cfg = tagd.AGDConfig(num_iterations=8, convergence_tol=0.0)

    def fit(**kw):
        return tsupervisor.run_agd_supervised(
            prox=prox, reg_value=reg_value, w0=np.zeros(D), config=cfg,
            staged=staged, **kw)

    a, b = fit(stream_iterations=True), fit(stream_iterations=False)
    assert torch.equal(a.weights, b.weights)
    assert np.array_equal(a.loss_history, b.loss_history)
    with pytest.raises(NotImplementedError, match="observability"):
        fit(stream_iterations=False, telemetry=object())


# ---------------------------------------------------------------------------
# the trainer, step for step


def _policy(pkg):
    return pkg.ResiliencePolicy(max_attempts=3, backoff_base=0.0,
                                jitter=0.0, seed=0, segment_iters=5)


def _trainers(tmp_path, dtype=np.float64, **over):
    """The same trainer in both packages (weights ``dtype``), each with
    its own registry and checkpoints under ``tmp_path``."""
    cfg = dict(num_iterations=12, convergence_tol=0.0)
    jprox, jreg = jsmooth.make_prox(JL2(), 0.01)
    tprox, treg = tsmooth.make_prox(TL2(), 0.01)
    jt = jpipeline.ContinuousTrainer(
        jserve.ModelRegistry(str(tmp_path / "jreg")), JLogistic(),
        prox=jprox, reg_value=jreg, w0=np.zeros(D, dtype),
        config=jagd.AGDConfig(**cfg), policy=_policy(jsupervisor),
        make_model=lambda w: jglm.LogisticRegressionModel(
            np.asarray(w), 0.0),
        checkpoint_path=str(tmp_path / "jck" / "epoch"), **over)
    tt = tpipeline.ContinuousTrainer(
        tserve.ModelRegistry(str(tmp_path / "treg"), device="cpu"),
        TLogistic(), prox=tprox, reg_value=treg, w0=np.zeros(D, dtype),
        config=tagd.AGDConfig(**cfg), policy=_policy(tsupervisor),
        make_model=lambda w: tglm.LogisticRegressionModel(w, 0.0),
        checkpoint_path=str(tmp_path / "tck" / "epoch"), device="cpu",
        **over)
    return jt, tt


def _hold_epoch(jr, tr):
    assert (tr.epoch, tr.generation) == (jr.epoch, jr.generation)
    assert tr.result.num_iters == jr.result.num_iters
    assert tr.result.retries == jr.result.retries
    np.testing.assert_allclose(np.asarray(tr.result.loss_history),
                               np.asarray(jr.result.loss_history),
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(tr.weights.numpy(), np.asarray(jr.weights),
                               rtol=3e-7, atol=1e-12)
    assert tr.final_loss == pytest.approx(jr.final_loss, rel=1e-9)


def test_epochs_match_jax_step_for_step(tmp_path):
    jt, tt = _trainers(tmp_path)
    for seed in (1, 2, 3):
        X, y = _data(seed=seed, dtype=np.float64)
        _hold_epoch(jt.run_epoch(X, y), tt.run_epoch(X, y))
    assert tt.total_iters == jt.total_iters == 36
    # the published candidates are the fits' weights, in the same format
    for g in (1, 2, 3):
        np.testing.assert_allclose(
            tt.registry.load(g).model.weights.numpy(),
            np.asarray(jt.registry.load(g).model.weights), rtol=3e-7)


def test_epoch_two_fits_epoch_two_data(tmp_path):
    """The one shared segment cache rebuilds its smooths over each
    epoch's fresh ``staged`` pair: epoch 2 equals a fresh trainer's first
    epoch on epoch 2's data from epoch 1's weights, bit for bit."""
    _, tt = _trainers(tmp_path)
    r1 = tt.run_epoch(*_data(seed=1, dtype=np.float64))
    build, keys = tt._build, set(tt._seg_cache)
    X2, y2 = _data(seed=2, dtype=np.float64)
    r2 = tt.run_epoch(X2, y2)
    assert tt._build is build and set(tt._seg_cache) == keys
    _, fresh = _trainers(tmp_path / "fresh")
    fresh.weights = r1.weights.clone()
    f2 = fresh.run_epoch(X2, y2)
    assert torch.equal(f2.weights, r2.weights)
    assert np.array_equal(f2.result.loss_history, r2.result.loss_history)


def test_streamed_epochs_match_jax(tmp_path):
    jt, tt = _trainers(tmp_path)
    for seed in (1, 2):
        X, y = _data(seed=seed, n=96, dtype=np.float64)
        jr = jt.run_epoch_streamed(
            jstreaming.StreamingDataset.from_arrays(X, y, batch_rows=32))
        tr = tt.run_epoch_streamed(
            tstreaming.StreamingDataset.from_arrays(X, y, batch_rows=32))
        _hold_epoch(jr, tr)


def test_weight_fault_corrupts_publish_not_chain(tmp_path):
    _, tt = _trainers(tmp_path,
                      weight_fault=lambda epoch, w: w + 100.0)
    r = tt.run_epoch(*_data(seed=1, dtype=np.float64))
    published = tt.registry.load(r.generation).model.weights
    assert torch.equal(published, r.weights + 100.0)
    assert torch.equal(tt.weights, r.weights)


def test_trainer_refuses_telemetry(tmp_path):
    prox, reg_value = tsmooth.make_prox(TL2(), 0.01)
    with pytest.raises(NotImplementedError, match="observability"):
        tpipeline.ContinuousTrainer(
            None, TLogistic(), prox=prox, reg_value=reg_value,
            w0=np.zeros(D), make_model=lambda w: w, telemetry=object(),
            device="cpu")


# ---------------------------------------------------------------------------
# the canary and the promoter: the scripted decisions, both packages


def _model(pkg, seed=1, scale=1.0):
    w = (_rng(seed).normal(size=D) * scale).astype(np.float32)
    if pkg is jglm:
        return jglm.LogisticRegressionModel(w, 0.0)
    return tglm.LogisticRegressionModel(torch.from_numpy(w), 0.0)


class _Stack:
    """One package's serving stack: a registry with one good serving
    generation, its engine and queue, and a canary graded on a held-out
    set; ``scenario`` publishes the candidate the case needs."""

    def __init__(self, pkg, path):
        self.pkg = pkg
        glm = jglm if pkg == "jax" else tglm
        self.glm = glm
        kw = {} if pkg == "jax" else {"device": "cpu"}
        serve = jserve if pkg == "jax" else tserve
        self.pipe = jpipeline if pkg == "jax" else tpipeline
        self.Xv, self.yv = _data(seed=5, n=96)
        self.reg = serve.ModelRegistry(str(path), **kw)
        g1 = _model(glm, seed=99)
        self.reg.publish(g1)
        self.engine = serve.ServeEngine(g1, generation=1, max_batch=8,
                                        min_bucket=4, **kw)
        self.reg.refresh(self.engine)
        self.queue = serve.MicroBatchQueue(self.engine).start()
        self.ctl = self.pipe.CanaryController(
            self.reg, self.engine, self.queue, holdout=(self.Xv, self.yv),
            slice_fraction=1.0, min_shadow_requests=2,
            thresholds={"p50_ms": 50.0, "p99_ms": 50.0})
        self.log_loss = jlog_loss if pkg == "jax" else tlog_loss

    def holdout_loss(self, model):
        return float(self.log_loss(model.predict_proba(self.Xv), self.yv))

    def traffic(self):
        for i in range(6):
            self.ctl.submit(_rng(i).normal(size=(3, D)).astype(
                np.float32)).result(timeout=WAIT)

    def run(self, scenario):
        post_check = None
        override = None
        if scenario == "pass":
            gen = self.reg.publish(_model(self.glm, seed=99))
        elif scenario == "quality_regression":
            gen = self.reg.publish(_model(self.glm, seed=3, scale=40.0))
        elif scenario == "missing":
            gen = 42
        elif scenario == "spec_mismatch":
            w = _rng(4).normal(size=D).astype(np.float32)
            gen = self.reg.publish(self.glm.LinearRegressionModel(
                w if self.pkg == "jax" else torch.from_numpy(w), 0.0))
        else:  # fault_injected: the canary is lied to, post_check sees it
            good = self.holdout_loss(self.reg.current.model)
            gen = self.reg.publish(_model(self.glm, seed=3, scale=40.0))
            override = good

            def post_check(loaded):
                live = self.holdout_loss(loaded.model)
                ok = live <= good * 1.5
                return ok, "" if ok else f"live loss {live:.3f}"
        try:
            started = self.ctl.start_canary(gen, epoch=1,
                                            quality_override=override)
            if started:
                self.traffic()
            report = self.ctl.finish_canary()
            decision = self.pipe.Promoter(
                self.reg, self.engine, post_check=post_check).decide(report)
        finally:
            self.queue.stop()
        return started, report, decision


SCENARIOS = ("pass", "quality_regression", "missing", "spec_mismatch",
             "fault_injected")


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scripted_decisions_equal_jax(tmp_path, scenario):
    j = _Stack("jax", tmp_path / "jax").run(scenario)
    t_stack = _Stack("torch", tmp_path / "torch")
    t = t_stack.run(scenario)
    assert t[0] == j[0]  # shadow serving started or refused pre-flight
    jrep, trep = j[1], t[1]
    assert (trep.verdict, trep.generation, trep.baseline_generation) == (
        jrep.verdict, jrep.generation, jrep.baseline_generation)
    assert len(trep.refusals) == len(jrep.refusals)
    jdec, tdec = j[2], t[2]
    for field in ("decision", "candidate_generation", "from_generation",
                  "to_generation", "gate_status"):
        assert getattr(tdec, field) == getattr(jdec, field), field
    want = {"pass": "promoted", "quality_regression": "rejected",
            "missing": "rejected", "spec_mismatch": "rejected",
            "fault_injected": "rolled_back"}[scenario]
    assert tdec.decision == want
    # HEAD and the engine end where the decision says
    head = tdec.to_generation
    assert t_stack.reg.current.generation == head
    assert t_stack.engine.generation == head
    # the records: valid under both packages' schema, the same keys
    for rec, jrec in ((trep.record, jrep.record),
                      (tdec.record, jdec.record)):
        assert tschema.validate_record(rec) == []
        assert jschema.validate_record(rec) == []
        assert sorted(rec) == sorted(jrec)
        assert rec["kind"] == jrec["kind"]
    if scenario == "fault_injected":
        assert trep.record["quality_fault_injected"] is True
        assert tdec.record["evidence"]["post_check"]
    if scenario == "spec_mismatch":
        assert any("spec mismatch" in s for s in trep.refusals)
        assert trep.record.get("candidate_spec")
    # the promotion gate, re-run over the canary record, agrees
    for perfgate in (tperfgate, jperfgate):
        gate = perfgate.gate_promotion(
            [trep.record], thresholds={"p50_ms": 50.0, "p99_ms": 50.0},
            min_shadow_requests=2)
        verdict = ("refused" if gate.refused
                   else "fail" if gate.failures else "pass")
        assert verdict == trep.verdict


def test_double_start_raises(tmp_path):
    s = _Stack("torch", tmp_path)
    try:
        gen = s.reg.publish(_model(tglm, seed=99))
        assert s.ctl.start_canary(gen)
        with pytest.raises(RuntimeError, match="already open"):
            s.ctl.start_canary(gen)
        s.ctl.finish_canary()
        assert not s.ctl.active
        with pytest.raises(RuntimeError, match="no canary window"):
            s.ctl.finish_canary()
    finally:
        s.queue.stop()


def test_shadow_slice_is_deterministic(tmp_path):
    s = _Stack("torch", tmp_path)
    try:
        s.ctl.slice_fraction = 0.5
        gen = s.reg.publish(_model(tglm, seed=99))
        assert s.ctl.start_canary(gen)
        futs = [s.ctl.submit(_rng(i).normal(size=(2, D)).astype(
            np.float32)) for i in range(10)]
        for f in futs:
            f.result(timeout=WAIT)
        assert s.ctl.shadow_count == 5
        s.ctl.finish_canary()
    finally:
        s.queue.stop()


@pytest.mark.parametrize("cls", ["CanaryController", "Promoter"])
def test_canary_and_promoter_refuse_telemetry(cls):
    with pytest.raises(NotImplementedError, match="observability"):
        if cls == "Promoter":
            tpipeline.Promoter(None, telemetry=object())
        else:
            tpipeline.CanaryController(None, None, None,
                                       telemetry=object())
