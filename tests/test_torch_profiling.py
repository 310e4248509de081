"""The port's profiling hooks and the fit entry points' ``telemetry=``
against the JAX package's, on the CPU.

``utils/profiling.py`` mirrors the JAX module name for name (fields and
keywords held to JAX's); ``OneShotTrace`` captures one Chrome trace into
``Telemetry(profile_dir=)``, holding the ``execute`` range.  An AGD fit
through ``api.run`` and ``make_runner`` with ``telemetry=`` streams one
record an iteration bit-equal to the loss history at f64 and thins with
``Telemetry(every=)`` as JAX's; with ``telemetry=None`` its weights and
history are the telemetry run's bits.  The spans come in JAX's order,
``trace`` and ``compile`` on the first call for a weight shape only, the
kernels' first-use build inside ``compile``.  L-BFGS and OWL-QN stream
JAX's records at 1e-9 relative, a failed last line search counted as
JAX counts it.  ``device_synth``'s blockwise least-squares data has the
planted model's statistics."""

import inspect
import json
import math
import os

import numpy as np
import pytest
import torch

from spark_agd_tpu import api as japi
from spark_agd_tpu.obs import Telemetry as JTelemetry
from spark_agd_tpu.ops.losses import LogisticGradient as JLogistic
from spark_agd_tpu.ops.prox import L1Prox as JL1, SquaredL2Updater as JL2
from spark_agd_tpu.utils import profiling as jprofiling
from spark_agd_tpu_torch import api
from spark_agd_tpu_torch.data import device_synth
from spark_agd_tpu_torch.obs import MetricsRegistry, Telemetry, schema
from spark_agd_tpu_torch.ops import fused_kernels
from spark_agd_tpu_torch.ops.losses import LogisticGradient, SoftmaxGradient
from spark_agd_tpu_torch.ops.prox import L1Prox, SquaredL2Updater
from spark_agd_tpu_torch.utils import profiling
from torch_records import assert_same

D = 12
ITER_TOL = {"loss": 1e-9, "L": 1e-9, "theta": 1e-9, "step": 1e-9}


@pytest.fixture(scope="module")
def glm():
    """JAX ``tests/test_obs.py``'s fixture at f64: logistic + L2."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(96, D))
    w_true = rng.normal(size=D)
    y = (1.0 / (1.0 + np.exp(-X @ w_true)) > rng.random(96)).astype(
        np.float64)
    return (X, y), np.zeros(D)


def _run(data, w0, tel, **kw):
    kw = dict(dict(reg_param=0.1, convergence_tol=0.0, num_iterations=7),
              **kw)
    return api.run(data, LogisticGradient(), SquaredL2Updater(),
                   initial_weights=w0, device="cpu", return_result=True,
                   telemetry=tel, **kw)


# ---------------------------------------------------------------------------
# utils/profiling.py


@pytest.mark.parametrize("name", ["trace", "annotate", "OneShotTrace",
                                  "timed_stats", "timed"])
def test_profiling_takes_the_jax_keywords(name):
    mine = inspect.signature(getattr(profiling, name))
    theirs = inspect.signature(getattr(jprofiling, name))
    assert [(p.name, p.kind, p.default) for p in
            mine.parameters.values()] == [
        (p.name, p.kind, p.default) for p in theirs.parameters.values()]


def test_timed_stats_fields_and_span_events():
    assert profiling.TimedStats._fields == jprofiling.TimedStats._fields
    reg = MetricsRegistry()
    calls = []

    def fn(x):
        calls.append(x)
        return torch.full((3,), float(x))

    stats, out = profiling.timed_stats(fn, 2, warmup=2, repeats=5,
                                       registry=reg, name="probe")
    assert len(calls) == 7 and torch.equal(out, torch.full((3,), 2.0))
    assert len(stats.times) == 5 and stats.min_s <= stats.median_s \
        <= stats.max_s
    assert stats.median_s == sorted(stats.times)[2]
    assert reg.snapshot()["probe.count"] == 5
    seconds, out = profiling.timed(fn, 3)
    assert seconds >= 0.0 and float(out[0]) == 3.0


def test_timed_waits_for_each_cuda_device_of_the_result(monkeypatch):
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)

    class _Cuda:  # stands in for a CUDA tensor's device
        type = "cuda"

    card = _Cuda()
    t = torch.zeros(2)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: card))
    profiling._ready({"a": (t, [t])})
    assert len(waited) == 1


def test_one_shot_trace_captures_once(tmp_path):
    capture = profiling.OneShotTrace(str(tmp_path))
    for _ in range(2):
        with capture(), profiling.annotate("execute"):
            torch.ones(64).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and capture.captured == str(tmp_path)
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert [e["name"] for e in events].count("execute") == 1
    off = profiling.OneShotTrace(None)
    with off():
        pass
    assert off.captured is None


# ---------------------------------------------------------------------------
# telemetry= on the AGD fit


def test_run_streams_the_history_bitwise(glm):
    data, w0 = glm
    tel = Telemetry()
    w, hist, res = _run(data, w0, tel)
    recs = tel.iterations("agd")
    assert len(recs) == int(res.num_iters) == len(hist) == 7
    for i, rec in enumerate(recs):
        assert rec["iter"] == i + 1
        assert np.float64(rec["loss"]) == np.float64(hist[i])
        assert schema.validate_record(rec) == []
        assert rec["L"] > 0 and rec["step"] >= 0
    snap = tel.registry.snapshot()
    for phase in ("h2d_transfer", "trace", "compile", "execute"):
        assert snap[f"{phase}.count"] == 1, (phase, snap)
    runs = [r for r in tel.records if r["kind"] == "run"]
    assert len(runs) == 1 and schema.validate_record(runs[0]) == []
    assert runs[0]["iters"] == 7 and runs[0]["tool"] == "api.run"
    # telemetry=None: the same bits, nothing recorded
    w_off, hist_off, res_off = _run(data, w0, None)
    assert torch.equal(w_off, w)
    assert np.array_equal(hist_off, hist)
    assert torch.equal(res_off.diag_l, res.diag_l)


def test_run_records_equal_jax(glm):
    data, w0 = glm
    jtel, tel = JTelemetry(), Telemetry()
    japi.run(data, JLogistic(), JL2(), reg_param=0.1, convergence_tol=0.0,
             num_iterations=7, initial_weights=w0, mesh=False,
             telemetry=jtel)
    _run(data, w0, tel)
    assert_same(tel.records, jtel.records, approx=ITER_TOL)


def test_every_thins_stream(glm):
    data, w0 = glm
    tel = Telemetry(every=2)
    _, hist, _ = _run(data, w0, tel, num_iterations=6)
    assert [r["iter"] for r in tel.iterations("agd")] == [2, 4, 6]
    assert tel.registry.counter("agd.iterations").value == len(hist)


def test_make_runner_spans_in_jax_order(glm, monkeypatch):
    data, w0 = glm
    order = []
    real = fused_kernels.load_for

    def load_for(gradient, device):
        order.append("load_for")
        return real(gradient, device)

    monkeypatch.setattr(fused_kernels, "load_for", load_for)

    class _Order:
        def emit(self, rec):
            if rec["kind"] == "span":
                order.append(rec["name"])

        def flush(self):
            pass

        def close(self):
            pass

    tel = Telemetry([_Order()])
    fit = api.make_runner(data, LogisticGradient(), SquaredL2Updater(),
                          reg_param=0.1, num_iterations=3,
                          convergence_tol=0.0, device="cpu", telemetry=tel)
    first = fit(w0)
    second = fit(w0)
    # trace and compile on the first call for a weight shape only; the
    # kernels' first-use build inside compile, so execute never absorbs it
    assert order == ["h2d_transfer", "trace", "load_for", "compile",
                     "execute", "h2d_transfer", "execute"]
    assert torch.equal(first.weights, second.weights)
    fit(np.zeros(D, np.float32))  # another dtype: traced again
    assert order[-4:] == ["trace", "load_for", "compile", "execute"]
    plain = api.make_runner(data, LogisticGradient(), SquaredL2Updater(),
                            reg_param=0.1, num_iterations=3,
                            convergence_tol=0.0, device="cpu")
    assert torch.equal(plain(w0).weights, first.weights)


def test_load_for_builds_only_what_the_gradient_launches(monkeypatch):
    built = []
    monkeypatch.setattr(fused_kernels, "library",
                        lambda: built.append("margin"))
    monkeypatch.setattr(fused_kernels, "softmax_library",
                        lambda: built.append("softmax"))
    fused = fused_kernels.FusedLogisticGradient()
    assert fused_kernels.load_for(fused, "cpu") == ()
    assert fused_kernels.load_for(LogisticGradient(), "cuda") == ()
    assert fused_kernels.load_for(fused, "cuda") == ("margin_loss_grad",)
    soft = fused_kernels.FusedSoftmaxGradient(SoftmaxGradient(3))
    assert fused_kernels.load_for(soft, "cuda:0") == ("softmax_loss_grad",)
    assert built == ["margin", "softmax"]


def test_profile_dir_captures_the_first_execute(glm, tmp_path):
    data, w0 = glm
    tel = Telemetry(profile_dir=str(tmp_path / "prof"))
    fit = api.make_runner(data, fused_kernels.FusedLogisticGradient(),
                          SquaredL2Updater(), reg_param=0.1,
                          num_iterations=4, convergence_tol=0.0,
                          device="cpu", telemetry=tel)
    fit(w0)
    fit(w0)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1
    with open(tmp_path / "prof" / files[0]) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    # the capture holds execute alone: the phases before it ran outside
    assert names.count("execute") == 1
    assert "h2d_transfer" not in names and "compile" not in names


# ---------------------------------------------------------------------------
# L-BFGS and OWL-QN


@pytest.mark.parametrize("algorithm", ["lbfgs", "owlqn"])
def test_quasi_newton_streams_equal_jax(glm, algorithm):
    data, w0 = glm
    jtel, tel = JTelemetry(), Telemetry()
    jupd, upd = ((JL2(), SquaredL2Updater()) if algorithm == "lbfgs"
                 else (JL1(), L1Prox()))
    # tol 0 and 60 iterations: the run ends on a failed line search at
    # the f64 noise floor, whose last pass is counted, not recorded
    kw = dict(reg_param=0.01, num_iterations=60, convergence_tol=0.0,
              initial_weights=w0)
    jres = japi.run_lbfgs(data, JLogistic(), jupd, mesh=False,
                          telemetry=jtel, **kw)
    res = api.run_lbfgs(data, LogisticGradient(), upd, device="cpu",
                        telemetry=tel, **kw)
    k = int(res.num_iters)
    assert k == int(jres.num_iters)
    assert_same(tel.records, jtel.records, approx=ITER_TOL)
    hist = res.loss_history.numpy()
    for rec in tel.iterations(algorithm):
        assert np.float64(rec["loss"]) == np.float64(hist[rec["iter"]])
    counters = [t.registry.counter(f"{algorithm}.rejected_steps").value
                for t in (tel, jtel)]
    assert counters[0] == counters[1] == int(bool(res.ls_failed)
                                             or bool(
                                                 res.aborted_non_finite))
    assert tel.records[-1]["kind"] == "run"
    assert tel.records[-1]["algorithm"] == algorithm


def test_quasi_newton_telemetry_none_is_the_same_fit(glm):
    data, w0 = glm
    for upd in (SquaredL2Updater(), L1Prox()):
        a = api.run_lbfgs(data, LogisticGradient(), upd, reg_param=0.01,
                          num_iterations=20, initial_weights=w0,
                          device="cpu", telemetry=Telemetry())
        b = api.run_lbfgs(data, LogisticGradient(), upd, reg_param=0.01,
                          num_iterations=20, initial_weights=w0,
                          device="cpu")
        assert torch.equal(a.weights, b.weights)
        assert torch.equal(a.loss_history.isnan(), b.loss_history.isnan())
        k = int(a.num_iters)
        assert torch.equal(a.loss_history[:k + 1], b.loss_history[:k + 1])


# ---------------------------------------------------------------------------
# device_synth's blockwise least squares (BASELINE config 2's generator)


def test_linreg_blocks_hold_the_planted_model():
    # checked: the planted model's statistics, not the JAX package's bits
    # (its threefry stream is not Philox's)
    d, rows, noise, seed = 16, 4096, 0.1, 2
    w = device_synth.linreg_params(d, seed=seed, device="cpu")
    assert w.shape == (d,) and w.dtype == torch.float32
    assert torch.equal(w, device_synth.linreg_params(d, seed=seed,
                                                     device="cpu"))
    blocks = [device_synth.linreg_block(w, rows, noise, seed=seed, block=b)
              for b in range(4)]
    # a block does not depend on the order blocks are made in, nor on
    # whether it fills a caller's buffer
    out = torch.empty(rows, d)
    X2, y2 = device_synth.linreg_block(w, rows, noise, seed=seed, block=2,
                                       out=out)
    assert X2 is out and torch.equal(X2, blocks[2][0])
    assert torch.equal(y2, blocks[2][1])
    assert not torch.equal(blocks[0][0], blocks[1][0])
    X = torch.cat([b[0] for b in blocks]).double().numpy()
    y = torch.cat([b[1] for b in blocks]).double().numpy()
    assert abs(X.mean()) < 0.01 and abs(X.var() - 1.0) < 0.02
    w_hat = np.linalg.lstsq(X, y, rcond=None)[0]
    n = X.shape[0]
    # least squares recovers w to about noise / sqrt(n) a coordinate
    assert np.max(np.abs(w_hat - w.double().numpy())) < \
        6 * noise / math.sqrt(n)
    resid = y - X @ w.double().numpy()
    assert abs(resid.std() - noise) < 0.05 * noise
    assert abs(float(w.double().norm()) - 1.0) < 0.5


def test_device_synth_has_every_jax_generator():
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]

    def public(path):
        tree = ast.parse(path.read_text())
        return {n.name for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                and not n.name.startswith("_")}

    mine = public(root / "spark_agd_tpu_torch" / "data" / "device_synth.py")
    theirs = public(root / "spark_agd_tpu" / "data" / "device_synth.py")
    # these only place JAX arrays on a JAX backend (the port's
    # generators take device= and draw on it): no twin is needed
    assert theirs - mine == {"device_gen", "host_gen", "cpu_device",
                             "ensure_cpu_backend"}
    assert mine >= {"linreg_params", "linreg_block", "softmax_params",
                    "softmax_block"}
