"""The port's serving engine against the JAX package's, on the CPU.

``BucketLadder``, ``ModelSpec`` and ``spec_of`` equal JAX's; every model
kind and op, at every bucket and at the edge sizes (1, a bucket's size
+- 1, a batch past ``max_batch`` that ``predict`` chunks), serves what
the JAX ``ServeEngine`` serves on the same weights and rows (1e-12
under x64, rtol 1e-6 at f32); hot swaps, spec mismatches and bad
requests raise the exception types JAX raises; the program census never
changes while serving; ``telemetry=`` emits the JAX engine's spans
(its ``program_cost`` records wait for the profiling and analysis
slice)."""

import dataclasses

import numpy as np
import pytest
import torch

from spark_agd_tpu.models import glm as jglm, mlp as jmlp
from spark_agd_tpu.obs import Telemetry as JTelemetry
from spark_agd_tpu.serve import engine as jengine
from spark_agd_tpu_torch.models import glm as tglm, mlp as tmlp
from spark_agd_tpu_torch.obs import Telemetry as TTelemetry
from spark_agd_tpu_torch.serve import engine as tengine
from torch_records import comparable

D = 12
MAX_BATCH = 16   # ladder (4, 8, 16)
MIN_BUCKET = 4
SIZES = (1, 3, 4, 5, 7, 8, 9, 15, 16, 40)  # 40: chunked by predict
TOL = {np.float64: dict(rtol=1e-12, atol=1e-12),
       np.float32: dict(rtol=1e-6, atol=1e-7)}

KINDS = ("logistic", "logistic_nothr", "svm", "svm_nothr", "linear",
         "softmax", "mlp_tanh", "mlp_relu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pair(kind, dtype=np.float32, seed=1):
    """The same model in both packages, its arrays made with numpy."""
    r = np.random.default_rng(seed)
    w = r.normal(size=D).astype(dtype)
    b = float(r.normal()) * 0.3
    if kind.startswith("logistic"):
        thr = None if kind.endswith("nothr") else 0.5
        return (jglm.LogisticRegressionModel(w, b, threshold=thr),
                tglm.LogisticRegressionModel(_t(w), b, threshold=thr))
    if kind.startswith("svm"):
        thr = None if kind.endswith("nothr") else 0.0
        return (jglm.SVMModel(w, b, threshold=thr),
                tglm.SVMModel(_t(w), b, threshold=thr))
    if kind == "linear":
        return (jglm.LinearRegressionModel(w, b),
                tglm.LinearRegressionModel(_t(w), b))
    if kind == "softmax":
        W = r.normal(size=(D, 4)).astype(dtype)
        c = r.normal(size=4).astype(dtype)
        return (jglm.SoftmaxRegressionModel(W, c),
                tglm.SoftmaxRegressionModel(_t(W), _t(c)))
    act = kind.split("_")[1]
    params = {k: np.asarray(v).astype(dtype) for k, v in
              jmlp.init_mlp_params(D, 6, 3, seed=seed).items()}
    return (jmlp.MLPModel({k: v for k, v in params.items()},
                          jmlp._ACTIVATIONS[act]),
            tmlp.MLPModel({k: _t(v) for k, v in params.items()},
                          tmlp._ACTIVATIONS[act]))


def _X(n, dtype=np.float32, seed=7, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(dtype)


def _engines(kind, dtype=np.float32, **kw):
    jm, tm = _pair(kind, dtype)
    kw = dict(generation=1, max_batch=MAX_BATCH, min_bucket=MIN_BUCKET,
              **kw)
    return (jengine.ServeEngine(jm, **kw),
            tengine.ServeEngine(tm, device="cpu", **kw))


@pytest.mark.parametrize("args", [
    dict(), dict(max_batch=64), dict(max_batch=48, min_bucket=8),
    dict(max_batch=5, min_bucket=8), dict(max_batch=1),
    dict(max_batch=16, buckets=[2, 16, 4]), dict(max_batch=16,
                                                  buckets=[16])])
def test_bucket_ladder_equals_jax(args):
    jl, tl = jengine.BucketLadder(**args), tengine.BucketLadder(**args)
    assert tl.buckets == jl.buckets and tl.max_batch == jl.max_batch
    for n in range(1, tl.max_batch + 1):
        assert tl.bucket_for(n) == jl.bucket_for(n)
    for n in (0, tl.max_batch + 1):
        for ladder in (jl, tl):
            with pytest.raises(ValueError, match="not admissible"):
                ladder.bucket_for(n)


@pytest.mark.parametrize("args", [dict(max_batch=0),
                                  dict(max_batch=16, buckets=[4, 8]),
                                  dict(max_batch=16, buckets=[])])
def test_bucket_ladder_refuses_as_jax(args):
    for mod in (jengine, tengine):
        with pytest.raises(ValueError):
            mod.BucketLadder(**args)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_spec_and_params_equal_jax(kind, dtype):
    jm, tm = _pair(kind, dtype)
    js, ts = jengine.spec_of(jm), tengine.spec_of(tm)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.ops == js.ops
    jp, tp = jengine.params_of(jm), tengine.params_of(tm)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert str(tp[k].dtype).removeprefix("torch.") \
            == str(jp[k].dtype)
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_every_op_at_every_size_serves_what_jax_serves(kind, dtype):
    je, te = _engines(kind, dtype)
    assert te.ops == je.ops and te.ladder.buckets == (4, 8, 16)
    census = te.compile_census()
    assert census == je.compile_census()
    _, tm = _pair(kind, dtype)
    for op in te.ops:
        for n in SIZES:
            X = _X(n, dtype, seed=n)
            got, want = te.predict(X, op), np.asarray(je.predict(X, op))
            assert got.shape == want.shape, (op, n)
            np.testing.assert_allclose(got, want, **TOL[dtype],
                                       err_msg=f"{op} n={n}")
            # the served values and dtype are the port model's own
            own = getattr(tm, op)(_t(X)).numpy()
            assert got.dtype == own.dtype
            np.testing.assert_allclose(got, own, **TOL[dtype])
        for n in (1, 4, 9, 16):
            vals, gen, bucket = te.serve_batch(_X(n, dtype), op)
            jvals, jgen, jbucket = je.serve_batch(_X(n, dtype), op)
            assert (gen, bucket) == (jgen, jbucket)
            assert vals.shape == np.asarray(jvals).shape
    assert te.compile_census() == census  # serving never adds a program


def test_single_row_squeezes():
    je, te = _engines("softmax")
    x = _X(1)[0]
    got = te.predict(x, "predict_proba")
    assert got.shape == (4,)
    np.testing.assert_allclose(got, np.asarray(je.predict(x,
                                                          "predict_proba")),
                               rtol=1e-6)


def test_repeated_calls_are_bit_identical_and_padding_rows_are_zero():
    _, te = _engines("logistic")
    X = _X(5)
    first = te.predict(X, "predict_proba")
    te.predict(_X(8, seed=3), "predict_proba")  # fills the bucket
    again = te.predict(X, "predict_proba")
    assert np.array_equal(first, again)
    prog = te._programs[("predict_proba", 8)]
    assert torch.count_nonzero(prog.inbuf[5:]) == 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_hot_swap_serves_the_new_generation_as_jax(dtype):
    je, te = _engines("logistic", dtype)
    jm2, tm2 = _pair("logistic", dtype, seed=2)
    census = te.compile_census()
    je.bind(jm2, 2)
    te.bind(tm2, 2)
    assert (te.generation, te.hot_swaps) == (je.generation,
                                             je.hot_swaps) == (2, 1)
    X = _X(7, dtype)
    for op in te.ops:
        np.testing.assert_allclose(te.predict(X, op),
                                   np.asarray(je.predict(X, op)),
                                   **TOL[dtype])
    assert te.compile_census() == census


@pytest.mark.parametrize("other", ["softmax", "logistic_nothr", "svm",
                                   "wider", "float64"])
def test_spec_mismatch_raises_the_jax_type(other):
    je, te = _engines("logistic")
    if other == "wider":
        r = np.random.default_rng(0).normal(size=D + 3).astype(np.float32)
        jm, tm = (jglm.LogisticRegressionModel(r),
                  tglm.LogisticRegressionModel(_t(r)))
    elif other == "float64":
        jm, tm = _pair("logistic", np.float64)
    else:
        jm, tm = _pair(other)
    with pytest.raises(jengine.ServeSpecMismatch):
        je.bind(jm, 5)
    with pytest.raises(tengine.ServeSpecMismatch) as err:
        te.bind(tm, 5)
    assert isinstance(err.value, ValueError)
    assert type(err.value).__name__ == jengine.ServeSpecMismatch.__name__
    assert te.generation == 1 and te.hot_swaps == 0


def _bad_calls(e):
    return {
        "wrong_features": lambda: e.predict(_X(3, d=D + 2)),
        "op_not_served": lambda: e.predict(_X(3), "decode"),
        "too_many_rows": lambda: e.serve_batch(_X(MAX_BATCH + 1)),
        "no_rows": lambda: e.serve_batch(_X(0)),
        "three_dims": lambda: e.serve_batch(_X(4)[None]),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls(None)))
def test_bad_requests_raise_the_jax_types(case):
    je, te = _engines("svm")
    with pytest.raises(Exception) as jerr:
        _bad_calls(je)[case]()
    with pytest.raises(Exception) as terr:
        _bad_calls(te)[case]()
    assert type(terr.value) is type(jerr.value) is ValueError


def test_construction_refusals_raise_the_jax_types():
    jm, tm = _pair("svm")
    for mod, m in ((jengine, jm), (tengine, tm)):
        kw = {} if mod is jengine else {"device": "cpu"}
        with pytest.raises(ValueError, match="not served"):
            mod.ServeEngine(m, ops=["predict_proba"], **kw)
        with pytest.raises(TypeError, match="not a servable"):
            mod.spec_of(object())
        with pytest.raises(ValueError, match="not served"):
            mod._make_forward(mod.spec_of(m), "predict_proba")


def test_mlp_with_an_unregistered_activation_is_refused():
    jm, tm = _pair("mlp_tanh")
    jm.activation = lambda x: x
    tm.activation = lambda x: x
    for mod, m in ((jengine, jm), (tengine, tm)):
        with pytest.raises(ValueError, match="unregistered activation"):
            mod.spec_of(m)


def test_programs_and_buffers():
    je, te = _engines("softmax")
    assert sorted(te._programs) == sorted(je.compiled_programs())
    for (op, bucket), prog in te._programs.items():
        assert prog.inbuf.shape == (bucket, D)
        assert prog.inbuf.device.type == "cpu"
    assert "device=cpu" in repr(te)


def test_telemetry_is_refused_naming_its_slice():
    # telemetry= is ported: the warmup span and one engine_call span a
    # batch, as the JAX engine emits them (less its program_cost records)
    jm, tm = _pair("logistic")
    jt, tt = JTelemetry(), TTelemetry()
    je = jengine.ServeEngine(jm, max_batch=MAX_BATCH,
                             min_bucket=MIN_BUCKET, telemetry=jt)
    te = tengine.ServeEngine(tm, max_batch=MAX_BATCH,
                             min_bucket=MIN_BUCKET, telemetry=tt,
                             device="cpu")
    for n in (3, 16):
        je.serve_batch(_X(n), "predict_proba")
        te.serve_batch(_X(n), "predict_proba")
    assert comparable(tt.records) == comparable(jt.records)
    # each causal span is an "open" record, then its closing record
    assert [(r["name"], r.get("status")) for r in tt.spans()] == [
        ("serve_warmup", None)] + [("engine_call", "open"),
                                   ("engine_call", "ok")] * 2


def test_engine_without_cuda_raises_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tm = _pair("logistic")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.ServeEngine(tm)
