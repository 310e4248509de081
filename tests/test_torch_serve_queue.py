"""The port's micro-batching queue, on the CPU: the queue cases the JAX
package holds its own queue to (``tests/test_serve.py``'s
``TestMicroBatchQueue``), with every served value held to the JAX
engine's on the same rows (rtol 1e-6 at f32).  Every wait on a future
has a timeout."""

import os
import sys
import threading

import numpy as np
import pytest

from spark_agd_tpu.models import glm as jglm
from spark_agd_tpu.resilience.errors import ServeOverloaded as JOverloaded
from spark_agd_tpu.serve import engine as jengine
from spark_agd_tpu_torch.models import glm as tglm
from spark_agd_tpu_torch.resilience.errors import (TRANSIENT,
                                                   ServeOverloaded,
                                                   classify_failure)
from spark_agd_tpu_torch.serve import (MicroBatchQueue, ServeEngine,
                                       ServeResult)

D = 10
MAX_BATCH = 16
WAIT = 30  # seconds, every future


def _weights(seed=1):
    r = np.random.default_rng(seed)
    return r.normal(size=D).astype(np.float32), float(r.normal()) * 0.1


def _logistic(seed=1):
    return tglm.LogisticRegressionModel(*_weights(seed))


def _jax_engine(seed=1, **kw):
    return jengine.ServeEngine(jglm.LogisticRegressionModel(
        *_weights(seed)), max_batch=kw.pop("max_batch", MAX_BATCH),
        min_bucket=4, **kw)


@pytest.fixture(scope="module")
def engine():
    return ServeEngine(_logistic(), generation=1, max_batch=MAX_BATCH,
                       min_bucket=4, device="cpu")


@pytest.fixture(scope="module")
def jax_engine():
    return _jax_engine()


def _X(n, seed=7, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(
        np.float32)


def test_submit_requires_started(engine):
    q = MicroBatchQueue(engine)
    with pytest.raises(RuntimeError, match="not running"):
        q.submit(_X(1))


@pytest.mark.parametrize("op", ["predict", "predict_proba"])
def test_roundtrip_and_slicing_serve_what_jax_serves(engine, jax_engine,
                                                     op):
    with MicroBatchQueue(engine, max_wait_us=100) as q:
        sizes = (1, 3, 7, 16)
        futs = [(n, q.submit(_X(n, seed=n), op)) for n in sizes]
        for n, f in futs:
            res = f.result(timeout=WAIT)
            assert isinstance(res, ServeResult)
            assert res.rows == n and res.value.shape == (n,)
            np.testing.assert_allclose(
                res.value, np.asarray(jax_engine.predict(_X(n, seed=n),
                                                         op)),
                rtol=1e-6, atol=1e-7)


def test_coalescing_shares_one_batch(engine):
    # a long window: the three submits land before the worker closes the
    # batch, so they ride one padded program call
    with MicroBatchQueue(engine, max_wait_us=300_000) as q:
        futs = [q.submit(_X(2, seed=s)) for s in range(3)]
        results = [f.result(timeout=WAIT) for f in futs]
        assert q.batches == 1
    assert all(r.batch_rows == 6 for r in results)
    assert {r.bucket for r in results} == {8}


def test_ops_never_share_a_batch(engine):
    with MicroBatchQueue(engine, max_wait_us=200_000) as q:
        f1 = q.submit(_X(2), "predict")
        f2 = q.submit(_X(2), "predict_proba")
        r1, r2 = f1.result(WAIT), f2.result(WAIT)
    assert r1.batch_rows == 2 and r2.batch_rows == 2
    assert set(np.unique(r1.value)) <= {0.0, 1.0}


def test_single_row_result_squeezed(engine):
    with MicroBatchQueue(engine, max_wait_us=0) as q:
        res = q.submit(_X(1)[0], "predict_proba").result(WAIT)
    assert res.value.shape == () and res.rows == 1


@pytest.mark.parametrize("case", ["oversized", "features", "op"])
def test_oversized_and_bad_requests_fail_typed(engine, case):
    bad = {"oversized": ((_X(MAX_BATCH + 1),), "not admissible"),
           "features": ((_X(3, d=D + 2),), "features"),
           "op": ((_X(3), "decode"), "not served")}
    args, match = bad[case]
    with MicroBatchQueue(engine) as q:
        with pytest.raises(ValueError, match=match):
            q.submit(*args)


def test_overload_is_typed_transient_and_admitted_drain(engine):
    q = MicroBatchQueue(engine, max_wait_us=300_000,
                        max_queue_rows=6).start()
    admitted, rejected = [], []
    try:
        for _ in range(20):
            try:
                admitted.append(q.submit(_X(2)))
            except ServeOverloaded as e:
                rejected.append(e)
    finally:
        q.stop()
    assert rejected and admitted
    for e in rejected:
        assert classify_failure(e) == TRANSIENT
        assert e.limit_rows == 6 and e.queued_rows == 8
        # the same fields as the JAX package's exception
        je = JOverloaded(8, 6)
        assert (e.queued_rows, e.limit_rows, str(e)) == (
            je.queued_rows, je.limit_rows, str(je))
    assert all(f.result(WAIT).rows == 2 for f in admitted)
    assert q.latency_summary()["rejected"] == len(rejected)


def test_submit_after_stop_raises(engine):
    q = MicroBatchQueue(engine).start()
    q.stop()
    with pytest.raises(RuntimeError, match="not running"):
        q.submit(_X(1))


def test_stop_drains_admitted_requests(engine):
    q = MicroBatchQueue(engine, max_wait_us=200_000).start()
    futs = [q.submit(_X(2, seed=s)) for s in range(4)]
    q.stop()  # must flush the coalescing window, not drop it
    assert all(f.result(timeout=5).rows == 2 for f in futs)


def test_latency_summary_fields(engine):
    with MicroBatchQueue(engine, max_wait_us=0) as q:
        for _ in range(5):
            q.submit(_X(2)).result(WAIT)
        s = q.latency_summary()
    assert s["requests"] == 5 and s["rows"] == 10
    assert s["p50_ms"] <= s["p99_ms"] <= s["max_ms"]
    assert s["qps"] > 0 and s["rejected"] == 0 and s["errors"] == 0


def test_hot_swap_mid_stream_drops_nothing():
    eng = ServeEngine(_logistic(1), generation=1, max_batch=8,
                      device="cpu")
    census = eng.compile_census()
    refs = {1: _jax_engine(1, max_batch=8), 2: _jax_engine(2, max_batch=8)}
    results = []
    with MicroBatchQueue(eng, max_wait_us=0) as q:
        for i in range(40):
            if i == 20:
                eng.bind(_logistic(2), 2)
            X = _X(2, seed=i)
            res = q.submit(X, "predict_proba").result(WAIT)
            np.testing.assert_allclose(
                res.value, np.asarray(refs[res.generation].predict(
                    X, "predict_proba")), rtol=1e-6, atol=1e-7)
            results.append(res)
    generations = [r.generation for r in results]
    assert len(results) == 40
    assert set(generations) == {1, 2}
    assert generations == sorted(generations)  # monotone swap
    assert eng.compile_census() == census


def test_concurrent_clients_get_their_own_rows(engine, jax_engine):
    """Four threads of mixed sizes: every answer is the engine's answer
    on that request's own rows, and batches coalesce requests."""
    answers, errors = {}, []

    def client(c):
        r = np.random.default_rng(100 + c)
        try:
            for i in range(40):
                X = r.normal(size=(int(r.integers(1, 9)), D)).astype(
                    np.float32)
                answers[(c, i)] = (X, q.submit(X, "predict_proba")
                                   .result(WAIT).value)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    with MicroBatchQueue(engine, max_wait_us=2000) as q:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
        batches = q.batches
    assert not errors and len(answers) == 160
    assert batches <= 160
    for X, got in answers.values():
        np.testing.assert_allclose(
            got, np.asarray(jax_engine.predict(X, "predict_proba")),
            rtol=1e-6, atol=1e-7)


def test_more_client_threads_than_cores_lose_no_request(engine):
    """A switch interval of a microsecond and more client threads than
    cores: every request is answered on its own rows, and the rollup
    counts every request and row (a lost update breaks either)."""
    n_threads = len(os.sched_getaffinity(0)) + 1
    w, b = _weights()
    errors, rows = [], []

    def client(c):
        r = np.random.default_rng(1000 + c)
        for _ in range(8):
            X = r.normal(size=(int(r.integers(1, 5)), D)).astype(np.float32)
            try:
                got = q.submit(X, "predict_proba").result(WAIT).value
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)
                continue
            want = 1.0 / (1.0 + np.exp(-(X.astype(np.float64) @ w + b)))
            if not np.allclose(got, want, rtol=1e-5, atol=1e-6):
                errors.append(("wrong rows", c))
            rows.append(X.shape[0])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with MicroBatchQueue(engine, max_wait_us=500,
                             max_queue_rows=4 * n_threads) as q:
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(4 * WAIT)
            assert not any(t.is_alive() for t in threads)
            summary = q.latency_summary()
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert summary["requests"] == 8 * n_threads == len(rows)
    assert summary["rows"] == sum(rows) and summary["errors"] == 0


def test_a_worker_that_cannot_warm_fails_start(engine, monkeypatch):
    q = MicroBatchQueue(engine)

    def boom():
        raise RuntimeError("no device")

    monkeypatch.setattr(engine, "warm", boom)
    with pytest.raises(RuntimeError, match="no device"):
        q.start()
    with pytest.raises(RuntimeError, match="not running"):
        q.submit(_X(1))


def test_telemetry_is_refused_naming_its_slice(engine):
    with pytest.raises(NotImplementedError, match="observability"):
        MicroBatchQueue(engine, telemetry=object())
