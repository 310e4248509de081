"""The port's structured logging (``utils/logging.py``), its run-record
schema (``obs/schema.py``) and the copied resilience leaves
(``resilience/errors.py``, ``resilience/retry.py``,
``resilience/manifest.py``) against the JAX package's, on the CPU.

``log_result`` and ``iteration_records`` give JAX's lines and records for
the same fit; ``run(..., verbose=True)`` logs them; every record passes
both packages' validators; ``make_host_logger`` follows a streamed
``run_agd_host`` as JAX's follows JAX's; and the four copies equal their
originals after their module docstrings, line for line."""

import ast
import json
import logging
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_agd_tpu as jpkg
from spark_agd_tpu.core import agd as jagd, host_agd as jhost
from spark_agd_tpu.core import smooth as jsmooth
from spark_agd_tpu.data import streaming as jstreaming
from spark_agd_tpu.obs import schema as jschema
from spark_agd_tpu.ops import losses as jl, prox as jp
from spark_agd_tpu.resilience import errors as jerrors, retry as jretry
from spark_agd_tpu.utils import logging as jlogging
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.core import smooth as tsmooth
from spark_agd_tpu_torch.data import streaming
from spark_agd_tpu_torch.obs import schema
from spark_agd_tpu_torch.ops import losses as tl, prox as tp
from spark_agd_tpu_torch.resilience import errors, retry
from spark_agd_tpu_torch.utils import logging as tlogging

ROOT = Path(__file__).resolve().parents[1]


def _data(n=300, d=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    w = rng.standard_normal(d)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ w))).astype(float)
    return X, y


def _fits(**cfg):
    X, y = _data()
    kw = dict(reg_param=0.1, num_iterations=12, convergence_tol=0.0,
              initial_weights=np.zeros(X.shape[1]), **cfg)
    _, _, jres = jpkg.run((X, y), jl.LogisticGradient(),
                          jp.SquaredL2Updater(), mesh=False,
                          return_result=True, **kw)
    _, _, tres = port.run((X, y), tl.LogisticGradient(),
                          tp.SquaredL2Updater(), device="cpu",
                          return_result=True, **kw)
    return jres, tres


def _lines(fn, result, **kw):
    log = logging.getLogger("test_torch_logging.capture")
    log.setLevel(logging.INFO)
    log.propagate = False
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append((record.levelno, record.getMessage()))

    h = Keep()
    log.addHandler(h)
    try:
        fn(result, log=log, **kw)
    finally:
        log.removeHandler(h)
    return records


@pytest.mark.parametrize("jsonl", [False, True], ids=["text", "jsonl"])
def test_log_result_gives_jax_lines(jsonl):
    jres, tres = _fits()
    # the same result object through both: the same lines, exactly
    assert _lines(tlogging.log_result, tres, jsonl=jsonl) == \
        _lines(jlogging.log_result, tres, jsonl=jsonl)
    # the same fit through both packages: the same lines
    mine = _lines(tlogging.log_result, tres, jsonl=jsonl)
    theirs = _lines(jlogging.log_result, jres, jsonl=jsonl)
    assert len(mine) == len(theirs) == 13
    if not jsonl:
        assert [m[1] for m in mine] == [t[1] for t in theirs]


def test_iteration_records_equal_jax_records():
    jres, tres = _fits()
    mine = tlogging.iteration_records(tres)
    theirs = jlogging.iteration_records(jres)
    assert len(mine) == len(theirs) == 12
    for a, b in zip(mine, theirs):
        assert a.keys() == b.keys()
        assert a["iter"] == b["iter"] and a["restarted"] == b["restarted"]
        for k in ("loss", "L", "theta", "step"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-9, err_msg=k)
    assert tlogging.iteration_records(tres) == \
        jlogging.iteration_records(tres)


def test_records_pass_both_validators(tmp_path):
    _, tres = _fits()
    recs = tlogging.iteration_records(tres, run_id="r1") + [
        tlogging.result_run_record(tres, run_id="r1", device_kind="cpu")]
    for rec in recs:
        rec = json.loads(json.dumps(rec))
        assert schema.validate_record(rec) == []
        assert jschema.validate_record(rec) == []
    path = str(tmp_path / "run.jsonl")
    run_id = tlogging.write_result_jsonl(tres, path)
    rows = jschema.read_jsonl(path)
    assert [r["kind"] for r in rows] == ["run"] + ["iteration"] * 12
    assert all(r["run_id"] == run_id for r in rows)
    assert all(jschema.validate_record(r) == [] for r in rows)
    assert schema.read_jsonl(path) == rows
    run = rows[0]
    assert run["iters"] == 12 and run["converged"] is False
    assert run["final_loss"] == pytest.approx(float(tres.loss_history[11]))


def test_run_verbose_logs_the_result_lines(caplog):
    X, y = _data(seed=1)
    kw = dict(reg_param=0.1, num_iterations=5, convergence_tol=0.0,
              initial_weights=np.zeros(X.shape[1]), device="cpu")
    with caplog.at_level(logging.INFO, logger="spark_agd_tpu"):
        _, hist, res = port.run((X, y), tl.LogisticGradient(), tp.L2Prox(),
                                verbose=True, return_result=True, **kw)
    got = [r.getMessage() for r in caplog.records
           if r.name == "spark_agd_tpu"]
    assert got == [m for _, m in _lines(jlogging.log_result, res)]
    assert got[0].startswith("iter=1 loss=")
    assert got[-1].startswith("AcceleratedGradientDescent.run finished.")
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="spark_agd_tpu"):
        port.run((X, y), tl.LogisticGradient(), tp.L2Prox(), **kw)
    assert not [r for r in caplog.records if r.name == "spark_agd_tpu"]


def test_aborted_result_logs_the_warning():
    _, tres = _fits()
    aborted = tres._replace(aborted_non_finite=torch.tensor(True))
    mine = _lines(tlogging.log_result, aborted)
    assert mine == _lines(jlogging.log_result, aborted)
    assert any(level == logging.WARNING and "infinite or NaN" in msg
               for level, msg in mine)
    assert tlogging.result_run_record(aborted)["error"] == \
        "aborted: non-finite loss"


@pytest.mark.parametrize("every", [1, 3])
def test_make_host_logger_follows_a_streamed_run_like_jax(every):
    X, y = _data(n=200, seed=2)
    cfg = dict(num_iterations=7, convergence_tol=0.0)
    sm, sl = streaming.make_streaming_smooth(
        tl.LogisticGradient(), streaming.StreamingDataset.from_arrays(
            X, y, 64), device="cpu")
    px, rv = tsmooth.make_prox(tp.SquaredL2Updater(), 0.1)
    jsm, jsl = jstreaming.make_streaming_smooth(
        jl.LogisticGradient(), jstreaming.StreamingDataset.from_arrays(
            X, y, 64))
    jpx, jrv = jsmooth.make_prox(jp.SquaredL2Updater(), 0.1)
    mine, theirs = [], []
    for sink, run_fn, args, w0 in (
            (mine, port.run_agd_host, (sm, px, rv),
             torch.zeros(5, dtype=torch.float64)),
            (theirs, jhost.run_agd_host, (jsm, jpx, jrv), jnp.zeros(5))):
        log = logging.getLogger(f"test_torch_logging.host{id(sink)}")
        log.setLevel(logging.INFO)
        log.propagate = False

        class Keep(logging.Handler):
            def emit(self, record, sink=sink):
                sink.append(record.getMessage())

        log.addHandler(Keep())
        mod = tlogging if run_fn is port.run_agd_host else jlogging
        config = (port.AGDConfig if run_fn is port.run_agd_host
                  else jagd.AGDConfig)(**cfg)
        run_fn(*args, w0, config, smooth_loss=sl if sink is mine else jsl,
               on_iteration=mod.make_host_logger(log=log, every=every))
    assert mine == theirs
    assert len(mine) == (7 if every == 1 else 3)
    assert mine[-1].endswith("done(iteration cap)")


# ---------------------------------------------------------------------------
# the copies: everything after the module docstring equals the original


def _after_docstring(path: Path) -> str:
    src = path.read_text()
    first = ast.parse(src).body[0]
    assert isinstance(first, ast.Expr) and isinstance(first.value,
                                                      ast.Constant)
    return "".join(src.splitlines(keepends=True)[first.end_lineno:])


@pytest.mark.parametrize("rel", ["resilience/errors.py",
                                 "resilience/retry.py", "obs/schema.py",
                                 "resilience/manifest.py",
                                 "resilience/journal.py"])
def test_copied_module_equals_the_original(rel):
    mine = ROOT / "spark_agd_tpu_torch" / rel
    theirs = ROOT / "spark_agd_tpu" / rel
    assert _after_docstring(mine) == _after_docstring(theirs)
    assert f"A copy of ``spark_agd_tpu/{rel}``" in ast.get_docstring(
        ast.parse(mine.read_text()))


def test_copies_behave_as_the_originals():
    def cases(mod):
        return (mod.AttemptTimeout("x", 1.0), OSError("io"),
                ValueError("bad"), mod.StreamDataLoss(1, 4, 0.5),
                RuntimeError("device lost"), RuntimeError("nan seen"),
                mod.Preempted(15), FloatingPointError(),
                mod.QuorumLost("gone"), mod.HostLost(1))

    mine = [errors.classify_failure(e) for e in cases(errors)]
    assert mine == [jerrors.classify_failure(e) for e in cases(jerrors)]
    assert mine[3] == errors.FATAL and mine[0] == errors.TRANSIENT
    p = retry.RetryPolicy(max_attempts=4, seed=3)
    jp_ = jretry.RetryPolicy(max_attempts=4, seed=3)
    s, js = p.backoff_schedule(), jp_.backoff_schedule()
    assert [s.next_delay(i) for i in range(1, 4)] == \
        [js.next_delay(i) for i in range(1, 4)]
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("again")
        return "ok"

    assert retry.call_with_retry(flaky, policy=p, sleep=lambda s: None) \
        == "ok" and len(calls) == 3
    with pytest.raises(ValueError):
        retry.call_with_retry(lambda: int("x"), policy=p,
                              sleep=lambda s: None)
    assert schema.KINDS == jschema.KINDS
    assert schema.selfcheck()[0] and jschema.selfcheck()[0]
