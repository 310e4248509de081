"""The port's streamed data plane (``data/streaming.py``, ``data/ingest.py``,
``core/host_agd.run_agd_host``) against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both packages:
streamed smooths equal the in-memory smooth and JAX's streamed smooth
(rtol 1e-12 at f64), dense and CSR, with a ragged tail and ``pad_to``;
``run_agd_host`` over a stream takes JAX's steps (the same counts,
histories within 1e-9, weights within 3e-7, ``tests/test_agd_core.py``'s
standard); LIBSVM part files give JAX's batches; quarantine and
``StreamDataLoss`` as in JAX; ``fold_stream``'s order and shutdown
contracts; the cursor codec's npz entries and a resumed pass; and at f32
``FusedLogisticGradient`` (its plain version on the CPU) against
``PallasLogisticGradient(interpret=True)`` over the same stream at the
kernel tolerances (``tests/test_pallas.py``)."""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu.core import agd as jagd, host_agd as jhost
from spark_agd_tpu.core import smooth as jsmooth
from spark_agd_tpu.data import libsvm as jlibsvm, streaming as jstreaming
from spark_agd_tpu.models import glm as jglm
from spark_agd_tpu.ops import losses as jlosses, prox as jprox
from spark_agd_tpu.ops.pallas_kernels import PallasLogisticGradient
from spark_agd_tpu.resilience.errors import StreamDataLoss as JStreamDataLoss
from spark_agd_tpu.resilience.retry import RetryPolicy as JRetryPolicy
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.parallel import mesh as tmesh
from spark_agd_tpu_torch.core import smooth as tsmooth
from spark_agd_tpu_torch.data import libsvm, streaming
from spark_agd_tpu_torch.models import glm as tglm
from spark_agd_tpu_torch.ops import losses, prox
from spark_agd_tpu_torch.ops.sparse import CSRMatrix
from spark_agd_tpu_torch.resilience import RetryPolicy, StreamDataLoss

D = 7


def _dense(n=531, d=D, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(dtype)
    w_true = rng.standard_normal(d)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ w_true))).astype(dtype)
    return X, y


def _csr(n=531, d=41, seed=1, dtype=np.float64):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 9, n)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    nnz = int(indptr[-1])
    indices = rng.integers(0, d, nnz).astype(np.int32)
    values = rng.normal(size=nnz).astype(dtype)
    y = (rng.random(n) < 0.5).astype(dtype)
    return indptr, indices, values, y


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------------------
# streamed smooths against the in-memory smooth and against JAX (f64)


@pytest.mark.parametrize("pad_to", [None, 128], ids=["ragged", "pad_to"])
def test_streamed_dense_smooth_equals_in_memory_and_jax(pad_to):
    X, y = _dense()
    w = np.random.default_rng(2).standard_normal(D)
    ref_f, ref_g = tsmooth.make_smooth(
        losses.LogisticGradient(), torch.from_numpy(X),
        torch.from_numpy(y))(torch.from_numpy(w))
    ds = streaming.StreamingDataset.from_arrays(X, y, batch_rows=128)
    stats = []
    sm, sl = streaming.make_streaming_smooth(
        losses.LogisticGradient(), ds, pad_to=pad_to, device="cpu",
        pass_stats=stats)
    f, g = sm(torch.from_numpy(w))
    assert f.dtype == g.dtype == torch.float64
    np.testing.assert_allclose(float(f), float(ref_f), rtol=1e-12)
    np.testing.assert_allclose(_np(g), _np(ref_g), rtol=1e-12)
    np.testing.assert_allclose(float(sl(torch.from_numpy(w))), float(ref_f),
                               rtol=1e-12)
    jds = jstreaming.StreamingDataset.from_arrays(X, y, batch_rows=128)
    jsm, jsl = jstreaming.make_streaming_smooth(
        jlosses.LogisticGradient(), jds, pad_to=pad_to)
    jf, jg = jsm(jnp.asarray(w))
    np.testing.assert_allclose(float(f), float(jf), rtol=1e-12)
    np.testing.assert_allclose(_np(g), np.asarray(jg), rtol=1e-12)
    np.testing.assert_allclose(float(sl(torch.from_numpy(w))),
                               float(jsl(jnp.asarray(w))), rtol=1e-12)
    # three passes (smooth, smooth_loss twice), one list for both
    assert [s["batches"] for s in stats] == [5, 5, 5]
    assert [s["rows"] for s in stats] == [531, 531, 531]


@pytest.mark.parametrize("with_csc", [True, False, "lazy"])
def test_streamed_csr_smooth_equals_in_memory_and_jax(with_csc):
    indptr, indices, values, y = _csr()
    d = 41
    w = np.random.default_rng(3).standard_normal(d)
    X = CSRMatrix.from_csr_arrays(indptr, indices, values, d, device="cpu")
    ref_f, ref_g = tsmooth.make_smooth(
        losses.LogisticGradient(), X, torch.from_numpy(y))(
        torch.from_numpy(w))
    ds = streaming.StreamingDataset.from_csr(
        indptr, indices, values, d, y, batch_rows=128, with_csc=with_csc)
    batches = list(ds)
    if with_csc == "lazy":
        assert all(b[0].want_csc and not b[0].has_csc for b in batches)
    else:
        assert all(b[0].has_csc == with_csc for b in batches)
    assert len({(b[0].nnz, b[0].shape) for b in batches}) == 1
    seen = []

    class Spy(losses.LogisticGradient):
        def batch_loss_and_grad(self, wv, Xv, yv, mask=None):
            seen.append(Xv.has_csc)
            return super().batch_loss_and_grad(wv, Xv, yv, mask)

    sm, sl = streaming.make_streaming_smooth(Spy(), ds, device="cpu")
    f, g = sm(torch.from_numpy(w))
    # a lazy twin is built at placement, before the kernel
    assert seen and all(seen) == (with_csc is not False)
    np.testing.assert_allclose(float(f), float(ref_f), rtol=1e-12)
    np.testing.assert_allclose(_np(g), _np(ref_g), rtol=1e-12, atol=1e-15)
    jds = jstreaming.StreamingDataset.from_csr(
        indptr, indices, values, d, y, batch_rows=128, with_csc=with_csc)
    jsm, jsl = jstreaming.make_streaming_smooth(jlosses.LogisticGradient(),
                                                jds)
    jf, jg = jsm(jnp.asarray(w))
    np.testing.assert_allclose(float(f), float(jf), rtol=1e-12)
    np.testing.assert_allclose(_np(g), np.asarray(jg), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(float(sl(torch.from_numpy(w))),
                               float(jsl(jnp.asarray(w))), rtol=1e-12)


@pytest.mark.parametrize("with_csc", [True, False, "lazy"])
def test_csr_batches_equal_jax_batches(with_csc):
    indptr, indices, values, y = _csr(n=300, seed=4)
    mask = (np.random.default_rng(5).random(300) < 0.8).astype(np.float32)
    mine = list(streaming.iter_csr_batches(indptr, indices, values, 41, y,
                                           64, mask, with_csc))
    theirs = list(jstreaming.iter_csr_batches(indptr, indices, values, 41, y,
                                              64, mask, with_csc))
    assert len(mine) == len(theirs) == 5
    for (X, yb, mb), (J, jy, jm) in zip(mine, theirs):
        assert X.shape == J.shape and X.nnz == J.nnz
        assert X.want_csc == bool(J.want_csc) and X.has_csc == J.has_csc
        for name in ("row_ids", "col_ids", "values") + (
                ("csc_row_ids", "csc_col_ids", "csc_values")
                if X.has_csc else ()):
            np.testing.assert_array_equal(_np(getattr(X, name)),
                                          np.asarray(getattr(J, name)))
        np.testing.assert_array_equal(yb, jy)
        np.testing.assert_array_equal(mb, jm)


def test_max_batch_nnz_and_nnz_pad_too_small():
    indptr, indices, values, y = _csr(n=64, seed=6)
    assert streaming._max_batch_nnz(indptr, 32) == \
        jstreaming._max_batch_nnz(indptr, 32)
    assert streaming._max_batch_nnz(np.array([0]), 32) == 0
    with pytest.raises(ValueError, match="nnz_pad"):
        list(streaming.iter_csr_batches(indptr, indices, values, 41, y, 32,
                                        nnz_pad=16))
    assert list(streaming.iter_csr_batches(np.array([0]), indices[:0],
                                           values[:0], 41, y[:0], 8)) == []


def test_pad_to_rows_are_masked_and_change_nothing():
    X, y = _dense(n=100)
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(D))
    ds = streaming.StreamingDataset.from_arrays(X, y, batch_rows=48)
    shapes = []

    class Spy(losses.LogisticGradient):
        def batch_loss_and_grad(self, wv, Xv, yv, mask=None):
            shapes.append((tuple(Xv.shape), None if mask is None
                           else float(mask.sum())))
            return super().batch_loss_and_grad(wv, Xv, yv, mask)

    f0, g0 = streaming.make_streaming_smooth(Spy(), ds, device="cpu")[0](w)
    f1, g1 = streaming.make_streaming_smooth(Spy(), ds, pad_to=48,
                                             device="cpu")[0](w)
    assert shapes == [((48, D), None), ((48, D), None), ((4, D), None),
                      ((48, D), None), ((48, D), None), ((48, D), 4.0)]
    np.testing.assert_allclose(float(f1), float(f0), rtol=1e-15)
    np.testing.assert_allclose(_np(g1), _np(g0), rtol=1e-14)


# ---------------------------------------------------------------------------
# run_agd_host over a stream against JAX's, step for step (f64)


def _hold_host(mine, theirs):
    assert mine.num_iters == theirs.num_iters
    assert mine.num_backtracks == theirs.num_backtracks
    assert mine.num_restarts == theirs.num_restarts
    assert mine.aborted_non_finite == theirs.aborted_non_finite
    assert mine.converged == theirs.converged
    np.testing.assert_allclose(mine.loss_history, theirs.loss_history,
                               rtol=1e-9)
    np.testing.assert_allclose(_np(mine.weights), np.asarray(theirs.weights),
                               rtol=3e-7, atol=1e-12)


def _both_dense_streams(n=900, seed=8, batch_rows=128):
    X, y = _dense(n=n, seed=seed)
    return (streaming.StreamingDataset.from_arrays(X, y, batch_rows),
            jstreaming.StreamingDataset.from_arrays(X, y, batch_rows))


@pytest.mark.parametrize("loss_mode", ["x", "x_strict", "y"])
@pytest.mark.parametrize("updater,reg", [("SquaredL2Updater", 0.1),
                                         ("L1Updater", 0.01)])
def test_run_agd_host_over_a_stream_matches_jax(loss_mode, updater, reg):
    ds, jds = _both_dense_streams()
    cfg = dict(num_iterations=25, convergence_tol=1e-9, loss_mode=loss_mode)
    sm, sl = streaming.make_streaming_smooth(losses.LogisticGradient(), ds,
                                             device="cpu")
    px, rv = tsmooth.make_prox(getattr(prox, updater)(), reg)
    mine = port.run_agd_host(sm, px, rv, torch.zeros(D, dtype=torch.float64),
                             port.AGDConfig(**cfg), smooth_loss=sl)
    jsm, jsl = jstreaming.make_streaming_smooth(jlosses.LogisticGradient(),
                                                jds)
    jpx, jrv = jsmooth.make_prox(getattr(jprox, updater)(), reg)
    theirs = jhost.run_agd_host(jsm, jpx, jrv, jnp.zeros(D),
                                jagd.AGDConfig(**cfg), smooth_loss=jsl)
    assert mine.num_iters > 3
    _hold_host(mine, theirs)


def test_run_agd_host_csr_stream_without_backtracking_matches_jax():
    indptr, indices, values, y = _csr(n=700, seed=9)
    args = (indptr, indices, values, 41, y, 256)
    cfg = dict(num_iterations=8, convergence_tol=0.0, beta=1.0, l0=4.0)
    sm, sl = streaming.make_streaming_smooth(
        losses.LogisticGradient(), streaming.StreamingDataset.from_csr(*args),
        device="cpu")
    px, rv = tsmooth.make_prox(prox.L2Prox(), 0.05)
    mine = port.run_agd_host(sm, px, rv, torch.zeros(41, dtype=torch.float64),
                             port.AGDConfig(**cfg), smooth_loss=sl)
    jsm, jsl = jstreaming.make_streaming_smooth(
        jlosses.LogisticGradient(),
        jstreaming.StreamingDataset.from_csr(*args))
    jpx, jrv = jsmooth.make_prox(jprox.L2Prox(), 0.05)
    theirs = jhost.run_agd_host(jsm, jpx, jrv, jnp.zeros(41),
                                jagd.AGDConfig(**cfg), smooth_loss=jsl)
    assert mine.num_iters == 8
    _hold_host(mine, theirs)


def test_run_agd_host_warm_continuation_and_carry_match_jax():
    ds, jds = _both_dense_streams(seed=10)
    cfg = dict(num_iterations=4, convergence_tol=0.0)
    sm, sl = streaming.make_streaming_smooth(losses.LogisticGradient(), ds,
                                             device="cpu")
    px, rv = tsmooth.make_prox(prox.SquaredL2Updater(), 0.1)
    jsm, jsl = jstreaming.make_streaming_smooth(jlosses.LogisticGradient(),
                                                jds)
    jpx, jrv = jsmooth.make_prox(jprox.SquaredL2Updater(), 0.1)
    carries, jcarries = [], []
    w0 = np.zeros(D)
    first = port.run_agd_host(sm, px, rv, torch.from_numpy(w0),
                              port.AGDConfig(**cfg), smooth_loss=sl,
                              on_iteration=carries.append)
    jfirst = jhost.run_agd_host(jsm, jpx, jrv, jnp.asarray(w0),
                                jagd.AGDConfig(**cfg), smooth_loss=jsl,
                                on_iteration=jcarries.append)
    assert len(carries) == len(jcarries) == 4
    for c, jc in zip(carries, jcarries):
        assert set(c) == set(jc)
        for key in ("prior_iters", "bts", "aborted", "stopped", "last"):
            assert c[key] == jc[key], key
        for key in ("theta", "big_l", "loss"):
            np.testing.assert_allclose(c[key], jc[key], rtol=1e-9)
        np.testing.assert_allclose(_np(c["x"]), np.asarray(jc["x"]),
                                   rtol=3e-7, atol=1e-12)
    last = carries[-1]
    warm = port.AGDWarmState(x=last["x"], z=last["z"], theta=last["theta"],
                             big_l=last["big_l"], bts=last["bts"],
                             prior_iters=last["prior_iters"])
    jlast = jcarries[-1]
    jwarm = jagd.AGDWarmState(x=jlast["x"], z=jlast["z"],
                              theta=jlast["theta"], big_l=jlast["big_l"],
                              bts=jlast["bts"],
                              prior_iters=jlast["prior_iters"])
    second = port.run_agd_host(sm, px, rv, None, port.AGDConfig(**cfg),
                               smooth_loss=sl, warm=warm)
    jsecond = jhost.run_agd_host(jsm, jpx, jrv, None,
                                 jagd.AGDConfig(**cfg), smooth_loss=jsl,
                                 warm=jwarm)
    _hold_host(first, jfirst)
    _hold_host(second, jsecond)
    # the continuation is the uninterrupted run, split in two
    whole = port.run_agd_host(sm, px, rv, torch.from_numpy(w0),
                              port.AGDConfig(num_iterations=8,
                                             convergence_tol=0.0),
                              smooth_loss=sl)
    np.testing.assert_array_equal(
        np.concatenate([first.loss_history, second.loss_history]),
        whole.loss_history)
    assert torch.equal(second.weights, whole.weights)


def test_run_agd_host_rejects_unknown_loss_mode():
    with pytest.raises(ValueError, match="loss_mode"):
        port.run_agd_host(None, None, None, torch.zeros(2),
                          port.AGDConfig(loss_mode="z"))


def test_run_agd_host_aborts_on_a_non_finite_loss_like_jax():
    def smooth(w):
        return torch.tensor(float("nan"), dtype=torch.float64), w * 0

    def jsmooth_(w):
        return jnp.asarray(np.nan), w * 0

    px, rv = tsmooth.make_prox(prox.L2Prox(), 0.1)
    jpx, jrv = jsmooth.make_prox(jprox.L2Prox(), 0.1)
    carries = []
    mine = port.run_agd_host(smooth, px, rv,
                             torch.ones(3, dtype=torch.float64),
                             port.AGDConfig(num_iterations=5),
                             on_iteration=carries.append)
    theirs = jhost.run_agd_host(jsmooth_, jpx, jrv, jnp.ones(3),
                                jagd.AGDConfig(num_iterations=5))
    assert mine.aborted_non_finite and theirs.aborted_non_finite
    assert mine.num_iters == theirs.num_iters == 1
    assert carries[-1]["aborted"] and carries[-1]["last"]


# ---------------------------------------------------------------------------
# LIBSVM part files, quarantine, data loss


def _write_parts(tmp_path, n_shards=4, rows=40, d=D, seed=11):
    rng = np.random.default_rng(seed)
    paths = []
    for k in range(n_shards):
        X = (rng.random((rows, d)) < 0.5) * rng.standard_normal((rows, d))
        y = np.where(rng.random(rows) < 0.5, 1.0, -1.0)
        p = str(tmp_path / f"part-{k:05d}")
        jlibsvm.save_libsvm(p, X.astype(np.float32), y)
        paths.append(p)
    return paths


def _fast(policy_cls):
    return policy_cls(max_attempts=2, backoff_base=0.0, backoff_max=0.0,
                      jitter=0.0, seed=0)


@pytest.mark.parametrize("nnz_pad", [None, 256])
def test_libsvm_parts_give_jax_batches(tmp_path, nnz_pad):
    paths = _write_parts(tmp_path)
    empty = str(tmp_path / "part-empty")
    open(empty, "w").close()
    paths = [empty] + paths  # an empty first part does not size the shape
    ds = streaming.StreamingDataset.from_libsvm_parts(
        paths, n_features=D, batch_rows=16, nnz_pad=nnz_pad)
    jds = jstreaming.StreamingDataset.from_libsvm_parts(
        paths, n_features=D, batch_rows=16, nnz_pad=nnz_pad)
    for _ in range(2):  # the inference parse serves the first pass only
        mine, theirs = list(ds), list(jds)
        assert len(mine) == len(theirs) == 12
        for (X, yb, mb), (J, jy, jm) in zip(mine, theirs):
            assert X.nnz == J.nnz and X.shape == J.shape
            for name in ("row_ids", "col_ids", "values"):
                np.testing.assert_array_equal(_np(getattr(X, name)),
                                              np.asarray(getattr(J, name)))
            np.testing.assert_array_equal(yb, jy)
            np.testing.assert_array_equal(mb, jm)
    with pytest.raises(ValueError, match="n_features"):
        list(streaming.StreamingDataset.from_libsvm_parts(
            paths[1:], n_features=3, batch_rows=16))
    with pytest.raises(ValueError, match="all parts are empty"):
        streaming.StreamingDataset.from_libsvm_parts([empty], n_features=D,
                                                     batch_rows=16)
    with pytest.raises(ValueError, match="at least one path"):
        streaming.StreamingDataset.from_libsvm_parts([], n_features=D,
                                                     batch_rows=16)


def test_libsvm_parts_stream_fits_like_jax(tmp_path):
    paths = _write_parts(tmp_path, seed=12)
    cfg = dict(num_iterations=6, convergence_tol=0.0)
    sm, sl = streaming.make_streaming_smooth(
        losses.LogisticGradient(),
        streaming.StreamingDataset.from_libsvm_parts(paths, n_features=D,
                                                     batch_rows=16),
        prefetch=2, device="cpu")
    px, rv = tsmooth.make_prox(prox.L2Prox(), 0.01)
    mine = port.run_agd_host(sm, px, rv, torch.zeros(D, dtype=torch.float32),
                             port.AGDConfig(**cfg), smooth_loss=sl)
    jsm, jsl = jstreaming.make_streaming_smooth(
        jlosses.LogisticGradient(),
        jstreaming.StreamingDataset.from_libsvm_parts(paths, n_features=D,
                                                      batch_rows=16))
    jpx, jrv = jsmooth.make_prox(jprox.L2Prox(), 0.01)
    theirs = jhost.run_agd_host(jsm, jpx, jrv, jnp.zeros(D, jnp.float32),
                                jagd.AGDConfig(**cfg), smooth_loss=jsl)
    assert mine.num_iters == theirs.num_iters == 6
    np.testing.assert_allclose(mine.loss_history, theirs.loss_history,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(mine.weights), np.asarray(theirs.weights),
                               rtol=1e-4, atol=1e-5)


def test_quarantine_matches_jax_and_is_sticky(tmp_path):
    paths = _write_parts(tmp_path, seed=13)
    with open(paths[2], "wb") as f:
        f.write(b"\x00 not libsvm at all\n")
    kw = dict(n_features=D, batch_rows=16, nnz_pad=128, quarantine=True)
    ds = streaming.StreamingDataset.from_libsvm_parts(
        paths, retries=_fast(RetryPolicy), **kw)
    jds = jstreaming.StreamingDataset.from_libsvm_parts(
        paths, retries=_fast(JRetryPolicy), **kw)
    rows = [int(m.sum()) for _, _, m in ds]
    jrows = [int(np.asarray(m).sum()) for _, _, m in jds]
    assert rows == jrows and sum(rows) == 3 * 40
    assert ds.quarantined.keys() == jds.quarantined.keys() == {paths[2]}
    assert ds.quarantined == jds.quarantined
    assert [int(m.sum()) for _, _, m in ds] == rows  # sticky


def test_data_loss_refuses_typed_like_jax(tmp_path):
    paths = _write_parts(tmp_path, n_shards=2, seed=14)
    with open(paths[0], "w") as f:
        f.write("garbage garbage\n")
    kw = dict(n_features=D, batch_rows=16, nnz_pad=128,
              quarantine=streaming.QuarantinePolicy(min_data_fraction=0.9))
    ds = streaming.StreamingDataset.from_libsvm_parts(
        paths, retries=_fast(RetryPolicy), **kw)
    with pytest.raises(StreamDataLoss, match="1/2 shards healthy"):
        list(ds)
    jkw = dict(kw, quarantine=jstreaming.QuarantinePolicy(
        min_data_fraction=0.9))
    with pytest.raises(JStreamDataLoss, match="1/2 shards healthy"):
        list(jstreaming.StreamingDataset.from_libsvm_parts(
            paths, retries=_fast(JRetryPolicy), **jkw))
    # without quarantine the epoch fails loudly
    with pytest.raises(ValueError):
        list(streaming.StreamingDataset.from_libsvm_parts(
            paths, n_features=D, batch_rows=16, nnz_pad=128,
            retries=_fast(RetryPolicy)))
    with pytest.raises(ValueError, match="min_data_fraction"):
        streaming.QuarantinePolicy(min_data_fraction=1.5)


@pytest.mark.parametrize("validate", ["raise", "drop"])
def test_validate_policy_like_jax(tmp_path, validate):
    paths = _write_parts(tmp_path, n_shards=2, seed=15)
    with open(paths[1], "a") as f:
        f.write("1 1:nan 2:1.0\n")
    kw = dict(n_features=D, batch_rows=16, nnz_pad=128, validate=validate)
    ds = streaming.StreamingDataset.from_libsvm_parts(
        paths, retries=_fast(RetryPolicy), **kw)
    jds = jstreaming.StreamingDataset.from_libsvm_parts(
        paths, retries=_fast(JRetryPolicy), **kw)
    if validate == "raise":
        with pytest.raises(libsvm.DataValidationError):
            list(ds)
        with pytest.raises(jlibsvm.DataValidationError):
            list(jds)
    else:
        rows = [int(m.sum()) for _, _, m in ds]
        assert rows == [int(np.asarray(m).sum()) for _, _, m in jds]
        assert sum(rows) == 80
    with pytest.raises(ValueError, match="validate"):
        streaming.StreamingDataset.from_libsvm_parts(
            paths, n_features=D, batch_rows=16, validate="maybe")


# ---------------------------------------------------------------------------
# fold_stream's contracts


def test_fold_stream_launches_before_placing_and_counts_once():
    events = []

    class FakeN:
        def __init__(self, i):
            self.i = i

        def __int__(self):
            events.append(("sync", self.i))
            return 1

    def fake_place(i):
        events.append(("place", i))
        return (i,)

    def fake_kernel(w, i):
        events.append(("dispatch", i))
        return np.float32(i), FakeN(i)

    acc, n = streaming.fold_stream(
        fake_kernel, lambda a, b: [a[0] + b[0]], fake_place,
        [(0,), (1,), (2,)], w=None)
    assert n == 3 and float(acc[0]) == 3.0
    kinds = [e[0] for e in events]
    assert kinds == ["place", "dispatch", "place", "dispatch", "place",
                     "dispatch", "sync", "sync", "sync"]


def test_fold_stream_adds_in_batch_order_and_counts_tensors_once():
    seen = []

    def kernel(w, X, y, mask):
        return X.sum(), torch.tensor(X.shape[0])

    def combine(a, b):
        seen.append(float(b[0]))
        return [a[0] + b[0]]

    X, y = _dense(n=50)
    ds = streaming.StreamingDataset.from_arrays(torch.from_numpy(X),
                                                torch.from_numpy(y), 16)
    acc, n = streaming.fold_stream(kernel, combine,
                                   streaming._make_placer(
                                       torch.device("cpu"), None), ds, None)
    assert n == 50 and isinstance(n, int)
    sums = [float(torch.from_numpy(X[s:s + 16]).sum())
            for s in range(0, 50, 16)]
    assert seen == sums[1:]
    expected = torch.tensor(sums[0], dtype=torch.float64)
    for v in sums[1:]:
        expected = expected + v
    assert float(acc[0]) == float(expected)


def test_empty_stream_raises_and_datasets_reiterate():
    with pytest.raises(ValueError, match="no batches"):
        streaming.fold_stream(lambda w, *b: (0.0, 0), lambda a, b: a,
                              lambda *b: b, [], None)
    calls = {"n": 0}

    def factory():
        calls["n"] += 1
        yield (np.zeros((4, 2)), np.zeros(4), None)

    ds = streaming.StreamingDataset(factory)
    assert len(list(ds)) == len(list(ds)) == 1
    assert calls["n"] == 2


def _alive_pumps():
    return [t for t in threading.enumerate()
            if t.name == "fold-stream-prefetch" and t.is_alive()]


def test_prefetcher_joined_when_the_kernel_raises_mid_pass():
    X, y = _dense(n=64)
    ds = streaming.StreamingDataset.from_arrays(X, y, batch_rows=8)
    sm, _ = streaming.make_streaming_smooth(losses.LogisticGradient(), ds,
                                            prefetch=2, device="cpu")
    calls = [0]

    def kernel(w, X, y, mask):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("kernel blew up")
        return torch.zeros(()), torch.tensor(X.shape[0])

    with pytest.raises(RuntimeError, match="kernel blew up"):
        streaming.fold_stream(kernel, lambda a, b: a,
                              streaming._make_placer(torch.device("cpu"),
                                                     None),
                              ds, None, prefetch=2)
    deadline = time.monotonic() + 5.0
    while _alive_pumps() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _alive_pumps()
    # the next pass is right
    w = torch.from_numpy(np.random.default_rng(16).standard_normal(D))
    f, _ = sm(w)
    ref, _ = tsmooth.make_smooth(losses.LogisticGradient(),
                                 torch.from_numpy(X),
                                 torch.from_numpy(y))(w)
    np.testing.assert_allclose(float(f), float(ref), rtol=1e-12)


def test_prefetcher_shutdown_contract():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    pf = streaming._Prefetcher(endless(), depth=2)
    assert pf() == 0
    assert pf.close() is True and pf.close() is True
    pf = streaming._Prefetcher(iter(range(5)), depth=1)
    got = []
    while (b := pf()) is not None:
        got.append(b)
    assert got == [0, 1, 2, 3, 4] and pf.close()

    def bad():
        yield 1
        raise OSError("disk on fire")

    pf = streaming._Prefetcher(bad(), depth=2)
    assert pf() == 1
    with pytest.raises(OSError, match="disk on fire"):
        while pf() is not None:
            pass
    assert pf.close()


@pytest.mark.parametrize("source", ["dense", "csr"])
def test_prefetch_0_and_2_give_equal_bits(source):
    if source == "dense":
        X, y = _dense(n=700, seed=17, dtype=np.float32)
        ds = streaming.StreamingDataset.from_arrays(X, y, batch_rows=96)
        w = torch.from_numpy(
            np.random.default_rng(18).standard_normal(D).astype(np.float32))
    else:
        indptr, indices, values, y = _csr(n=700, seed=19, dtype=np.float32)
        ds = streaming.StreamingDataset.from_csr(indptr, indices, values, 41,
                                                 y, batch_rows=96)
        w = torch.from_numpy(
            np.random.default_rng(20).standard_normal(41).astype(np.float32))
    outs = []
    for prefetch in (0, 2, 0, 2):
        sm, sl = streaming.make_streaming_smooth(
            port.FusedLogisticGradient(), ds, prefetch=prefetch,
            device="cpu")
        outs.append((sm(w), sl(w)))
    for (f, g), l in outs[1:]:
        assert torch.equal(f, outs[0][0][0]) and torch.equal(g, outs[0][0][1])
        assert torch.equal(l, outs[0][1])


# ---------------------------------------------------------------------------
# the cursor: JAX's npz entries, a resumed pass equals the uninterrupted one


class _Checkpointer:
    """The three duck-typed members ``StreamCheckpoint`` drives, for both
    packages."""

    def __init__(self, extras=None):
        self.saved = []
        self.stream_hook = None
        self.loaded_extras = extras or {}

    def update_stream(self, extra):
        self.saved.append(dict(extra))
        return True


def test_cursor_codec_gives_jax_npz_entries():
    leaves = (np.arange(3) * 1.25, np.asarray(7.5))
    extra = streaming.cursor_to_extra(streaming.StreamCursor(2, 5, 40,
                                                             leaves))
    jextra = jstreaming.cursor_to_extra(jstreaming.StreamCursor(2, 5, 40,
                                                                leaves))
    assert extra.keys() == jextra.keys()
    for k in extra:
        assert extra[k].dtype == jextra[k].dtype, k
        np.testing.assert_array_equal(extra[k], jextra[k])
    back = streaming.cursor_from_extras(jextra)
    assert (back.pass_offset, back.batch_index, back.n) == (2, 5, 40)
    assert streaming.cursor_from_extras({}) is None
    del extra["stream_acc_1"]
    assert streaming.cursor_from_extras(extra) is None
    # a torch leaf encodes as its numpy twin
    t = streaming.cursor_to_extra(streaming.StreamCursor(
        0, 1, 2, (torch.arange(3, dtype=torch.float64) * 1.25,)))
    np.testing.assert_array_equal(t["stream_acc_0"], leaves[0])
    with pytest.raises(ValueError, match="every_batches"):
        streaming.StreamCheckpoint(_Checkpointer(), every_batches=0)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_a_pass_resumed_from_a_cursor_equals_the_uninterrupted_pass(
        prefetch):
    X, y = _dense(n=300, seed=21)
    w = np.random.default_rng(22).standard_normal(D)
    ds = streaming.StreamingDataset.from_arrays(X, y, batch_rows=32)
    jds = jstreaming.StreamingDataset.from_arrays(X, y, batch_rows=32)
    full, _ = streaming.make_streaming_smooth(
        losses.LogisticGradient(), ds, device="cpu")
    f_full, g_full = full(torch.from_numpy(w))

    ck, jck = _Checkpointer(), _Checkpointer()
    sc = streaming.StreamCheckpoint(ck, every_batches=4)
    jsc = jstreaming.StreamCheckpoint(jck, every_batches=4)
    assert ck.stream_hook is sc and jck.stream_hook is jsc
    sm, _ = streaming.make_streaming_smooth(
        losses.LogisticGradient(), ds, stream_ckpt=sc, prefetch=prefetch,
        device="cpu")
    jsm, _ = jstreaming.make_streaming_smooth(
        jlosses.LogisticGradient(), jds, stream_ckpt=jsc)
    f, g = sm(torch.from_numpy(w))
    jsm(jnp.asarray(w))
    assert torch.equal(f, f_full) and torch.equal(g, g_full)
    assert sc.commits == jsc.commits == 2  # after batches 4 and 8 of 10
    for mine, theirs in zip(ck.saved, jck.saved):
        assert mine.keys() == theirs.keys()
        for k in mine:
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-12)

    # a new process: the loaded cursor of pass 0, batch 8, resumes there
    ck2 = _Checkpointer(extras=ck.saved[-1])
    sc2 = streaming.StreamCheckpoint(ck2, every_batches=100)
    stats = []
    sm2, _ = streaming.make_streaming_smooth(
        losses.LogisticGradient(), ds, stream_ckpt=sc2, prefetch=prefetch,
        device="cpu", pass_stats=stats)
    f2, g2 = sm2(torch.from_numpy(w))
    assert stats[-1]["skipped_batches"] == 8
    assert stats[-1]["resumed_from_batch"] == 8
    assert torch.equal(f2, f_full) and torch.equal(g2, g_full)
    # the same cursor in the JAX package gives the same pass
    jsc2 = jstreaming.StreamCheckpoint(_Checkpointer(extras=ck.saved[-1]),
                                       every_batches=100)
    jsm2, _ = jstreaming.make_streaming_smooth(
        jlosses.LogisticGradient(), jds, stream_ckpt=jsc2)
    jf2, jg2 = jsm2(jnp.asarray(w))
    np.testing.assert_allclose(float(f2), float(jf2), rtol=1e-12)
    np.testing.assert_allclose(_np(g2), np.asarray(jg2), rtol=1e-12)


def test_an_incompatible_cursor_replays_the_whole_pass():
    X, y = _dense(n=64, seed=23)
    ds = streaming.StreamingDataset.from_arrays(X, y, batch_rows=16)
    sc = streaming.StreamCheckpoint(_Checkpointer(), every_batches=100)
    sc.adopt(streaming.cursor_to_extra(streaming.StreamCursor(
        0, 1, 16, (np.ones(1), np.ones(1), np.ones(1)))))
    stats = []
    sm, _ = streaming.make_streaming_smooth(losses.LogisticGradient(), ds,
                                            stream_ckpt=sc, device="cpu",
                                            pass_stats=stats)
    sm(torch.zeros(D, dtype=torch.float64))
    assert stats[-1]["skipped_batches"] == 0
    assert stats[-1]["batches"] == 4


# ---------------------------------------------------------------------------
# f32: the fused gradient (plain on the CPU) against the Pallas kernel


@pytest.mark.parametrize("pad_to", [None, 64])
def test_fused_logistic_stream_matches_pallas_interpret(pad_to):
    X, y = _dense(n=333, d=24, seed=24, dtype=np.float32)
    w = (np.random.default_rng(25).standard_normal(24) / 5).astype(
        np.float32)
    ds = streaming.StreamingDataset.from_arrays(X, y, batch_rows=64)
    jds = jstreaming.StreamingDataset.from_arrays(X, y, batch_rows=64)
    sm, sl = streaming.make_streaming_smooth(port.FusedLogisticGradient(),
                                             ds, pad_to=pad_to, device="cpu")
    jsm, jsl = jstreaming.make_streaming_smooth(
        PallasLogisticGradient(interpret=True), jds, pad_to=pad_to)
    f, g = sm(torch.from_numpy(w))
    jf, jg = jsm(jnp.asarray(w))
    assert f.dtype == g.dtype == torch.float32
    np.testing.assert_allclose(float(f), float(jf), rtol=1e-5)
    np.testing.assert_allclose(_np(g), np.asarray(jg), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(sl(torch.from_numpy(w))),
                               float(jsl(jnp.asarray(w))), rtol=1e-5)


def test_fused_logistic_stream_fit_matches_pallas_fit():
    X, y = _dense(n=400, d=16, seed=26, dtype=np.float32)
    cfg = dict(num_iterations=8, convergence_tol=0.0)
    sm, sl = streaming.make_streaming_smooth(
        port.FusedLogisticGradient(),
        streaming.StreamingDataset.from_arrays(X, y, batch_rows=96),
        device="cpu")
    px, rv = tsmooth.make_prox(prox.SquaredL2Updater(), 0.1)
    mine = port.run_agd_host(sm, px, rv, torch.zeros(16), port.AGDConfig(
        **cfg), smooth_loss=sl)
    jsm, jsl = jstreaming.make_streaming_smooth(
        PallasLogisticGradient(interpret=True),
        jstreaming.StreamingDataset.from_arrays(X, y, batch_rows=96))
    jpx, jrv = jsmooth.make_prox(jprox.SquaredL2Updater(), 0.1)
    theirs = jhost.run_agd_host(jsm, jpx, jrv, jnp.zeros(16, jnp.float32),
                                jagd.AGDConfig(**cfg), smooth_loss=jsl)
    assert mine.num_iters == theirs.num_iters == 8
    np.testing.assert_allclose(mine.loss_history, theirs.loss_history,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the surface: later slices raise, the card is the default, predict_stream


@pytest.mark.parametrize("option", [
    # a data mesh and its budget are ported: beside a model axis they
    # still raise
    dict(mesh=tmesh.make_mesh({"data": 1, "model": 2}, devices=["cpu"] * 2)),
    dict(csr_nnz_per_shard=256, mesh=tmesh.make_mesh({"data": 1, "model": 2}, devices=["cpu"] * 2)),
    dict(telemetry=object())], ids=lambda o: next(iter(o)))
def test_streaming_smooth_later_slice_options_raise(option):
    ds = streaming.StreamingDataset.from_arrays(*_dense(n=8), batch_rows=4)
    with pytest.raises(NotImplementedError, match="later slice"):
        streaming.make_streaming_smooth(losses.LogisticGradient(), ds,
                                        device="cpu", **option)
    if "telemetry" not in option:
        with pytest.raises(NotImplementedError, match="mesh slice"):
            streaming.make_streaming_eval_multi(losses.LogisticGradient(),
                                                ds, device="cpu", **option)


@pytest.mark.parametrize("option", [
    dict(telemetry=object()),
    # chaos= is ported; beside it telemetry= still raises
    dict(chaos=object(), telemetry=object())], ids=lambda o: next(iter(o)))
def test_libsvm_parts_later_slice_options_raise(tmp_path, option):
    paths = _write_parts(tmp_path, n_shards=1)
    with pytest.raises(NotImplementedError, match="later slice"):
        streaming.StreamingDataset.from_libsvm_parts(
            paths, n_features=D, batch_rows=8, **option)


def test_a_stream_runs_on_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = streaming.StreamingDataset.from_arrays(*_dense(n=8), batch_rows=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        streaming.make_streaming_smooth(losses.LogisticGradient(), ds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        streaming.make_streaming_eval_multi(losses.LogisticGradient(), ds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.streaming_sweep(ds, losses.LogisticGradient(), prox.L2Prox(),
                             [0.1], initial_weights=np.zeros(D))


@pytest.mark.parametrize("source", ["dense", "csr"])
def test_predict_stream_iterates_a_port_dataset_like_jax(source):
    rng = np.random.default_rng(27)
    if source == "dense":
        X, y = _dense(n=70, seed=28)
        mask = (rng.random(70) < 0.7).astype(np.float32)
        ds = streaming.StreamingDataset.from_arrays(X, y, 32, mask=mask)
        jds = jstreaming.StreamingDataset.from_arrays(X, y, 32, mask=mask)
        d = D
    else:
        indptr, indices, values, y = _csr(n=70, seed=29)
        args = (indptr, indices, values, 41, y, 32)
        ds = streaming.StreamingDataset.from_csr(*args)
        jds = jstreaming.StreamingDataset.from_csr(*args)
        d = 41
    w = rng.standard_normal(d)
    model = tglm.LogisticRegressionModel(torch.from_numpy(w), 0.25,
                                         threshold=None)
    jmodel = jglm.LogisticRegressionModel(jnp.asarray(w), 0.25,
                                          threshold=None)
    mine = list(model.predict_stream(ds))
    theirs = list(jmodel.predict_stream(jds))
    assert [len(p) for p in mine] == [len(p) for p in theirs]
    np.testing.assert_allclose(np.concatenate(mine), np.concatenate(theirs),
                               rtol=1e-12)


def test_retry_engine_rereads_a_flaky_shard(tmp_path, monkeypatch):
    paths = _write_parts(tmp_path, n_shards=2, seed=30)
    real = libsvm.load_libsvm
    failures = {"n": 0}

    def flaky(path, n_features=None):
        if path == paths[1] and failures["n"] == 0:
            failures["n"] += 1
            raise OSError("transient read error")
        return real(path, n_features=n_features)

    monkeypatch.setattr(libsvm, "load_libsvm", flaky)
    ds = streaming.StreamingDataset.from_libsvm_parts(
        paths, n_features=D, batch_rows=16, retries=RetryPolicy(
            max_attempts=3, backoff_base=0.0, jitter=0.0, seed=0))
    assert sum(int(m.sum()) for _, _, m in ds) == 80
    assert failures["n"] == 1 and not ds.quarantined


def test_ingest_retrying_loader_and_validation_like_jax(tmp_path):
    from spark_agd_tpu.data import ingest as jingest
    from spark_agd_tpu_torch.data import ingest

    assert ingest.DEFAULT_READ_RETRIES.max_attempts == \
        jingest.DEFAULT_READ_RETRIES.max_attempts == 3
    calls = []

    def flaky(path):
        calls.append(path)
        if len(calls) < 2:
            raise OSError("transient")
        return libsvm.load_libsvm(path, n_features=D)

    paths = _write_parts(tmp_path, n_shards=2, seed=31)
    with open(paths[1], "a") as f:
        f.write("1 1:inf\n")
    loader = ingest._retrying_loader(flaky, RetryPolicy(
        max_attempts=2, backoff_base=0.0, jitter=0.0, seed=0), None)
    parts = [loader(p) for p in paths]
    assert len(calls) == 3  # one retry, then each part once
    kept = ingest._validated_parts(paths, parts, D, "drop", None)
    jparts = [jlibsvm.load_libsvm(p, n_features=D) for p in paths]
    jkept = jingest._validated_parts(paths, jparts, D, "drop", None)
    for a, b in zip(kept, jkept):
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.values, b.values)
    assert len(kept[1].labels) == 40 and len(parts[1].labels) == 41
    assert ingest._validated_parts(paths, parts, D, False, None) is parts
    with pytest.raises(libsvm.DataValidationError):
        ingest._validated_parts(paths, parts, D, "raise", None)
    with pytest.raises(ValueError, match="validate"):
        ingest._validated_parts(paths, parts, D, "maybe", None)
