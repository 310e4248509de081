"""The port's sparse data plane (``ops/sparse.py``, CSR through the losses,
the fused gradients, the intercept, the trainers and ``run``, the sparse
generators) against the JAX package, on the CPU.

Inputs are made from a seed with numpy, or by the JAX generators, and
carried across with ``convert.csr_from_numpy``.  Tolerances: single
products and evaluations at f64 within 1e-12 (the port's ``segment_reduce``
and the JAX ``segment_sum`` add in different orders); fits at f64 take the
same iterations, losses within 1e-9 relative, weights within 3e-7 (the
oracle tolerances of ``tests/test_agd_core.py:75-88``)."""

import jax
import numpy as np
import pytest
import torch

import spark_agd_tpu as jpkg
from spark_agd_tpu.data import device_synth as jsynth
from spark_agd_tpu.models import glm as jglm
from spark_agd_tpu.ops import losses as jlosses, sparse as jsparse
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch import convert
from spark_agd_tpu_torch.data import device_synth
from spark_agd_tpu_torch.models import glm as tglm
from spark_agd_tpu_torch.ops import fused_kernels as fk, losses, sparse

RTOL = 1e-12


def _close(actual, expected, rtol=RTOL):
    expected = np.asarray(expected, np.float64)
    atol = rtol * float(np.max(np.abs(expected))) if expected.size else 0.0
    np.testing.assert_allclose(np.asarray(actual), expected, rtol=rtol,
                               atol=atol)


def _problem(seed=23, n=211, d=100, dtype=np.float64):
    """CSR arrays with empty rows (counts from 0), three empty columns
    (ids below d - 3), duplicate (row, col) pairs and zero-value padding
    entries (every fifth row ends with one at the last column)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, n)
    pad = (np.arange(n) % 5 == 0).astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(counts + pad)])
    indices, values = [], []
    for c, p in zip(counts, pad):
        indices.append(rng.integers(0, d - 3, c))
        values.append(rng.standard_normal(c))
        if p:
            indices.append([d - 1])
            values.append([0.0])
    indices = np.concatenate(indices).astype(np.int32)
    values = np.concatenate(values).astype(dtype)
    return indptr, indices, values, n, d


def _dense(indptr, indices, values, n, d):
    D = np.zeros((n, d))
    np.add.at(D, (np.repeat(np.arange(n), np.diff(indptr)), indices), values)
    return D


def _pair(twin, build="convert", seed=23):
    """(JAX CSRMatrix, the port's, dense twin) of one problem."""
    indptr, indices, values, n, d = _problem(seed)
    jx = jsparse.CSRMatrix.from_csr_arrays(indptr, indices, values, d,
                                           with_csc=twin)
    if build == "convert":
        csc = ((np.asarray(jx.csc_row_ids), np.asarray(jx.csc_col_ids),
                np.asarray(jx.csc_values)) if twin else None)
        tx = convert.csr_from_numpy(
            np.asarray(jx.row_ids), np.asarray(jx.col_ids),
            np.asarray(jx.values), jx.shape, csc=csc, device="cpu")
    else:
        tx = sparse.CSRMatrix.from_csr_arrays(indptr, indices, values, d,
                                              with_csc=twin, device="cpu")
    return jx, tx, _dense(indptr, indices, values, n, d)


@pytest.mark.parametrize("build", ["convert", "from_csr_arrays"])
@pytest.mark.parametrize("twin", [True, False], ids=["twin", "no-twin"])
@pytest.mark.parametrize("product", ["matvec", "rmatvec", "matmat",
                                     "rmatmat"])
def test_products_match_jax(product, twin, build):
    jx, tx, D = _pair(twin, build)
    rng = np.random.default_rng(5)
    n, d = D.shape
    arg = {"matvec": (d,), "rmatvec": (n,), "matmat": (d, 4),
           "rmatmat": (n, 4)}[product]
    a = rng.standard_normal(arg)
    got = getattr(tx, product)(torch.from_numpy(a))
    want = np.asarray(getattr(jx, product)(a))
    assert got.dtype == torch.float64 and got.shape == want.shape
    _close(got.numpy(), want)
    dense = D @ a if product.startswith("mat") else D.T @ a
    _close(got.numpy(), dense)
    # the polymorphic helpers route by layout and by the argument's rank
    poly = (sparse.matvec if product.startswith("mat") else sparse.rmatvec)
    assert torch.equal(poly(tx, torch.from_numpy(a)), got)


def test_empty_rows_and_columns_sum_to_zero():
    _, tx, D = _pair(True)
    n, d = D.shape
    out = tx.matvec(torch.ones(d, dtype=torch.float64))
    assert (out[torch.from_numpy(~D.any(axis=1))] == 0).all()
    cols = tx.rmatvec(torch.ones(n, dtype=torch.float64))
    assert cols.shape == (d,) and (cols[-3:] == 0).all()
    assert int((tx.colptr[1:] == tx.colptr[:-1]).sum()) >= 2


@pytest.mark.parametrize("product", ["matvec", "rmatvec", "matmat",
                                     "rmatmat"])
def test_long_segments_are_summed_in_chunks(product):
    """A row and a column longer than ``CHUNK`` entries (as the
    intercept's column is) are summed chunk by chunk, then over their
    chunks: the same products as the JAX package's."""
    rng = np.random.default_rng(12)
    n, d = 1_500, 40
    counts = np.where(np.arange(n) == 7, 3 * sparse.CHUNK + 5,
                      rng.integers(0, 6, n))
    indptr = np.concatenate([[0], np.cumsum(counts)])
    indices = np.where(np.arange(indptr[-1]) % 2 == 0, 3,
                       rng.integers(0, d, indptr[-1])).astype(np.int32)
    values = rng.standard_normal(indptr[-1])
    tx = sparse.CSRMatrix.from_csr_arrays(indptr, indices, values, d,
                                          with_csc=True, device="cpu")
    jx = jsparse.CSRMatrix.from_csr_arrays(indptr, indices, values, d,
                                           with_csc=True)
    assert sparse._plan(tx.indptr) is not None
    assert sparse._plan(tx.colptr) is not None
    arg = {"matvec": (d,), "rmatvec": (n,), "matmat": (d, 3),
           "rmatmat": (n, 3)}[product]
    a = rng.standard_normal(arg)
    got = getattr(tx, product)(torch.from_numpy(a))
    _close(got.numpy(), np.asarray(getattr(jx, product)(a)))
    assert torch.equal(getattr(tx, product)(torch.from_numpy(a)), got)


def test_zero_value_padding_is_inert():
    indptr, indices, values, n, d = _problem()
    live = values != 0
    counts = np.add.reduceat(live.astype(np.int64), indptr[:-1]) \
        * (np.diff(indptr) > 0)
    bare = sparse.CSRMatrix.from_csr_arrays(
        np.concatenate([[0], np.cumsum(counts)]), indices[live],
        values[live], d, with_csc=True, device="cpu")
    padded = sparse.CSRMatrix.from_csr_arrays(indptr, indices, values, d,
                                              with_csc=True, device="cpu")
    assert padded.nnz > bare.nnz
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal(d))
    v = torch.from_numpy(rng.standard_normal(n))
    assert torch.equal(padded.matvec(w), bare.matvec(w))
    assert torch.equal(padded.rmatvec(v), bare.rmatvec(v))


def test_twin_layout_matches_jax():
    """Both packages build the twin by a stable sort of the column ids:
    the same entries in the same order; offsets point at each column's
    run; the forward arrays are the CSR arrays in row order."""
    jx, tx, _ = _pair(True, "from_csr_arrays")
    for name in ("row_ids", "col_ids", "values", "csc_row_ids",
                 "csc_col_ids", "csc_values"):
        np.testing.assert_array_equal(getattr(tx, name).numpy(),
                                      np.asarray(getattr(jx, name)), name)
    indptr, _, _, n, d = _problem()
    np.testing.assert_array_equal(tx.indptr.numpy(), indptr)
    cid = tx.csc_col_ids.numpy()
    np.testing.assert_array_equal(
        tx.colptr.numpy(), np.searchsorted(cid, np.arange(d + 1)))
    assert tx.rows_sorted and tx.has_csc and tx.nnz == len(cid)
    assert tx.shape == jx.shape and tx.dtype == torch.float64
    assert tx.device.type == "cpu" and tx.to("cpu") is tx


def test_with_csc_idempotent_and_lazy_marker():
    _, tx, _ = _pair(False, "from_csr_arrays")
    assert not tx.has_csc and not tx.want_csc
    full = tx.with_csc()
    assert full.has_csc and full.with_csc() is full
    assert full.with_csc(lazy=True) is full
    lazy = tx.with_csc(lazy=True)
    assert lazy.want_csc and not lazy.has_csc
    assert lazy.with_csc(lazy=True) is lazy
    Xp, _, _ = losses.LogisticGradient().prepare(lazy, torch.zeros(211))
    assert Xp.has_csc and Xp.want_csc
    # prepare builds a missing twin even when none was asked for: every
    # transpose product runs on it
    Xq, _, _ = losses.LogisticGradient().prepare(tx, torch.zeros(211))
    assert Xq.has_csc
    assert torch.equal(Xq.csc_values, full.csc_values)


def test_unsorted_rows_are_sorted_once():
    """The JAX intercept puts every intercept entry first (rows out of
    order); carried over, the port sorts its rows once, stably, and the
    products agree."""
    jx, _, D = _pair(True)
    ja = jglm._add_intercept(jx)
    assert not ja.rows_sorted
    ta = convert.csr_from_numpy(np.asarray(ja.row_ids),
                                np.asarray(ja.col_ids),
                                np.asarray(ja.values), ja.shape,
                                device="cpu")
    rid = ta.row_ids.numpy()
    assert ta.rows_sorted and np.all(np.diff(rid) >= 0)
    w = np.random.default_rng(7).standard_normal(ja.shape[1])
    _close(ta.matvec(torch.from_numpy(w)).numpy(),
           np.asarray(ja.matvec(w)))


def test_csr_to_numpy_rebuilds_the_jax_matrix():
    _, tx, D = _pair(True, "from_csr_arrays")
    jx = jsparse.CSRMatrix(**convert.csr_to_numpy(tx))
    assert jx.has_csc and jx.shape == tx.shape
    v = np.random.default_rng(8).standard_normal(D.shape[0])
    _close(np.asarray(jx.rmatvec(v)), tx.rmatvec(torch.from_numpy(v)))


def test_construction_rejects_what_it_does_not_take():
    indptr, indices, values, n, d = _problem()
    with pytest.raises(TypeError, match="later slice"):
        sparse.CSRMatrix(torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.bfloat16), (1, 1))
    with pytest.raises(TypeError, match="f32 or f64"):
        sparse.CSRMatrix(torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int64), (1, 1))
    with pytest.raises(ValueError, match="one length"):
        sparse.CSRMatrix(torch.zeros(2, dtype=torch.int32),
                         torch.zeros(3, dtype=torch.int32),
                         torch.zeros(2), (1, 1))
    with pytest.raises(ValueError, match=r"\[0, 50\)"):
        sparse.CSRMatrix.from_csr_arrays(indptr, indices, values, 50,
                                         device="cpu")


# --- CSR through the losses and the fused gradients -----------------------

def _loss_pair(name, fused):
    if name == "softmax":
        jg, tg = jlosses.SoftmaxGradient(4), losses.SoftmaxGradient(4)
        return jg, (fk.FusedSoftmaxGradient(tg) if fused else tg)
    jg, tg = jlosses.GRADIENTS[name](), losses.GRADIENTS[name]()
    return jg, (fk.FusedMarginGradient(tg) if fused else tg)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("name", ["logistic", "least_squares", "hinge",
                                  "softmax"])
def test_losses_on_csr_match_jax(name, masked, fused):
    jx, tx, _ = _pair(True)
    n, d = jx.shape
    rng = np.random.default_rng(9)
    if name == "softmax":
        w = rng.standard_normal((d, 4)) / np.sqrt(d)
        y = rng.integers(0, 4, n).astype(np.float64)
    else:
        w = rng.standard_normal(d) / np.sqrt(d)
        y = (rng.random(n) < 0.5).astype(np.float64)
    mask = (rng.random(n) < 0.7).astype(np.float64) if masked else None
    jg, tg = _loss_pair(name, fused)
    jl, jgr, jn = jg.batch_loss_and_grad(w, jx, y, mask)
    before = (fk.launch_count, fk.softmax_launch_count)
    Xp, yp, mp = tg.prepare(tx, torch.from_numpy(y),
                            None if mask is None else torch.from_numpy(mask))
    tl, tgr, tn = tg.batch_loss_and_grad(torch.from_numpy(w), Xp, yp, mp)
    assert (fk.launch_count, fk.softmax_launch_count) == before
    assert tgr.dtype == torch.float64 and tgr.shape == w.shape
    _close(float(tl), float(jl))
    _close(tgr.numpy(), np.asarray(jgr))
    assert int(tn) == int(jn)


# --- the intercept ----------------------------------------------------------

@pytest.mark.parametrize("twin", [True, False], ids=["twin", "no-twin"])
def test_intercept_matches_jax_through_dense(twin):
    jx, tx, D = _pair(twin)
    ja, ta = jglm._add_intercept(jx), tglm._add_intercept(tx)
    n, d = D.shape
    assert ta.shape == ja.shape == (n, d + 1) and ta.nnz == ja.nnz
    want = np.concatenate([np.ones((n, 1)), D], axis=1)
    np.testing.assert_array_equal(_dense_rows(ja), want)
    np.testing.assert_array_equal(_dense_rows(ta), want)
    # row i's intercept entry opens row i; offsets moved by one a row
    first = ta.indptr[:-1]
    assert (ta.col_ids[first] == 0).all() and (ta.values[first] == 1).all()
    np.testing.assert_array_equal(ta.indptr.numpy(),
                                  tx.indptr.numpy() + np.arange(n + 1))
    if twin:
        # the carried twin is the one with_csc builds from the new entries
        fresh = sparse.CSRMatrix(ta.row_ids, ta.col_ids, ta.values,
                                 ta.shape, rows_sorted=True).with_csc()
        for name in ("csc_row_ids", "csc_col_ids", "csc_values", "colptr"):
            assert torch.equal(getattr(ta, name), getattr(fresh, name)), name
    v = np.random.default_rng(10).standard_normal(n)
    _close(ta.rmatvec(torch.from_numpy(v)).numpy(), np.asarray(
        ja.rmatvec(v)))


def _dense_rows(X):
    """Dense array of a CSRMatrix of either package (entries in any
    order)."""
    D = np.zeros(X.shape)
    rid, cid, val = (np.asarray(X.row_ids), np.asarray(X.col_ids),
                     np.asarray(X.values))
    np.add.at(D, (rid, cid), val)
    return D


def test_intercept_keeps_the_lazy_marker():
    _, tx, _ = _pair(False, "from_csr_arrays")
    ta = tglm._add_intercept(tx.with_csc(lazy=True))
    assert ta.want_csc and not ta.has_csc


def test_models_predict_on_csr():
    jx, tx, D = _pair(True)
    rng = np.random.default_rng(11)
    w = rng.standard_normal(D.shape[1])
    tm = tglm.LogisticRegressionModel(torch.from_numpy(w), 0.25)
    jm = jglm.LogisticRegressionModel(w, 0.25)
    _close(tm.margin(tx).numpy(), np.asarray(jm.margin(jx)))
    np.testing.assert_array_equal(tm.predict(tx).numpy(),
                                  np.asarray(jm.predict(jx)))
    W = rng.standard_normal((D.shape[1], 3))
    sm = tglm.SoftmaxRegressionModel(torch.from_numpy(W))
    _close(sm.logits(tx).numpy(), D @ W)


# --- trainers and run at f64 ------------------------------------------------

N_TR, D_TR, NNZ_TR = 3_000, 2_000, 12


def _rcv1_like(varied):
    """A rcv1-like CSR made by the JAX generators on the CPU, f64
    values, carried across."""
    key = jax.random.PRNGKey(4)
    if varied:
        parts = jsynth.planted_sparse_parts_varied(key, N_TR, D_TR, NNZ_TR)
    else:
        parts = jsynth.planted_sparse_parts(key, N_TR, D_TR, NNZ_TR)
    rid, cid, val, y = (np.asarray(p) for p in parts)
    val = val.astype(np.float64)
    jx = jsparse.CSRMatrix(rid, cid, val, (N_TR, D_TR), rows_sorted=True)
    tx = convert.csr_from_numpy(rid, cid, val, (N_TR, D_TR), device="cpu")
    return jx, tx, y.astype(np.float64)


TRAINERS = {
    "logistic_l2": (jglm.LogisticRegressionWithAGD,
                    tglm.LogisticRegressionWithAGD, 1e-3),
    "svm_l1": (jglm.SVMWithAGD, tglm.SVMWithAGD, 1e-3),
}


@pytest.mark.parametrize("varied", [False, True],
                         ids=["constant-counts", "varied-counts"])
@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_on_csr_matches_jax_at_f64(name, varied):
    jx, tx, y = _rcv1_like(varied)
    jcls, tcls, reg = TRAINERS[name]
    j, t = jcls(reg_param=reg, mesh=False), tcls(reg_param=reg)
    j.optimizer.setNumIterations(25)
    t.optimizer.setNumIterations(25).set_device("cpu")
    w0 = np.zeros(D_TR + 1)
    jm = j.train(jx, y, initial_weights=w0)
    tm = t.train(tx, y, initial_weights=w0)
    np.testing.assert_allclose(tm.weights.numpy(), np.asarray(jm.weights),
                               rtol=3e-7, atol=1e-12)
    assert tm.intercept == pytest.approx(float(jm.intercept), rel=3e-7,
                                         abs=1e-12)
    # the fit the trainer ran, through run on the intercept CSR
    opt = t.optimizer
    jw, jh, jr = jpkg.run(
        (jglm._add_intercept(jx), y), j.optimizer._gradient,
        j.optimizer._updater, reg_param=reg, num_iterations=25,
        initial_weights=w0, mesh=False, return_result=True)
    tw, th, tr = port.run(
        (tglm._add_intercept(tx), y), opt._gradient, opt._updater,
        reg_param=reg, num_iterations=25, initial_weights=w0,
        device="cpu", return_result=True)
    assert int(tr.num_iters) == int(jr.num_iters)
    assert int(tr.num_backtracks) == int(jr.num_backtracks)
    assert int(tr.num_restarts) == int(jr.num_restarts)
    np.testing.assert_allclose(th, jh, rtol=1e-9)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=3e-7,
                               atol=1e-12)
    assert torch.equal(tw[1:], tm.weights)
    if name == "svm_l1":
        assert int((tw == 0).sum()) == int((np.asarray(jw) == 0).sum())


def test_fused_gradient_fit_on_csr_matches_plain():
    """``FusedLogisticGradient`` on CSR takes the sparse products: the
    same fit, bit for bit, as ``LogisticGradient``, and no launch."""
    _, tx, y = _rcv1_like(False)
    Xa = tglm._add_intercept(tx)
    w0 = np.zeros(D_TR + 1)
    before = fk.launch_count
    wf, hf = port.run((Xa, y), port.FusedLogisticGradient(), port.L2Prox(),
                      reg_param=1e-3, num_iterations=10, initial_weights=w0,
                      device="cpu")
    wp, hp = port.run((Xa, y), port.LogisticGradient(), port.L2Prox(),
                      reg_param=1e-3, num_iterations=10, initial_weights=w0,
                      device="cpu")
    assert fk.launch_count == before
    assert torch.equal(wf, wp) and np.array_equal(hf, hp)


# --- the sparse generators --------------------------------------------------

def test_planted_sparse_parts_shape_order_labels():
    rid, cid, val, y = device_synth.planted_sparse_parts(
        5_000, 1_000, 7, seed=3, device="cpu")
    assert rid.dtype == cid.dtype == torch.int32
    assert val.dtype == y.dtype == torch.float32
    assert rid.shape == cid.shape == val.shape == (35_000,)
    np.testing.assert_array_equal(rid.numpy(), np.repeat(np.arange(5_000), 7))
    assert int(cid.min()) >= 0 and int(cid.max()) < 1_000
    assert set(np.unique(y.numpy())) == {0.0, 1.0}
    assert 0.4 < float(y.mean()) < 0.6
    assert abs(float(val.mean())) < 0.03 and 0.95 < float(val.std()) < 1.05
    again = device_synth.planted_sparse_parts(5_000, 1_000, 7, seed=3,
                                              device="cpu")
    assert all(torch.equal(a, b) for a, b in zip((rid, cid, val, y), again))
    # the labels follow the planted model: a logistic fit beats chance
    X = sparse.CSRMatrix(rid, cid, val, (5_000, 1_000), rows_sorted=True)
    model = tglm.LogisticRegressionWithAGD(reg_param=1e-3)
    model.optimizer.setNumIterations(30).set_device("cpu")
    acc = float((model.train(X, y).predict(X) == y).float().mean())
    assert acc > 0.7


def test_planted_sparse_parts_varied_counts_and_padding():
    n, mean = 20_000, 12
    rid, cid, val, y = device_synth.planted_sparse_parts_varied(
        n, 3_000, mean, seed=5, device="cpu")
    width = 3 * mean
    assert val.shape == (n * width,)
    np.testing.assert_array_equal(rid.numpy(),
                                  np.repeat(np.arange(n), width))
    live = (val != 0).view(n, width)
    counts = live.sum(dim=1)
    # entries past a row's count are value-0 padding at its end
    assert bool((live == (torch.arange(width)[None, :]
                          < counts[:, None])).all())
    assert int(counts.min()) >= 1 and int(counts.max()) <= width
    assert abs(float(counts.float().mean()) - mean) < 0.5
    assert float(counts.float().std()) > 3.0  # long-tailed, not constant
    assert set(np.unique(y.numpy())) == {0.0, 1.0}
