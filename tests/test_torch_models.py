"""The port's model layer (``models/glm.py``, ``models/evaluation.py``)
against the JAX package, on the CPU.

Each trainer runs with ``.optimizer.set_device("cpu")`` beside its JAX
twin (``mesh=False``) on the same numpy data: at f64 the weights agree
within 3e-7 and the runs take the same iterations (the oracle tolerances
of ``tests/test_agd_core.py``); the fused softmax trainer is held to the
JAX trainer with ``PallasSoftmaxGradient(interpret=True)`` at f32, loss
history rtol 1e-4 (``tests/test_pallas.py``).  Models saved by either
package load in the other; the metrics match the JAX ones."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_agd_tpu as jpkg
from spark_agd_tpu.models import evaluation as jeval, glm as jglm
from spark_agd_tpu.ops.pallas_kernels import PallasSoftmaxGradient
from spark_agd_tpu.utils.checkpoint import read_npz_entries
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch import convert
from spark_agd_tpu_torch.models import evaluation as teval, glm as tglm
from spark_agd_tpu_torch.ops import fused_kernels as fk

N, D, K = 160, 6, 4


def _binary(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    w = rng.standard_normal(d)
    y = (rng.random(n) < 1 / (1 + np.exp(-2 * X @ w - 0.5))).astype(float)
    return X, y


def _regression(seed=1, n=N, d=D):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = X @ rng.standard_normal(d) + 0.3 + 0.1 * rng.standard_normal(n)
    return X, y


def _multiclass(seed=2, n=N, d=D, k=K):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    W = rng.standard_normal((d, k))
    y = np.argmax(X @ W + rng.gumbel(size=(n, k)), axis=1)
    return X, y


# name -> (JAX trainer, port trainer, data, constructor kwargs)
TRAINERS = {
    "logistic": (jglm.LogisticRegressionWithAGD,
                 tglm.LogisticRegressionWithAGD, _binary,
                 dict(reg_param=0.05)),
    "linear": (jglm.LinearRegressionWithAGD, tglm.LinearRegressionWithAGD,
               _regression, dict(reg_param=0.01)),
    "svm": (jglm.SVMWithAGD, tglm.SVMWithAGD, _binary,
            dict(reg_param=0.01)),
    "softmax": (jglm.SoftmaxRegressionWithAGD,
                tglm.SoftmaxRegressionWithAGD, _multiclass,
                dict(num_classes=K, reg_param=0.01)),
}


def _pair(name, add_intercept, iters=15):
    jcls, tcls, data, kw = TRAINERS[name]
    j = jcls(add_intercept=add_intercept, mesh=False, **kw)
    t = tcls(add_intercept=add_intercept, mesh=False, **kw)
    j.optimizer.setNumIterations(iters)
    t.optimizer.setNumIterations(iters).set_device("cpu")
    return j, t, data()


def _w0(name, X, add_intercept, dtype=np.float64):
    d = X.shape[1] + int(add_intercept)
    return np.zeros((d, K) if name == "softmax" else d, dtype)


@pytest.mark.parametrize("add_intercept", [True, False],
                         ids=["intercept", "no-intercept"])
@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_matches_jax_at_f64(name, add_intercept):
    j, t, (X, y) = _pair(name, add_intercept)
    w0 = _w0(name, X, add_intercept)
    jm = j.train(X, y, initial_weights=w0)
    tm = t.train(X, y, initial_weights=w0)
    assert type(tm).__name__ == type(jm).__name__
    assert tm.weights.dtype == torch.float64
    assert tm.weights.device.type == "cpu"
    np.testing.assert_allclose(tm.weights.numpy(), np.asarray(jm.weights),
                               rtol=3e-7, atol=1e-12)
    np.testing.assert_allclose(np.asarray(tm.intercept, dtype=float),
                               np.asarray(jm.intercept, dtype=float),
                               rtol=3e-7, atol=1e-12)
    # the same iterations: the fits the trainers ran, through run
    Xa = (np.array(jglm._add_intercept(X)) if add_intercept else X)
    np.testing.assert_array_equal(tglm._add_intercept(X).numpy()
                                  if add_intercept else X, Xa)
    opt = t.optimizer
    _, jh = jpkg.run((Xa, y), j.optimizer._gradient, j.optimizer._updater,
                     reg_param=opt._reg_param, num_iterations=15,
                     initial_weights=w0, mesh=False)
    _, th = port.run((Xa, y), opt._gradient, opt._updater,
                     reg_param=opt._reg_param, num_iterations=15,
                     initial_weights=w0, device="cpu")
    assert len(th) == len(jh)
    np.testing.assert_allclose(th, jh, rtol=1e-9)


def test_fused_softmax_trainer_matches_jax_pallas_trainer_at_f32():
    X, y = _multiclass(seed=3, n=256, d=12)
    X = X.astype(np.float32)
    j = jglm.SoftmaxRegressionWithAGD(K, reg_param=1e-3, mesh=False)
    j.optimizer.setGradient(PallasSoftmaxGradient(
        jpkg.SoftmaxGradient(K), interpret=True)).setNumIterations(8)
    t = tglm.SoftmaxRegressionWithAGD(K, reg_param=1e-3, mesh=False)
    t.optimizer.setGradient(fk.FusedSoftmaxGradient(
        port.SoftmaxGradient(K))).setNumIterations(8).set_device("cpu")
    jm, tm = j.train(X, y), t.train(X, y)
    assert tm.weights.dtype == torch.float32
    np.testing.assert_allclose(tm.weights.numpy(), np.asarray(jm.weights),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(tm.intercept.numpy(),
                               np.asarray(jm.intercept), rtol=1e-3,
                               atol=1e-5)
    Xa = tglm._add_intercept(X).numpy()
    w0 = np.zeros((X.shape[1] + 1, K), np.float32)
    _, jh = jpkg.run((Xa, y), PallasSoftmaxGradient(
        jpkg.SoftmaxGradient(K), interpret=True), jpkg.L2Prox(),
        reg_param=1e-3, num_iterations=8, initial_weights=w0, mesh=False)
    _, th = port.run((Xa, y), fk.FusedSoftmaxGradient(
        port.SoftmaxGradient(K)), port.L2Prox(), reg_param=1e-3,
        num_iterations=8, initial_weights=w0, device="cpu")
    assert len(th) == len(jh)
    np.testing.assert_allclose(th, jh, rtol=1e-4)
    assert th[-1] < th[0]


def test_softmax_weights_carried_from_jax_give_the_same_loss_and_grad():
    X, y = _multiclass(seed=4)
    X = X.astype(np.float32)
    jm = jglm.SoftmaxRegressionWithAGD(K, add_intercept=False, mesh=False)
    jm.optimizer.setNumIterations(10)
    W = jm.train(X, y).weights
    Wt = convert.weights_from_numpy(np.asarray(W), "cpu")
    assert Wt.shape == (D, K)
    np.testing.assert_array_equal(convert.weights_to_numpy(Wt),
                                  np.asarray(W))
    j_loss, j_grad, _ = jpkg.SoftmaxGradient(K).batch_loss_and_grad(
        W, jnp.asarray(X), jnp.asarray(y))
    g = fk.FusedSoftmaxGradient(port.SoftmaxGradient(K))
    staged, _, _ = g.prepare(torch.from_numpy(X), torch.from_numpy(y))
    t_loss, t_grad, _ = g.batch_loss_and_grad(Wt, staged, None)
    assert float(t_loss) == pytest.approx(float(j_loss), rel=1e-5)
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad),
                               rtol=1e-4, atol=1e-5)


def _model_pair(cls_name, seed=5):
    rng = np.random.default_rng(seed)
    if cls_name == "SoftmaxRegressionModel":
        W, b = rng.standard_normal((D, K)), rng.standard_normal(K)
        return (jglm.SoftmaxRegressionModel(W, b),
                tglm.SoftmaxRegressionModel(torch.from_numpy(W),
                                            torch.from_numpy(b)))
    w, b = rng.standard_normal(D), float(rng.standard_normal())
    return (getattr(jglm, cls_name)(w, b),
            getattr(tglm, cls_name)(torch.from_numpy(w), b))


CLASSES = ["LogisticRegressionModel", "SVMModel", "LinearRegressionModel",
           "SoftmaxRegressionModel"]


@pytest.mark.parametrize("cls_name", CLASSES)
def test_predictions_match_jax(cls_name):
    jm, tm = _model_pair(cls_name)
    X = np.random.default_rng(6).standard_normal((30, D))
    np.testing.assert_allclose(tm.predict(X).numpy(),
                               np.asarray(jm.predict(X)), rtol=1e-12)
    if hasattr(jm, "predict_proba"):
        np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                                   np.asarray(jm.predict_proba(X)),
                                   rtol=1e-12, atol=1e-15)
    if hasattr(jm, "clear_threshold"):
        jm.threshold = tm.threshold = 0.3
        np.testing.assert_array_equal(tm.predict(X).numpy(),
                                      np.asarray(jm.predict(X)))
        assert tm.clear_threshold() is tm and tm.threshold is None
        jm.clear_threshold()
        np.testing.assert_allclose(tm.predict(X).numpy(),
                                   np.asarray(jm.predict(X)), rtol=1e-12)
    if hasattr(jm, "predict_stream"):
        batches = [(X[:10], None, None), (X[10:], None, np.ones(20))]
        streamed = np.concatenate(list(tm.predict_stream(batches)))
        np.testing.assert_allclose(streamed, tm.predict(X).numpy())


@pytest.mark.parametrize("cls_name", CLASSES)
def test_models_saved_by_either_package_load_in_the_other(cls_name, tmp_path):
    jm, tm = _model_pair(cls_name)
    if cls_name == "SVMModel":
        jm.clear_threshold()
        tm.clear_threshold()
    X = np.random.default_rng(7).standard_normal((12, D))
    # port -> JAX
    tm.save(str(tmp_path / "t.npz"))
    entries = read_npz_entries(str(tmp_path / "t.npz"))  # verifies CRCs
    assert set(entries) == {"class", "weights", "intercept", "threshold"}
    back = jglm.load_model(str(tmp_path / "t.npz"))
    assert type(back).__name__ == cls_name
    np.testing.assert_allclose(np.asarray(back.predict(X)),
                               tm.predict(X).numpy(), rtol=1e-12)
    # JAX -> port
    jm.save(str(tmp_path / "j.npz"))
    loaded = tglm.load_model(str(tmp_path / "j.npz"), device="cpu")
    assert type(loaded).__name__ == cls_name
    assert getattr(loaded, "threshold", None) == getattr(jm, "threshold",
                                                         None)
    np.testing.assert_array_equal(loaded.weights.numpy(),
                                  np.asarray(jm.weights))
    np.testing.assert_allclose(loaded.predict(X).numpy(),
                               np.asarray(jm.predict(X)), rtol=1e-12)


def test_load_model_rejects_unknown_classes(tmp_path):
    from spark_agd_tpu_torch.utils.checkpoint import atomic_savez

    atomic_savez(str(tmp_path / "m.npz"), {"class": np.asarray("Nope"),
                                           "weights": np.zeros(2)})
    with pytest.raises(ValueError, match="unknown model class"):
        tglm.load_model(str(tmp_path / "m.npz"), device="cpu")


def _scores(seed=8, n=200):
    rng = np.random.default_rng(seed)
    # rounded scores: many ties
    s = np.round(rng.standard_normal(n), 1).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-2 * s))).astype(np.float32)
    m = (rng.random(n) < 0.8).astype(np.float32)
    return s, y, m


def _close(t, j, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=1e-7)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_binary_metrics_and_auc_with_ties_match_jax(masked):
    s, y, m = _scores()
    mask = m if masked else None
    _close(teval.roc_auc(s, y, mask), jeval.roc_auc(s, y, mask))
    p = 1 / (1 + np.exp(-s))
    _close(teval.log_loss(p, y, mask), jeval.log_loss(p, y, mask))
    tb = teval.binary_metrics(s, y, mask, threshold=0.0)
    jb = jeval.binary_metrics(s, y, mask, threshold=0.0)
    assert set(tb) == set(jb)
    for key in jb:
        _close(tb[key], jb[key])


def test_auc_edge_cases_match_jax():
    s = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
    y = np.array([1, 0, 1, 0], np.float32)
    _close(teval.roc_auc(s, y), jeval.roc_auc(s, y))  # all tied: 0.5
    assert np.isnan(float(teval.roc_auc(s, np.ones(4))))  # one class
    # a masked row's -inf sink stays below a valid -inf score
    s2 = np.array([-np.inf, 1.0, 0.0, 2.0], np.float32)
    y2 = np.array([0, 1, 0, 1], np.float32)
    m2 = np.array([1, 1, 1, 0], np.float32)
    _close(teval.roc_auc(s2, y2, m2), jeval.roc_auc(s2, y2, m2))


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_regression_and_multiclass_metrics_match_jax(masked):
    rng = np.random.default_rng(9)
    n = 150
    mask = (rng.random(n) < 0.7).astype(np.float32) if masked else None
    pred, targ = rng.standard_normal(n), rng.standard_normal(n) + 0.2
    tr = teval.regression_metrics(pred, targ, mask)
    jr = jeval.regression_metrics(pred, targ, mask)
    for key in jr:
        _close(tr[key], jr[key], rtol=1e-5)
    p, y = rng.integers(0, K, n), rng.integers(0, K, n)
    tc = teval.confusion_matrix(p, y, K, mask)
    np.testing.assert_array_equal(tc.numpy(),
                                  np.asarray(jeval.confusion_matrix(
                                      p, y, K, mask)))
    tm = teval.multiclass_metrics(p, y, K, mask)
    jm = jeval.multiclass_metrics(p, y, K, mask)
    assert set(tm) == set(jm)
    for key in jm:
        _close(tm[key], jm[key])


def test_later_slice_methods_raise():
    X, y = _binary()
    t = tglm.LogisticRegressionWithAGD()
    t.optimizer.set_device("cpu").set_num_iterations(3)
    # the AGD seat's lanes are ported: the path and CV run
    models, res = t.train_path(X, y, [0.1, 0.01])
    assert len(models) == 2 and res.loss_history.shape == (2, 3)
    model, cv = t.cross_validate(X, y, [0.1, 0.01], n_folds=2)
    assert model is not None and cv.val_loss.shape == (2, 2)
    # and so are the LBFGS seats' paths (the L-BFGS lanes)
    for lbfgs_trainer in (tglm.LogisticRegressionWithLBFGS(),
                          tglm.SoftmaxRegressionWithLBFGS(3)):
        lbfgs_trainer.optimizer.set_device("cpu").set_num_iterations(3)
        models, res = lbfgs_trainer.train_path(X, y, [0.1, 0.01])
        assert len(models) == 2 and res.loss_history.shape == (2, 4)
    with pytest.raises(NotImplementedError, match="mesh"):
        tglm.SVMWithAGD(mesh="data")


def test_sparse_input_raises():
    """A JAX CSRMatrix or a torch sparse layout raises, naming the port's
    CSRMatrix, which is accepted."""
    from spark_agd_tpu.ops.sparse import CSRMatrix

    csr = CSRMatrix.from_csr_arrays(np.arange(4), np.arange(3), np.ones(3),
                                   n_features=3)
    with pytest.raises(TypeError, match="CSRMatrix"):
        tglm._add_intercept(csr)
    with pytest.raises(TypeError, match="CSRMatrix"):
        tglm._add_intercept(torch.eye(3).to_sparse())
    tcsr = convert.csr_from_numpy(np.asarray(csr.row_ids),
                                  np.asarray(csr.col_ids),
                                  np.asarray(csr.values), csr.shape,
                                  device="cpu")
    Xi = tglm._add_intercept(tcsr)
    assert Xi.shape == (3, 4) and Xi.nnz == 6
    np.testing.assert_array_equal(Xi.col_ids.numpy(), [0, 1, 0, 2, 0, 3])


def test_trainers_and_load_model_need_cuda_unless_told_cpu(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _multiclass()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tglm.SoftmaxRegressionWithAGD(K).train(X, y)
    _, tm = _model_pair("SoftmaxRegressionModel")
    tm.save(str(tmp_path / "m.npz"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tglm.load_model(str(tmp_path / "m.npz"))
    assert tglm.load_model(str(tmp_path / "m.npz"),
                           device="cpu").num_classes == K
