"""The MLP of BASELINE config 5 (``models/mlp.py``) and its generator
(``device_synth.planted_mlp``) against the JAX package, on the CPU.

At f64 the loss sum and the autograd gradient agree with ``jax.grad``
within 1e-12 relative (dense and CSR X, masked and not, for tanh, relu
and gelu, JAX's gelu being its tanh approximation); the trainer takes the
JAX AGD trajectory step for step (the oracle tolerances of
``tests/test_agd_core.py:75-88``); ``init_mlp_params`` draws the same
values; a model saved by either package loads in the other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_agd_tpu as jpkg
from spark_agd_tpu.models import glm as jglm, mlp as jmlp
from spark_agd_tpu.ops import sparse as jsparse
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.parallel import mesh as tmesh
from spark_agd_tpu_torch import convert
from spark_agd_tpu_torch.data import device_synth
from spark_agd_tpu_torch.models import glm as tglm, mlp as tmlp

D, H, K = 12, 5, 3


def _data(seed=0, n=180, sparse=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D))
    if sparse:
        X = X * (rng.random((n, D)) < 0.4)
    return X, rng.integers(0, K, n).astype(np.int32)


def _params(dtype=np.float64, seed=1):
    jp = jmlp.init_mlp_params(D, H, K, seed=seed, dtype=jnp.dtype(dtype))
    tp = tmlp.init_mlp_params(D, H, K, seed=seed,
                              dtype=torch.from_numpy(np.zeros(1, dtype))
                              .dtype, device="cpu")
    return jp, tp


def _csr(X):
    rows, cols = np.nonzero(X)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows,
                                                        minlength=len(X)))])
    jx = jsparse.CSRMatrix.from_csr_arrays(indptr, cols, X[rows, cols],
                                           X.shape[1])
    tx = convert.csr_from_numpy(np.asarray(jx.row_ids),
                                np.asarray(jx.col_ids),
                                np.asarray(jx.values), jx.shape,
                                device="cpu")
    return jx, tx


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_init_draws_the_jax_values(dtype):
    jp, tp = _params(dtype, seed=7)
    assert set(tp) == set(jp)
    for k in jp:
        assert tp[k].dtype == torch.from_numpy(np.array(jp[k])).dtype
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


@pytest.mark.parametrize("layout", ["dense", "csr"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("act", ["tanh", "relu", "gelu"])
def test_loss_and_gradient_match_jax_grad(act, masked, layout):
    X, y = _data(sparse=layout == "csr")
    mask = (np.arange(len(y)) % 3 != 0).astype(np.float64) if masked \
        else None
    jX, tX = (jnp.asarray(X), torch.tensor(X)) if layout == "dense" \
        else _csr(X)
    jp, tp = _params()
    jl, jg, jn = jmlp.mlp_gradient(act).batch_loss_and_grad(
        jp, jX, jnp.asarray(y), None if mask is None else jnp.asarray(mask))
    tl, tg, tn = tmlp.mlp_gradient(act).batch_loss_and_grad(
        tp, tX, torch.tensor(y), None if mask is None else torch.tensor(mask))
    assert int(tn) == int(jn)
    assert float(tl) == pytest.approx(float(jl), rel=1e-12)
    for k in jg:
        g = np.asarray(jg[k])
        np.testing.assert_allclose(tg[k].numpy(), g, rtol=1e-12,
                                   atol=1e-12 * np.abs(g).max())


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 41)
    np.testing.assert_allclose(
        tmlp._ACTIVATIONS["gelu"](torch.tensor(x)).numpy(),
        np.asarray(jmlp._ACTIVATIONS["gelu"](jnp.asarray(x))), rtol=1e-13,
        atol=1e-15)


@pytest.mark.parametrize("act", ["tanh", "gelu"])
def test_trainer_matches_jax_step_for_step(act):
    X, y = _data(seed=3)
    jp, tp = _params(seed=0)
    j = jmlp.MLPClassifierWithAGD(H, K, reg_param=1e-3, activation=act)
    j.optimizer.setNumIterations(20).set_mesh(False)
    t = tmlp.MLPClassifierWithAGD(H, K, reg_param=1e-3, activation=act)
    t.optimizer.setNumIterations(20).set_device("cpu")
    jm, tm = j.train(X, y, initial_params=jp), t.train(X, y,
                                                       initial_params=tp)
    for k in jm.params:
        np.testing.assert_allclose(tm.params[k].numpy(),
                                   np.asarray(jm.params[k]), rtol=3e-7,
                                   atol=1e-12)
    # the fit the trainer ran, through run, with its counts
    jw, jh, jr = jpkg.run((X, y), j.optimizer._gradient, jpkg.L2Prox(),
                          reg_param=1e-3, num_iterations=20,
                          initial_weights=jp, mesh=False, return_result=True)
    tw, th, tr = port.run((X, y), t.optimizer._gradient, port.L2Prox(),
                          reg_param=1e-3, num_iterations=20,
                          initial_weights=tp, device="cpu",
                          return_result=True)
    assert int(tr.num_iters) == int(jr.num_iters)
    assert int(tr.num_backtracks) == int(jr.num_backtracks)
    assert int(tr.num_restarts) == int(jr.num_restarts)
    np.testing.assert_allclose(th, jh, rtol=1e-9)
    np.testing.assert_array_equal(tm.predict(torch.tensor(X)).numpy(),
                                  np.asarray(jm.predict(jnp.asarray(X))))
    np.testing.assert_allclose(
        tm.predict_proba(torch.tensor(X)).numpy(),
        np.asarray(jm.predict_proba(jnp.asarray(X))), rtol=1e-6,
        atol=1e-12)


def test_trainer_default_init_and_csr_fit():
    """``train`` without initial params draws this trainer's seed, as
    the JAX trainer does; a CSR X fits like its dense twin."""
    X, y = _data(seed=4, sparse=True)
    t = tmlp.MLPClassifierWithAGD(H, K, seed=2)
    t.optimizer.setNumIterations(5).set_device("cpu")
    m_dense = t.train(X, y)
    j = jmlp.MLPClassifierWithAGD(H, K, seed=2)
    j.optimizer.setNumIterations(5).set_mesh(False)
    jm = j.train(X.astype(np.float32), y)
    for k in jm.params:
        assert m_dense.params[k].dtype == torch.float32
        np.testing.assert_allclose(m_dense.params[k].numpy(),
                                   np.asarray(jm.params[k]), rtol=1e-4,
                                   atol=1e-6)
    _, tx = _csr(X.astype(np.float32))
    m_csr = t.train(tx, y)
    for k in m_dense.params:
        np.testing.assert_allclose(m_csr.params[k].numpy(),
                                   m_dense.params[k].numpy(), rtol=1e-4,
                                   atol=1e-6)
    assert repr(m_csr) == f"MLPModel(d={D}, hidden={H}, k={K})"


@pytest.mark.parametrize("act", ["tanh", "relu", "gelu"])
def test_models_saved_by_either_package_load_in_the_other(act, tmp_path):
    jp, tp = _params(seed=5)
    X = _data(seed=5)[0]
    jm = jmlp.MLPModel(jp, jmlp._ACTIVATIONS[act])
    tm = tmlp.MLPModel(tp, tmlp._ACTIVATIONS[act])
    jm.save(str(tmp_path / "j.npz"))
    tm.save(str(tmp_path / "t.npz"))
    from_j = tglm.load_model(str(tmp_path / "j.npz"), device="cpu")
    from_t = jglm.load_model(str(tmp_path / "t.npz"))
    assert isinstance(from_j, tmlp.MLPModel)
    assert isinstance(from_t, jmlp.MLPModel)
    assert from_j.activation is tmlp._ACTIVATIONS[act]
    for k in jp:
        np.testing.assert_array_equal(from_j.params[k].numpy(),
                                      np.asarray(jp[k]))
        np.testing.assert_array_equal(np.asarray(from_t.params[k]),
                                      tp[k].numpy())
    np.testing.assert_allclose(from_j.logits(torch.tensor(X)).numpy(),
                               np.asarray(jm.logits(jnp.asarray(X))),
                               rtol=1e-12, atol=1e-12)


def test_save_and_load_refuse_unknown_activations(tmp_path):
    _, tp = _params()
    with pytest.raises(ValueError, match="custom activation"):
        tmlp.MLPModel(tp, lambda x: x).save(str(tmp_path / "m.npz"))
    tmlp.MLPModel(tp).save(str(tmp_path / "m.npz"))
    with np.load(tmp_path / "m.npz") as z:
        payload = {k: z[k] for k in z.files}
    payload["activation"] = np.asarray("swish")
    np.savez(tmp_path / "bad.npz", **payload)
    with pytest.raises(ValueError, match="unknown activation"):
        tglm.load_model(str(tmp_path / "bad.npz"), device="cpu")


def test_convert_carries_the_params_dict():
    jp, _ = _params(np.float32, seed=6)
    t = convert.weights_from_numpy(jp, "cpu", dtype=torch.float64)
    assert set(t) == set(jp)
    assert all(v.dtype == torch.float64 for v in t.values())
    back = convert.weights_to_numpy(t)
    for k in jp:
        np.testing.assert_array_equal(back[k].astype(np.float32),
                                      np.asarray(jp[k]))
    # a model fitted in one package continues in the other
    X, y = _data(seed=6)
    jl, _, _ = jmlp.mlp_gradient().batch_loss_and_grad(
        jp, jnp.asarray(X), jnp.asarray(y))
    tl, _, _ = tmlp.mlp_gradient().batch_loss_and_grad(
        convert.weights_from_numpy(jp, "cpu"), torch.tensor(X).float(),
        torch.tensor(y))
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)


def test_planted_mlp_on_cpu(monkeypatch):
    monkeypatch.setattr(device_synth, "_BLOCK_ROWS", 512)  # three blocks
    X, y = device_synth.planted_mlp(1_200, 16, 4, seed=4, device="cpu")
    assert X.shape == (1_200, 16) and X.dtype == torch.float32
    assert y.shape == (1_200,) and y.dtype == torch.int32
    assert set(y.unique().tolist()) == {0, 1}
    X2, y2 = device_synth.planted_mlp(1_200, 16, 4, seed=4, device="cpu")
    assert torch.equal(X, X2) and torch.equal(y, y2)
    X3, _ = device_synth.planted_mlp(1_200, 16, 4, seed=5, device="cpu")
    assert not torch.equal(X, X3)
    # the labels carry the planted signal: a small MLP fits above chance
    t = tmlp.MLPClassifierWithAGD(4, 2)
    t.optimizer.setNumIterations(60).set_device("cpu")
    acc = float((t.train(X, y).predict(X) == y).float().mean())
    assert acc > 0.6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_synth.planted_mlp(8, 3, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmlp.init_mlp_params(3, 2, 2)


def test_mlp_trainer_rejects_a_mesh():
    # a data mesh is taken; a model axis comes with a later slice
    with pytest.raises(NotImplementedError, match="mesh"):
        tmlp.MLPClassifierWithAGD(H, K, mesh=tmesh.make_mesh({"data": 1, "model": 2}, devices=["cpu"] * 2))
