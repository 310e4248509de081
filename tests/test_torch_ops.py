"""Parity of the PyTorch port's losses, prox operators and vector algebra
with the JAX package on the same numpy inputs (CPU, small shapes).

f64 runs hold the JAX package's own x64 numerics (rtol 1e-12); f32 runs
the f32 kernel tolerance of ``tests/test_pallas.py`` (rtol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu.core import tvec as jtvec
from spark_agd_tpu.ops import losses as jlosses, prox as jprox
from spark_agd_tpu_torch.core import tvec
from spark_agd_tpu_torch.ops import losses, prox
from spark_agd_tpu_torch.ops.sparse import CSRMatrix

RTOL = {np.float64: 1e-12, np.float32: 1e-5}
# a gradient component near zero is a difference of large sums: its
# error scales with the gradient's size, not its own
GRAD_ATOL = {np.float64: 1e-12, np.float32: 1e-6}
TDTYPE = {np.float64: torch.float64, np.float32: torch.float32}


def _problem(seed, n=96, d=11, dtype=np.float64, k=None):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(dtype)
    if k is None:
        w = (rng.standard_normal(d) / np.sqrt(d)).astype(dtype)
        y = (rng.random(n) < 0.5).astype(dtype)
    else:
        w = (rng.standard_normal((d, k)) / np.sqrt(d)).astype(dtype)
        y = rng.integers(0, k, n).astype(dtype)
    mask = (rng.random(n) < 0.7).astype(dtype)
    return X, y, w, mask


def _pair(name):
    if name == "softmax":
        return jlosses.SoftmaxGradient(4), losses.SoftmaxGradient(4)
    return jlosses.GRADIENTS[name](), losses.GRADIENTS[name]()


def _close(actual, expected, rtol, atol_scale=0.0):
    expected = np.asarray(expected)
    atol = atol_scale * float(np.max(np.abs(expected))) if expected.size \
        else 0.0
    np.testing.assert_allclose(np.asarray(actual), expected, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("name", ["logistic", "least_squares", "hinge",
                                  "softmax"])
def test_gradient_matches_jax(name, masked, dtype):
    X, y, w, mask = _problem(7, dtype=dtype,
                             k=4 if name == "softmax" else None)
    jg, tg = _pair(name)
    m = mask if masked else None
    jl, jgr, jn = jg.batch_loss_and_grad(
        jnp.asarray(w), jnp.asarray(X), jnp.asarray(y),
        None if m is None else jnp.asarray(m))
    tl, tgr, tn = tg.batch_loss_and_grad(
        torch.from_numpy(w), torch.from_numpy(X), torch.from_numpy(y),
        None if m is None else torch.from_numpy(m))
    assert tl.dtype == TDTYPE[dtype] and tgr.dtype == TDTYPE[dtype]
    assert int(tn) == int(jn)
    _close(tl, jl, RTOL[dtype])
    _close(tgr, jgr, RTOL[dtype], GRAD_ATOL[dtype])
    jml, jmg = jg.mean_loss_and_grad(jnp.asarray(w), jnp.asarray(X),
                                     jnp.asarray(y))
    tml, tmg = tg.mean_loss_and_grad(torch.from_numpy(w),
                                     torch.from_numpy(X),
                                     torch.from_numpy(y))
    _close(tml, jml, RTOL[dtype])
    _close(tmg, jmg, RTOL[dtype], GRAD_ATOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_logistic_large_margins(dtype):
    """Margins beyond ±30: ``torch.nn.functional.softplus`` would switch
    to ``x`` above 20 and miss ``jax.nn.softplus`` by about exp(-20)."""
    rng = np.random.default_rng(3)
    n, d = 64, 5
    X = rng.standard_normal((n, d)).astype(dtype)
    w = (40.0 * rng.standard_normal(d)).astype(dtype)
    y = (rng.random(n) < 0.5).astype(dtype)
    dots = X @ w
    assert np.sum(np.abs(dots) > 30) > n // 2
    jl, jgr, _ = jlosses.LogisticGradient().batch_loss_and_grad(
        jnp.asarray(w), jnp.asarray(X), jnp.asarray(y))
    tl, tgr, _ = losses.LogisticGradient().batch_loss_and_grad(
        torch.from_numpy(w), torch.from_numpy(X), torch.from_numpy(y))
    _close(tl, jl, RTOL[dtype])
    _close(tgr, jgr, RTOL[dtype], GRAD_ATOL[dtype])
    jper, jmult = jlosses.LogisticGradient().dots_loss_and_mult(
        jnp.asarray(dots), jnp.asarray(y))
    tper, tmult = losses.LogisticGradient().dots_loss_and_mult(
        torch.from_numpy(dots), torch.from_numpy(y))
    # XLA on the CPU flushes f32 subnormals to zero, torch keeps them
    _close(tper, jper, RTOL[dtype], GRAD_ATOL[dtype])
    _close(tmult, jmult, RTOL[dtype], GRAD_ATOL[dtype])


def _mlp_jax(params, X, y, mask=None):
    h = jnp.tanh(X @ params["w1"])
    logits = h @ params["w2"]
    per = jax.nn.softplus(-logits) + (1.0 - y) * logits
    return jnp.sum(per if mask is None else per * mask)


def _mlp_torch(params, X, y, mask=None):
    h = torch.tanh(X @ params["w1"])
    logits = h @ params["w2"]
    per = torch.logaddexp(-logits, torch.zeros_like(logits)) \
        + (1.0 - y) * logits
    return torch.sum(per if mask is None else per * mask)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_custom_gradient_matches_value_and_grad(masked):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((40, 6))
    y = (rng.random(40) < 0.5).astype(np.float64)
    mask = (rng.random(40) < 0.6).astype(np.float64)
    params = {"w1": rng.standard_normal((6, 4)) / 3,
              "w2": rng.standard_normal(4) / 2}
    jg = jlosses.CustomGradient(_mlp_jax, supports_mask=True)
    tg = losses.CustomGradient(_mlp_torch, supports_mask=True)
    m = mask if masked else None
    jl, jgr, jn = jg.batch_loss_and_grad(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(X),
        jnp.asarray(y), None if m is None else jnp.asarray(m))
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tl, tgr, tn = tg.batch_loss_and_grad(
        tparams, torch.from_numpy(X), torch.from_numpy(y),
        None if m is None else torch.from_numpy(m))
    assert int(tn) == int(jn)
    _close(tl, jl, 1e-12)
    assert set(tgr) == set(params)
    for k in params:
        _close(tgr[k], jgr[k], 1e-12)
    # the caller's weights are left alone (no grad attached)
    assert not any(t.requires_grad for t in tparams.values())


def test_custom_gradient_rejects_unsupported_mask():
    g = losses.CustomGradient(lambda w, X, y: torch.sum(X @ w))
    with pytest.raises(ValueError, match="supports_mask"):
        g.batch_loss_and_grad(torch.zeros(3), torch.ones(2, 3),
                              torch.ones(2), torch.ones(2))


def test_sparse_input_names_the_later_slice():
    """torch's own sparse layouts still raise, naming CSRMatrix; a
    CSRMatrix is accepted (its products: tests/test_torch_sparse.py)."""
    Xs = torch.eye(4).to_sparse()
    for g in (losses.LogisticGradient(), losses.SoftmaxGradient(3)):
        with pytest.raises(TypeError, match="CSRMatrix"):
            g.batch_loss_and_grad(torch.zeros(4), Xs, torch.zeros(4))
    with pytest.raises(TypeError, match="CSRMatrix"):
        losses.LogisticGradient().prepare(Xs, torch.zeros(4))
    csr = CSRMatrix.from_csr_arrays([0, 1, 2, 3, 4], [0, 1, 2, 3],
                                    np.ones(4), 4, device="cpu")
    Xp, _, _ = losses.LogisticGradient().prepare(csr, torch.zeros(4))
    assert isinstance(Xp, CSRMatrix) and Xp.has_csc
    for g, w in ((losses.LogisticGradient(), torch.zeros(4,
                                                         dtype=torch.float64)),
                 (losses.SoftmaxGradient(3), torch.zeros((4, 3),
                                                         dtype=torch.float64))):
        loss, grad, n = g.batch_loss_and_grad(w, Xp, torch.zeros(4))
        assert grad.shape == w.shape and int(n) == 4
        assert torch.isfinite(loss)


def test_registries_match():
    assert set(losses.GRADIENTS) == set(jlosses.GRADIENTS)
    assert set(prox.PROXES) == set(jprox.PROXES)
    assert prox.SquaredL2Updater is prox.MLlibSquaredL2Updater
    assert prox.SimpleUpdater is prox.IdentityProx
    assert prox.L1Updater is prox.L1Prox


PROX_CASES = [
    ("identity", lambda m: m.IdentityProx(), 0.0),
    ("l2", lambda m: m.L2Prox(), 0.3),
    ("l2_mllib", lambda m: m.MLlibSquaredL2Updater(), 0.3),
    ("l1", lambda m: m.L1Prox(), 0.05),
    ("elastic_net", lambda m: m.ElasticNetProx(0.3), 0.2),
]


def _tree(rng):
    return {"a": rng.standard_normal(7), "b": rng.standard_normal((2, 3))}


def _to_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _to_torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("name,make,reg", PROX_CASES,
                         ids=[c[0] for c in PROX_CASES])
def test_prox_matches_jax(name, make, reg):
    rng = np.random.default_rng(11)
    w, g = _tree(rng), _tree(rng)
    jp, tp = make(jprox), make(prox)
    for step in (0.0, 0.37, 2.5):
        jw, jr = jp.prox(_to_jax(w), _to_jax(g), step, reg)
        tw, tr = tp.prox(_to_torch(w), _to_torch(g), step, reg)
        _close(tr, jr, 1e-12)
        for k in w:
            _close(tw[k], jw[k], 1e-12)
    _close(tp.reg_value(_to_torch(w), reg), jp.reg_value(_to_jax(w), reg),
           1e-12)


@pytest.mark.parametrize("name,make,reg", PROX_CASES,
                         ids=[c[0] for c in PROX_CASES])
def test_prox_step_zero_identity(name, make, reg):
    """``prox(w, g, 0) == (w, reg_value(w))`` exactly: the loss history
    relies on it."""
    rng = np.random.default_rng(12)
    w, g = _to_torch(_tree(rng)), _to_torch(_tree(rng))
    p = make(prox)
    w_new, rv = p.prox(w, g, 0.0, reg)
    for k in w:
        assert torch.equal(w_new[k], w[k])
    assert torch.equal(rv, p.reg_value(w, reg))


@pytest.mark.parametrize("name,make,reg", PROX_CASES,
                         ids=[c[0] for c in PROX_CASES])
def test_smooth_penalty_and_owlqn_match_jax(name, make, reg):
    rng = np.random.default_rng(13)
    w = rng.standard_normal(9)
    jp, tp = make(jprox), make(prox)
    js = jp.smooth_penalty(jnp.asarray(w), reg)
    ts = tp.smooth_penalty(torch.from_numpy(w), reg)
    assert (js is None) == (ts is None)
    if js is not None:
        _close(ts[0], js[0], 1e-12)
        _close(ts[1], js[1], 1e-12)
    jd, td = jp.owlqn_decomposition(reg), tp.owlqn_decomposition(reg)
    assert (jd is None) == (td is None)
    if jd is not None:
        assert td[0] == pytest.approx(jd[0], rel=1e-15)
        jv, jgr = jd[1](jnp.asarray(w))
        tv, tgr = td[1](torch.from_numpy(w))
        _close(tv, jv, 1e-12)
        _close(tgr, jgr, 1e-12)


def test_tvec_matches_jax_on_trees():
    rng = np.random.default_rng(17)
    a, b = _tree(rng), _tree(rng)
    ja, jb, ta, tb = _to_jax(a), _to_jax(b), _to_torch(a), _to_torch(b)
    _close(tvec.dot(ta, tb), jtvec.dot(ja, jb), 1e-12)
    _close(tvec.norm(ta), jtvec.norm(ja), 1e-12)
    _close(tvec.l1_norm(ta), jtvec.l1_norm(ja), 1e-12)
    assert tvec.size(ta) == jtvec.size(ja)
    for k, v in tvec.axpby(0.3, ta, -1.7, tb).items():
        _close(v, jtvec.axpby(0.3, ja, -1.7, jb)[k], 1e-12)
    assert bool(tvec.isfinite_all(ta))
    ta["a"][0] = float("nan")
    assert not bool(tvec.isfinite_all(ta))
    with pytest.raises(ValueError, match="structures"):
        tvec.add(ta, {"a": ta["a"]})
    assert tvec.dot(torch.ones(3), torch.ones(3)).dim() == 0
