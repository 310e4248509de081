"""The port's AGD loop and ``run`` against the JAX package (CPU, f64).

Same data, same configuration: ``spark_agd_tpu_torch.run(...,
device="cpu")`` must take the JAX ``api.run(..., mesh=False,
return_result=True)`` trajectory step by step — the same iteration,
backtrack and restart counts and stop decision, loss histories within
rtol 1e-9 and weights within rtol 3e-7 / atol 1e-12 (the oracle-parity
tolerances of ``tests/test_agd_core.py``).  ``mesh=False`` because the
test process has 8 virtual CPU devices and ``mesh=None`` would shard."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu import api as japi
from spark_agd_tpu.core import agd as jagd, oracle, smooth as jsmooth
from spark_agd_tpu.ops import losses as jlosses, prox as jprox
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch import convert
from spark_agd_tpu_torch.core import agd, smooth


def make_problem(rng, n=400, d=5, kind="logistic"):
    X = rng.normal(size=(n, d))
    w_true = rng.normal(size=d)
    if kind == "logistic":
        p = 1 / (1 + np.exp(-(X @ w_true)))
        y = (rng.random(n) < p).astype(np.float64)
    else:
        y = X @ w_true + 0.1 * rng.normal(size=n)
    return X, y


def _pair(kind):
    name = "logistic" if kind == "logistic" else "least_squares"
    return jlosses.GRADIENTS[name](), port.GRADIENTS[name]()


def run_both(X, y, kind, jp, tp, reg, w0, cfg: dict):
    jg, tg = _pair(kind)
    jw, jh, jr = japi.run((X, y), jg, jp, reg_param=reg, initial_weights=w0,
                          mesh=False, return_result=True, **cfg)
    tw, th, tr = port.run((X, y), tg, tp, reg_param=reg, initial_weights=w0,
                          device="cpu", return_result=True, **cfg)
    return (jw, jh, jr), (tw, th, tr)


def assert_same_trajectory(j, t, loss_rtol=1e-9, w_rtol=3e-7,
                           diag_rtol=1e-6):
    """``diag_rtol``: the curvature estimate of L divides a dot by a
    tiny ``‖x - y‖²``, which magnifies summation-order rounding."""
    (jw, jh, jr), (tw, th, tr) = j, t
    n = int(jr.num_iters)
    assert int(tr.num_iters) == n == len(th) == len(jh)
    assert int(tr.num_backtracks) == int(jr.num_backtracks)
    assert int(tr.num_restarts) == int(jr.num_restarts)
    assert bool(tr.converged) == bool(jr.converged)
    assert bool(tr.aborted_non_finite) == bool(jr.aborted_non_finite)
    np.testing.assert_allclose(th, jh, rtol=loss_rtol)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=w_rtol,
                               atol=1e-12)
    # the full result has the JAX shapes, NaN-padded past num_iters
    for f in ("loss_history", "diag_l", "diag_theta", "diag_step",
              "diag_restarted"):
        a, b = np.asarray(getattr(jr, f)), getattr(tr, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if a.dtype == np.bool_:
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(
                b, a, rtol=loss_rtol if f == "loss_history" else diag_rtol)
    assert float(tr.final_l) == pytest.approx(float(jr.final_l),
                                              rel=diag_rtol)
    assert bool(tr.final_bts) == bool(jr.final_bts)


CONFIGS = [
    ("default", dict(num_iterations=10, convergence_tol=1e-12)),
    ("no_backtrack", dict(num_iterations=10, beta=1.0,
                          convergence_tol=1e-12)),
    ("no_restart", dict(num_iterations=12, may_restart=False,
                        convergence_tol=1e-12)),
    ("lexact", dict(num_iterations=10, l_exact=50.0, convergence_tol=1e-12)),
    ("loose_tol", dict(num_iterations=1000, convergence_tol=0.1)),
    ("alpha1", dict(num_iterations=8, alpha=1.0, convergence_tol=1e-12)),
]


@pytest.mark.parametrize("name,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
@pytest.mark.parametrize("kind", ["logistic", "least_squares"])
def test_unregularized_matches_jax(name, cfg, kind):
    rng = np.random.default_rng(42)
    X, y = make_problem(rng, kind=kind)
    w0 = rng.normal(size=X.shape[1])
    j, t = run_both(X, y, kind, jprox.IdentityProx(), port.IdentityProx(),
                    0.0, w0, cfg)
    assert_same_trajectory(j, t)


PROXES = [
    ("mllib_l2", lambda m: m.MLlibSquaredL2Updater(), 0.2),
    ("exact_l2", lambda m: m.L2Prox(), 0.2),
    ("l1", lambda m: m.L1Prox(), 0.05),
    ("elastic_net", lambda m: m.ElasticNetProx(0.4), 0.1),
]


@pytest.mark.parametrize("name,make,reg", PROXES, ids=[p[0] for p in PROXES])
def test_regularized_matches_jax(name, make, reg):
    rng = np.random.default_rng(43)
    X, y = make_problem(rng)
    w0 = rng.normal(size=X.shape[1])
    j, t = run_both(X, y, "logistic", make(jprox), make(port), reg, w0,
                    dict(num_iterations=15, convergence_tol=1e-12))
    assert_same_trajectory(j, t)


def test_backtracking_and_restart_paths_match_jax():
    """Tiny L0 forces backtracking (and the estimator switch); the run
    must also restart, or the surface is not covered."""
    rng = np.random.default_rng(44)
    X, y = make_problem(rng, kind="least_squares")
    w0 = rng.normal(size=X.shape[1])
    j, t = run_both(X, y, "least_squares", jprox.IdentityProx(),
                    port.IdentityProx(), 0.0, w0,
                    dict(num_iterations=12, convergence_tol=0.0, l0=1e-3))
    assert int(t[2].num_backtracks) > 0 and int(t[2].num_restarts) > 0
    assert_same_trajectory(j, t)


@pytest.mark.parametrize("loss_mode", ["x", "x_strict", "y"])
@pytest.mark.parametrize("beta", [0.5, 1.0], ids=["bt", "no_bt"])
def test_loss_modes_match_jax(loss_mode, beta):
    rng = np.random.default_rng(45)
    X, y = make_problem(rng)
    w0 = rng.normal(size=X.shape[1])
    j, t = run_both(X, y, "logistic", jprox.MLlibSquaredL2Updater(),
                    port.MLlibSquaredL2Updater(), 0.1, w0,
                    dict(num_iterations=9, convergence_tol=0.0, beta=beta,
                         loss_mode=loss_mode))
    assert_same_trajectory(j, t)


def test_non_finite_loss_aborts_like_jax():
    rng = np.random.default_rng(46)
    X, y = make_problem(rng, kind="least_squares")
    y[3] = np.nan
    w0 = np.zeros(X.shape[1])
    j, t = run_both(X, y, "least_squares", jprox.IdentityProx(),
                    port.IdentityProx(), 0.0, w0, dict(num_iterations=6))
    assert bool(t[2].aborted_non_finite) and int(t[2].num_iters) == 1
    assert not bool(t[2].converged)
    assert int(j[2].num_iters) == 1 and bool(j[2].aborted_non_finite)


def _max_backtracks_run(pkg_agd, pkg_smooth, pkg_losses, pkg_prox, X, y, w0,
                        as_array):
    cfg = pkg_agd.AGDConfig(num_iterations=6, convergence_tol=0.0, l0=1e-4,
                            max_backtracks=2)
    sm = pkg_smooth.make_smooth(pkg_losses.LeastSquaresGradient(),
                                as_array(X), as_array(y))
    px, rv = pkg_smooth.make_prox(pkg_prox.IdentityProx(), 0.0)
    return pkg_agd.run_agd(sm, px, rv, as_array(w0), cfg)


def test_max_backtracks_cap_matches_jax():
    from spark_agd_tpu_torch.ops import losses as tlosses, prox as tprox

    rng = np.random.default_rng(47)
    X, y = make_problem(rng, kind="least_squares")
    w0 = rng.normal(size=X.shape[1])
    jr = jax.jit(lambda w: _max_backtracks_run(
        jagd, jsmooth, jlosses, jprox, X, y, w, jnp.asarray))(w0)
    tr = _max_backtracks_run(agd, smooth, tlosses, tprox, X, y, w0,
                             torch.from_numpy)
    assert int(tr.num_backtracks) == int(jr.num_backtracks) > 0
    n = int(jr.num_iters)
    assert int(tr.num_iters) == n
    np.testing.assert_allclose(tr.loss_history.numpy(),
                               np.asarray(jr.loss_history), rtol=1e-9)
    np.testing.assert_allclose(tr.weights.numpy(), np.asarray(jr.weights),
                               rtol=3e-7, atol=1e-12)


def test_matches_numpy_oracle():
    """Against ``core/oracle.py:run_oracle``, the executable spec."""
    rng = np.random.default_rng(48)
    X, y = make_problem(rng, n=300)
    w0 = rng.normal(size=X.shape[1])

    def np_smooth(w):
        m = -(X @ w)
        loss = np.sum(np.logaddexp(0.0, m) - (1 - y) * m) / len(y)
        p = np.exp(-np.logaddexp(0.0, m))  # 1 / (1 + e^m), no overflow
        return loss, X.T @ (p - y) / len(y)

    p = port.MLlibSquaredL2Updater()

    def np_prox(w, g, step):
        wt, rv = p.prox(torch.from_numpy(w), torch.from_numpy(g), step, 0.2)
        return wt.numpy(), float(rv)

    orc = oracle.run_oracle(np_smooth, np_prox, w0, convergence_tol=1e-12,
                            num_iterations=15, l0=0.01)
    _, hist, res = port.run((X, y), port.LogisticGradient(), p,
                            convergence_tol=1e-12, num_iterations=15,
                            reg_param=0.2, initial_weights=w0, l0=0.01,
                            device="cpu", return_result=True)
    assert len(hist) == len(orc.loss_history)
    np.testing.assert_allclose(hist, orc.loss_history, rtol=1e-9)
    np.testing.assert_allclose(res.weights.numpy(), orc.weights, rtol=3e-7,
                               atol=1e-12)
    assert int(res.num_backtracks) == orc.num_backtracks
    assert int(res.num_restarts) == orc.num_restarts


def _jax_run(X, y, w0, n_iter, warm=None):
    cfg = jagd.AGDConfig(num_iterations=n_iter, convergence_tol=0.0)
    sm = jsmooth.make_smooth(jlosses.LogisticGradient(), jnp.asarray(X),
                             jnp.asarray(y))
    px, rv = jsmooth.make_prox(jprox.MLlibSquaredL2Updater(), 0.1)
    return jagd.run_agd(sm, px, rv, jnp.asarray(w0), cfg, warm=warm)


def _port_run(X, y, w0, n_iter, warm=None):
    cfg = agd.AGDConfig(num_iterations=n_iter, convergence_tol=0.0)
    sm = smooth.make_smooth(port.LogisticGradient(), torch.from_numpy(X),
                            torch.from_numpy(y))
    px, rv = smooth.make_prox(port.MLlibSquaredL2Updater(), 0.1)
    return agd.run_agd(sm, px, rv, torch.from_numpy(w0), cfg, warm=warm)


def _warm_from_jax(res, prior):
    return jagd.AGDWarmState(
        x=np.asarray(res.weights), z=np.asarray(res.final_z),
        theta=np.asarray(res.final_theta), big_l=np.asarray(res.final_l),
        bts=np.asarray(res.final_bts), prior_iters=prior)


def test_jax_warm_state_continues_in_the_port():
    """5 JAX iterations, carried over by ``convert``, then 5 in the port,
    equal 10 JAX iterations."""
    rng = np.random.default_rng(49)
    X, y = make_problem(rng)
    w0 = rng.normal(size=X.shape[1])
    first = _jax_run(X, y, w0, 5)
    warm = convert.warm_state_from_numpy(_warm_from_jax(first, 5), "cpu")
    assert warm.x.dtype == torch.float64 and warm.prior_iters == 5
    rest = _port_run(X, y, w0, 5, warm=warm)
    full = _jax_run(X, y, w0, 10)
    hist = np.concatenate([np.asarray(first.loss_history),
                           rest.loss_history.numpy()])
    np.testing.assert_allclose(hist, np.asarray(full.loss_history),
                               rtol=1e-9)
    np.testing.assert_allclose(rest.weights.numpy(),
                               np.asarray(full.weights), rtol=3e-7,
                               atol=1e-12)
    assert int(first.num_restarts) + int(rest.num_restarts) \
        == int(full.num_restarts)


def test_port_warm_state_continues_in_jax():
    rng = np.random.default_rng(50)
    X, y = make_problem(rng)
    w0 = rng.normal(size=X.shape[1])
    first = _port_run(X, y, w0, 5)
    warm = convert.warm_state_to_numpy(convert.warm_from_result(first, 5))
    assert isinstance(warm.x, np.ndarray)
    rest = _jax_run(X, y, w0, 5, warm=jagd.AGDWarmState(*warm))
    full = _port_run(X, y, w0, 10)
    np.testing.assert_allclose(np.asarray(rest.weights),
                               full.weights.numpy(), rtol=3e-7, atol=1e-12)
    np.testing.assert_allclose(np.asarray(rest.loss_history),
                               full.loss_history.numpy()[5:], rtol=1e-9)


def test_f32_run_matches_jax_f32():
    rng = np.random.default_rng(51)
    X, y = make_problem(rng)
    X32, y32 = X.astype(np.float32), y.astype(np.float32)
    w0 = np.zeros(X.shape[1], np.float32)
    j, t = run_both(X32, y32, "logistic", jprox.MLlibSquaredL2Updater(),
                    port.MLlibSquaredL2Updater(), 0.1, w0,
                    dict(num_iterations=12, convergence_tol=0.0))
    assert t[0].dtype == torch.float32
    assert t[2].loss_history.dtype == torch.float32
    assert int(t[2].num_iters) == int(j[2].num_iters)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-5)
    # test_pallas.py's f32 weight tolerance after a full run
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=1e-3,
                               atol=1e-5)


def test_dict_weights_through_custom_gradient():
    """A tree of weights runs through the loop (the MLP seam)."""
    rng = np.random.default_rng(52)
    X, y = make_problem(rng, n=120, d=4)

    def loss_t(p, X, y):
        m = -(X @ p["w"] + p["b"])
        return torch.sum(torch.logaddexp(m, torch.zeros_like(m))
                         - (1 - y) * m)

    def loss_j(p, X, y):
        m = -(X @ p["w"] + p["b"])
        return jnp.sum(jax.nn.softplus(m) - (1 - y) * m)

    w0 = {"w": np.zeros(4), "b": np.zeros(())}
    jw, jh = japi.run((X, y), jlosses.CustomGradient(loss_j),
                      jprox.L2Prox(), reg_param=0.05, num_iterations=8,
                      convergence_tol=0.0, initial_weights=w0, mesh=False)
    tw, th = port.run((X, y), port.CustomGradient(loss_t), port.L2Prox(),
                      reg_param=0.05, num_iterations=8, convergence_tol=0.0,
                      initial_weights=w0, device="cpu")
    np.testing.assert_allclose(th, jh, rtol=1e-9)
    for k in w0:
        np.testing.assert_allclose(tw[k].numpy(), np.asarray(jw[k]),
                                   rtol=3e-7, atol=1e-12)


def test_unknown_loss_mode_raises():
    with pytest.raises(ValueError, match="loss_mode"):
        agd.run_agd(lambda w: (w.sum(), w), lambda w, g, s: (w, 0.0),
                    lambda w: 0.0, torch.zeros(2),
                    agd.AGDConfig(loss_mode="z"))


def test_zero_iterations_returns_the_start():
    w0 = torch.tensor([1.0, 2.0], dtype=torch.float64)
    res = agd.run_agd(lambda w: (w.sum(), w), lambda w, g, s: (w, 0.0),
                      lambda w: 0.0, w0, agd.AGDConfig(num_iterations=0))
    assert int(res.num_iters) == 0 and res.loss_history.shape == (0,)
    assert torch.equal(res.weights, w0)
    assert math.isinf(float(res.final_theta))
