"""The quasi-Newton member (``core/lbfgs.py``, ``core/host_lbfgs.py``,
``api.run_lbfgs``/``make_lbfgs_runner``/``LBFGS`` and the ``*WithLBFGS``
trainers) against the JAX package, on the CPU.

At f64 the port's loop takes the JAX fused loop's decisions, and the
port's host twin the JAX host twin's: the same ``num_iters``,
``num_fn_evals``, ``converged``, ``ls_failed``, ``ls_stop_reason`` and
``aborted_non_finite``, loss histories within 1e-9 relative, weights
within 3e-7 (``tests/test_agd_core.py:75-88``), and under L1 the same
exact zeros.  The stop reasons are manufactured with the objectives of
``tests/test_lbfgs.py::TestLsStopReason``, at f32 where the reference
runs them so."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_agd_tpu as jpkg
from spark_agd_tpu import api as japi
from spark_agd_tpu.core import (host_lbfgs as jhost, lbfgs as jlb,
                                smooth as jsmooth)
from spark_agd_tpu.models import glm as jglm
from spark_agd_tpu.ops import losses as jlosses, prox as jprox
from spark_agd_tpu.ops import sparse as jsparse
from spark_agd_tpu.ops.pallas_kernels import PallasLogisticGradient
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.parallel import mesh as tmesh
from spark_agd_tpu_torch import convert
from spark_agd_tpu_torch.core import host_lbfgs, lbfgs, smooth
from spark_agd_tpu_torch.models import glm as tglm
from spark_agd_tpu_torch.ops import fused_kernels as fk


def logistic_problem(seed=0, n=300, d=8):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    w_true = rng.standard_normal(d)
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ w_true)))).astype(float)
    return X, y


def assert_same(j, t, w_rtol=3e-7, hist_rtol=1e-9):
    """A JAX result (fused ``LBFGSResult`` or ``HostLBFGSResult``)
    against the port's of the same kind."""
    for f in ("num_iters", "num_fn_evals", "converged", "ls_failed",
              "ls_stop_reason", "aborted_non_finite"):
        assert int(getattr(t, f)) == int(getattr(j, f)), f
    k = int(j.num_iters)
    jh = np.asarray(j.loss_history, np.float64)
    th = np.asarray(t.loss_history, np.float64)
    assert th.shape == jh.shape
    np.testing.assert_array_equal(np.isnan(th), np.isnan(jh))
    np.testing.assert_allclose(th[:k + 1], jh[:k + 1], rtol=hist_rtol)
    jw, tw = np.asarray(j.weights), np.asarray(t.weights)
    np.testing.assert_allclose(tw, jw, rtol=w_rtol, atol=1e-12)
    np.testing.assert_array_equal(tw == 0, jw == 0)
    assert float(t.grad_norm) == pytest.approx(float(j.grad_norm),
                                               rel=1e-6, abs=1e-12)


def _run_both(X, y, jupd, tupd, reg, loss="logistic", **kw):
    d = X.shape[1]
    kw.setdefault("initial_weights", np.zeros(d))
    jr = japi.run_lbfgs((X, y), jlosses.GRADIENTS[loss](), jupd,
                        reg_param=reg, mesh=False, **kw)
    tr = port.run_lbfgs((X, y), port.GRADIENTS[loss](), tupd, reg_param=reg,
                        device="cpu", **kw)
    return jr, tr


CASES = {
    "l2": (jprox.SquaredL2Updater, port.SquaredL2Updater, 0.05, {}),
    "l2_prox": (jprox.L2Prox, port.L2Prox, 0.1, {}),
    "corrections_1": (jprox.SquaredL2Updater, port.SquaredL2Updater, 0.1,
                      dict(num_corrections=1, num_iterations=300)),
    "loose_tol": (jprox.SquaredL2Updater, port.SquaredL2Updater, 0.01,
                  dict(convergence_tol=1e-3)),
    "grad_tol": (jprox.SquaredL2Updater, port.SquaredL2Updater, 0.01,
                 dict(grad_tol=1e-5, convergence_tol=0.0)),
    "l1_owlqn": (jprox.L1Updater, port.L1Updater, 0.05, {}),
    "elastic_net": (lambda: jprox.ElasticNetProx(0.5),
                    lambda: port.ElasticNetProx(0.5), 0.1, {}),
    "elastic_net_l1_zero": (lambda: jprox.ElasticNetProx(0.0),
                            lambda: port.ElasticNetProx(0.0), 0.1, {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_lbfgs_matches_jax_at_f64(name):
    X, y = logistic_problem(seed=1)
    jcls, tcls, reg, extra = CASES[name]
    kw = dict(convergence_tol=1e-10, num_iterations=100)
    kw.update(extra)
    jr, tr = _run_both(X, y, jcls(), tcls(), reg, **kw)
    assert_same(jr, tr)
    assert tr.loss_history.dtype == torch.float64
    assert tr.loss_history.shape == (kw["num_iterations"] + 1,)
    assert bool(tr.converged) and not bool(tr.ls_failed)


def test_least_squares_unregularized_lands_on_the_normal_equations():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((300, 8))
    y = X @ rng.standard_normal(8) + 0.01 * rng.standard_normal(300)
    jr, tr = _run_both(X, y, jprox.SimpleUpdater(), port.SimpleUpdater(),
                       0.0, loss="least_squares", convergence_tol=1e-12,
                       num_iterations=200)
    assert_same(jr, tr)
    np.testing.assert_allclose(tr.weights.numpy(),
                               np.linalg.lstsq(X, y, rcond=None)[0],
                               atol=1e-6)


def test_loss_history_semantics():
    X, y = logistic_problem(seed=3, n=200, d=6)
    _, tr = _run_both(X, y, jprox.SquaredL2Updater(),
                      port.SquaredL2Updater(), 0.1, convergence_tol=1e-10,
                      num_iterations=50)
    h = tr.loss_history.numpy()
    k = int(tr.num_iters)
    np.testing.assert_allclose(h[0], math.log(2.0), rtol=1e-12)
    assert np.isfinite(h[:k + 1]).all() and np.isnan(h[k + 1:]).all()
    assert (np.diff(h[:k + 1]) <= 0).all()


@pytest.mark.parametrize("updater", ["l2", "l1"])
def test_step_diagnostics_account_for_every_evaluation(updater):
    """``diag_evals`` counts each accepted iteration's objective
    evaluations (all but the one at ``w0``); ``diag_step`` holds the
    step each search accepted, NaN past ``num_iters``."""
    X, y = logistic_problem(seed=17, n=200, d=6)
    upd = port.SquaredL2Updater() if updater == "l2" else port.L1Prox()
    res = port.run_lbfgs((X, y), port.LogisticGradient(), upd,
                         reg_param=0.05, convergence_tol=1e-10,
                         num_iterations=60, initial_weights=np.zeros(6),
                         device="cpu")
    k = int(res.num_iters)
    assert res.diag_step.shape == res.diag_evals.shape == (60,)
    assert int(res.diag_evals.sum()) + 1 == int(res.num_fn_evals)
    assert (res.diag_evals[:k] >= 1).all() and not res.diag_evals[k:].any()
    assert (res.diag_step[:k] > 0).all() and res.diag_step[k:].isnan().all()


def test_owlqn_exact_zeros_match_jax_and_prox_agd():
    X, y = logistic_problem(seed=4, n=300, d=20)
    jr, tr = _run_both(X, y, jprox.L1Updater(), port.L1Updater(), 0.15,
                       convergence_tol=1e-11, num_iterations=200)
    assert_same(jr, tr)
    w = tr.weights.numpy()
    assert (w == 0).sum() > 0
    agd_w, _ = port.run((X, y), port.LogisticGradient(), port.L1Prox(),
                        reg_param=0.15, convergence_tol=1e-12,
                        num_iterations=2000, initial_weights=np.zeros(20),
                        device="cpu")
    assert set(np.nonzero(w)[0]) == set(np.nonzero(agd_w.numpy())[0])


def test_non_finite_objective_aborts_like_jax():
    rng = np.random.default_rng(5)
    X = rng.standard_normal((20, 3))
    X[0, 0] = np.inf
    jr, tr = _run_both(X, np.zeros(20), jprox.SimpleUpdater(),
                       port.SimpleUpdater(), 0.0, loss="least_squares",
                       initial_weights=np.ones(3))
    assert bool(tr.aborted_non_finite) and int(tr.num_iters) == 0
    assert_same(jr, tr)


def test_runner_routes_and_rejects_before_staging():
    X, y = logistic_problem(seed=6, n=40, d=3)
    fit = port.make_lbfgs_runner((X, y), port.LogisticGradient(),
                                 port.L1Prox(), reg_param=0.1, device="cpu")
    assert fit.algorithm == "owlqn"
    fit2 = port.make_lbfgs_runner((X, y), port.LogisticGradient(),
                                  port.L2Prox(), reg_param=0.1, device="cpu")
    assert fit2.algorithm == "lbfgs"
    a, b = fit2(np.zeros(3)), fit2(np.zeros(3))
    assert torch.equal(a.weights, b.weights)

    class ProxOnly(port.Prox):
        def prox(self, w, g, step, reg):
            return w, 0.0

        def reg_value(self, w, reg):
            return 0.0

    class Staging(port.LogisticGradient):
        def prepare(self, *a):
            raise AssertionError("staged before the updater was checked")

    with pytest.raises(ValueError, match="neither a smooth penalty"):
        port.make_lbfgs_runner((X, y), Staging(), ProxOnly(), device="cpu")
    with pytest.raises(ValueError, match="smooth penalty"):
        lbfgs.make_objective(lambda w: (0.0, w), port.L1Updater(), 0.1)
    with pytest.raises(ValueError, match="num_corrections"):
        port.run_lbfgs((X, y), port.LogisticGradient(), port.L2Prox(),
                       num_corrections=0, initial_weights=np.zeros(3),
                       device="cpu")
    with pytest.raises(ValueError, match="l1_reg"):
        lbfgs.run_owlqn(lambda w: (w.sum(), w), torch.zeros(2), -1.0)


def _jax_objective(X, y, reg):
    sm = jsmooth.make_smooth(jlosses.LogisticGradient(), jnp.asarray(X),
                             jnp.asarray(y))
    return jlb.make_objective(sm, jprox.SquaredL2Updater(), reg)


def _port_objective(X, y, reg):
    sm = smooth.make_smooth(port.LogisticGradient(), torch.tensor(X),
                            torch.tensor(y))
    return lbfgs.make_objective(sm, port.SquaredL2Updater(), reg)


def test_core_drivers_match_both_jax_twins():
    """The port's loop against the JAX fused loop, the port's host twin
    against the JAX host twin, and the two port twins against each
    other."""
    X, y = logistic_problem(seed=7, n=300, d=9)
    cfg = dict(convergence_tol=1e-11, num_iterations=80)
    jcfg, tcfg = jlb.LBFGSConfig(**cfg), lbfgs.LBFGSConfig(**cfg)
    jobj, tobj = _jax_objective(X, y, 0.07), _port_objective(X, y, 0.07)
    jf = jax.jit(lambda w: jlb.run_lbfgs(jobj, w, jcfg))(jnp.zeros(9))
    tf = lbfgs.run_lbfgs(tobj, torch.zeros(9, dtype=torch.float64), tcfg)
    assert_same(jf, tf)
    jh = jhost.run_lbfgs_host(jobj, jnp.zeros(9), jcfg)
    th = host_lbfgs.run_lbfgs_host(tobj, torch.zeros(9, dtype=torch.float64),
                                   tcfg)
    assert isinstance(th.loss_history, np.ndarray)
    assert isinstance(th.num_iters, int) and isinstance(th.grad_norm, float)
    assert_same(jh, th)
    assert th.num_iters == int(tf.num_iters)
    np.testing.assert_allclose(th.loss_history,
                               tf.loss_history[:th.num_iters + 1].numpy(),
                               rtol=1e-12)


def test_owlqn_core_drivers_match_both_jax_twins():
    X, y = logistic_problem(seed=8, n=250, d=9)
    jsm = jsmooth.make_smooth(jlosses.LogisticGradient(), jnp.asarray(X),
                              jnp.asarray(y))
    tsm = smooth.make_smooth(port.LogisticGradient(), torch.tensor(X),
                             torch.tensor(y))
    cfg = dict(convergence_tol=1e-11, num_iterations=80)
    jcfg, tcfg = jlb.LBFGSConfig(**cfg), lbfgs.LBFGSConfig(**cfg)
    w0 = torch.zeros(9, dtype=torch.float64)
    jf = jax.jit(lambda w: jlb.run_owlqn(jsm, w, 0.06, jcfg))(jnp.zeros(9))
    assert_same(jf, lbfgs.run_owlqn(tsm, w0, 0.06, tcfg))
    assert_same(jhost.run_owlqn_host(jsm, jnp.zeros(9), 0.06, jcfg),
                host_lbfgs.run_owlqn_host(tsm, w0, 0.06, tcfg))


def test_host_warm_resume_is_exact():
    X, y = logistic_problem(seed=9, n=250, d=7)
    obj = _port_objective(X, y, 0.03)
    w0 = torch.zeros(7, dtype=torch.float64)
    cfg = lbfgs.LBFGSConfig(convergence_tol=1e-11, num_iterations=40)
    full = host_lbfgs.run_lbfgs_host(obj, w0, cfg)
    assert full.num_iters >= 6
    seg1 = host_lbfgs.run_lbfgs_host(
        obj, w0, lbfgs.LBFGSConfig(convergence_tol=1e-11, num_iterations=3))
    assert seg1.num_iters == 3 and not seg1.converged
    seg2 = host_lbfgs.run_lbfgs_host(
        obj, w0, cfg, warm=host_lbfgs.HostLBFGSWarm.from_result(seg1))
    assert 3 + seg2.num_iters == full.num_iters
    assert seg2.converged == full.converged
    np.testing.assert_array_equal(
        np.concatenate([seg1.loss_history, seg2.loss_history[1:]]),
        full.loss_history)
    assert torch.equal(seg2.weights, full.weights)
    # the objective is not evaluated again at the resume point
    assert seg1.num_fn_evals + seg2.num_fn_evals == full.num_fn_evals


def test_host_on_iteration_carry_round_trips():
    X, y = logistic_problem(seed=10, n=200, d=6)
    obj = _port_objective(X, y, 0.05)
    w0 = torch.zeros(6, dtype=torch.float64)
    cfg = lbfgs.LBFGSConfig(convergence_tol=1e-11, num_iterations=30)
    full = host_lbfgs.run_lbfgs_host(obj, w0, cfg)
    snaps = []
    host_lbfgs.run_lbfgs_host(obj, w0, cfg, on_iteration=lambda s:
                              snaps.append(s) if s["it"] == 2 else None)
    s = snaps[0]
    warm = host_lbfgs.HostLBFGSWarm(w=s["w"], f=s["f"], g=s["g"],
                                    pairs=s["pairs"], prior_iters=s["it"])
    seg2 = host_lbfgs.run_lbfgs_host(obj, w0, cfg, warm=warm)
    assert torch.equal(seg2.weights, full.weights)
    assert 2 + seg2.num_iters == full.num_iters


def test_owlqn_host_warm_resume_is_exact():
    X, y = logistic_problem(seed=11, n=200, d=7)
    sm = smooth.make_smooth(port.LogisticGradient(), torch.tensor(X),
                            torch.tensor(y))
    w0 = torch.zeros(7, dtype=torch.float64)
    cfg = lbfgs.LBFGSConfig(convergence_tol=1e-11, num_iterations=50)
    full = host_lbfgs.run_owlqn_host(sm, w0, 0.05, cfg)
    assert full.num_iters >= 4
    s1 = host_lbfgs.run_owlqn_host(
        sm, w0, 0.05, lbfgs.LBFGSConfig(convergence_tol=1e-11,
                                        num_iterations=3))
    s2 = host_lbfgs.run_owlqn_host(
        sm, w0, 0.05, cfg, warm=host_lbfgs.HostLBFGSWarm.from_result(s1))
    assert 3 + s2.num_iters == full.num_iters
    assert torch.equal(s2.weights, full.weights)
    np.testing.assert_array_equal(
        np.concatenate([s1.loss_history, s2.loss_history[1:]]),
        full.loss_history)


# --- the line search's stop reasons (tests/test_lbfgs.py:672-800) ---------

def _noise_floor(mod):
    def obj(w):
        r = w - 1.0
        f = (r * r).sum()
        return mod.round(f * 1e4) / 1e4, 2.0 * r

    return obj


def _linear(mod):
    return lambda w: (mod.abs(w).sum(), mod.sign(w))


def _steep(mod):
    return lambda w: (1e8 * (w * w).sum(), 2e8 * w)


def _steep_off_boundary(mod):
    def obj(w):
        r = w - 0.5
        return 1e8 * (r * r).sum(), 2e8 * r

    return obj


def _nan_off_start(mod):
    """Finite only at w0 = 2: every trial is NaN, so the search exhausts
    its zoom on a non-finite trial."""
    def obj(w):
        return mod.where(w == 2.0, w * w, mod.nan).sum(), 2.0 * w

    return obj


STOP_CASES = {
    "noise_floor_f32": (_noise_floor, 1.0 + 1e-4, np.float32,
                        dict(convergence_tol=-1.0, num_iterations=200),
                        "lbfgs", None, jlb.LS_STOP_NOISE_FLOOR),
    "bracket_exhausted": (_linear, 1e7, np.float32,
                          dict(num_iterations=3), "lbfgs", None,
                          jlb.LS_STOP_BRACKET),
    "zoom_exhausted": (_steep, 1.0, np.float32, dict(num_iterations=3),
                       "lbfgs", None, jlb.LS_STOP_ZOOM),
    "zoom_on_nan_trials_f64": (_nan_off_start, 2.0, np.float64,
                               dict(num_iterations=3), "lbfgs", None,
                               jlb.LS_STOP_ZOOM),
    "owlqn_armijo_exhausted": (_steep_off_boundary, 1.0, np.float32,
                               dict(num_iterations=3, max_ls_steps=4),
                               "owlqn", 0.1, jlb.LS_STOP_ARMIJO),
    "owlqn_noise_floor_f32": (_noise_floor, 1.0 + 1e-4, np.float32,
                              dict(convergence_tol=-1.0,
                                   num_iterations=200),
                              "owlqn", 0.0, jlb.LS_STOP_NOISE_FLOOR),
}


@pytest.mark.parametrize("twin", ["fused", "host"])
@pytest.mark.parametrize("name", sorted(STOP_CASES))
def test_stop_reasons_match_jax(name, twin):
    mk, start, dtype, cfg, algo, l1, reason = STOP_CASES[name]
    jw0 = jnp.full((4,), start, dtype)
    tw0 = torch.full((4,), start, dtype=torch.float32
                     if dtype == np.float32 else torch.float64)
    jcfg, tcfg = jlb.LBFGSConfig(**cfg), lbfgs.LBFGSConfig(**cfg)
    if twin == "fused":
        jrun = (jlb.run_lbfgs if algo == "lbfgs"
                else lambda o, w, c: jlb.run_owlqn(o, w, l1, c))
        trun = (lbfgs.run_lbfgs if algo == "lbfgs"
                else lambda o, w, c: lbfgs.run_owlqn(o, w, l1, c))
        j = jax.jit(lambda w: jrun(mk(jnp), w, jcfg))(jw0)
    else:
        jrun = (jhost.run_lbfgs_host if algo == "lbfgs"
                else lambda o, w, c: jhost.run_owlqn_host(o, w, l1, c))
        trun = (host_lbfgs.run_lbfgs_host if algo == "lbfgs"
                else lambda o, w, c: host_lbfgs.run_owlqn_host(o, w, l1, c))
        j = jrun(mk(np), np.asarray(jw0), jcfg)
    t = trun(mk(torch), tw0, tcfg)
    assert bool(t.ls_failed)
    assert int(t.ls_stop_reason) == reason
    assert lbfgs.ls_stop_reason_name(t.ls_stop_reason) == \
        jlb.ls_stop_reason_name(reason)
    assert_same(j, t, w_rtol=1e-6, hist_rtol=1e-6)


def test_a_failed_search_on_a_nan_trial_aborts_only_the_fused_twin():
    """The JAX fused loop marks the abort from the last trial's value
    even when the search failed; its host twin does not.  Each port twin
    keeps its reference's flag."""
    w0 = torch.full((4,), 2.0, dtype=torch.float64)
    cfg = lbfgs.LBFGSConfig(num_iterations=3)
    assert bool(lbfgs.run_lbfgs(_nan_off_start(torch), w0,
                                cfg).aborted_non_finite)
    assert not host_lbfgs.run_lbfgs_host(_nan_off_start(torch), w0,
                                         cfg).aborted_non_finite


# --- the optimizer class and the trainers ----------------------------------

def test_lbfgs_class_drop_in_and_setters():
    X, y = logistic_problem(seed=12, n=200, d=6)
    opt = (port.LBFGS(port.LogisticGradient(), port.SquaredL2Updater())
           .setRegParam(0.1).setConvergenceTol(1e-10).setNumIterations(100)
           .setNumCorrections(7).set_device("cpu"))
    assert opt.set_grad_tol(0.0) is opt and opt.set_dist_mode("auto") is opt
    w = opt.optimize((X, y), np.zeros(6))
    ref = port.run_lbfgs((X, y), port.LogisticGradient(),
                         port.SquaredL2Updater(), reg_param=0.1,
                         num_corrections=7, convergence_tol=1e-10,
                         num_iterations=100, initial_weights=np.zeros(6),
                         device="cpu")
    assert torch.equal(w, ref.weights)
    jopt = jpkg.LBFGS(None, None)
    for name in dir(jopt):
        if name.startswith("set"):
            assert hasattr(opt, name), name
    # the L-BFGS lanes are ported: the path runs with this configuration
    path = opt.sweep((X, y), [0.1, 0.01], np.zeros(6))
    assert path.weights.shape == (2, 6)
    assert torch.equal(path.num_iters[0], ref.num_iters)
    with pytest.raises(NotImplementedError, match="mesh"):
        opt.set_mesh(tmesh.make_mesh({"data": 1, "model": 2}, devices=["cpu"] * 2))
    with pytest.raises(NotImplementedError, match="telemetry"):
        port.run_lbfgs((X, y), port.LogisticGradient(), port.L2Prox(),
                       initial_weights=np.zeros(6), device="cpu",
                       telemetry=object())
    with pytest.raises(ValueError, match="dist_mode"):
        port.run_lbfgs((X, y), port.LogisticGradient(), port.L2Prox(),
                       initial_weights=np.zeros(6), device="cpu",
                       dist_mode="gspmd")


def _csr_pair(X):
    """The JAX and port CSR of dense ``X`` (zeros dropped)."""
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


def _sparse_X(seed, n, d):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)) * (rng.random((n, d)) < 0.3)
    return X


@pytest.mark.parametrize("layout", ["dense", "csr"])
@pytest.mark.parametrize("updater", ["l2", "l1"])
def test_logistic_lbfgs_trainer_matches_jax(layout, updater):
    X = _sparse_X(13, 240, 10)
    y = (np.random.default_rng(1).random(240)
         < 1 / (1 + np.exp(-X @ np.linspace(-1, 1, 10)))).astype(float)
    jupd, tupd = ((jprox.L2Prox(), port.L2Prox()) if updater == "l2"
                  else (jprox.L1Prox(), port.L1Prox()))
    j = jglm.LogisticRegressionWithLBFGS(0.02, num_corrections=5,
                                         updater=jupd, mesh=False)
    t = tglm.LogisticRegressionWithLBFGS(0.02, num_corrections=5,
                                         updater=tupd)
    j.optimizer.setNumIterations(40).setConvergenceTol(1e-9)
    t.optimizer.setNumIterations(40).setConvergenceTol(1e-9) \
        .set_device("cpu")
    jX, tX = (X, X) if layout == "dense" else _csr_pair(X)
    w0 = np.zeros(11)
    jm, tm = j.train(jX, y, initial_weights=w0), t.train(tX, y,
                                                         initial_weights=w0)
    assert type(tm).__name__ == type(jm).__name__
    np.testing.assert_allclose(tm.weights.numpy(), np.asarray(jm.weights),
                               rtol=3e-7, atol=1e-12)
    assert tm.intercept == pytest.approx(float(jm.intercept), rel=3e-7,
                                         abs=1e-12)
    np.testing.assert_array_equal(tm.weights.numpy() == 0,
                                  np.asarray(jm.weights) == 0)
    # the fit the trainer ran, with every diagnostic
    jr = japi.run_lbfgs((jglm._add_intercept(jX), y),
                        jlosses.LogisticGradient(), jupd, 5, 1e-9, 40, 0.02,
                        w0, mesh=False)
    tr = port.run_lbfgs((tglm._add_intercept(tX), y),
                        port.LogisticGradient(), tupd, 5, 1e-9, 40, 0.02, w0,
                        device="cpu")
    assert_same(jr, tr)


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_softmax_lbfgs_trainer_matches_jax(layout):
    k = 3
    X = _sparse_X(14, 210, 8)
    rng = np.random.default_rng(2)
    y = np.argmax(X @ rng.standard_normal((8, k))
                  + rng.gumbel(size=(210, k)), axis=1).astype(np.int32)
    j = jglm.SoftmaxRegressionWithLBFGS(k, reg_param=1e-3, mesh=False)
    t = tglm.SoftmaxRegressionWithLBFGS(k, reg_param=1e-3)
    j.optimizer.setNumIterations(30).setConvergenceTol(1e-9)
    t.optimizer.setNumIterations(30).setConvergenceTol(1e-9) \
        .set_device("cpu")
    jX, tX = (X, X) if layout == "dense" else _csr_pair(X)
    w0 = np.zeros((9, k))
    jm, tm = j.train(jX, y, initial_weights=w0), t.train(tX, y,
                                                         initial_weights=w0)
    np.testing.assert_allclose(tm.weights.numpy(), np.asarray(jm.weights),
                               rtol=3e-7, atol=1e-12)
    np.testing.assert_allclose(tm.intercept.numpy(),
                               np.asarray(jm.intercept), rtol=3e-7,
                               atol=1e-12)
    jr = japi.run_lbfgs((jglm._add_intercept(jX), y),
                        jpkg.SoftmaxGradient(k), jprox.L2Prox(), 10, 1e-9,
                        30, 1e-3, w0, mesh=False)
    tr = port.run_lbfgs((tglm._add_intercept(tX), y),
                        port.SoftmaxGradient(k), port.L2Prox(), 10, 1e-9,
                        30, 1e-3, w0, device="cpu")
    assert_same(jr, tr)


def test_fused_gradients_in_the_lbfgs_seat_match_jax_pallas_at_f32():
    """``FusedLogisticGradient`` (its plain version on the CPU) against
    ``PallasLogisticGradient(interpret=True)`` through L-BFGS at f32,
    loss histories rtol 1e-4 (``tests/test_pallas.py``); the fused
    softmax gradient in ``SoftmaxRegressionWithLBFGS`` against the plain
    one."""
    X, y = logistic_problem(seed=15, n=256, d=12)
    X32, y32 = X.astype(np.float32), y.astype(np.float32)
    w0 = np.zeros(12, np.float32)
    jr = japi.run_lbfgs((X32, y32), PallasLogisticGradient(interpret=True),
                        jprox.SquaredL2Updater(), reg_param=0.1,
                        num_iterations=6, convergence_tol=0.0,
                        initial_weights=w0, mesh=False)
    tr = port.run_lbfgs((X32, y32), port.FusedLogisticGradient(),
                        port.SquaredL2Updater(), reg_param=0.1,
                        num_iterations=6, convergence_tol=0.0,
                        initial_weights=w0, device="cpu")
    k = min(int(jr.num_iters), int(tr.num_iters))
    assert k >= 4 and tr.weights.dtype == torch.float32
    np.testing.assert_allclose(tr.loss_history[:k + 1].numpy(),
                               np.asarray(jr.loss_history)[:k + 1],
                               rtol=1e-4)

    K = 3
    labels = (np.arange(256) % K).astype(np.int32)
    fits = []
    for g in (fk.FusedSoftmaxGradient(port.SoftmaxGradient(K)),
              port.SoftmaxGradient(K)):
        t = tglm.SoftmaxRegressionWithLBFGS(K, reg_param=1e-3)
        t.optimizer.set_gradient(g).setNumIterations(6).set_device("cpu")
        fits.append(t.train(X32, labels))
    np.testing.assert_allclose(fits[0].weights.numpy(),
                               fits[1].weights.numpy(), rtol=1e-3,
                               atol=1e-5)


def test_lbfgs_trainer_paths_still_raise_and_need_cuda(monkeypatch):
    X, y = logistic_problem(seed=16, n=40, d=3)
    t = tglm.LogisticRegressionWithLBFGS()
    t.optimizer.set_device("cpu")
    # the L-BFGS lanes are ported: the path runs from the LBFGS seat
    models, res = t.train_path(X, y, [0.1, 0.01])
    assert len(models) == 2 and res.weights.shape == (2, 4)
    # cross-validation is AGD-only in both packages: the JAX ValueError
    with pytest.raises(ValueError, match="requires an optimizer seat"):
        tglm.SoftmaxRegressionWithLBFGS(2).cross_validate(X, y, [0.1])
    with pytest.raises(NotImplementedError, match="mesh"):
        tglm.LogisticRegressionWithLBFGS(
            mesh=tmesh.make_mesh({"data": 1, "model": 2}, devices=["cpu"] * 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tglm.LogisticRegressionWithLBFGS().train(X, y)
