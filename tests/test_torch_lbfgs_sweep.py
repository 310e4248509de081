"""The port's L-BFGS lanes against the JAX package at f64.

``LBFGS.sweep``/``make_lbfgs_sweep_runner`` and the ``*WithLBFGS``
trainers' ``train_path`` run K L-BFGS fits in lock-step
(``core.lbfgs.run_lanes``, one multi-evaluation a round) where the JAX
package ``vmap``s its fused loop; every lane must take the JAX lane's
path: the same ``num_iters``, ``num_fn_evals``, ``converged`` and
``ls_stop_reason``, loss histories within 1e-9 relative and weights
within 3e-7 (the port's f64 parity standard,
``tests/test_agd_core.py:75-88``).  Each lane equals the port's solo
``run_lbfgs`` at its strength.  ``run_lbfgs_host_multi`` is held to the
JAX host loop's on the same objective.  The lanes kernel's plain version
runs here (``FusedLogisticGradient`` on the CPU); the kernel itself is
held on the card (``test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu import api as japi
from spark_agd_tpu.core import host_lbfgs as jhost, lbfgs as jlbfgs
from spark_agd_tpu.core import smooth as jsmooth, tvec as jtvec
from spark_agd_tpu.ops import losses as jl, prox as jp
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch import api as tapi
from spark_agd_tpu_torch.core import host_lbfgs as thost, lbfgs as tlbfgs
from spark_agd_tpu_torch.core import smooth as tsmooth, tvec
from spark_agd_tpu_torch.models import glm as tglm
from spark_agd_tpu_torch.ops import fused_kernels as fk, losses as tl
from spark_agd_tpu_torch.ops import prox as tp

REGS = [0.3, 0.03, 3e-3, 1e-4]
UPDATERS = {
    "l2": (jp.L2Prox, tp.L2Prox),
    "mllib_l2": (jp.SquaredL2Updater, tp.SquaredL2Updater),
}


def _problem(loss, seed=0, n=240, d=9):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    if loss == "logistic":
        y = (rng.random(n) < 1 / (1 + np.exp(-X[:, 0] + X[:, 1]))) \
            .astype(float)
    else:
        y = X @ rng.standard_normal(d) + 0.1 * rng.standard_normal(n)
    return X, y, np.zeros(d)


def assert_same_lanes(jr, tr, loss_rtol=1e-9, w_rtol=3e-7):
    """Every lane of two batched ``LBFGSResult``s took the same path."""
    for f in ("num_iters", "num_fn_evals", "converged", "ls_failed",
              "aborted_non_finite", "ls_stop_reason"):
        np.testing.assert_array_equal(np.asarray(getattr(tr, f)),
                                      np.asarray(getattr(jr, f)), err_msg=f)
    a, b = np.asarray(jr.loss_history), tr.loss_history.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_allclose(b, a, rtol=loss_rtol)
    tvec.tmap(lambda t, j: np.testing.assert_allclose(
        t.numpy(), np.asarray(j), rtol=w_rtol, atol=1e-12),
        tr.weights, tuple(jr.weights) if isinstance(tr.weights, tuple)
        else jr.weights)
    np.testing.assert_allclose(tr.grad_norm.numpy(),
                               np.asarray(jr.grad_norm), rtol=1e-6,
                               atol=1e-12)


def _jax_sweep(entry, X, y, loss, updater, regs, w0, **cfg):
    if entry == "LBFGS.sweep":
        opt = japi.LBFGS(jl.GRADIENTS[loss](), updater).set_mesh(False)
        opt.set_num_iterations(cfg["num_iterations"])
        opt.set_convergence_tol(cfg["convergence_tol"])
        return opt.sweep((X, y), regs, w0)
    return japi.make_lbfgs_sweep_runner(
        (X, y), jl.GRADIENTS[loss](), updater, mesh=False, **cfg)(w0, regs)


def _port_sweep(entry, X, y, loss, updater, regs, w0, gradient=None,
                **cfg):
    gradient = gradient or tl.GRADIENTS[loss]()
    if entry == "LBFGS.sweep":
        opt = port.LBFGS(gradient, updater).set_device("cpu")
        opt.set_num_iterations(cfg["num_iterations"])
        opt.set_convergence_tol(cfg["convergence_tol"])
        return opt.sweep((X, y), regs, w0)
    return port.make_lbfgs_sweep_runner(
        (X, y), gradient, updater, device="cpu", **cfg)(w0, regs)


ENTRIES = ["LBFGS.sweep", "make_lbfgs_sweep_runner"]


class TestSweep:
    @pytest.mark.parametrize("updater", sorted(UPDATERS))
    @pytest.mark.parametrize("loss", ["logistic", "least_squares"])
    @pytest.mark.parametrize("entry", ENTRIES)
    def test_lanes_match_the_jax_sweep(self, entry, loss, updater):
        X, y, w0 = _problem(loss)
        ju, tu = UPDATERS[updater]
        cfg = dict(num_iterations=30, convergence_tol=1e-8)
        jr = _jax_sweep(entry, X, y, loss, ju(), REGS, w0, **cfg)
        tr = _port_sweep(entry, X, y, loss, tu(), REGS, w0, **cfg)
        assert tr.loss_history.shape == (len(REGS), 31)
        assert 0 < tr.eval_rounds == int(tr.num_fn_evals.max())
        assert_same_lanes(jr, tr)

    def test_per_lane_stops(self):
        """Lanes stop at different iterations (the strong strengths
        converge first) and a stopped lane stays frozen."""
        X, y, w0 = _problem("logistic", seed=3)
        cfg = dict(num_iterations=40, convergence_tol=1e-6)
        jr = _jax_sweep("make_lbfgs_sweep_runner", X, y, "logistic",
                        jp.SquaredL2Updater(), REGS, w0, **cfg)
        tr = _port_sweep("make_lbfgs_sweep_runner", X, y, "logistic",
                         tp.SquaredL2Updater(), REGS, w0, **cfg)
        assert len(set(tr.num_iters.tolist())) > 1
        assert_same_lanes(jr, tr)
        for k in range(len(REGS)):
            n = int(tr.num_iters[k])
            assert np.isnan(tr.loss_history[k, n + 1:].numpy()).all()

    @pytest.mark.parametrize("loss", ["logistic", "least_squares"])
    def test_lanes_equal_solo_runs(self, loss):
        """Each lane makes the decisions of the port's solo ``run_lbfgs``
        at its strength; the values agree to the lanes products'
        rounding."""
        X, y, w0 = _problem(loss, seed=4)
        cfg = dict(num_iterations=25, convergence_tol=1e-7)
        tr = _port_sweep("make_lbfgs_sweep_runner", X, y, loss,
                         tp.SquaredL2Updater(), REGS, w0, **cfg)
        for k, reg in enumerate(REGS):
            solo = port.run_lbfgs((X, y), tl.GRADIENTS[loss](),
                                  tp.SquaredL2Updater(), reg_param=reg,
                                  initial_weights=w0, device="cpu", **cfg)
            for f in ("num_iters", "num_fn_evals", "converged",
                      "ls_stop_reason"):
                assert int(getattr(tr, f)[k]) == int(getattr(solo, f)), f
            np.testing.assert_allclose(tr.loss_history[k].numpy(),
                                       solo.loss_history.numpy(),
                                       rtol=1e-12)
            np.testing.assert_allclose(tr.weights[k].numpy(),
                                       solo.weights.numpy(), rtol=1e-10,
                                       atol=1e-14)
            np.testing.assert_allclose(tr.diag_step[k].numpy(),
                                       solo.diag_step.numpy(), rtol=1e-10)

    def test_fused_gradients_on_the_cpu_match_the_plain_ones(self):
        """``FusedLogisticGradient`` (the lanes kernel's plain version on
        the CPU, one call a round) and ``FusedSoftmaxGradient`` (lane by
        lane) take the plain gradients' paths.  The kernels read f32 (or
        bf16) X, so both sides run at f32 here: the same decisions, the
        values within f32 rounding of the two products' order."""
        X, y, _ = _problem("logistic", seed=5)
        X, y = X.astype(np.float32), y.astype(np.float32)
        labels = np.random.default_rng(5).integers(0, 3, len(y))
        cfg = dict(num_iterations=12, convergence_tol=0.0)
        cases = [(y, tp.SquaredL2Updater(), REGS, tl.LogisticGradient(),
                  fk.FusedLogisticGradient(), (X.shape[1],)),
                 (labels, tp.L2Prox(), REGS[:2], tl.SoftmaxGradient(3),
                  fk.FusedSoftmaxGradient(tl.SoftmaxGradient(3)),
                  (X.shape[1], 3))]
        for yy, updater, regs, plain_g, fused_g, shape in cases:
            w0 = np.zeros(shape, np.float32)
            plain, fused = (
                _port_sweep("make_lbfgs_sweep_runner", X, yy, None, updater,
                            regs, w0, gradient=g, **cfg)
                for g in (plain_g, fused_g))
            assert fused.weights.shape == (len(regs),) + shape
            for f in ("num_iters", "num_fn_evals", "converged",
                      "ls_stop_reason"):
                assert torch.equal(getattr(fused, f), getattr(plain, f)), f
            np.testing.assert_allclose(fused.loss_history.numpy(),
                                       plain.loss_history.numpy(),
                                       rtol=1e-5)
            np.testing.assert_allclose(fused.weights.numpy(),
                                       plain.weights.numpy(), rtol=1e-4,
                                       atol=1e-6)

    @pytest.mark.parametrize("case", ["l1", "elastic_net", "identity"])
    def test_grids_the_lanes_refuse_raise_as_in_jax(self, case):
        """L1 and elastic-net penalties have no smooth part (the OWL-QN
        dispatch cannot join lanes); a no-penalty updater with a non-zero
        grid would ignore it.  Both packages raise ``ValueError``."""
        X, y, w0 = _problem("logistic")
        ju, tu = {"l1": (jp.L1Updater, tp.L1Updater),
                  "elastic_net": (lambda: jp.ElasticNetProx(0.5),
                                  lambda: tp.ElasticNetProx(0.5)),
                  "identity": (jp.IdentityProx, tp.IdentityProx)}[case]
        for entry in ENTRIES:
            with pytest.raises(ValueError) as jerr:
                _jax_sweep(entry, X, y, "logistic", ju(), [0.1, 0.01], w0,
                           num_iterations=3, convergence_tol=0.0)
            with pytest.raises(ValueError) as terr:
                _port_sweep(entry, X, y, "logistic", tu(), [0.1, 0.01], w0,
                            num_iterations=3, convergence_tol=0.0)
            assert str(terr.value) == str(jerr.value)
        # a zero grid through the identity prox runs in both
        if case == "identity":
            cfg = dict(num_iterations=4, convergence_tol=0.0)
            assert_same_lanes(
                _jax_sweep("LBFGS.sweep", X, y, "logistic", ju(), [0.0],
                           w0, **cfg),
                _port_sweep("LBFGS.sweep", X, y, "logistic", tu(), [0.0],
                            w0, **cfg))

    def test_rejects_bad_inputs(self):
        X, y, w0 = _problem("logistic")
        fit = port.make_lbfgs_sweep_runner((X, y), tl.LogisticGradient(),
                                           tp.L2Prox(), device="cpu")
        with pytest.raises(ValueError, match="1-D"):
            fit(w0, [[0.1, 0.2]])
        # a mesh= that is not a Mesh raises in both packages (JAX an
        # AttributeError reading its shape, the port a TypeError naming
        # the Mesh it takes); a real mesh computes (test_torch_grid_mesh)
        with pytest.raises(AttributeError):
            japi.make_lbfgs_sweep_runner((X, y), jl.LogisticGradient(),
                                         jp.L2Prox(), mesh="data")
        with pytest.raises(TypeError, match="Mesh"):
            port.make_lbfgs_sweep_runner((X, y), tl.LogisticGradient(),
                                         tp.L2Prox(), mesh="data",
                                         device="cpu")


class TestTrainers:
    def test_logistic_train_path_matches_jax(self):
        from spark_agd_tpu.models import LogisticRegressionWithLBFGS as JLR

        X, y, _ = _problem("logistic", seed=6)
        regs = [0.1, 0.01, 1e-3]
        w0 = np.zeros(X.shape[1] + 1)  # f64: the default zeros are f32
        jt = JLR()
        jt.optimizer.set_num_iterations(20).set_mesh(False)
        jmodels, jres = jt.train_path(X, y, regs, w0)
        tt = tglm.LogisticRegressionWithLBFGS()
        tt.optimizer.set_num_iterations(20).set_device("cpu")
        tmodels, tres = tt.train_path(X, y, regs, w0)
        assert_same_lanes(jres, tres)
        assert len(tmodels) == 3
        for jm, tm in zip(jmodels, tmodels):
            assert type(tm).__name__ == type(jm).__name__
            np.testing.assert_allclose(tm.weights.numpy(),
                                       np.asarray(jm.weights), rtol=3e-7,
                                       atol=1e-12)
            assert tm.intercept == pytest.approx(jm.intercept, rel=3e-7,
                                                 abs=1e-12)

    def test_softmax_train_path_matches_jax(self):
        from spark_agd_tpu.models import SoftmaxRegressionWithLBFGS as JSR

        rng = np.random.default_rng(7)
        X = rng.standard_normal((150, 6))
        y = rng.integers(0, 4, 150)
        regs = [1.0, 0.1, 0.01]
        W0 = np.zeros((7, 4))
        jt = JSR(4)
        jt.optimizer.set_num_iterations(8).set_mesh(False)
        jmodels, jres = jt.train_path(X, y, regs, W0)
        tt = tglm.SoftmaxRegressionWithLBFGS(4)
        tt.optimizer.set_num_iterations(8).set_device("cpu")
        tmodels, tres = tt.train_path(X, y, regs, W0)
        assert tres.weights.shape == (3, 7, 4)
        assert tmodels[0].weights.shape == (6, 4)
        assert tmodels[0].intercept.shape == (4,)
        assert_same_lanes(jres, tres)


# ---------------------------------------------------------------------------
# run_lbfgs_host_multi against the JAX host loop
# ---------------------------------------------------------------------------

HOST_REGS = [0.01, 0.1, 1.0]


def _host_objectives(loss, X, y, regs):
    """The same objective for both packages: a lane's smooth mean loss
    plus its ``SquaredL2Updater`` penalty."""
    jsm = jsmooth.make_smooth(jl.GRADIENTS[loss](), jnp.asarray(X),
                              jnp.asarray(y))

    def jobj(w, reg):
        f, g = jsm(w)
        pv, pg = jp.SquaredL2Updater().smooth_penalty(w, reg)
        return f + pv, jtvec.add(g, pg)

    def jmulti(W):
        return jax.vmap(jobj)(W, jnp.asarray(regs))

    tsm, _ = tsmooth.lanes_smooth(tl.GRADIENTS[loss](), torch.from_numpy(X),
                                  torch.from_numpy(y))

    def tmulti(W):
        fs, G = tsm(W)
        pen = [tp.SquaredL2Updater().smooth_penalty(W[k], r)
               for k, r in enumerate(regs)]
        return (fs + torch.stack([p[0] for p in pen]),
                torch.stack([G[k] + p[1] for k, p in enumerate(pen)]))

    return jmulti, tmulti


@pytest.mark.parametrize("loss", ["logistic", "least_squares"])
def test_host_multi_matches_the_jax_host_loop(loss):
    X, y, _ = _problem(loss, seed=8, n=280)
    d = X.shape[1]
    cfg_kw = dict(convergence_tol=1e-10, num_iterations=40)
    jmulti, tmulti = _host_objectives(loss, X, y, HOST_REGS)
    j = jhost.run_lbfgs_host_multi(jmulti, jnp.zeros((3, d)),
                                   jlbfgs.LBFGSConfig(**cfg_kw))
    t = thost.run_lbfgs_host_multi(tmulti, torch.zeros((3, d),
                                                       dtype=torch.float64),
                                   tlbfgs.LBFGSConfig(**cfg_kw))
    for f in ("num_iters", "num_fn_evals", "converged", "ls_failed",
              "aborted_non_finite", "ls_stop_reason"):
        np.testing.assert_array_equal(getattr(t, f),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert t.eval_rounds == j.eval_rounds
    assert t.loss_history.shape == j.loss_history.shape
    np.testing.assert_allclose(t.loss_history, j.loss_history, rtol=1e-9)
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights),
                               rtol=3e-7, atol=1e-12)
    np.testing.assert_allclose(t.grad_norm, j.grad_norm, rtol=1e-6)


def test_host_multi_lanes_equal_solo_host_runs():
    """The lock-step claim: each lane makes its solo host run's
    decisions, and the rounds are the most evaluations of any lane, not
    their sum."""
    X, y, _ = _problem("logistic", seed=9, n=280)
    d = X.shape[1]
    cfg = tlbfgs.LBFGSConfig(convergence_tol=1e-10, num_iterations=60)
    _, tmulti = _host_objectives("logistic", X, y, HOST_REGS)
    multi = thost.run_lbfgs_host_multi(
        tmulti, torch.zeros((3, d), dtype=torch.float64), cfg)
    sm = tsmooth.make_smooth(tl.LogisticGradient(), torch.from_numpy(X),
                             torch.from_numpy(y))
    total = 0
    for k, reg in enumerate(HOST_REGS):
        solo = thost.run_lbfgs_host(
            tlbfgs.make_objective(sm, tp.SquaredL2Updater(), reg),
            torch.zeros(d, dtype=torch.float64), cfg)
        assert int(multi.num_iters[k]) == solo.num_iters
        assert int(multi.num_fn_evals[k]) == solo.num_fn_evals
        assert bool(multi.converged[k]) == solo.converged
        np.testing.assert_allclose(
            multi.loss_history[k, :solo.num_iters + 1], solo.loss_history,
            rtol=1e-12)
        np.testing.assert_allclose(multi.weights[k].numpy(),
                                   solo.weights.numpy(), rtol=1e-10,
                                   atol=1e-14)
        total += solo.num_fn_evals
    assert multi.eval_rounds == int(np.max(multi.num_fn_evals)) < total


def test_solo_loop_is_the_lanes_generator():
    """One body of decisions: the solo loop drives the same generator the
    lanes run, so a one-lane ``run_lanes`` reproduces ``run_lbfgs`` bit
    for bit."""
    X, y, w0 = _problem("least_squares", seed=10)
    sm = tsmooth.make_smooth(tl.LeastSquaresGradient(), torch.from_numpy(X),
                             torch.from_numpy(y))
    obj = tlbfgs.make_objective(sm, tp.L2Prox(), 0.05)
    cfg = tlbfgs.LBFGSConfig(num_iterations=15, convergence_tol=1e-9)
    solo = tlbfgs.run_lbfgs(obj, torch.from_numpy(w0), cfg)

    def multi(W):
        f, g = obj(W[0])
        return f[None], g[None]

    lanes = tlbfgs.run_lbfgs_lanes(multi, torch.from_numpy(w0)[None], cfg)
    assert torch.equal(lanes.weights[0], solo.weights)
    assert np.array_equal(lanes.loss_history[0].numpy(),
                          solo.loss_history.numpy(), equal_nan=True)
    assert int(lanes.num_fn_evals[0]) == int(solo.num_fn_evals)
    assert lanes.eval_rounds == int(solo.num_fn_evals)
    assert tapi.make_lbfgs_sweep_runner is port.make_lbfgs_sweep_runner
