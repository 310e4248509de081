"""The port's regularization path against the JAX package at f64.

``api.sweep``/``make_sweep_runner``/``sweep_warm_state`` and the
trainers' ``train_path`` run K fits in lock-step (``core.host_agd``)
where the JAX package ``vmap``s its fused loop; every lane must take the
JAX lane's path: the same ``num_iters``, ``num_backtracks`` and
``num_restarts``, loss histories within 1e-9 relative, weights within
3e-7 (the port's f64 parity standard, ``tests/test_agd_core.py:75-88``),
the diagnostics within 1e-5: the curvature estimate of L divides a dot
by a tiny ``‖x - y‖²``, which magnifies summation-order rounding, and the
lanes' dots sum in another order than the JAX lanes' batched ones (up
to 1.3e-6 seen on L; the solo loop's 1e-6 of ``test_torch_agd.py``
leaves no room for that).  Then
``run_agd_host_multi`` against the JAX host loop, as
``tests/test_host_multi.py`` pins it, and its warm segments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu import api as japi
from spark_agd_tpu.core import agd as jagd, host_agd as jhost
from spark_agd_tpu.ops import losses as jl, prox as jp, sparse as jsparse
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch import api as tapi
from spark_agd_tpu_torch.core import agd as tagd, host_agd as thost
from spark_agd_tpu_torch.core import smooth as tsmooth
from spark_agd_tpu_torch.models import glm as tglm
from spark_agd_tpu_torch.ops import losses as tl, prox as tp

REGS = [0.0, 0.05, 0.5]
UPDATERS = {
    "l2": (jp.L2Prox, tp.L2Prox),
    "mllib_l2": (jp.SquaredL2Updater, tp.SquaredL2Updater),
    "l1": (jp.L1Updater, tp.L1Updater),
    "elastic_net": (lambda: jp.ElasticNetProx(0.3),
                    lambda: tp.ElasticNetProx(0.3)),
}


def _problem(seed=0, n=300, d=12):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = (rng.random(n) < 1 / (1 + np.exp(-X[:, 0]))).astype(float)
    return X, y, np.zeros(d)


def assert_same_lanes(jr, tr, loss_rtol=1e-9, w_rtol=3e-7, diag_rtol=1e-5):
    """Every lane of two batched ``AGDResult``s took the same path."""
    for f in ("num_iters", "num_backtracks", "num_restarts", "converged",
              "aborted_non_finite", "final_bts"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)
    for f in ("loss_history", "diag_l", "diag_theta", "diag_step",
              "diag_restarted"):
        a, b = np.asarray(getattr(jr, f)), getattr(tr, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if a.dtype == np.bool_:
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(
                b, a, err_msg=f,
                rtol=loss_rtol if f == "loss_history" else diag_rtol)
    for f in ("weights", "final_z"):
        np.testing.assert_allclose(
            getattr(tr, f).numpy(), np.asarray(getattr(jr, f)),
            rtol=w_rtol, atol=1e-12, err_msg=f)
    for f in ("final_l", "final_theta"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)),
                                   rtol=diag_rtol, err_msg=f)


class TestSweep:
    @pytest.mark.parametrize("updater", sorted(UPDATERS))
    def test_lanes_match_the_jax_sweep(self, updater):
        X, y, w0 = _problem()
        ju, tu = UPDATERS[updater]
        regs = [0.01, 0.2] if updater == "l1" else REGS
        kw = dict(num_iterations=25, convergence_tol=1e-4,
                  initial_weights=w0)
        jr = japi.sweep((X, y), jl.LogisticGradient(), ju(), regs, **kw)
        tr = tapi.sweep((X, y), tl.LogisticGradient(), tu(), regs,
                        device="cpu", **kw)
        assert tr.weights.shape == (len(regs), 12)
        assert_same_lanes(jr, tr)

    def test_per_lane_convergence(self):
        """Lanes stop on their own: a strong strength converges first,
        and each lane's count is the JAX lane's."""
        X, y, w0 = _problem(1)
        kw = dict(num_iterations=40, convergence_tol=1e-3,
                  initial_weights=w0)
        jr = japi.sweep((X, y), jl.LogisticGradient(),
                        jp.SquaredL2Updater(), [0.0, 2.0], **kw)
        tr = tapi.sweep((X, y), tl.LogisticGradient(),
                        tp.SquaredL2Updater(), [0.0, 2.0], device="cpu",
                        **kw)
        iters = tr.num_iters.numpy()
        assert iters[0] != iters[1], "tolerance did not differentiate"
        assert_same_lanes(jr, tr)

    def test_sparse_sweep(self):
        rng = np.random.default_rng(2)
        n, d, npr = 200, 30, 5
        indptr = np.arange(n + 1) * npr
        indices = rng.integers(0, d, n * npr).astype(np.int32)
        values = rng.normal(size=n * npr)
        y = (rng.random(n) < 0.5).astype(float)
        Xj = jsparse.CSRMatrix.from_csr_arrays(indptr, indices, values, d,
                                               with_csc=True)
        Xt = port.CSRMatrix.from_csr_arrays(indptr, indices, values, d,
                                            device="cpu")
        kw = dict(num_iterations=8, convergence_tol=0.0,
                  initial_weights=np.zeros(d))
        jr = japi.sweep((Xj, y), jl.LogisticGradient(),
                        jp.SquaredL2Updater(), [0.0, 0.1], **kw)
        tr = tapi.sweep((Xt, y), tl.LogisticGradient(),
                        tp.SquaredL2Updater(), [0.0, 0.1], device="cpu",
                        **kw)
        assert_same_lanes(jr, tr)

    def test_lanes_equal_solo_runs_at_their_f32_strength(self):
        """The JAX sweep casts the grid to float32, so a lane is the solo
        ``run`` at ``float(np.float32(reg))``."""
        X, y, w0 = _problem(3)
        regs = [0.1, 0.3]
        tr = tapi.sweep((X, y), tl.LogisticGradient(), tp.L2Prox(), regs,
                        num_iterations=10, initial_weights=w0,
                        device="cpu")
        for k, reg in enumerate(regs):
            w, hist = tapi.run((X, y), tl.LogisticGradient(), tp.L2Prox(),
                               reg_param=float(np.float32(reg)),
                               num_iterations=10, initial_weights=w0,
                               device="cpu")
            assert int(tr.num_iters[k]) == len(hist)
            np.testing.assert_allclose(
                tr.loss_history[k, :len(hist)].numpy(), hist, rtol=1e-12)
            np.testing.assert_allclose(tr.weights[k].numpy(), w.numpy(),
                                       rtol=1e-9, atol=1e-12)

    def test_fused_gradient_sweep_on_the_cpu_matches_the_plain_one(self):
        """``FusedLogisticGradient`` on CPU tensors takes the lanes'
        plain version in f32; its lanes follow the plain f32 sweep within
        the kernels' tolerances (loss rtol 1e-5, weights 1e-4)."""
        X, y, w0 = _problem(4, n=200, d=8)
        X32, w32 = X.astype(np.float32), w0.astype(np.float32)
        kw = dict(num_iterations=8, convergence_tol=0.0,
                  initial_weights=w32, device="cpu")
        fused = tapi.sweep((X32, y), port.FusedLogisticGradient(),
                           tp.SquaredL2Updater(), REGS, **kw)
        plain = tapi.sweep((X32, y), tl.LogisticGradient(),
                           tp.SquaredL2Updater(), REGS, **kw)
        np.testing.assert_allclose(fused.loss_history.numpy(),
                                   plain.loss_history.numpy(), rtol=1e-5)
        np.testing.assert_allclose(fused.weights.numpy(),
                                   plain.weights.numpy(), rtol=1e-4,
                                   atol=1e-4)

    def test_rejects_bad_inputs(self):
        X, y, w0 = _problem()
        with pytest.raises(ValueError, match="initial_weights"):
            tapi.sweep((X, y), tl.LogisticGradient(),
                       tp.SquaredL2Updater(), REGS, device="cpu")
        with pytest.raises(ValueError, match="1-D"):
            tapi.sweep((X, y), tl.LogisticGradient(),
                       tp.SquaredL2Updater(), [[0.1]],
                       initial_weights=w0, device="cpu")
        with pytest.raises(NotImplementedError, match="mesh"):
            tapi.sweep((X, y), tl.LogisticGradient(),
                       tp.SquaredL2Updater(), REGS, initial_weights=w0,
                       device="cpu", mesh=object())


class TestTrainPath:
    def test_models_match_the_jax_path(self):
        from spark_agd_tpu.models import LogisticRegressionWithAGD as JLR

        X, y, _ = _problem(5)
        regs = [0.01, 0.3]
        jt = JLR()
        jt.optimizer.set_num_iterations(6).set_convergence_tol(0.0)
        jt.optimizer.set_mesh(False)
        w0 = np.zeros(13)  # f64: the trainers' default zeros are f32
        jmodels, jres = jt.train_path(X, y, regs, w0)
        tt = tglm.LogisticRegressionWithAGD()
        tt.optimizer.set_num_iterations(6).set_convergence_tol(0.0)
        tt.optimizer.set_device("cpu")
        tmodels, tres = tt.train_path(X, y, regs, w0)
        assert len(tmodels) == 2
        assert_same_lanes(jres, tres)
        for jm, tm in zip(jmodels, tmodels):
            assert type(tm).__name__ == type(jm).__name__
            np.testing.assert_allclose(tm.weights.numpy(),
                                       np.asarray(jm.weights), rtol=3e-7,
                                       atol=1e-12)
            assert tm.intercept == pytest.approx(jm.intercept, rel=3e-7,
                                                 abs=1e-12)
        preds = tmodels[0].predict(X)
        assert set(np.unique(preds.numpy())) <= {0.0, 1.0}

    def test_softmax_path(self):
        from spark_agd_tpu.models import SoftmaxRegressionWithAGD as JSR

        rng = np.random.default_rng(6)
        X = rng.standard_normal((120, 9))
        y = rng.integers(0, 4, 120)
        regs = [0.0, 0.1, 1.0]
        jt = JSR(4)
        jt.optimizer.set_num_iterations(3).set_convergence_tol(0.0)
        jt.optimizer.set_mesh(False)
        w0 = np.zeros((10, 4))  # f64: the trainers' default zeros are f32
        jmodels, jres = jt.train_path(X, y, regs, w0)
        tt = tglm.SoftmaxRegressionWithAGD(4)
        tt.optimizer.set_num_iterations(3).set_convergence_tol(0.0)
        tt.optimizer.set_device("cpu")
        tmodels, tres = tt.train_path(X, y, regs, w0)
        assert len(tmodels) == 3
        assert tmodels[0].weights.shape == (9, 4)
        assert tmodels[0].intercept.shape == (4,)
        assert tres.weights.shape == (3, 10, 4)
        assert_same_lanes(jres, tres)

    def test_identity_prox_grid_rejected(self):
        X, y, _ = _problem()
        t = tglm.LinearRegressionWithAGD()  # reg 0 froze IdentityProx
        t.optimizer.set_device("cpu")
        with pytest.raises(ValueError, match="IdentityProx"):
            t.train_path(X, y, [0.0, 0.1])
        with pytest.raises(ValueError, match="IdentityProx"):
            t.cross_validate(X, y, [0.0, 0.1])
        models, _ = t.train_path(X, y, [0.0])  # an all-zero grid is fine
        assert len(models) == 1


class TestSweepContinuation:
    def _runners(self, X, y, **kw):
        args = ((X, y), )
        j = lambda n: japi.make_sweep_runner(  # noqa: E731
            *args, jl.LogisticGradient(), jp.SquaredL2Updater(),
            num_iterations=n, **kw)
        t = lambda n: tapi.make_sweep_runner(  # noqa: E731
            *args, tl.LogisticGradient(), tp.SquaredL2Updater(),
            num_iterations=n, device="cpu", **kw)
        return j, t

    def test_two_segments_equal_one_run(self):
        X, y, w0 = _problem(7)
        regs = [0.01, 0.3]
        j, t = self._runners(X, y, convergence_tol=0.0)
        ref = t(8)(w0, regs)
        seg1 = t(4)(w0, regs)
        seg2 = t(4)(w0, regs, warm=tapi.sweep_warm_state(seg1))
        np.testing.assert_allclose(seg2.weights.numpy(),
                                   ref.weights.numpy(), rtol=1e-12,
                                   atol=1e-15)
        hist = np.concatenate([seg1.loss_history.numpy(),
                               seg2.loss_history.numpy()], axis=1)
        np.testing.assert_allclose(hist, ref.loss_history.numpy(),
                                   rtol=1e-12)
        jseg1 = j(4)(w0, regs)
        jseg2 = j(4)(w0, regs, warm=japi.sweep_warm_state(jseg1))
        assert_same_lanes(jseg2, seg2)

    def test_three_segments_accumulate_prior_iters(self):
        X, y, w0 = _problem(8)
        regs = [0.01, 0.3]
        j, t = self._runners(X, y, convergence_tol=0.0)
        ref = t(12)(w0, regs)
        seg1 = t(4)(w0, regs)
        warm1 = tapi.sweep_warm_state(seg1)
        seg2 = t(4)(w0, regs, warm=warm1)
        warm2 = tapi.sweep_warm_state(seg2, prior_iters=warm1.prior_iters)
        np.testing.assert_array_equal(warm2.prior_iters.numpy(), [8, 8])
        seg3 = t(4)(w0, regs, warm=warm2)
        np.testing.assert_allclose(seg3.weights.numpy(),
                                   ref.weights.numpy(), rtol=1e-12,
                                   atol=1e-15)

    def test_warm_keeps_per_lane_state_and_reruns_stopped_lanes(self):
        """Lanes carry their own (theta, L, bts); under a tolerance a lane
        that stopped in the first segment iterates again in the next, as
        the JAX sweep's warm runs do."""
        X, y, w0 = _problem(9)
        regs = [0.0, 1.0]
        j, t = self._runners(X, y, convergence_tol=2e-3, l0=1e-3)
        seg1 = t(30)(w0, regs)
        warm = tapi.sweep_warm_state(seg1)
        assert warm.big_l.shape == (2,)
        assert bool(seg1.converged.any())
        seg2 = t(5)(w0, regs, warm=warm)
        assert bool((seg2.num_iters > 0).all())
        jseg1 = j(30)(w0, regs)
        jseg2 = j(5)(w0, regs, warm=japi.sweep_warm_state(jseg1))
        assert_same_lanes(jseg1, seg1)
        assert_same_lanes(jseg2, seg2)


# ---------------------------------------------------------------------------
# run_agd_host_multi against the JAX host loop (tests/test_host_multi.py)
# ---------------------------------------------------------------------------

HOST_REGS = [0.0, 0.03, 0.4, 5.0]


def _jax_multi(X, y, g, updater, regs, w0, cfg, warm=None):
    Xd, yd = jnp.asarray(X), jnp.asarray(y)

    def smooth_multi(W):
        ls, gs, n = jax.vmap(lambda w: g.batch_loss_and_grad(w, Xd, yd))(W)
        nf = jnp.asarray(n[0], ls.dtype)
        return ls / nf, gs / nf

    def smooth_loss_multi(W):
        return smooth_multi(W)[0]

    pxm, rvm = jhost.make_prox_multi(updater, regs)
    W0 = jnp.stack([jnp.asarray(w0)] * len(regs))
    return jhost.run_agd_host_multi(smooth_multi, pxm, rvm, W0, cfg,
                                    smooth_loss_multi=smooth_loss_multi,
                                    warm=warm)


def _port_multi(X, y, g, updater, regs, w0, cfg, warm=None):
    sm, sl = tsmooth.lanes_smooth(g, torch.from_numpy(X),
                                  torch.from_numpy(y))
    pxm, rvm = thost.make_prox_multi(updater, regs)
    W0 = torch.stack([torch.from_numpy(w0)] * len(regs))
    return thost.run_agd_host_multi(sm, pxm, rvm, W0, cfg,
                                    smooth_loss_multi=sl, warm=warm)


def assert_same_multi(j, t):
    for f in ("num_iters", "num_backtracks", "num_restarts", "converged",
              "aborted_non_finite"):
        np.testing.assert_array_equal(np.asarray(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert t.loss_history.shape == np.asarray(j.loss_history).shape
    np.testing.assert_allclose(t.loss_history, np.asarray(j.loss_history),
                               rtol=1e-9)
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights),
                               rtol=3e-7, atol=1e-12)
    # near a solution the curvature estimate of L is a ratio of two
    # differences at the rounding level (1.3e-4 apart seen with l0 = 1e-3
    # on least squares while losses and weights agree to 1e-9)
    np.testing.assert_allclose(t.final_l, np.asarray(j.final_l), rtol=1e-3)


HOST_CASES = {
    "l2": ("logistic", jp.SquaredL2Updater, tp.SquaredL2Updater,
           dict(num_iterations=8, convergence_tol=0.0), True),
    "l1": ("logistic", jp.L1Updater, tp.L1Updater,
           dict(num_iterations=8, convergence_tol=0.0), True),
    "early_converging": ("logistic", jp.SquaredL2Updater,
                         tp.SquaredL2Updater,
                         dict(num_iterations=25, convergence_tol=3e-3),
                         False),
    "backtracking_restart": ("least_squares", jp.SquaredL2Updater,
                             tp.SquaredL2Updater,
                             dict(num_iterations=10, convergence_tol=0.0,
                                  l0=1e-3), True),
    "backtracking_off": ("logistic", jp.L1Updater, tp.L1Updater,
                         dict(num_iterations=6, convergence_tol=0.0,
                              beta=1.0), False),
    "x_strict": ("logistic", jp.SquaredL2Updater, tp.SquaredL2Updater,
                 dict(num_iterations=5, convergence_tol=0.0,
                      loss_mode="x_strict"), False),
    "y": ("logistic", jp.SquaredL2Updater, tp.SquaredL2Updater,
          dict(num_iterations=5, convergence_tol=0.0, loss_mode="y"),
          False),
    "l_cap": ("logistic", jp.SquaredL2Updater, tp.SquaredL2Updater,
              dict(num_iterations=7, convergence_tol=0.0, l_exact=2.0,
                   alpha=0.7), False),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_multi_lanes_match_the_jax_host_loop(case):
    loss, ju, tu, cfg_kw, random_w0 = HOST_CASES[case]
    rng = np.random.default_rng(11)
    X = rng.standard_normal((400, 7))
    y = (rng.random(400) < 0.5).astype(float)
    w0 = rng.normal(size=7) * 0.2 if random_w0 else np.zeros(7)
    j = _jax_multi(X, y, jl.GRADIENTS[loss](), ju(), HOST_REGS, w0,
                   jagd.AGDConfig(**cfg_kw))
    t = _port_multi(X, y, tl.GRADIENTS[loss](), tu(), HOST_REGS, w0,
                    tagd.AGDConfig(**cfg_kw))
    if case == "early_converging":
        assert len(set(t.num_iters.tolist())) > 1
    if case == "backtracking_restart":
        assert t.num_backtracks.sum() > 0
    assert_same_multi(j, t)
    # the port's diagnostics rows: NaN where a lane did not run
    ran = np.arange(t.loss_history.shape[0])[:, None] < t.num_iters
    assert np.isfinite(t.diag_l[ran]).all() and np.isnan(t.diag_l[~ran]).all()


def test_host_multi_warm_segments():
    """3 + 3 iterations equal 6; a lane that converged stays frozen
    across a warm boundary, with its history forward-filled; each
    segment equals the JAX host loop's."""
    rng = np.random.default_rng(12)
    X = rng.standard_normal((400, 7))
    y = (rng.random(400) < 0.5).astype(float)
    w0 = np.zeros(7)
    g, jg = tl.LogisticGradient(), jl.LogisticGradient()
    run = lambda cfg, warm=None: _port_multi(  # noqa: E731
        X, y, g, tp.SquaredL2Updater(), HOST_REGS, w0, cfg, warm)
    jrun = lambda cfg, warm=None: _jax_multi(  # noqa: E731
        X, y, jg, jp.SquaredL2Updater(), HOST_REGS, w0, cfg, warm)
    cfg3 = tagd.AGDConfig(num_iterations=3, convergence_tol=0.0)
    seg1 = run(cfg3)
    seg2 = run(cfg3, thost.multi_warm_state(seg1))
    full = run(tagd.AGDConfig(num_iterations=6, convergence_tol=0.0))
    np.testing.assert_allclose(seg2.weights.numpy(), full.weights.numpy(),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(
        np.vstack([seg1.loss_history, seg2.loss_history]),
        full.loss_history, rtol=1e-12)
    np.testing.assert_array_equal(seg2.num_backtracks, full.num_backtracks)
    np.testing.assert_array_equal(seg2.num_restarts, full.num_restarts)

    cfg = tagd.AGDConfig(num_iterations=12, convergence_tol=3e-3)
    jcfg = jagd.AGDConfig(num_iterations=12, convergence_tol=3e-3)
    seg1, jseg1 = run(cfg), jrun(jcfg)
    stopped = seg1.converged.copy()
    assert stopped.any(), "need an early stop"
    w_frozen = seg1.weights.numpy()[stopped].copy()
    cfg5 = tagd.AGDConfig(num_iterations=5, convergence_tol=3e-3)
    seg2 = run(cfg5, thost.multi_warm_state(seg1))
    jseg2 = jrun(jagd.AGDConfig(num_iterations=5, convergence_tol=3e-3),
                 jhost.multi_warm_state(jseg1))
    np.testing.assert_array_equal(seg2.weights.numpy()[stopped], w_frozen)
    assert np.all(seg2.num_iters[stopped] == 0)
    np.testing.assert_array_equal(seg2.loss_history[0][stopped],
                                  seg1.loss_history[-1][stopped])
    assert_same_multi(jseg1, seg1)
    assert_same_multi(jseg2, seg2)


def test_prox_lanes_keep_the_identity_lane_by_lane():
    """Every operator's K-lane form satisfies ``prox(w, g, 0, reg) == (w,
    reg_value(w, reg))`` lane by lane, and equals the solo form."""
    rng = np.random.default_rng(13)
    W = torch.from_numpy(rng.standard_normal((3, 5)))
    G = torch.from_numpy(rng.standard_normal((3, 5)))
    regs = torch.tensor([0.0, 0.2, 1.5])
    steps = torch.tensor([0.3, 0.1, 2.0], dtype=torch.float64)
    for name, cls in tp.PROXES.items():
        op = cls()
        W0, r0 = op.prox_lanes(W, G, torch.zeros(3, dtype=torch.float64),
                               regs)
        assert torch.equal(W0, W), name
        np.testing.assert_allclose(r0.numpy(),
                                   op.reg_value_lanes(W, regs).numpy(),
                                   rtol=1e-15, err_msg=name)
        W1, r1 = op.prox_lanes(W, G, steps, regs)
        for k in range(3):
            w, r = op.prox(W[k], G[k], float(steps[k]), float(regs[k]))
            np.testing.assert_allclose(W1[k].numpy(), w.numpy(), rtol=1e-15,
                                       atol=1e-15, err_msg=name)
            np.testing.assert_allclose(float(r1[k]), float(r), rtol=1e-14,
                                       err_msg=name)
