"""The port's K-fold cross-validation against the JAX package.

``api.cross_validate``/``make_cv_runner`` run the ``n_folds x
len(reg_params)`` fits as lanes in lock-step, each under an (N, K) mask
column, where the JAX package ``vmap``s its fused loop.  At f64 every
lane takes the JAX lane's path (``test_torch_sweep.assert_same_lanes``
tolerances) and the held-out losses agree within 1e-9; the fold ids are
JAX's draw bit for bit (``core.prng.permutation``: one, two and three
sort rounds at 1,000, 5,000 and 3,000,000 rows)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu import api as japi
from spark_agd_tpu.models import evaluation as jeval
from spark_agd_tpu.ops import losses as jl, prox as jp, sparse as jsparse
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch import api as tapi
from spark_agd_tpu_torch.models import evaluation as teval, glm as tglm
from spark_agd_tpu_torch.ops import losses as tl, prox as tp

from test_torch_sweep import assert_same_lanes


def _problem(seed=0, n=400, d=10):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    w_true = rng.standard_normal(d)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ w_true))).astype(float)
    return X, y, np.zeros(d)


def _pair(data_j, data_t, regs, **kw):
    jcv = japi.cross_validate(data_j, jl.LogisticGradient(),
                              jp.SquaredL2Updater(), regs, **kw)
    tcv = tapi.cross_validate(data_t, tl.LogisticGradient(),
                              tp.SquaredL2Updater(), regs, device="cpu",
                              **kw)
    return jcv, tcv


def assert_same_cv(jcv, tcv):
    np.testing.assert_array_equal(tcv.fold_ids.numpy(),
                                  np.asarray(jcv.fold_ids))
    np.testing.assert_array_equal(tcv.base_mask.numpy(),
                                  np.asarray(jcv.base_mask))
    np.testing.assert_allclose(tcv.val_loss.numpy(),
                               np.asarray(jcv.val_loss), rtol=1e-9)
    np.testing.assert_allclose(tcv.mean_val_loss.numpy(),
                               np.asarray(jcv.mean_val_loss), rtol=1e-9)
    assert int(tcv.best_index) == int(jcv.best_index)
    f, r = tcv.val_loss.shape
    flat = lambda res: type(res)(*(  # noqa: E731
        a.reshape((f * r,) + tuple(a.shape[2:])) for a in res))
    assert_same_lanes(flat(jcv.train_result), flat(tcv.train_result))


@pytest.mark.parametrize("n", [1_000, 5_000, 3_000_000])
def test_fold_ids_are_the_jax_draw(n):
    """One sort round up to 1,625 rows, two up to 2,642,245, three past
    that: the assignment of ``api.py:836-843`` bit for bit."""
    perm = np.asarray(
        __import__("jax").random.permutation(
            __import__("jax").random.PRNGKey(7), n))
    want = np.zeros(n, np.int32)
    want[perm] = np.arange(n) % 5
    got = tapi.fold_assignment(n, 5, 7, "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


class TestCrossValidate:
    def test_lanes_match_the_jax_cv(self):
        X, y, w0 = _problem()
        jcv, tcv = _pair((X, y), (X, y), [0.01, 0.2], n_folds=3,
                         num_iterations=8, convergence_tol=1e-4,
                         initial_weights=w0, seed=3)
        assert tcv.val_loss.shape == (3, 2)
        assert tcv.train_result.weights.shape == (3, 2, 10)
        assert_same_cv(jcv, tcv)

    def test_sparse_input(self):
        rng = np.random.default_rng(1)
        n, d, npr = 240, 20, 4
        indptr = np.arange(n + 1) * npr
        indices = rng.integers(0, d, n * npr).astype(np.int32)
        values = rng.normal(size=n * npr)
        y = (rng.random(n) < 0.5).astype(float)
        Xj = jsparse.CSRMatrix.from_csr_arrays(indptr, indices, values, d,
                                               with_csc=True)
        Xt = port.CSRMatrix.from_csr_arrays(indptr, indices, values, d,
                                            device="cpu")
        jcv, tcv = _pair((Xj, y), (Xt, y), [0.05, 0.5], n_folds=2,
                         num_iterations=5, convergence_tol=0.0,
                         initial_weights=np.zeros(d))
        assert_same_cv(jcv, tcv)

    def test_base_mask_excluded_everywhere(self):
        """Rows masked out in the input influence neither training nor
        validation: a lane equals the solo run under its train mask, and
        its held-out loss the manual one."""
        X, y, w0 = _problem(2)
        keep = np.ones(400)
        keep[350:] = 0.0
        jcv, tcv = _pair((X, y, keep), (X, y, keep), [0.1], n_folds=3,
                         num_iterations=4, convergence_tol=0.0,
                         initial_weights=w0, seed=5)
        assert_same_cv(jcv, tcv)
        ids = tcv.fold_ids.numpy()
        for f in range(3):
            w, _ = tapi.run((X, y, keep * (ids != f)), tl.LogisticGradient(),
                            tp.SquaredL2Updater(),
                            reg_param=float(np.float32(0.1)),
                            num_iterations=4, convergence_tol=0.0,
                            initial_weights=w0, device="cpu")
            np.testing.assert_allclose(tcv.train_result.weights[f, 0].numpy(),
                                       w.numpy(), rtol=1e-9, atol=1e-12)
            val = keep * (ids == f)
            ls, _, cnt = tl.LogisticGradient().batch_loss_and_grad(
                w, torch.from_numpy(X), torch.from_numpy(y),
                torch.from_numpy(val))
            assert float(tcv.val_loss[f, 0]) == pytest.approx(
                float(ls) / float(cnt), rel=1e-9)

    def test_masked_out_fold_reads_nan(self):
        X, y, w0 = _problem(3)
        kw = dict(n_folds=4, num_iterations=2, convergence_tol=0.0,
                  initial_weights=w0, seed=2)
        ids = tapi.fold_assignment(400, 4, 2, "cpu").numpy()
        keep = (ids != 1).astype(float)  # the base mask empties fold 1
        jcv, tcv = _pair((X, y, keep), (X, y, keep), [0.1, 1.0], **kw)
        v = tcv.val_loss.numpy()
        assert np.isnan(v[1]).all()
        assert np.isfinite(v[[0, 2, 3]]).all()
        assert np.isfinite(tcv.mean_val_loss.numpy()).all()
        assert_same_cv(jcv, tcv)

    def test_best_index_matches_jax_on_a_strength_with_no_valid_fold(self):
        """``mean_val_loss`` is a ``nanmean``; a strength whose folds are
        all NaN (a NaN strength: every lane's fit goes non-finite) stays
        NaN, and ``best_index`` is JAX's ``jnp.argmin``, which takes the
        first NaN entry; the trainers then refuse to refit it, in both
        packages."""
        X, y, w0 = _problem(4)
        kw = dict(n_folds=3, num_iterations=3, convergence_tol=0.0,
                  initial_weights=w0, seed=2)
        regs = [0.1, np.nan, 1.0]
        jcv, tcv = _pair((X, y), (X, y), regs, **kw)
        assert np.isnan(tcv.val_loss[:, 1].numpy()).all()
        np.testing.assert_array_equal(np.isnan(tcv.mean_val_loss.numpy()),
                                      np.isnan(np.asarray(jcv.mean_val_loss)))
        assert int(tcv.best_index) == int(jcv.best_index) == 1
        v = torch.tensor([2.0, np.nan, 1.0, np.nan])
        assert int(tapi._nan_first_argmin(v)) == int(jnp.argmin(
            jnp.asarray(v.numpy()))) == 1
        assert int(tapi._nan_first_argmin(v[[0, 2]])) == 1
        from spark_agd_tpu.models import LogisticRegressionWithAGD as JLR

        jt = JLR(add_intercept=False)
        jt.optimizer.set_num_iterations(3).set_mesh(False)
        tt = tglm.LogisticRegressionWithAGD(add_intercept=False)
        tt.optimizer.set_num_iterations(3).set_device("cpu")
        with pytest.raises(ValueError) as jerr:
            jt.cross_validate(X, y, regs, n_folds=3, seed=2)
        with pytest.raises(ValueError) as terr:
            tt.cross_validate(X, y, regs, n_folds=3, seed=2)
        assert str(terr.value) == str(jerr.value)

    def test_rejects_bad_inputs(self):
        X, y, w0 = _problem()
        g, u = tl.LogisticGradient(), tp.SquaredL2Updater()
        with pytest.raises(ValueError, match="initial_weights"):
            tapi.cross_validate((X, y), g, u, [0.1], device="cpu")
        with pytest.raises(ValueError, match="n_folds"):
            tapi.cross_validate((X, y), g, u, [0.1], n_folds=1,
                                initial_weights=w0, device="cpu")
        # a fused gradient's staged X: the JAX message for Pallas layouts
        with pytest.raises(ValueError, match="prepare"):
            tapi.cross_validate((X, y), port.FusedLogisticGradient(), u,
                                [0.1], initial_weights=w0, device="cpu")
        # a mesh= that is not a Mesh raises in both packages (JAX an
        # AttributeError reading its shape, the port a TypeError naming
        # the Mesh it takes); a real mesh computes (test_torch_grid_mesh)
        with pytest.raises(AttributeError):
            japi.cross_validate((X, y), jl.LogisticGradient(),
                                jp.SquaredL2Updater(), [0.1],
                                initial_weights=w0, mesh=object())
        with pytest.raises(TypeError, match="Mesh"):
            tapi.cross_validate((X, y), g, u, [0.1], initial_weights=w0,
                                device="cpu", mesh=object())

    def test_optimizer_method_forwards_config(self):
        X, y, w0 = _problem(4)
        opt = (port.AcceleratedGradientDescent(tl.LogisticGradient(),
                                               tp.SquaredL2Updater())
               .set_num_iterations(3).set_convergence_tol(0.0)
               .set_device("cpu"))
        got = opt.cross_validate((X, y), [0.1, 0.5], w0, n_folds=2, seed=9)
        want = tapi.cross_validate(
            (X, y), tl.LogisticGradient(), tp.SquaredL2Updater(),
            [0.1, 0.5], n_folds=2, num_iterations=3, convergence_tol=0.0,
            initial_weights=w0, seed=9, device="cpu")
        assert torch.equal(got.val_loss, want.val_loss)
        assert int(got.best_index) == int(want.best_index)
        fit = tapi.make_cv_runner((X, y), tl.LogisticGradient(),
                                  tp.SquaredL2Updater(), n_folds=2,
                                  num_iterations=3, convergence_tol=0.0,
                                  seed=9, device="cpu")
        assert torch.equal(fit(w0, [0.1, 0.5]).val_loss, want.val_loss)


class TestTrainerCV:
    def test_refit_on_best_matches_jax(self):
        from spark_agd_tpu.models import LogisticRegressionWithAGD as JLR

        X, y, _ = _problem(5)
        regs = [1e-3, 0.1, 1.0]
        jt = JLR()
        jt.optimizer.set_num_iterations(4).set_convergence_tol(0.0)
        jt.optimizer.set_mesh(False)
        jmodel, jcv = jt.cross_validate(X, y, regs, n_folds=3, seed=1)
        tt = tglm.LogisticRegressionWithAGD()
        tt.optimizer.set_num_iterations(4).set_convergence_tol(0.0)
        tt.optimizer.set_device("cpu").set_reg_param(0.7)
        tmodel, tcv = tt.cross_validate(X, y, regs, n_folds=3, seed=1)
        assert int(tcv.best_index) == int(jcv.best_index)
        np.testing.assert_array_equal(tcv.fold_ids.numpy(),
                                      np.asarray(jcv.fold_ids))
        # the trainers' default weights are f32: f32 tolerances
        np.testing.assert_allclose(tcv.val_loss.numpy(),
                                   np.asarray(jcv.val_loss), rtol=1e-5)
        np.testing.assert_allclose(tmodel.weights.numpy(),
                                   np.asarray(jmodel.weights), rtol=1e-4,
                                   atol=1e-5)
        # the refit is a plain train at the winner; the seat's own
        # strength is restored
        assert tt.optimizer._reg_param == 0.7
        tt.optimizer.set_reg_param(regs[int(tcv.best_index)])
        ref = tt.train(X, y)
        assert torch.equal(tmodel.weights, ref.weights)
        model, _ = tt.cross_validate(X, y, regs, n_folds=3, refit=False)
        assert model is None

    def test_no_finite_score_refuses_to_refit(self, monkeypatch):
        X, y, _ = _problem(6)
        tt = tglm.LogisticRegressionWithAGD()
        tt.optimizer.set_num_iterations(2).set_device("cpu")
        monkeypatch.setattr(tapi, "_mean_loss",
                            lambda g, W, X, y, m: torch.full(
                                (tl._lane_counts(X, m, W.shape[0]).shape),
                                float("nan"), dtype=torch.float64))
        with pytest.raises(ValueError, match="no finite validation"):
            tt.cross_validate(X, y, [0.1, 1.0], n_folds=2)

    def test_lbfgs_seat_errors_match_jax(self):
        from spark_agd_tpu.models import LogisticRegressionWithLBFGS as JLB

        X, y, _ = _problem(7, n=40, d=3)
        with pytest.raises(ValueError) as jerr:
            JLB().cross_validate(X, y, [0.1])
        t = tglm.LogisticRegressionWithLBFGS()
        t.optimizer.set_device("cpu")
        with pytest.raises(ValueError) as terr:
            t.cross_validate(X, y, [0.1])
        assert str(terr.value) == str(jerr.value)
        # the L-BFGS lanes are ported: the LBFGS seat's path runs
        models, res = t.train_path(X, y, [0.1, 0.01])
        assert len(models) == 2 and res.loss_history.shape[0] == 2


def test_cv_validation_scores_match_jax():
    """Any metric over the lanes: held-out AUC per (fold, strength),
    default margins and a custom ``predict_fn``, with a base mask."""
    X, y, w0 = _problem(8)
    keep = np.ones(400)
    keep[::7] = 0.0
    regs = [0.01, 1.0]
    jcv, tcv = _pair((X, y, keep), (X, y, keep), regs, n_folds=3,
                     num_iterations=4, convergence_tol=0.0,
                     initial_weights=w0, seed=4)
    jper, jmean = jeval.cv_validation_scores(jcv, jnp.asarray(X), y,
                                             score_fn=jeval.roc_auc)
    tper, tmean = teval.cv_validation_scores(tcv, X, y,
                                             score_fn=teval.roc_auc)
    assert tper.shape == (3, 2) and tmean.shape == (2,)
    np.testing.assert_allclose(tper.numpy(), np.asarray(jper), rtol=1e-6)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-6)
    Xt = torch.from_numpy(X)
    tper2, _ = teval.cv_validation_scores(
        tcv, None, y, score_fn=teval.roc_auc,
        predict_fn=lambda w: -(Xt @ w))
    np.testing.assert_allclose(tper2.numpy(), 1.0 - tper.numpy(),
                               rtol=1e-6)
