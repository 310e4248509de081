"""``mesh=`` through the port's entry points against the JAX package's, on
the CPU, at f64.

``run``, ``make_runner``, ``run_lbfgs``, ``AcceleratedGradientDescent``
(``set_mesh``), ``LBFGS``, ``run_minibatch_sgd``, the GLM trainers and a
``ShardedBatch`` passed as data run on a mesh of N CPU slots (N = 1, 2, 3,
8, rows not divisible by N) against the JAX package on a mesh of as many
virtual CPU devices: the same iteration, backtrack and restart counts,
histories within 1e-9 and weights within 3e-7 (the parity standard of
``tests/test_agd_core.py``).  The API's rules: ``mesh=None`` shards over
every visible card when there is more than one and no ``device=``; a
``ShardedBatch`` with another explicit mesh raises as the JAX package's
does; what the model-parallel slice brings (a model axis, the grid fits
over a mesh, the sharded update) raises naming it."""

import jax
import numpy as np
import pytest
import torch

from spark_agd_tpu import api as japi
from spark_agd_tpu.models import glm as jglm
from spark_agd_tpu.ops import losses as jlosses, prox as jprox
from spark_agd_tpu.parallel import mesh as jmesh
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch import api as tapi
from spark_agd_tpu_torch.models import glm as tglm
from spark_agd_tpu_torch.parallel import dist_smooth as tdist
from spark_agd_tpu_torch.parallel import mesh as tmesh

SLOTS = [1, 2, 3, 8]


def _meshes(n):
    return (jmesh.make_mesh({"data": n}, devices=jax.devices()[:n]),
            tmesh.make_mesh({"data": n}, devices=["cpu"] * n))


def _problem(seed, n=203, d=6, kind="logistic"):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    w_true = rng.standard_normal(d)
    if kind == "logistic":
        y = (rng.random(n) < 1 / (1 + np.exp(-X @ w_true))).astype(float)
    else:
        y = X @ w_true + 0.1 * rng.standard_normal(n)
    return X, y, rng.standard_normal(d) * 0.1


def _same(jres, tres, jh=None, th=None):
    n = int(jres.num_iters)
    assert int(tres.num_iters) == n
    assert int(tres.num_backtracks) == int(jres.num_backtracks)
    assert int(tres.num_restarts) == int(jres.num_restarts)
    assert bool(tres.converged) == bool(jres.converged)
    jh = np.asarray(jres.loss_history)[:n] if jh is None else jh
    th = tres.loss_history[:n].numpy() if th is None else th
    np.testing.assert_allclose(th, jh, rtol=1e-9)
    np.testing.assert_allclose(tres.weights.numpy(),
                               np.asarray(jres.weights), rtol=3e-7,
                               atol=1e-12)


# short enough to stay off the f64 loss floor, where a backtrack is
# decided by rounding (the order of the slots' sums differs from psum's)
CFG = dict(num_iterations=10, convergence_tol=1e-12, reg_param=0.05)


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("kind,upd", [("logistic", "l2"),
                                      ("least_squares", "l1"),
                                      ("hinge", "mllib_l2")])
def test_run_on_a_mesh_matches_jax(n, kind, upd):
    X, y, w0 = _problem(n, kind="least_squares" if kind == "least_squares"
                        else "logistic")
    jm, tm = _meshes(n)
    pj, pt = {"l2": (jprox.L2Prox(), port.L2Prox()),
              "l1": (jprox.L1Prox(), port.L1Prox()),
              "mllib_l2": (jprox.MLlibSquaredL2Updater(),
                           port.MLlibSquaredL2Updater())}[upd]
    jw, jh, jr = japi.run((X, y), jlosses.GRADIENTS[kind](), pj,
                          initial_weights=w0, mesh=jm, return_result=True,
                          **CFG)
    tdist.reset_counts()
    tw, th, tr = port.run((X, y), port.GRADIENTS[kind](), pt,
                          initial_weights=w0, mesh=tm, return_result=True,
                          **CFG)
    _same(jr, tr, jh, th)
    assert tdist.slot_evaluations == n * tdist.mesh_evaluations > 0


def test_backtracks_and_restarts_on_a_mesh_match_jax():
    X, y, w0 = _problem(9, kind="least_squares")
    jm, tm = _meshes(3)
    kw = dict(num_iterations=14, convergence_tol=0.0, l0=1e-3,
              initial_weights=w0, return_result=True)
    jr = japi.run((X, y), jlosses.LeastSquaresGradient(),
                  jprox.IdentityProx(), mesh=jm, **kw)[2]
    tr = port.run((X, y), port.LeastSquaresGradient(), port.IdentityProx(),
                  mesh=tm, **kw)[2]
    assert int(tr.num_backtracks) > 0 and int(tr.num_restarts) > 0
    _same(jr, tr)


@pytest.mark.parametrize("n", [2, 8])
def test_make_runner_and_the_optimizer_on_a_mesh(n):
    X, y, w0 = _problem(20 + n)
    jm, tm = _meshes(n)
    jfit = japi.make_runner((X, y), jlosses.LogisticGradient(),
                            jprox.L2Prox(), mesh=jm, **CFG)
    tfit = port.make_runner((X, y), port.LogisticGradient(), port.L2Prox(),
                            mesh=tm, **CFG)
    _same(jfit(w0), tfit(w0))
    assert torch.equal(tfit(w0).weights, tfit(w0).weights)
    opt = (port.AcceleratedGradientDescent(port.LogisticGradient(),
                                           port.L2Prox())
           .setRegParam(0.05).setNumIterations(10).setConvergenceTol(1e-12)
           .set_mesh(tm))
    jopt = (japi.AcceleratedGradientDescent(jlosses.LogisticGradient(),
                                            jprox.L2Prox())
            .setRegParam(0.05).setNumIterations(10)
            .setConvergenceTol(1e-12).set_mesh(jm))
    np.testing.assert_allclose(opt.optimize((X, y), w0).numpy(),
                               np.asarray(jopt.optimize((X, y), w0)),
                               rtol=3e-7, atol=1e-12)


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("upd", ["l2", "l1"])
def test_lbfgs_on_a_mesh_matches_jax(n, upd):
    X, y, w0 = _problem(30 + n)
    jm, tm = _meshes(n)
    pj, pt = ((jprox.L2Prox(), port.L2Prox()) if upd == "l2"
              else (jprox.L1Prox(), port.L1Prox()))
    kw = dict(num_iterations=12, reg_param=0.05, initial_weights=w0)
    jr = japi.run_lbfgs((X, y), jlosses.LogisticGradient(), pj, mesh=jm,
                        **kw)
    tr = port.run_lbfgs((X, y), port.LogisticGradient(), pt, mesh=tm, **kw)
    k = int(jr.num_iters)
    assert int(tr.num_iters) == k
    np.testing.assert_allclose(tr.loss_history[:k + 1].numpy(),
                               np.asarray(jr.loss_history)[:k + 1],
                               rtol=1e-9)
    np.testing.assert_allclose(tr.weights.numpy(), np.asarray(jr.weights),
                               rtol=3e-7, atol=1e-12)
    w = (port.LBFGS(port.LogisticGradient(), pt).set_mesh(tm)
         .setNumIterations(12).setRegParam(0.05).optimize((X, y), w0))
    assert torch.equal(w, tr.weights)


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_minibatch_sgd_on_a_mesh_matches_jax(n, fraction):
    X, y, w0 = _problem(50 + n)
    jm, tm = _meshes(n)
    kw = dict(step_size=0.5, num_iterations=12, reg_param=0.01,
              minibatch_fraction=fraction, initial_weights=w0, seed=3)
    jw, jh = japi.run_minibatch_sgd((X, y), jlosses.LogisticGradient(),
                                    jprox.L2Prox(), mesh=jm, **kw)
    tw, th = port.run_minibatch_sgd((X, y), port.LogisticGradient(),
                                    port.L2Prox(), mesh=tm, **kw)
    np.testing.assert_allclose(th, jh, rtol=1e-9)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=3e-7,
                               atol=1e-12)


@pytest.mark.parametrize("n", [1, 3])
def test_a_sharded_batch_as_data_matches_jax(n):
    X, y, w0 = _problem(60 + n, n=101)
    mask = (np.random.default_rng(n).random(101) < 0.9).astype(np.float64)
    jm, tm = _meshes(n)
    jb = jmesh.shard_batch(jm, X, y, mask)
    tb = tmesh.shard_batch(tm, X, y, mask)
    jr = japi.run(jb, jlosses.LogisticGradient(), jprox.L2Prox(),
                  initial_weights=w0, return_result=True, **CFG)[2]
    tr = port.run(tb, port.LogisticGradient(), port.L2Prox(),
                  initial_weights=w0, return_result=True, **CFG)[2]
    _same(jr, tr)
    # mesh=False gathers the batch onto one device
    tr1 = port.run(tb, port.LogisticGradient(), port.L2Prox(),
                   initial_weights=w0, return_result=True, mesh=False,
                   device="cpu", **CFG)[2]
    np.testing.assert_allclose(tr1.weights.numpy(), tr.weights.numpy(),
                               rtol=1e-9)
    # another explicit mesh raises, as the JAX package's does
    other_j, other_t = _meshes(2 if n != 2 else 3)
    with pytest.raises(ValueError, match="differs"):
        japi.run(jb, jlosses.LogisticGradient(), jprox.L2Prox(),
                 initial_weights=w0, mesh=other_j)
    with pytest.raises(ValueError, match="differs"):
        port.run(tb, port.LogisticGradient(), port.L2Prox(),
                 initial_weights=w0, mesh=other_t)


def test_glm_trainer_on_a_mesh_matches_jax():
    X, y, _ = _problem(70, n=150)
    jm, tm = _meshes(3)
    j = jglm.LogisticRegressionWithAGD(reg_param=0.01, mesh=jm)
    t = tglm.LogisticRegressionWithAGD(reg_param=0.01, mesh=tm)
    j.optimizer.setNumIterations(15)
    t.optimizer.setNumIterations(15)
    jm_, tm_ = j.train(X, y), t.train(X, y)
    np.testing.assert_allclose(tm_.weights.numpy(), np.asarray(jm_.weights),
                               rtol=3e-7, atol=1e-12)
    np.testing.assert_allclose(float(tm_.intercept), float(jm_.intercept),
                               rtol=3e-7, atol=1e-12)


def test_supervised_run_on_a_mesh_equals_the_plain_mesh_run():
    X, y, w0 = _problem(80)
    _, tm = _meshes(3)
    plain = port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                     initial_weights=w0, mesh=tm, **CFG)
    sup = port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                   initial_weights=w0, mesh=tm, resilience=True, **CFG)
    np.testing.assert_allclose(sup[1], plain[1], rtol=1e-12)
    assert torch.equal(sup[0], plain[0])


def test_mesh_none_shards_over_every_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    m = tapi._resolve_mesh(None)
    assert m.shape == {"data": 4}
    assert m.slots() == [torch.device("cuda", i) for i in range(4)]
    assert tapi._resolve_mesh(None, device="cuda:1") is None
    assert tapi._resolve_mesh(False) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tapi._resolve_mesh(None) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tapi._resolve_mesh(None) is None


def test_what_the_next_slice_brings_raises():
    X, y, w0 = _problem(90, n=40)
    _, tm = _meshes(2)
    mm = tmesh.make_mesh({"data": 2, "model": 2}, devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match="later slice"):
        port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                 initial_weights=w0, mesh=mm)
    for opt in (port.AcceleratedGradientDescent(port.LogisticGradient(),
                                                port.L2Prox()),
                port.LBFGS(port.LogisticGradient(), port.L2Prox())):
        with pytest.raises(NotImplementedError, match="model"):
            opt.set_mesh(mm)
        opt.set_mesh(tm)  # a data mesh is taken
    with pytest.raises(NotImplementedError, match="sharded_update"):
        port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                 initial_weights=w0, mesh=tm, sharded_update=True)
    with pytest.raises(NotImplementedError, match="grid"):
        port.sweep((X, y), port.LogisticGradient(), port.L2Prox(),
                   [0.1, 0.01], initial_weights=w0, mesh=tm)
    with pytest.raises(NotImplementedError, match="grid"):
        port.cross_validate((X, y), port.LogisticGradient(), port.L2Prox(),
                            [0.1], initial_weights=w0, mesh=tm)
    with pytest.raises(NotImplementedError, match="grid"):
        (port.LBFGS(port.LogisticGradient(), port.L2Prox()).set_mesh(tm)
         .sweep((X, y), [0.1], w0))
    with pytest.raises(NotImplementedError, match="grid"):
        port.sweep(tmesh.shard_batch(tm, X, y), port.LogisticGradient(),
                   port.L2Prox(), [0.1], initial_weights=w0)
    with pytest.raises(TypeError, match="Mesh"):
        port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                 initial_weights=w0, mesh="data")
    with pytest.raises(ValueError, match="lead device"):
        port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                 initial_weights=w0, mesh=tm, device="cuda:0")
    Xc = port.CSRMatrix.from_csr_arrays(np.arange(41), np.zeros(40),
                                        np.ones(40), 6, device="cpu")
    with pytest.raises(ValueError, match="dense"):
        port.run_minibatch_sgd((Xc, y), port.LogisticGradient(),
                               port.L2Prox(), initial_weights=w0, mesh=tm)
