"""The port's streamed regularization paths (``api.streaming_sweep``,
``api.streaming_lbfgs_sweep``) against the JAX package's, on the CPU.

The same numpy stream, made from a seed, goes through both packages at
f64: every lane takes JAX's steps (the same counts, histories within
1e-9, weights within 3e-7, ``tests/test_agd_core.py``'s standard; the
L-BFGS lanes the same evaluation rounds).  One f32 case runs through
``FusedLogisticGradient`` (the lanes kernel's plain version on the CPU)
against ``PallasLogisticGradient(interpret=True)`` under JAX's
``vmap`` at the kernel tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_agd_tpu as jpkg
from spark_agd_tpu.data import streaming as jstreaming
from spark_agd_tpu.ops import losses as jl, prox as jp
from spark_agd_tpu.ops.pallas_kernels import PallasLogisticGradient
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.data import streaming
from spark_agd_tpu_torch.ops import losses as tl, prox as tp

REGS = [0.3, 0.03, 0.003]


def _stream(loss="logistic", n=500, d=6, seed=0, dtype=np.float64,
            batch_rows=96, sparse=False):
    rng = np.random.default_rng(seed)
    if sparse:
        counts = rng.integers(1, 6, n)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        indices = rng.integers(0, d, int(indptr[-1])).astype(np.int32)
        values = rng.normal(size=int(indptr[-1])).astype(dtype)
        y = (rng.random(n) < 0.5).astype(dtype)
        args = (indptr, indices, values, d, y, batch_rows)
        return (streaming.StreamingDataset.from_csr(*args),
                jstreaming.StreamingDataset.from_csr(*args), d)
    X = rng.standard_normal((n, d)).astype(dtype)
    w_true = rng.standard_normal(d)
    if loss == "least_squares":
        y = (X @ w_true + 0.1 * rng.standard_normal(n)).astype(dtype)
    else:
        y = (rng.random(n) < 1 / (1 + np.exp(-X @ w_true))).astype(dtype)
    return (streaming.StreamingDataset.from_arrays(X, y, batch_rows),
            jstreaming.StreamingDataset.from_arrays(X, y, batch_rows), d)


def _hold_agd_lanes(t, j):
    for f in ("num_iters", "num_backtracks", "num_restarts", "converged",
              "aborted_non_finite"):
        np.testing.assert_array_equal(np.asarray(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert t.loss_history.shape == np.asarray(j.loss_history).shape
    np.testing.assert_allclose(t.loss_history, np.asarray(j.loss_history),
                               rtol=1e-9)
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights),
                               rtol=3e-7, atol=1e-12)


AGD_CASES = {
    "logistic_l2": ("logistic", "SquaredL2Updater",
                    dict(num_iterations=12, convergence_tol=0.0), {}),
    "logistic_l1": ("logistic", "L1Updater",
                    dict(num_iterations=12, convergence_tol=0.0), {}),
    "early_converging": ("logistic", "SquaredL2Updater",
                         dict(num_iterations=30, convergence_tol=3e-3), {}),
    "least_squares_backtracking": (
        "least_squares", "SquaredL2Updater",
        dict(num_iterations=10, convergence_tol=0.0, l0=1e-3), {}),
    "pad_to": ("logistic", "SquaredL2Updater",
               dict(num_iterations=6, convergence_tol=0.0),
               dict(pad_to=96)),
    "loss_mode_y": ("logistic", "SquaredL2Updater",
                    dict(num_iterations=6, convergence_tol=0.0,
                         loss_mode="y"), {}),
    "backtracking_off": ("logistic", "L1Updater",
                         dict(num_iterations=6, convergence_tol=0.0,
                              beta=1.0), {}),
}


@pytest.mark.parametrize("case", sorted(AGD_CASES))
def test_streaming_sweep_matches_jax(case):
    loss, updater, cfg, extra = AGD_CASES[case]
    ds, jds, d = _stream(loss, seed=1)
    w0 = np.zeros(d)
    j = jpkg.streaming_sweep(jds, jl.GRADIENTS[loss](),
                             getattr(jp, updater)(), REGS,
                             initial_weights=jnp.asarray(w0), **cfg,
                             **extra)
    stats = []
    t = port.streaming_sweep(ds, tl.GRADIENTS[loss](),
                             getattr(tp, updater)(), REGS,
                             initial_weights=w0, device="cpu",
                             pass_stats=stats, **cfg, **extra)
    _hold_agd_lanes(t, j)
    if case == "early_converging":
        assert len(set(t.num_iters.tolist())) > 1
    if case == "least_squares_backtracking":
        assert t.num_backtracks.sum() > 0
    # every pass reads the whole stream once for all the lanes
    assert stats and all(s["rows"] == 500 and s["batches"] == 6
                         for s in stats)


def test_streaming_sweep_over_csr_matches_jax():
    ds, jds, d = _stream(sparse=True, seed=2, d=23)
    cfg = dict(num_iterations=8, convergence_tol=0.0)
    j = jpkg.streaming_sweep(jds, jl.LogisticGradient(), jp.L2Prox(), REGS,
                             initial_weights=jnp.zeros(d), **cfg)
    t = port.streaming_sweep(ds, tl.LogisticGradient(), tp.L2Prox(), REGS,
                             initial_weights=np.zeros(d), device="cpu",
                             **cfg)
    _hold_agd_lanes(t, j)


def test_streaming_sweep_lanes_equal_solo_streamed_runs():
    """A lane of the path is the solo host run at its strength."""
    ds, _, d = _stream(seed=3)
    cfg = dict(num_iterations=10, convergence_tol=0.0)
    t = port.streaming_sweep(ds, tl.LogisticGradient(),
                             tp.SquaredL2Updater(), REGS,
                             initial_weights=np.zeros(d), device="cpu",
                             **cfg)
    sm, sl = streaming.make_streaming_smooth(tl.LogisticGradient(), ds,
                                             device="cpu")
    from spark_agd_tpu_torch.core import smooth as tsmooth

    for k, reg in enumerate(REGS):
        px, rv = tsmooth.make_prox(tp.SquaredL2Updater(), reg)
        solo = port.run_agd_host(sm, px, rv,
                                 torch.zeros(d, dtype=torch.float64),
                                 port.AGDConfig(**cfg), smooth_loss=sl)
        assert solo.num_iters == int(t.num_iters[k])
        np.testing.assert_allclose(t.loss_history[:, k], solo.loss_history,
                                   rtol=1e-12)
        np.testing.assert_allclose(t.weights[k].numpy(),
                                   solo.weights.numpy(), rtol=1e-9,
                                   atol=1e-14)


@pytest.mark.parametrize("loss", ["logistic", "least_squares"])
def test_streaming_lbfgs_sweep_matches_jax(loss):
    ds, jds, d = _stream(loss, seed=4)
    cfg = dict(num_iterations=20, convergence_tol=1e-10)
    j = jpkg.streaming_lbfgs_sweep(jds, jl.GRADIENTS[loss](),
                                   jp.SquaredL2Updater(), REGS,
                                   initial_weights=jnp.zeros(d), **cfg)
    stats = []
    t = port.streaming_lbfgs_sweep(ds, tl.GRADIENTS[loss](),
                                   tp.SquaredL2Updater(), REGS,
                                   initial_weights=np.zeros(d),
                                   device="cpu", pass_stats=stats, **cfg)
    for f in ("num_iters", "num_fn_evals", "converged", "ls_failed",
              "aborted_non_finite", "ls_stop_reason"):
        np.testing.assert_array_equal(np.asarray(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert t.eval_rounds == j.eval_rounds == len(stats) > 0
    assert t.loss_history.shape == np.asarray(j.loss_history).shape
    np.testing.assert_allclose(t.loss_history, np.asarray(j.loss_history),
                               rtol=1e-9)
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights),
                               rtol=3e-7, atol=1e-12)


def test_streaming_lbfgs_sweep_guards_as_in_jax():
    ds, jds, d = _stream(seed=5, n=50)
    w0 = np.zeros(d)
    for pkg, data, prox_mod in ((jpkg, jds, jp), (port, ds, tp)):
        kw = dict(initial_weights=w0)
        if pkg is port:
            kw["device"] = "cpu"
        with pytest.raises(ValueError, match="IdentityProx"):
            pkg.streaming_lbfgs_sweep(data, tl.LogisticGradient()
                                      if pkg is port
                                      else jl.LogisticGradient(),
                                      prox_mod.IdentityProx(), REGS, **kw)
        with pytest.raises(ValueError):
            pkg.streaming_lbfgs_sweep(data, tl.LogisticGradient()
                                      if pkg is port
                                      else jl.LogisticGradient(),
                                      prox_mod.L1Updater(), REGS, **kw)
    with pytest.raises(ValueError, match="initial_weights"):
        port.streaming_sweep(ds, tl.LogisticGradient(), tp.L2Prox(), REGS,
                             device="cpu")
    with pytest.raises(ValueError, match="initial_weights"):
        port.streaming_lbfgs_sweep(ds, tl.LogisticGradient(), tp.L2Prox(),
                                   REGS, device="cpu")
    # a mesh= that is not a Mesh raises (a real mesh runs:
    # tests/test_torch_grid_mesh.py)
    for fn in (port.streaming_sweep, port.streaming_lbfgs_sweep):
        with pytest.raises(TypeError, match="Mesh"):
            fn(ds, tl.LogisticGradient(), tp.L2Prox(), REGS,
               initial_weights=w0, device="cpu", mesh=object())


def test_fused_streaming_sweep_at_f32_matches_pallas_under_vmap():
    ds, jds, d = _stream(seed=6, d=12, dtype=np.float32)
    cfg = dict(num_iterations=6, convergence_tol=0.0)
    w0 = np.zeros(d, np.float32)
    j = jpkg.streaming_sweep(jds, PallasLogisticGradient(interpret=True),
                             jp.SquaredL2Updater(), REGS,
                             initial_weights=jnp.asarray(w0), **cfg)
    t = port.streaming_sweep(ds, port.FusedLogisticGradient(),
                             tp.SquaredL2Updater(), REGS,
                             initial_weights=w0, device="cpu", **cfg)
    assert t.weights.dtype == torch.float32
    np.testing.assert_array_equal(t.num_iters, np.asarray(j.num_iters))
    np.testing.assert_allclose(t.loss_history, np.asarray(j.loss_history),
                               rtol=1e-5)
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights),
                               rtol=1e-4, atol=1e-4)
    # the fused lanes and the plain lanes over the same stream
    plain = port.streaming_sweep(ds, tl.LogisticGradient(),
                                 tp.SquaredL2Updater(), REGS,
                                 initial_weights=w0, device="cpu", **cfg)
    np.testing.assert_allclose(t.loss_history, plain.loss_history,
                               rtol=1e-5)


@pytest.mark.parametrize("name", [
    "streaming_sweep", "streaming_lbfgs_sweep", "StreamingDataset",
    "make_streaming_smooth", "make_streaming_eval_multi", "obs"])
def test_streamed_plane_is_exported_as_in_the_jax_package(name):
    assert hasattr(port, name) and hasattr(jpkg, name), name


def test_streaming_builders_take_every_keyword_of_the_jax_ones():
    import inspect

    for name in ("make_streaming_smooth", "make_streaming_eval_multi",
                 "fold_stream", "iter_csr_batches"):
        jparams = inspect.signature(getattr(jstreaming, name)).parameters
        tparams = inspect.signature(getattr(streaming, name)).parameters
        assert [p for p in jparams if p not in tparams] == [], name
    jparams = inspect.signature(
        jstreaming.StreamingDataset.from_libsvm_parts).parameters
    tparams = inspect.signature(
        streaming.StreamingDataset.from_libsvm_parts).parameters
    assert list(jparams) == list(tparams)


@pytest.mark.parametrize("sweep", ["streaming_sweep",
                                   "streaming_lbfgs_sweep"])
def test_a_streaming_sweep_stages_through_one_placer(monkeypatch, sweep):
    """The evaluators a sweep builds (with and without the gradient)
    share one placer: on the card, one ring of pinned staging buffers."""
    made = []
    real = streaming._make_placer

    def counting(*args, **kwargs):
        made.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(streaming, "_make_placer", counting)
    ds, _, d = _stream(seed=6)
    extra = dict(beta=1.0) if sweep == "streaming_sweep" else {}
    stats = []
    getattr(port, sweep)(ds, tl.LogisticGradient(), tp.SquaredL2Updater(),
                         REGS, num_iterations=3, convergence_tol=0.0,
                         initial_weights=np.zeros(d), device="cpu",
                         pass_stats=stats, **extra)
    assert len(made) == 1
    assert len(stats) > 3 and all(s["rows"] == 500 for s in stats)
