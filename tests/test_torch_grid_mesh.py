"""The grid fits over a mesh (``parallel/grid.py``) against the JAX
package's, on the CPU.

The same numpy problems go to the JAX package on a mesh of 8 virtual CPU
devices and to the port on 8 CPU slots (and 2 and 3; 300 rows, not
divisible): the mesh sweep (dense, CSR, a ``ShardedBatch``, a warm
continuation), cross-validation over a mesh (its fold ids, base masks,
CSR folds through the balancer's permutation by the extras channel), the
extras channel and ``shard_row_array`` themselves, and the mesh L-BFGS
sweep.  At f64 every lane has JAX's ``num_iters`` and its loss history
within 1e-9; at f32 the mesh paths' ``_RTOL``/``_ATOL``.  The fused
gradient's lanes run one ``lanes_loss_and_grad`` call a slot a round."""

import jax
import numpy as np
import pytest
import torch

from spark_agd_tpu import api as japi
from spark_agd_tpu.ops import losses as jl, prox as jp, sparse as jsparse
from spark_agd_tpu.parallel import grid as jgrid, mesh as jmesh
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.ops import losses as tl, prox as tp
from spark_agd_tpu_torch.ops.sparse import CSRMatrix
from spark_agd_tpu_torch.parallel import dist_smooth as tdist
from spark_agd_tpu_torch.parallel import grid as tgrid, mesh as tmesh

REGS = [0.001, 0.1, 1.0]
_RTOL, _ATOL = 1e-5, 1e-7  # __graft_entry__.py:28-29


def _meshes(n=8):
    return (jmesh.make_mesh({"data": n}, devices=jax.devices()[:n]),
            tmesh.make_mesh({"data": n}, devices=["cpu"] * n))


def _problem(seed=0, n=300, d=12, dtype=np.float64):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(dtype)
    y = (rng.random(n) < 0.5).astype(dtype)
    return X, y, np.zeros(d, dtype)


def _csr_problem(seed=1, n=200, d=8, npr=3):
    rng = np.random.default_rng(seed)
    indptr = np.arange(n + 1) * npr
    indices = rng.integers(0, d, n * npr).astype(np.int32)
    values = rng.normal(size=n * npr)
    y = (rng.random(n) < 0.5).astype(np.float64)
    return (jsparse.CSRMatrix.from_csr_arrays(indptr, indices, values, d,
                                              with_csc=True),
            CSRMatrix.from_csr_arrays(indptr, indices, values, d,
                                      device="cpu"), y)


def _same_lanes(tres, jres, rtol=1e-9, atol=0.0):
    np.testing.assert_array_equal(tres.num_iters.numpy(),
                                  np.asarray(jres.num_iters))
    np.testing.assert_allclose(tres.loss_history.numpy(),
                               np.asarray(jres.loss_history), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(tres.weights.numpy(),
                               np.asarray(jres.weights),
                               rtol=max(rtol, 3e-7), atol=max(atol, 1e-12))


@pytest.mark.parametrize("n", [2, 3, 8])
def test_mesh_sweep_matches_jax(n):
    X, y, w0 = _problem()
    jm, tm = _meshes(n)
    kw = dict(num_iterations=5, convergence_tol=0.0, initial_weights=w0)
    jr = japi.sweep((X, y), jl.LogisticGradient(), jp.SquaredL2Updater(),
                    REGS, mesh=jm, **kw)
    tdist.reset_counts()
    tr = port.sweep((X, y), tl.LogisticGradient(), tp.SquaredL2Updater(),
                    REGS, mesh=tm, **kw)
    _same_lanes(tr, jr)
    # one lanes call a slot a round: slots x rounds
    assert tdist.slot_evaluations == n * tdist.mesh_evaluations


def test_even_split_no_mask_and_l1():
    X, y, w0 = _problem(seed=2, n=320, d=6)
    jm, tm = _meshes()
    kw = dict(num_iterations=4, convergence_tol=0.0, initial_weights=w0)
    jr = japi.sweep((X, y), jl.LogisticGradient(), jp.L1Updater(),
                    [0.01, 0.2], mesh=jm, **kw)
    tr = port.sweep((X, y), tl.LogisticGradient(), tp.L1Updater(),
                    [0.01, 0.2], mesh=tm, **kw)
    _same_lanes(tr, jr)


def test_f32_sweep_within_the_mesh_tolerances():
    X, y, w0 = _problem(seed=3, dtype=np.float32)
    jm, tm = _meshes()
    kw = dict(num_iterations=5, convergence_tol=0.0, initial_weights=w0)
    jr = japi.sweep((X, y), jl.LogisticGradient(), jp.SquaredL2Updater(),
                    REGS, mesh=jm, **kw)
    tr = port.sweep((X, y), tl.LogisticGradient(), tp.SquaredL2Updater(),
                    REGS, mesh=tm, **kw)
    _same_lanes(tr, jr, rtol=_RTOL, atol=_ATOL)


def test_sharded_batch_brings_its_mesh():
    X, y, w0 = _problem(seed=4)
    jm, tm = _meshes()
    kw = dict(num_iterations=3, convergence_tol=0.0, initial_weights=w0)
    jr = japi.sweep(jmesh.shard_batch(jm, X, y), jl.LogisticGradient(),
                    jp.SquaredL2Updater(), REGS, **kw)
    tr = port.sweep(tmesh.shard_batch(tm, X, y), tl.LogisticGradient(),
                    tp.SquaredL2Updater(), REGS, **kw)
    _same_lanes(tr, jr)


def test_csr_mesh_sweep_matches_jax():
    jX, tX, y = _csr_problem()
    jm, tm = _meshes()
    kw = dict(num_iterations=4, convergence_tol=0.0,
              initial_weights=np.zeros(8))
    jr = japi.sweep((jX, y), jl.LogisticGradient(), jp.SquaredL2Updater(),
                    [0.0, 0.1], mesh=jm, **kw)
    tr = port.sweep((tX, y), tl.LogisticGradient(), tp.SquaredL2Updater(),
                    [0.0, 0.1], mesh=tm, **kw)
    _same_lanes(tr, jr)


def test_warm_continuation_on_mesh():
    X, y, w0 = _problem(seed=5)
    _, tm = _meshes()
    fit = port.make_sweep_runner((X, y), tl.LogisticGradient(),
                                 tp.SquaredL2Updater(), num_iterations=3,
                                 convergence_tol=0.0, mesh=tm)
    seg1 = fit(w0, REGS)
    seg2 = fit(w0, REGS, warm=port.sweep_warm_state(seg1))
    full = port.sweep((X, y), tl.LogisticGradient(), tp.SquaredL2Updater(),
                      REGS, mesh=tm, num_iterations=6, convergence_tol=0.0,
                      initial_weights=w0)
    np.testing.assert_allclose(seg2.weights.numpy(), full.weights.numpy(),
                               rtol=1e-12, atol=1e-15)


def test_fused_sweep_runs_a_lanes_call_a_slot():
    """FusedLogisticGradient on CPU slots takes its plain version; the
    mesh sweep makes one lanes call a slot a round, and agrees with the
    plain gradient's mesh sweep."""
    X, y, w0 = _problem(seed=6, dtype=np.float32)
    _, tm = _meshes(4)
    kw = dict(num_iterations=4, convergence_tol=0.0, initial_weights=w0)
    tdist.reset_counts()
    fr = port.sweep((X, y), port.FusedLogisticGradient(),
                    tp.SquaredL2Updater(), REGS, mesh=tm, **kw)
    assert tdist.slot_evaluations == 4 * tdist.mesh_evaluations
    pr = port.sweep((X, y), tl.LogisticGradient(), tp.SquaredL2Updater(),
                    REGS, mesh=tm, **kw)
    np.testing.assert_allclose(fr.loss_history.numpy(),
                               pr.loss_history.numpy(), rtol=_RTOL,
                               atol=_ATOL)


def _same_cv(tcv, jcv, rtol=1e-9):
    np.testing.assert_array_equal(tcv.fold_ids.numpy(),
                                  np.asarray(jcv.fold_ids))
    np.testing.assert_allclose(tcv.val_loss.numpy(),
                               np.asarray(jcv.val_loss), rtol=rtol)
    np.testing.assert_allclose(tcv.mean_val_loss.numpy(),
                               np.asarray(jcv.mean_val_loss), rtol=rtol)
    assert int(tcv.best_index) == int(jcv.best_index)
    np.testing.assert_array_equal(
        tcv.train_result.num_iters.numpy(),
        np.asarray(jcv.train_result.num_iters))


@pytest.mark.parametrize("masked", [False, True])
def test_mesh_cv_matches_jax(masked):
    X, y, w0 = _problem(seed=7)
    data = (X, y, (np.arange(300) % 5 != 0).astype(np.float64)) \
        if masked else (X, y)
    jm, tm = _meshes()
    kw = dict(n_folds=3, num_iterations=3, convergence_tol=0.0,
              initial_weights=w0, seed=1)
    jcv = japi.cross_validate(data, jl.LogisticGradient(),
                              jp.SquaredL2Updater(), [0.05, 0.5], mesh=jm,
                              **kw)
    tcv = port.cross_validate(data, tl.LogisticGradient(),
                              tp.SquaredL2Updater(), [0.05, 0.5], mesh=tm,
                              **kw)
    _same_cv(tcv, jcv)


def test_csr_mesh_cv_follows_the_balancer_permutation():
    jX, tX, y = _csr_problem(seed=8)
    jm, tm = _meshes()
    kw = dict(n_folds=3, num_iterations=4, convergence_tol=0.0,
              initial_weights=np.zeros(8), seed=5)
    jcv = japi.cross_validate((jX, y), jl.LogisticGradient(),
                              jp.SquaredL2Updater(), [0.05, 0.5], mesh=jm,
                              **kw)
    tcv = port.cross_validate((tX, y), tl.LogisticGradient(),
                              tp.SquaredL2Updater(), [0.05, 0.5], mesh=tm,
                              **kw)
    _same_cv(tcv, jcv)
    # and the single-device CV of the same rows (input-row-order folds)
    one = port.cross_validate((tX, y), tl.LogisticGradient(),
                              tp.SquaredL2Updater(), [0.05, 0.5],
                              device="cpu", **kw)
    np.testing.assert_allclose(tcv.val_loss.numpy(), one.val_loss.numpy(),
                               rtol=1e-9)


def test_preplaced_csr_batch_cv_as_jax():
    jX, tX, y = _csr_problem(seed=9)
    jm, tm = _meshes()
    kw = dict(n_folds=2, num_iterations=2, convergence_tol=0.0,
              initial_weights=np.zeros(8))
    jcv = japi.cross_validate(jmesh.shard_csr_batch(jm, jX, y),
                              jl.LogisticGradient(), jp.SquaredL2Updater(),
                              [0.1, 1.0], **kw)
    tcv = port.cross_validate(tmesh.shard_csr_batch(tm, tX, y),
                              tl.LogisticGradient(), tp.SquaredL2Updater(),
                              [0.1, 1.0], **kw)
    _same_cv(tcv, jcv)


def test_extras_follow_the_row_permutation():
    n = 53  # uneven over 8 shards: padding slots exist
    jX, tX, _ = _csr_problem(seed=10, n=n, d=7, npr=2)
    y = np.random.default_rng(3).standard_normal(n)
    jm, tm = _meshes()
    tag = np.arange(n, dtype=np.int32)
    side = np.stack([np.arange(n)] * 3, axis=1).astype(np.float64)
    jb, jplaced = jmesh.shard_csr_batch(jm, jX, y,
                                        extras={"tag": tag, "side": side})
    tb, tplaced = tmesh.shard_csr_batch(tm, tX, y,
                                        extras={"tag": tag, "side": side})
    for name in ("tag", "side"):
        got = tplaced[name].gather().numpy()
        np.testing.assert_array_equal(got, np.asarray(jplaced[name]))
    tags = tplaced["tag"].gather().numpy()
    live = tb.mask.gather().numpy() > 0
    assert sorted(tags[live].tolist()) == list(range(n))
    assert np.all(tags[~live] == -1)
    for pkg, m, X in ((jmesh, jm, jX), (tmesh, tm, tX)):
        with pytest.raises(ValueError, match="extras"):
            pkg.shard_csr_batch(m, X, y, extras={"bad": np.arange(5)})


def test_shard_row_array_pads_and_rejects():
    jm, tm = _meshes()
    arr = np.arange(10, dtype=np.int32)
    got = tgrid.shard_row_array(tm, arr, 16, fill=-1)
    np.testing.assert_array_equal(
        got.gather().numpy(),
        np.asarray(jgrid.shard_row_array(jm, arr, 16, fill=-1)))
    for g, m in ((jgrid, jm), (tgrid, tm)):
        with pytest.raises(ValueError, match="exceed"):
            g.shard_row_array(m, arr, 8)


def test_mesh_lbfgs_sweep_matches_jax():
    X, y, w0 = _problem(seed=11)
    jm, tm = _meshes()
    jfit = japi.make_lbfgs_sweep_runner(
        (X, y), jl.LogisticGradient(), jp.L2Prox(), num_iterations=6,
        mesh=jm)
    tfit = port.make_lbfgs_sweep_runner(
        (X, y), tl.LogisticGradient(), tp.L2Prox(), num_iterations=6,
        mesh=tm)
    jr, tr = jfit(w0, REGS), tfit(w0, REGS)
    np.testing.assert_array_equal(tr.num_iters.numpy(),
                                  np.asarray(jr.num_iters))
    np.testing.assert_allclose(tr.weights.numpy(), np.asarray(jr.weights),
                               rtol=1e-7, atol=1e-12)
    with pytest.raises(ValueError, match="smooth"):
        port.make_lbfgs_sweep_runner((X, y), tl.LogisticGradient(),
                                     tp.L1Updater(), mesh=tm)
