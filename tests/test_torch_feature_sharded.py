"""Feature (D-axis) sharding of CSR columns (``parallel/feature_sharded.py``)
against the JAX package's, on the CPU.

The same numpy problem (D = 203, not divisible by the 8 shards) goes to
``spark_agd_tpu.parallel.feature_sharded`` on a ``model`` mesh of 8
virtual CPU devices and to the port on 8 CPU slots: the balancer's column
``positions`` are equal; the smooth at a point, with and without a mask,
agrees with JAX's at f64 (values and labels are f32 in both, as the layout
takes them); a whole AGD fit runs on the padded state, its unused
positions exactly zero; a power-law column distribution stays balanced.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu.core import agd as jagd, smooth as jsmooth
from spark_agd_tpu.ops import losses as jl, prox as jp
from spark_agd_tpu.parallel import feature_sharded as jfs, mesh as jmesh
from spark_agd_tpu_torch.core import agd as tagd, smooth as tsmooth
from spark_agd_tpu_torch.ops import losses as tl, prox as tp
from spark_agd_tpu_torch.parallel import feature_sharded as tfs
from spark_agd_tpu_torch.parallel import mesh as tmesh

LOSSES = [("logistic", jl.LogisticGradient, tl.LogisticGradient),
          ("least_squares", jl.LeastSquaresGradient,
           tl.LeastSquaresGradient),
          ("hinge", jl.HingeGradient, tl.HingeGradient)]


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(9)
    n, d, nnz_row = 300, 203, 7
    indptr = np.arange(n + 1) * nnz_row
    indices = np.concatenate(
        [rng.choice(d, nnz_row, replace=False) for _ in range(n)]
    ).astype(np.int32)
    values = rng.standard_normal(n * nnz_row).astype(np.float32)
    w_true = rng.standard_normal(d).astype(np.float32) / np.sqrt(nnz_row)
    margins = np.zeros(n, np.float32)
    np.add.at(margins, np.repeat(np.arange(n), nnz_row),
              values * w_true[indices])
    y = (rng.random(n) < 1 / (1 + np.exp(-margins))).astype(np.float32)
    w = rng.standard_normal(d) / np.sqrt(d)
    return indptr, indices, values, d, y, w


def _meshes(k=8):
    return (jmesh.make_mesh({"model": k}, devices=jax.devices()[:k]),
            tmesh.make_mesh({"model": k}, devices=["cpu"] * k))


def _pair(problem, mask=None, with_csc=True):
    indptr, indices, values, d, y, _ = problem
    jm, tm = _meshes()
    jb = jfs.shard_csr_by_columns(indptr, indices, values, d, y, jm,
                                  mask=mask, with_csc=with_csc)
    tb = tfs.shard_csr_by_columns(indptr, indices, values, d, y, tm,
                                  mask=mask, with_csc=with_csc)
    return jm, tm, jb, tb


def test_layout_equals_jax(problem):
    jm, tm, jb, tb = _pair(problem)
    np.testing.assert_array_equal(tb.positions, jb.positions)
    assert tb.d_local == jb.d_local and tb.n_rows == jb.n_rows
    k = len(tb.shards)
    nnz = jb.values.shape[0] // k
    for s, shard in enumerate(tb.shards):
        sl = slice(s * nnz, (s + 1) * nnz)
        np.testing.assert_array_equal(shard.row_ids.numpy(),
                                      np.asarray(jb.row_ids)[sl])
        np.testing.assert_array_equal(shard.col_ids.numpy(),
                                      np.asarray(jb.col_local)[sl])
        np.testing.assert_array_equal(shard.values.numpy(),
                                      np.asarray(jb.values)[sl])
        np.testing.assert_array_equal(shard.csc_values.numpy(),
                                      np.asarray(jb.csc_values)[sl])
    np.testing.assert_array_equal(
        tfs.shard_weights(problem[-1], tb, tm).numpy(),
        np.asarray(jfs.shard_weights(problem[-1], jb, jm)))


@pytest.mark.parametrize("name,jcls,tcls", LOSSES, ids=[x[0] for x in LOSSES])
@pytest.mark.parametrize("masked", [False, True])
def test_smooth_matches_jax(problem, name, jcls, tcls, masked):
    mask = None
    if masked:
        mask = (np.random.default_rng(1).random(len(problem[4])) < 0.6) \
            .astype(np.float32)
    jm, tm, jb, tb = _pair(problem, mask=mask)
    w = problem[-1]
    jsm, jsl = jfs.make_feature_sharded_smooth(jcls(), jb, mesh=jm)
    tsm, tsl = tfs.make_feature_sharded_smooth(tcls(), tb, mesh=tm)
    jws = jfs.shard_weights(w, jb, jm).astype(jnp.float64)
    tws = torch.from_numpy(np.asarray(jws))
    jf, jg = jsm(jws)
    tf, tg = tsm(tws)
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-12)
    np.testing.assert_allclose(tfs.unshard_weights(tg, tb),
                               jfs.unshard_weights(jg, jb), rtol=1e-11,
                               atol=1e-15)
    np.testing.assert_allclose(float(tsl(tws)), float(jsl(jws)),
                               rtol=1e-12)


def test_fit_runs_on_the_padded_state_as_jax(problem):
    jm, tm, jb, tb = _pair(problem)
    d = problem[3]
    cfg = dict(convergence_tol=0.0, num_iterations=6)
    jsm, jsl = jfs.make_feature_sharded_smooth(jl.LogisticGradient(), jb,
                                               mesh=jm)
    tsm, tsl = tfs.make_feature_sharded_smooth(tl.LogisticGradient(), tb,
                                               mesh=tm)
    jpx, jrv = jsmooth.make_prox(jp.L1Prox(), 0.05)
    tpx, trv = tsmooth.make_prox(tp.L1Prox(), 0.05)
    jw0 = jfs.shard_weights(np.zeros(d), jb, jm).astype(jnp.float64)
    jr = jax.jit(lambda w: jagd.run_agd(jsm, jpx, jrv, w,
                                        jagd.AGDConfig(**cfg),
                                        smooth_loss=jsl))(jw0)
    tr = tagd.run_agd(tsm, tpx, trv, torch.from_numpy(np.asarray(jw0)),
                      tagd.AGDConfig(**cfg), smooth_loss=tsl)
    n = int(jr.num_iters)
    assert int(tr.num_iters) == n
    assert int(tr.num_backtracks) == int(jr.num_backtracks)
    np.testing.assert_allclose(tr.loss_history[:n].numpy(),
                               np.asarray(jr.loss_history)[:n], rtol=1e-9)
    full = tr.weights.numpy()
    assert full.shape[0] == 8 * tb.d_local
    unused = np.ones(full.shape[0], bool)
    unused[tb.positions] = False
    assert unused.sum() == full.shape[0] - d
    np.testing.assert_array_equal(full[unused], 0.0)
    np.testing.assert_allclose(tfs.unshard_weights(tr.weights, tb),
                               jfs.unshard_weights(jr.weights, jb),
                               rtol=3e-7, atol=1e-12)


def test_without_the_twin_the_gradient_is_the_same(problem):
    jm, tm, jb, tb = _pair(problem, with_csc=False)
    assert not tb.has_csc
    w = torch.from_numpy(np.asarray(
        jfs.shard_weights(problem[-1], jb, jm)).astype(np.float64))
    _, g0 = tfs.make_feature_sharded_smooth(
        tl.LogisticGradient(), tb, mesh=tm)[0](w)
    _, _, _, tb2 = _pair(problem)
    _, g1 = tfs.make_feature_sharded_smooth(
        tl.LogisticGradient(), tb2, mesh=tm)[0](w)
    np.testing.assert_allclose(g0.numpy(), g1.numpy(), rtol=1e-12,
                               atol=1e-15)


def test_nnz_balanced_on_power_law():
    rng = np.random.default_rng(2)
    n, d, nnz_row = 2000, 500, 10
    p = 1.0 / np.arange(1, d + 1)
    p /= p.sum()
    indices = rng.choice(d, size=n * nnz_row, p=p).astype(np.int32)
    indptr = np.arange(n + 1) * nnz_row
    values = np.ones(n * nnz_row, np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    jm, tm = _meshes()
    tb = tfs.shard_csr_by_columns(indptr, indices, values, d, y, tm)
    jb = jfs.shard_csr_by_columns(indptr, indices, values, d, y, jm)
    np.testing.assert_array_equal(tb.positions, jb.positions)
    blowup = 8 * tb.shards[0].values.shape[0] / (n * nnz_row)
    assert blowup < 1.5, f"padding blowup {blowup:.2f}x"


def test_rejections_as_in_jax():
    jm, tm = _meshes()
    for fs_, m in ((jfs, jm), (tfs, tm)):
        with pytest.raises(ValueError, match="out of range"):
            fs_.shard_csr_by_columns(np.array([0, 1]), np.array([7]),
                                     np.ones(1, np.float32), 7,
                                     np.zeros(1), m)
    tb = tfs.shard_csr_by_columns(np.array([0, 1]), np.array([2]),
                                  np.ones(1, np.float32), 7, np.zeros(1),
                                  tm)
    with pytest.raises(TypeError, match="MarginGradient"):
        tfs.make_feature_sharded_smooth(tl.SoftmaxGradient(3), tb, mesh=tm)
