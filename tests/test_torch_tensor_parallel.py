"""The model axis (``parallel/dist_smooth.py``'s ``mode="auto"``) against
the JAX package's tensor parallelism, on the CPU at f64.

The JAX package shards a softmax's (D, K) W over a mesh's ``model`` axis
(``P(None, "model")``) and lets GSPMD partition both products; the port
writes the partition out.  Held here: the class-sharded evaluation
against JAX's at rtol 1e-12 (gradient 1e-11) on a {data: 4, model: 2}
mesh and an AGD run on it; uneven class splits; ``FusedSoftmaxGradient``
on a model-axis mesh (on the CPU its plain version, once a data slot);
dense feature sharding (``shard_batch_by_features``), its fit held to
JAX's and its pad tail exactly zero; the trainers with a model axis; and
the dry run's eight paths, 2, 3 and 7 among them, on 8 CPU slots."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from spark_agd_tpu.core import agd as jagd, smooth as jsmooth
from spark_agd_tpu.models import glm as jglm
from spark_agd_tpu.ops import losses as jl, prox as jp
from spark_agd_tpu.ops.pallas_kernels import PallasSoftmaxGradient
from spark_agd_tpu.parallel import dist_smooth as jdist, mesh as jmesh
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.core import agd as tagd, smooth as tsmooth
from spark_agd_tpu_torch.models import glm as tglm
from spark_agd_tpu_torch.ops import losses as tl, prox as tp
from spark_agd_tpu_torch.parallel import dist_smooth as tdist
from spark_agd_tpu_torch.parallel import mesh as tmesh


def _meshes(axes):
    n = int(np.prod(list(axes.values())))
    return (jmesh.make_mesh(axes, devices=jax.devices()[:n]),
            tmesh.make_mesh(axes, devices=["cpu"] * n))


def _softmax(seed=0, n=1024, d=6, k=8, masked=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = rng.integers(0, k, size=n)
    W = rng.normal(size=(d, k))
    mask = (rng.random(n) < 0.7).astype(np.float64) if masked else None
    return X, y, W, mask


@pytest.mark.parametrize("axes,k", [({"data": 4, "model": 2}, 8),
                                    ({"data": 2, "model": 4}, 8),
                                    ({"data": 2, "model": 2}, 5)],
                         ids=["4x2", "2x4", "2x2-k5"])
@pytest.mark.parametrize("masked", [False, True])
def test_class_sharded_evaluation_matches_jax(axes, k, masked):
    X, y, W, mask = _softmax(k=k, masked=masked)
    jm, tm = _meshes(axes)
    jb = jmesh.shard_batch(jm, X, y, mask)
    split = k % axes["model"] == 0
    jW = jax.device_put(W, NamedSharding(jm, P(None, "model"))) if split \
        else jnp.asarray(W)
    jsm, jsl = jdist.make_dist_smooth(jl.SoftmaxGradient(k), jb, mesh=jm,
                                      mode="auto")
    jf, jg = jax.jit(jsm)(jW)
    tdist.reset_counts()
    tsm, tsl = tdist.make_dist_smooth(tl.SoftmaxGradient(k), X, y, mask,
                                      mesh=tm, mode="auto")
    tf, tg = tsm(torch.as_tensor(W))
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-12)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-11,
                               atol=1e-15)
    np.testing.assert_allclose(float(tsl(torch.as_tensor(W))),
                               float(jax.jit(jsl)(jW)), rtol=1e-12)
    # one class-sharded evaluation a data index, for each of the two calls
    assert tdist.slot_evaluations == 2 * axes["data"]


def test_agd_on_the_class_sharded_smooth_matches_jax():
    X, y, W0, _ = _softmax(seed=1)
    jm, tm = _meshes({"data": 4, "model": 2})
    jsm, jsl = jdist.make_dist_smooth(jl.SoftmaxGradient(8),
                                      jmesh.shard_batch(jm, X, y), mesh=jm,
                                      mode="auto")
    tsm, tsl = tdist.make_dist_smooth(tl.SoftmaxGradient(8), X, y,
                                      mesh=tm, mode="auto")
    jpx, jrv = jsmooth.make_prox(jp.L2Prox(), 0.01)
    tpx, trv = tsmooth.make_prox(tp.L2Prox(), 0.01)
    cfg = dict(num_iterations=5, convergence_tol=1e-12)
    jr = jax.jit(lambda w: jagd.run_agd(jsm, jpx, jrv, w,
                                        jagd.AGDConfig(**cfg),
                                        smooth_loss=jsl))(
        jax.device_put(W0, NamedSharding(jm, P(None, "model"))))
    tr = tagd.run_agd(tsm, tpx, trv, torch.as_tensor(W0),
                      tagd.AGDConfig(**cfg), smooth_loss=tsl)
    n = int(jr.num_iters)
    assert int(tr.num_iters) == n == 5
    assert int(tr.num_backtracks) == int(jr.num_backtracks)
    np.testing.assert_allclose(tr.loss_history[:n].numpy(),
                               np.asarray(jr.loss_history)[:n], rtol=1e-9)
    np.testing.assert_allclose(tr.weights.numpy(), np.asarray(jr.weights),
                               rtol=3e-7, atol=1e-12)


def test_run_with_auto_mode_takes_the_model_axis():
    X, y, W0, _ = _softmax(seed=2, n=203)
    jm, tm = _meshes({"data": 2, "model": 2})
    kw = dict(num_iterations=6, convergence_tol=1e-12, reg_param=0.05,
              initial_weights=W0, return_result=True)
    jr = jax.block_until_ready(
        port_free_jax_run(X, y, jm, **kw))
    tdist.reset_counts()
    tr = port.run((X, y), tl.SoftmaxGradient(8), tp.L2Prox(), mesh=tm,
                  dist_mode="auto", **kw)[2]
    assert tdist.slot_evaluations == 2 * tdist.mesh_evaluations
    n = int(jr.num_iters)
    assert int(tr.num_iters) == n
    np.testing.assert_allclose(tr.loss_history[:n].numpy(),
                               np.asarray(jr.loss_history)[:n], rtol=1e-9)


def port_free_jax_run(X, y, jm, **kw):
    from spark_agd_tpu import api as japi

    return japi.run((X, y), jl.SoftmaxGradient(8), jp.L2Prox(), mesh=jm,
                    dist_mode="auto", **kw)[2]


def test_fused_softmax_on_a_model_axis_once_a_data_slot():
    """``FusedSoftmaxGradient`` on a model-axis mesh: W's classes are
    gathered onto each data slot and the softmax kernel runs once a data
    slot (on CPU slots its plain version), as JAX computes its Pallas
    softmax there (interpret mode)."""
    X, y, W, _ = _softmax(seed=3, n=256)
    jm, tm = _meshes({"data": 4, "model": 2})
    jsm, _ = jdist.make_dist_smooth(
        PallasSoftmaxGradient(jl.SoftmaxGradient(8), interpret=True),
        jmesh.shard_batch(jm, X, y), mesh=jm, mode="auto")
    jf, jg = jax.jit(jsm)(jax.device_put(W, NamedSharding(jm,
                                                          P(None, "model"))))
    tdist.reset_counts()
    tsm, _ = tdist.make_dist_smooth(port.FusedSoftmaxGradient(
        tl.SoftmaxGradient(8)), X, y, mesh=tm, mode="auto")
    tf, tg = tsm(torch.as_tensor(W))
    assert tdist.slot_evaluations == 4  # once a data slot
    # the Pallas kernel sums in f32: the kernels' tolerances
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4)
    # and the same gradient's single-device smooth (the kernel's plain
    # version stages X in f32): only the order of the slots' sums differs
    f1, g1 = tsmooth.make_smooth(port.FusedSoftmaxGradient(
        tl.SoftmaxGradient(8)), torch.as_tensor(X), torch.as_tensor(y))(
        torch.as_tensor(W))
    np.testing.assert_allclose(float(tf), float(f1), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), g1.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_dense_feature_sharding_matches_jax_and_keeps_its_pad_zero():
    rng = np.random.default_rng(47)
    n, d = 192, 101  # 101 does not divide over 8 slots: 104 padded
    X = rng.standard_normal((n, d))
    y = (rng.random(n) < 0.5).astype(np.float64)
    jm, tm = _meshes({"model": 8})
    jb = jmesh.shard_batch_by_features(jm, X, y)
    tb = tmesh.shard_batch_by_features(tm, X, y)
    assert tb.X.shape == tuple(jb.X.shape)
    jsm, jsl = jdist.make_dist_smooth(jl.LogisticGradient(), jb, mesh=jm,
                                      mode="auto")
    tsm, tsl = tdist.make_dist_smooth(tl.LogisticGradient(), tb, mesh=tm,
                                      mode="auto")
    jw0 = jmesh.shard_weights_by_features(np.zeros(d), jb, jm)
    tw0 = tmesh.shard_weights_by_features(np.zeros(d), tb, tm)
    cfg = dict(num_iterations=5, convergence_tol=0.0)
    jpx, jrv = jsmooth.make_prox(jp.L2Prox(), 0.05)
    tpx, trv = tsmooth.make_prox(tp.L2Prox(), 0.05)
    jr = jax.jit(lambda w: jagd.run_agd(jsm, jpx, jrv, w,
                                        jagd.AGDConfig(**cfg),
                                        smooth_loss=jsl))(jw0)
    tr = tagd.run_agd(tsm, tpx, trv, tw0, tagd.AGDConfig(**cfg),
                      smooth_loss=tsl)
    nit = int(jr.num_iters)
    assert int(tr.num_iters) == nit
    np.testing.assert_allclose(tr.loss_history[:nit].numpy(),
                               np.asarray(jr.loss_history)[:nit],
                               rtol=1e-9)
    np.testing.assert_array_equal(tr.weights.numpy()[d:], 0.0)
    np.testing.assert_allclose(
        tmesh.unshard_weights_by_features(tr.weights, d),
        jmesh.unshard_weights_by_features(jr.weights, d), rtol=3e-7,
        atol=1e-12)
    # one evaluation a point: its gradient's pad tail is exactly zero
    f, g = tsm(torch.as_tensor(rng.standard_normal(104) * np.r_[
        np.ones(d), np.zeros(3)]))
    np.testing.assert_array_equal(g.numpy()[d:], 0.0)
    with pytest.raises(ValueError, match="auto"):
        tdist.make_dist_smooth(tl.LogisticGradient(), tb, mesh=tm)
    with pytest.raises(TypeError, match="margin"):
        tdist.make_dist_smooth(port.FusedLogisticGradient(), tb, mesh=tm,
                               mode="auto")


@pytest.mark.parametrize("kind", ["softmax", "logistic"])
def test_trainers_with_a_model_axis_match_jax(kind):
    rng = np.random.default_rng(4)
    X = rng.standard_normal((120, 5))
    if kind == "softmax":
        y = rng.integers(0, 4, 120).astype(np.float64)
        tt, jt = (tglm.SoftmaxRegressionWithAGD(4),
                  jglm.SoftmaxRegressionWithAGD(4))
    else:
        y = (rng.random(120) < 0.5).astype(np.float64)
        tt, jt = (tglm.LogisticRegressionWithAGD(),
                  jglm.LogisticRegressionWithAGD())
    jm, tm = _meshes({"data": 2, "model": 2})
    tt.optimizer.set_mesh(tm).set_dist_mode("auto").set_num_iterations(5)
    jt.optimizer.set_mesh(jm).set_dist_mode("auto").set_num_iterations(5)
    tmod, jmod = tt.train(X, y), jt.train(X, y)
    np.testing.assert_allclose(tmod.weights.numpy(), np.asarray(jmod.weights),
                               rtol=1e-5, atol=1e-7)


def test_dryrun_paths_on_eight_cpu_slots():
    from spark_agd_tpu_torch.parallel.dryrun import dryrun_multichip

    counts = dryrun_multichip(8, "cpu")
    # path 2: 4 data slots x its evaluations; path 7: 8 slots a round
    assert counts["dp_tp_softmax"] % 4 == 0 and counts["dp_tp_softmax"]
    assert counts["mesh_sweep"] % 8 == 0 and counts["mesh_sweep"]
