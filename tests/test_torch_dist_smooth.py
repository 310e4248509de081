"""The port's mesh smooth (``parallel/dist_smooth.py``) against the JAX
package's, on the CPU.

The same numpy inputs go through ``spark_agd_tpu.parallel.dist_smooth`` on
a mesh of the conftest's virtual CPU devices and through the port on a
mesh of as many CPU slots (N = 1, 2, 3, 8, rows not divisible by N): the
mean loss and gradient at f64 within 1e-12, both modes.  The fused
gradients' plain versions (f32) are held to ``PallasMarginGradient`` /
``PallasSoftmaxGradient`` in interpret mode under the JAX mesh.  Each
shard is prepared once, when the smooth is built (a fused shard staged as
a view of X), an evaluation is one slot evaluation a slot, and repeated
evaluations give the same bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu.ops import losses as jlosses
from spark_agd_tpu.ops.pallas_kernels import (PallasMarginGradient,
                                              PallasSoftmaxGradient)
from spark_agd_tpu.parallel import dist_smooth as jdist, mesh as jmesh
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.ops import fused_kernels as fk
from spark_agd_tpu_torch.parallel import dist_smooth as tdist
from spark_agd_tpu_torch.parallel import mesh as tmesh

SLOTS = [1, 2, 3, 8]
MARGIN = ["logistic", "least_squares", "hinge"]


def _meshes(n):
    return (jmesh.make_mesh({"data": n}, devices=jax.devices()[:n]),
            tmesh.make_mesh({"data": n}, devices=["cpu"] * n))


def _data(rng, n=101, d=6, kind="logistic", k=4):
    X = rng.standard_normal((n, d))
    if kind == "softmax":
        y = rng.integers(0, k, n).astype(np.int32)
    elif kind == "least_squares":
        y = X @ rng.standard_normal(d) + 0.1 * rng.standard_normal(n)
    else:
        y = (rng.random(n) < 0.5).astype(np.float64)
    mask = (rng.random(n) < 0.8).astype(np.float64)
    return X, y, mask


def _jax_pair(g, X, y, mask, mesh, mode):
    sm, sl = jdist.make_dist_smooth(g, X, y, mask, mesh=mesh, mode=mode)
    return jax.jit(sm), jax.jit(sl)


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("mode", ["shard_map", "auto"])
@pytest.mark.parametrize("kind", MARGIN + ["softmax"])
def test_f64_smooth_matches_jax(n, mode, kind):
    rng = np.random.default_rng(n + 10 * len(kind))
    X, y, mask = _data(rng, kind=kind)
    jm, tm = _meshes(n)
    if kind == "softmax":
        jg, tg = jlosses.SoftmaxGradient(4), port.SoftmaxGradient(4)
        w = rng.standard_normal((X.shape[1], 4)) * 0.3
    else:
        jg, tg = jlosses.GRADIENTS[kind](), port.GRADIENTS[kind]()
        w = rng.standard_normal(X.shape[1]) * 0.3
    jsm, jsl = _jax_pair(jg, X, y, mask, jm, mode)
    tsm, tsl = tdist.make_dist_smooth(tg, X, y, mask, mesh=tm, mode=mode)
    jf, jgr = jsm(jnp.asarray(w))
    tf, tgr = tsm(torch.from_numpy(w))
    assert tf.dtype == torch.float64
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-12)
    np.testing.assert_allclose(tgr.numpy(), np.asarray(jgr), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(float(tsl(torch.from_numpy(w))),
                               float(jsl(jnp.asarray(w))), rtol=1e-12)


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("kind", MARGIN)
def test_fused_margin_plain_version_matches_pallas_under_mesh(n, kind):
    rng = np.random.default_rng(20 + n)
    X, y, mask = _data(rng, n=203, d=10, kind=kind)
    X = X.astype(np.float32)
    y = y.astype(np.float32)
    w = (rng.standard_normal(10) * 0.3).astype(np.float32)
    jm, tm = _meshes(n)
    jg = PallasMarginGradient(jlosses.GRADIENTS[kind](), interpret=True)
    tg = port.FusedMarginGradient(port.GRADIENTS[kind]())
    jsm, _ = _jax_pair(jg, X, y, mask.astype(np.float32), jm, "shard_map")
    tsm, _ = tdist.make_dist_smooth(tg, X, y, mask.astype(np.float32),
                                    mesh=tm)
    jf, jgr = jsm(jnp.asarray(w))
    tf, tgr = tsm(torch.from_numpy(w))
    np.testing.assert_allclose(float(tf), float(jf), rtol=2e-6)
    np.testing.assert_allclose(tgr.numpy(), np.asarray(jgr), rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("n", [2, 3])
def test_fused_softmax_plain_version_matches_pallas_under_mesh(n):
    rng = np.random.default_rng(30 + n)
    X, y, mask = _data(rng, n=151, d=12, kind="softmax", k=5)
    X = X.astype(np.float32)
    W = (rng.standard_normal((12, 5)) * 0.3).astype(np.float32)
    jm, tm = _meshes(n)
    jg = PallasSoftmaxGradient(jlosses.SoftmaxGradient(5), interpret=True)
    tg = port.FusedSoftmaxGradient(port.SoftmaxGradient(5))
    jsm, _ = _jax_pair(jg, X, y, mask.astype(np.float32), jm, "shard_map")
    tsm, _ = tdist.make_dist_smooth(tg, X, y, mask.astype(np.float32),
                                    mesh=tm)
    jf, jgr = jsm(jnp.asarray(W))
    tf, tgr = tsm(torch.from_numpy(W))
    np.testing.assert_allclose(float(tf), float(jf), rtol=2e-6)
    np.testing.assert_allclose(tgr.numpy(), np.asarray(jgr), rtol=2e-5,
                               atol=2e-6)


class _CountingPrepare(fk.FusedMarginGradient):
    def __init__(self):
        super().__init__(port.LogisticGradient())
        self.prepares = 0
        self.sums = 0

    def prepare(self, X, y, mask=None):
        self.prepares += 1
        return super().prepare(X, y, mask)

    def batch_loss_and_grad(self, weights, X, y, mask=None):
        assert isinstance(X, fk.StagedDense)  # never staged per call
        self.sums += 1
        return super().batch_loss_and_grad(weights, X, y, mask)


def test_shards_are_staged_once_as_views_and_evaluated_once_a_slot():
    rng = np.random.default_rng(4)
    X = torch.from_numpy(rng.standard_normal((100, 5)).astype(np.float32))
    y = torch.from_numpy((rng.random(100) < 0.5).astype(np.float32))
    mesh = tmesh.make_mesh(devices=["cpu"] * 3)
    g = _CountingPrepare()
    build, dargs = tdist.make_dist_smooth_staged(g, X, y, mesh=mesh)
    assert g.prepares == 3
    rps = -(-100 // 3)
    for i, ops in enumerate(dargs):
        assert ops[0].X.data_ptr() == X[i * rps:].data_ptr()
    sm, _ = build(*dargs)
    tdist.reset_counts()
    w = torch.zeros(5)
    out = [sm(w + 0.1) for _ in range(4)]
    assert g.prepares == 3 and g.sums == 12
    assert tdist.slot_evaluations == 12 and tdist.mesh_evaluations == 4
    for f, gr in out[1:]:  # the same bits on repeat
        assert torch.equal(f, out[0][0]) and torch.equal(gr, out[0][1])


def test_empty_shards_add_nothing():
    rng = np.random.default_rng(6)
    X, y, mask = _data(rng, n=5)
    jm, tm = _meshes(8)  # 8 slots over 5 rows: three hold padding only
    jsm, _ = _jax_pair(jlosses.LogisticGradient(), X, y, mask, jm,
                       "shard_map")
    tsm, _ = tdist.make_dist_smooth(port.LogisticGradient(), X, y, mask,
                                    mesh=tm)
    w = rng.standard_normal(X.shape[1])
    np.testing.assert_allclose(float(tsm(torch.from_numpy(w))[0]),
                               float(jsm(jnp.asarray(w))[0]), rtol=1e-12)


def test_staging_rules_and_rejections():
    rng = np.random.default_rng(8)
    X, y, _ = _data(rng, n=20)
    m2 = tmesh.make_mesh(devices=["cpu"] * 2)
    b = tmesh.shard_batch(m2, X, y)
    with pytest.raises(ValueError, match="not both"):
        tdist.make_dist_smooth(port.LogisticGradient(), b, y, mesh=m2)
    with pytest.raises(ValueError, match="y is required"):
        tdist.make_dist_smooth(port.LogisticGradient(), X, mesh=m2)
    with pytest.raises(ValueError, match="another mesh"):
        tdist.make_dist_smooth(port.LogisticGradient(), b,
                               mesh=tmesh.make_mesh(devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="unknown mode"):
        tdist.make_dist_smooth(port.LogisticGradient(), b, mesh=m2,
                               mode="gspmd")
    mm = tmesh.make_mesh({"data": 2, "model": 2}, devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match="model"):
        tdist.make_dist_smooth(port.SoftmaxGradient(3), X, y, mesh=mm)
    with pytest.raises(NotImplementedError, match="sharded update"):
        tdist.psum_scatter_combine(None, None, None, "data", None)
    Xc = port.CSRMatrix.from_csr_arrays(
        np.arange(21) * 2, rng.integers(0, 6, 40), rng.random(40), 6,
        device="cpu")
    with pytest.raises(ValueError, match="shard_map"):
        tdist.make_dist_smooth(port.LogisticGradient(), Xc, y, mesh=m2,
                               mode="auto")
