"""Sparse data parallelism in the port (``RowShardedCSR`` under
``parallel/dist_smooth.py``) against the JAX package's, on the CPU.

The same CSR data from a numpy seed goes through JAX's row-sharded CSR
smooth on a mesh of the conftest's virtual CPU devices and through the
port's on a mesh of as many CPU slots (N = 1, 2, 3, 8, rows not divisible
by N, nnz-balanced, with and without the column-sorted twin): the mean
loss and gradient at f64 within 1e-12, and full AGD fits through ``run``
with the parity standard of ``tests/test_agd_core.py`` (the same
iteration, backtrack and restart counts, histories within 1e-9, weights
within 3e-7).  Each shard's
reduction plans are worked out once, when the smooth is built."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu import api as japi
from spark_agd_tpu.ops import losses as jlosses, prox as jprox
from spark_agd_tpu.ops.sparse import CSRMatrix as JCSR
from spark_agd_tpu.parallel import dist_smooth as jdist, mesh as jmesh
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.ops import sparse as tsparse
from spark_agd_tpu_torch.parallel import dist_smooth as tdist
from spark_agd_tpu_torch.parallel import mesh as tmesh

SLOTS = [1, 2, 3, 8]


def _meshes(n):
    return (jmesh.make_mesh({"data": n}, devices=jax.devices()[:n]),
            tmesh.make_mesh({"data": n}, devices=["cpu"] * n))


def _problem(seed, n=203, d=17):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 7, n)
    counts[5] = 15  # a heavy row
    indptr = np.concatenate([[0], np.cumsum(counts)])
    nnz = int(indptr[-1])
    indices = rng.integers(0, d, nnz).astype(np.int32)
    values = rng.standard_normal(nnz)
    y = (rng.random(n) < 0.5).astype(np.float64)
    return indptr, indices, values, y, d


def _pair(indptr, indices, values, d, with_csc=True):
    return (JCSR.from_csr_arrays(indptr, indices, values, d,
                                 with_csc=with_csc),
            port.CSRMatrix.from_csr_arrays(indptr, indices, values, d,
                                           with_csc=with_csc,
                                           device="cpu"))


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("with_csc", [True, False])
@pytest.mark.parametrize("kind", ["logistic", "hinge", "least_squares"])
def test_f64_csr_smooth_matches_jax(n, with_csc, kind):
    indptr, indices, values, y, d = _problem(n)
    jX, tX = _pair(indptr, indices, values, d, with_csc=with_csc)
    jm, tm = _meshes(n)
    jb = jmesh.shard_csr_batch(jm, jX, y)
    tb = tmesh.shard_csr_batch(tm, tX, y)
    jsm, jsl = jdist.make_dist_smooth(jlosses.GRADIENTS[kind](), jb,
                                      mesh=jm)
    tsm, tsl = tdist.make_dist_smooth(port.GRADIENTS[kind](), tb, mesh=tm)
    w = np.random.default_rng(1).standard_normal(d) * 0.3
    jf, jg = jax.jit(jsm)(jnp.asarray(w))
    tf, tg = tsm(torch.from_numpy(w))
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-12)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(float(tsl(torch.from_numpy(w))),
                               float(jax.jit(jsl)(jnp.asarray(w))),
                               rtol=1e-12)


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("upd", ["l2", "l1"])
def test_csr_mesh_fit_matches_jax(n, upd):
    indptr, indices, values, y, d = _problem(40 + n)
    jX, tX = _pair(indptr, indices, values, d, with_csc=False)
    jm, tm = _meshes(n)
    jp, tp = ((jprox.L2Prox(), port.L2Prox()) if upd == "l2"
              else (jprox.L1Prox(), port.L1Prox()))
    kw = dict(reg_param=0.05, num_iterations=15, convergence_tol=1e-12,
              initial_weights=np.zeros(d), return_result=True)
    jw, jh, jr = japi.run((jX, y), jlosses.LogisticGradient(), jp,
                          mesh=jm, **kw)
    tw, th, tr = port.run((tX, y), port.LogisticGradient(), tp, mesh=tm,
                          **kw)
    assert int(tr.num_iters) == int(jr.num_iters) == len(th)
    assert int(tr.num_backtracks) == int(jr.num_backtracks)
    assert int(tr.num_restarts) == int(jr.num_restarts)
    np.testing.assert_allclose(th, jh, rtol=1e-9)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=3e-7,
                               atol=1e-12)


def test_plans_are_made_once_a_shard(monkeypatch):
    indptr, indices, values, y, d = _problem(3, n=90)
    _, tX = _pair(indptr, indices, values, d, with_csc=False)
    tm = tmesh.make_mesh(devices=["cpu"] * 3)
    calls = []
    real = tsparse._plan
    monkeypatch.setattr(tsparse, "_plan",
                        lambda off: calls.append(1) or real(off))
    tb = tmesh.shard_csr_batch(tm, tX, y)
    sm, _ = tdist.make_dist_smooth(port.LogisticGradient(), tb, mesh=tm)
    assert len(calls) == 6  # two products, three shards
    for _ in range(3):
        sm(torch.zeros(d, dtype=torch.float64))
    assert len(calls) == 6


def test_csr_mesh_needs_its_mask():
    indptr, indices, values, y, d = _problem(5, n=30)
    _, tX = _pair(indptr, indices, values, d)
    tm = tmesh.make_mesh(devices=["cpu"] * 2)
    tb = tmesh.shard_csr_batch(tm, tX, y)
    with pytest.raises(ValueError, match="padding mask"):
        tdist.csr_shard_sums(port.LogisticGradient(), tb.X, tb.y, None, tm)
    ev, _ = tdist.csr_shard_sums(port.LogisticGradient(), tb.X, tb.y,
                                 tb.mask, tm)
    ls, _, n = ev(torch.zeros(d, dtype=torch.float64))
    assert int(n) == 30 and float(ls) == pytest.approx(30 * np.log(2))
