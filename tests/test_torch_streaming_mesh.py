"""The port's streamed smooth over a mesh (``data/streaming.py``'s
``mesh=`` and ``csr_nnz_per_shard=``) against the JAX package's, on the
CPU, at f64.

Each macro-batch is sharded over the mesh (dense by ``shard_batch``, CSR
by the nnz-balanced ``shard_csr_batch`` under one entry budget a shard)
and each slot evaluates its shard.  The same streams from a numpy seed go
through JAX's streamed mesh smooth on its virtual CPU devices and the
port's on as many CPU slots: the mean loss and gradient within 1e-12, and
the host AGD driver over the stream step for step (histories 1e-9,
weights 3e-7).  A batch past the budget raises with the knob's name."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu.core import host_agd as jhost, smooth as jsmooth
from spark_agd_tpu.data import streaming as jstream
from spark_agd_tpu.ops import losses as jlosses, prox as jprox
from spark_agd_tpu.parallel import mesh as jmesh
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.core import host_agd as thost, smooth as tsmooth
from spark_agd_tpu_torch.data import streaming as tstream
from spark_agd_tpu_torch.parallel import dist_smooth as tdist
from spark_agd_tpu_torch.parallel import mesh as tmesh


def _meshes(n):
    return (jmesh.make_mesh({"data": n}, devices=jax.devices()[:n]),
            tmesh.make_mesh({"data": n}, devices=["cpu"] * n))


def _dense(seed, n=230, d=7):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = (rng.random(n) < 1 / (1 + np.exp(-X[:, 0]))).astype(np.float64)
    return X, y


def _csr(seed, n=250, d=23):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 8, n)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    nnz = int(indptr[-1])
    return (indptr, rng.integers(0, d, nnz).astype(np.int32),
            rng.standard_normal(nnz), d,
            (rng.random(n) < 0.5).astype(np.float64))


def _streams(kind, seed, batch_rows):
    if kind == "dense":
        X, y = _dense(seed)
        return (jstream.StreamingDataset.from_arrays(X, y, batch_rows),
                tstream.StreamingDataset.from_arrays(X, y, batch_rows),
                X.shape[1])
    indptr, indices, values, d, y = _csr(seed)
    return (jstream.StreamingDataset.from_csr(indptr, indices, values, d, y,
                                              batch_rows),
            tstream.StreamingDataset.from_csr(indptr, indices, values, d, y,
                                              batch_rows), d)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("kind,budget", [("dense", None), ("csr", None),
                                         ("csr", 512)])
def test_streamed_mesh_smooth_matches_jax(n, kind, budget):
    jds, tds, d = _streams(kind, n, batch_rows=64)
    jm, tm = _meshes(n)
    kw = dict(pad_to=64 if kind == "dense" else None,
              csr_nnz_per_shard=budget)
    jsm, jsl = jstream.make_streaming_smooth(jlosses.LogisticGradient(),
                                             jds, mesh=jm, **kw)
    tdist.reset_counts()
    tsm, tsl = tstream.make_streaming_smooth(port.LogisticGradient(), tds,
                                             mesh=tm, **kw)
    w = np.random.default_rng(9).standard_normal(d) * 0.2
    jf, jg = jsm(jnp.asarray(w))
    tf, tg = tsm(torch.from_numpy(w))
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-12)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-11,
                               atol=1e-14)
    np.testing.assert_allclose(float(tsl(torch.from_numpy(w))),
                               float(jsl(jnp.asarray(w))), rtol=1e-12)
    batches = 4  # 230 or 250 rows in batches of 64
    assert tdist.mesh_evaluations == 2 * batches
    assert tdist.slot_evaluations <= 2 * batches * n


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_host_agd_over_a_mesh_stream_matches_jax(n, kind):
    jds, tds, d = _streams(kind, 20 + n, batch_rows=80)
    jm, tm = _meshes(n)
    cfg_kw = dict(num_iterations=8, convergence_tol=1e-12)
    jsm, jsl = jstream.make_streaming_smooth(jlosses.LogisticGradient(),
                                             jds, mesh=jm)
    tsm, tsl = tstream.make_streaming_smooth(port.LogisticGradient(), tds,
                                             mesh=tm)
    jpx, jrv = jsmooth.make_prox(jprox.L2Prox(), 0.05)
    tpx, trv = tsmooth.make_prox(port.L2Prox(), 0.05)
    from spark_agd_tpu.core import agd as jagd
    from spark_agd_tpu_torch.core import agd as tagd

    jr = jhost.run_agd_host(jsm, jpx, jrv, np.zeros(d),
                            jagd.AGDConfig(**cfg_kw), smooth_loss=jsl)
    tr = thost.run_agd_host(tsm, tpx, trv,
                            torch.zeros(d, dtype=torch.float64),
                            tagd.AGDConfig(**cfg_kw), smooth_loss=tsl)
    assert tr.num_iters == jr.num_iters
    assert tr.num_backtracks == jr.num_backtracks
    assert tr.num_restarts == jr.num_restarts
    np.testing.assert_allclose(tr.loss_history, jr.loss_history, rtol=1e-9)
    np.testing.assert_allclose(tr.weights.numpy(), np.asarray(jr.weights),
                               rtol=3e-7, atol=1e-12)


def test_a_batch_past_the_budget_raises_and_the_sweeps_refuse_a_mesh():
    _, tds, d = _streams("csr", 5, batch_rows=200)
    _, tm = _meshes(2)
    sm, _ = tstream.make_streaming_smooth(port.LogisticGradient(), tds,
                                          mesh=tm, csr_nnz_per_shard=8)
    with pytest.raises(ValueError, match="csr_nnz_per_shard"):
        sm(torch.zeros(d, dtype=torch.float64))
    # the multi-lane evaluator takes the mesh and its budget too
    ev = tstream.make_streaming_eval_multi(port.LogisticGradient(), tds,
                                           mesh=tm, csr_nnz_per_shard=8)
    with pytest.raises(ValueError, match="csr_nnz_per_shard"):
        ev(torch.zeros((2, d), dtype=torch.float64))
    with pytest.raises(ValueError, match="lead device"):
        tstream.make_streaming_smooth(port.LogisticGradient(), tds,
                                      mesh=tm, device="cuda:0")
