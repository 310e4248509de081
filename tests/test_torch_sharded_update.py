"""The sharded weight update (``parallel/sharded_update.py``,
``run(sharded_update=True)``) against the JAX package's, on the CPU at
f64.

The same problems go to the JAX package's sharded mode on 1, 2 and 4
virtual CPU devices and to the port's on as many CPU slots: the same
iteration count, the final loss within 1e-9 and the weights within 1e-7
of JAX's sharded fit and of the port's replicated fit (dense and CSR, a
width of 13 over 4 shards whose pad slots stay inert).  The JAX package's
checks ("requires a mesh", ``dist_mode='shard_map'``, its fused kernel
refused), a checkpoint written in either mode resumed in the other, and
two gloo ranks whose census shows the reduce-scatter and the all-gather,
each scalar collective at most 96 bytes (``analysis/pins.json``'s
``agd_sharded`` ceiling for the JAX program)."""

import json

import jax
import numpy as np
import pytest
import torch

from spark_agd_tpu import api as japi
from spark_agd_tpu.analysis import contracts
from spark_agd_tpu.data import ingest as jingest
from spark_agd_tpu.ops.losses import LogisticGradient as JLogistic
from spark_agd_tpu.ops.prox import L2Prox as JL2
from spark_agd_tpu.ops.sparse import CSRMatrix as JCSR
from spark_agd_tpu.parallel import mesh as jmesh
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.core import agd as tagd, smooth as tsmooth
from spark_agd_tpu_torch.ops.sparse import CSRMatrix
from spark_agd_tpu_torch.parallel import mesh as tmesh, multihost as tmh
from spark_agd_tpu_torch.parallel import sharded_update as tsu
from spark_agd_tpu_torch.resilience import (AutoCheckpointer,
                                            DistributedCheckpointer,
                                            ResiliencePolicy)

from test_torch_multihost import _run_ranks, _write_parts

FIT = dict(reg_param=0.1, convergence_tol=0.0, num_iterations=25)


def _meshes(k):
    return (jmesh.make_mesh({"data": k}, devices=jax.devices()[:k]),
            tmesh.make_mesh({"data": k}, devices=["cpu"] * k))


def _dense(seed=3, n=96, d=12):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (rng.random(n) > 0.5).astype(np.float64)
    return X, y, np.zeros(d)


def _csr():
    rng = np.random.default_rng(17)
    n, d = 301, 157
    counts = rng.integers(1, 12, n)
    indptr = np.zeros(n + 1, np.int32)
    indptr[1:] = np.cumsum(counts)
    indices = rng.integers(0, d, indptr[-1]).astype(np.int32)
    values = rng.normal(size=indptr[-1])
    y = (rng.random(n) > 0.5).astype(np.float64)
    return (JCSR.from_csr_arrays(indptr, indices, values, d),
            CSRMatrix.from_csr_arrays(indptr, indices, values, d,
                                      device="cpu"), y, np.zeros(d))


def _fits(jdata, tdata, w0, k):
    jm, tm = _meshes(k)
    js = japi.make_runner(jdata, JLogistic(), JL2(), mesh=jm,
                          sharded_update=True, **FIT)(w0)
    tr = port.make_runner(tdata, port.LogisticGradient(), port.L2Prox(),
                          mesh=tm, **FIT)(w0)
    ts = port.make_runner(tdata, port.LogisticGradient(), port.L2Prox(),
                          mesh=tm, sharded_update=True, **FIT)(w0)
    return js, tr, ts


def _held(js, tr, ts):
    n = int(js.num_iters)
    assert int(ts.num_iters) == int(tr.num_iters) == n
    last = float(np.asarray(js.loss_history)[n - 1])
    assert abs(float(ts.loss_history[n - 1]) - last) <= 1e-9
    assert abs(float(ts.loss_history[n - 1])
               - float(tr.loss_history[n - 1])) <= 1e-9
    np.testing.assert_allclose(ts.weights.numpy(), np.asarray(js.weights),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(ts.weights.numpy(), tr.weights.numpy(),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_dense_parity(k):
    X, y, w0 = _dense()
    _held(*_fits((X, y), (X, y), w0, k))


def test_csr_parity():
    jX, tX, y, w0 = _csr()
    _held(*_fits((jX, y, None), (tX, y, None), w0, 4))


def test_uneven_feature_count_pads_inert():
    X, y, w0 = _dense(seed=5, n=64, d=13)
    js, tr, ts = _fits((X, y), (X, y), w0, 4)
    _held(js, tr, ts)
    # the layout pads 13 to 16; the carry's pad slots stay exactly zero
    lay = tsu.ShardLayout.for_tree(torch.zeros(13), 4)
    assert lay.shard_sizes == (4,) and lay.sizes == (13,)
    _, tm = _meshes(4)
    shards = lay.local(ts.weights, tm)
    assert float(shards[-1][-3:].abs().sum()) == 0.0
    torch.testing.assert_close(lay.gather(shards, tm), ts.weights)


def test_layout_of_a_tree_and_its_dot():
    _, tm = _meshes(3)
    tree = {"W": torch.arange(10.0).reshape(5, 2),
            "b": torch.arange(4.0)}
    lay = tsu.ShardLayout.for_tree(tree, 3)
    sh = lay.local(tree, tm)
    assert len(sh) == 3 and lay.shard_sizes == (4, 2)
    back = lay.gather(sh, tm)
    assert torch.equal(back["W"], tree["W"]) and torch.equal(back["b"],
                                                             tree["b"])
    assert float(lay.dot(sh, sh, tm)) == float(
        (tree["W"] ** 2).sum() + (tree["b"] ** 2).sum())
    # the reduce-scatter of one process: each slot its shard of the sum
    g = lay.scatter(tree, tm)
    assert torch.equal(g[1]["b"], torch.tensor([2.0, 3.0]))


def test_checks_as_in_jax():
    X, y, w0 = _dense()
    _, tm = _meshes(2)
    for pkg, g, u, m in ((japi, JLogistic(), JL2(), False),
                         (port, port.LogisticGradient(), port.L2Prox(),
                          False)):
        with pytest.raises(ValueError, match="requires a mesh"):
            pkg.make_runner((X, y), g, u, mesh=m, sharded_update=True)
    with pytest.raises(ValueError, match="shard_map"):
        port.make_runner((X, y), port.LogisticGradient(), port.L2Prox(),
                         mesh=tm, dist_mode="auto", sharded_update=True)
    with pytest.raises(ValueError, match="fused"):
        port.make_runner((X, y), port.FusedLogisticGradient(),
                         port.L2Prox(), mesh=tm, sharded_update=True)
    build, dargs = tsu.make_sharded_staged(port.LogisticGradient(), X, y,
                                           mesh=tm)
    with pytest.raises(TypeError, match="make_agd_run"):
        build(*dargs)


def test_a_hand_built_run_matches_run_agd():
    X, y, w0 = _dense(seed=8)
    _, tm = _meshes(4)
    build, dargs = tsu.make_sharded_staged(port.LogisticGradient(), X, y,
                                           mesh=tm)
    px, rv = tsmooth.make_prox(port.L2Prox(), 0.1)
    cfg = tagd.AGDConfig(convergence_tol=0.0, num_iterations=10)
    res = build.make_agd_run(px, rv, cfg)(torch.zeros(12,
                                                      dtype=torch.float64),
                                          dargs)
    sm = tsmooth.make_smooth(port.LogisticGradient(), torch.from_numpy(X),
                             torch.from_numpy(y))
    ref = tagd.run_agd(sm, px, rv, torch.zeros(12, dtype=torch.float64),
                       cfg)
    np.testing.assert_allclose(res.loss_history.numpy(),
                               ref.loss_history.numpy(), rtol=1e-12)
    assert res.final_z.shape == (12,)


POL = ResiliencePolicy(segment_iters=7, jitter=0.0, seed=0)


def _supervised(problem, iters, *, sharded, checkpointer=None):
    X, y, w0 = problem
    return port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                    reg_param=0.1, initial_weights=w0, num_iterations=iters,
                    convergence_tol=0.0, mesh=_meshes(4)[1],
                    resilience=POL, sharded_update=sharded,
                    return_result=True, checkpointer=checkpointer)


def test_replicated_writes_sharded_resumes(tmp_path):
    problem = _dense()
    _, hs, _ = _supervised(problem, 20, sharded=True)
    path = str(tmp_path / "c.npz")
    _supervised(problem, 8, sharded=False,
                checkpointer=AutoCheckpointer(path, every_iters=4))
    _, hx, sres = _supervised(problem, 20, sharded=True,
                              checkpointer=AutoCheckpointer(path,
                                                            every_iters=4))
    assert sres.resumed_from == 8
    assert abs(float(hx[-1]) - float(hs[-1])) <= 1e-9


def test_sharded_writes_replicated_resumes_distributed(tmp_path):
    problem = _dense()
    _, hr, _ = _supervised(problem, 20, sharded=False)
    ck = DistributedCheckpointer(str(tmp_path), every_iters=4,
                                 process_index=0, process_count=1)
    _supervised(problem, 8, sharded=True, checkpointer=ck)
    ck2 = DistributedCheckpointer(str(tmp_path), every_iters=4,
                                  process_index=0, process_count=1)
    _, hx, sres = _supervised(problem, 20, sharded=False, checkpointer=ck2)
    assert sres.resumed_from == 8
    assert abs(float(hx[-1]) - float(hr[-1])) <= 1e-9


def test_two_gloo_ranks_census_and_parity(tmp_path):
    """Two real gloo ranks fit the partitioned batch in the sharded mode:
    both hold the same histories and gathered weights, within the parity
    standard of the JAX package's one-process sharded fit; the census
    shows the reduce-scatter of the gradient and the all-gather of the
    weights, and no scalar collective carries more than 96 bytes."""
    rng = np.random.default_rng(11)
    paths = _write_parts(tmp_path, rng)
    r0, r1 = _run_ranks(tmp_path, "--sharded")
    assert r0["sharded"]["hist"] == r1["sharded"]["hist"]
    assert r0["sharded"]["w"] == r1["sharded"]["w"]
    jm = jmesh.make_mesh({"data": 4}, devices=jax.devices()[:4])
    jw, jh, jr = japi.run(jingest.from_partitioned_files(paths, jm,
                                                         n_features=9),
                          JLogistic(), JL2(), reg_param=0.05,
                          num_iterations=10, convergence_tol=1e-12,
                          initial_weights=np.zeros(9), sharded_update=True,
                          return_result=True)
    got = r0["sharded"]
    assert got["iters"] == int(jr.num_iters)
    hist = [float.fromhex(v) for v in got["hist"]]
    np.testing.assert_allclose(hist, np.asarray(jh), rtol=1e-9)
    np.testing.assert_allclose([float.fromhex(v) for v in got["w"]],
                               np.asarray(jw), rtol=0, atol=1e-7)
    pin = contracts.load_pins()["agd_sharded"]
    for r in (r0, r1):
        census = r["sharded"]["census"]
        assert census["reduce-scatter"]["count"] >= 1
        assert census["all-gather"]["count"] >= 1
        assert "sums" not in census  # no replicated gradient combine
        assert census["scalars"]["max_bytes"] <= pin["max_all_reduce_bytes"]
    assert json.dumps(r0["sharded"]["census"]) == json.dumps(
        r1["sharded"]["census"])


def test_census_counts_and_resets():
    tmh.reset_census()
    tmh._count_collective("scalars", 16)
    tmh._count_collective("scalars", 8)
    assert tmh.census["scalars"] == {"count": 2, "bytes": 24,
                                     "max_bytes": 16}
    tmh.reset_census()
    assert tmh.census == {}
