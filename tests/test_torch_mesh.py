"""The port's meshes and placement (``parallel/mesh.py``) against the JAX
package's, on the CPU.

The same numpy inputs go to ``spark_agd_tpu.parallel.mesh`` on a mesh of
the conftest's virtual CPU devices and to the port on a mesh of as many
CPU slots (N = 1, 2, 3, 8, row counts not divisible by N): the padded
arrays and masks of ``shard_batch``, the ``csr_shard_layout`` arrays, the
placed ``RowShardedCSR`` arrays and the balancer's assignment must be
equal exactly.  Dense shards are views of X, and the C++ balancer is a
byte-for-byte copy of the JAX package's."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from spark_agd_tpu import native as jnative
from spark_agd_tpu.ops.sparse import CSRMatrix as JCSR
from spark_agd_tpu.parallel import mesh as jmesh
from spark_agd_tpu_torch import native
from spark_agd_tpu_torch.ops.sparse import CSRMatrix, RowShardedCSR
from spark_agd_tpu_torch.parallel import mesh as tmesh

ROOT = Path(__file__).resolve().parents[1]
SLOTS = [1, 2, 3, 8]


def _jax_mesh(n):
    return jmesh.make_mesh({"data": n}, devices=jax.devices()[:n])


def _port_mesh(n):
    return tmesh.make_mesh({"data": n}, devices=["cpu"] * n)


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("rows", [37, 64, 5])
@pytest.mark.parametrize("with_mask", [False, True])
def test_shard_batch_equals_jax(n, rows, with_mask):
    rng = np.random.default_rng(n * 100 + rows)
    X = rng.standard_normal((rows, 3))
    y = rng.standard_normal(rows)
    mask = (rng.random(rows) < 0.7).astype(np.float32) if with_mask \
        else None
    jb = jmesh.shard_batch(_jax_mesh(n), X, y, mask)
    tb = tmesh.shard_batch(_port_mesh(n), X, y, mask)
    np.testing.assert_array_equal(tb.X.gather().numpy(), np.asarray(jb.X))
    np.testing.assert_array_equal(tb.y.gather().numpy(), np.asarray(jb.y))
    assert (tb.mask is None) == (jb.mask is None)
    if jb.mask is not None:
        np.testing.assert_array_equal(tb.mask.gather().numpy(),
                                      np.asarray(jb.mask))
    assert tb.X.shape == tuple(jb.X.shape)
    # each shard's rows are JAX's shard's (its padding rows not stored)
    for i, shard in enumerate(jb.X.addressable_shards):
        k = tb.X.shards[i].shape[0]
        np.testing.assert_array_equal(tb.X.shards[i].numpy(),
                                      np.asarray(shard.data)[:k])
        assert k + tb.X.pads[i] == shard.data.shape[0]


def test_dense_shards_are_views_of_x():
    X = torch.randn(103, 4)
    y = torch.zeros(103)
    b = tmesh.shard_batch(_port_mesh(3), X, y)
    rps = b.X.rows_per_shard
    for i, s in enumerate(b.X.shards):
        assert s.data_ptr() == X[i * rps:].data_ptr()  # no copy
    assert b.X.pads == [0, 0, 3 * rps - 103]
    # a numpy X is shared too
    Xn = np.random.default_rng(0).standard_normal((10, 2))
    bn = tmesh.shard_batch(_port_mesh(2), Xn, np.zeros(10))
    Xn[0, 0] = 123.0
    assert float(bn.X.shards[0][0, 0]) == 123.0


def test_make_mesh_rules():
    m = tmesh.make_mesh(devices=["cpu"] * 4)
    assert m.shape == {"data": 4} and m.lead == torch.device("cpu")
    assert m == _port_mesh(4) and m != _port_mesh(2)
    assert hash(m) == hash(_port_mesh(4))
    with pytest.raises(ValueError, match="need 8 devices"):
        tmesh.make_mesh({"data": 8}, devices=["cpu"] * 4)
    m2 = tmesh.make_mesh({"data": 2, "model": 2}, devices=["cpu"] * 4)
    assert m2.shape == {"data": 2, "model": 2}
    with pytest.raises(NotImplementedError, match="later slice"):
        tmesh.check_data_mesh(m2)
    # a size-1 model axis is a data mesh
    tmesh.check_data_mesh(tmesh.make_mesh({"data": 2, "model": 1},
                                          devices=["cpu"] * 2))
    with pytest.raises(TypeError, match="Mesh"):
        tmesh.check_data_mesh("data")
    for fn in (tmesh.shard_batch_by_features,
               tmesh.shard_weights_by_features):
        with pytest.raises(NotImplementedError, match="feature"):
            fn(m, None, None)
    with pytest.raises(NotImplementedError, match="feature"):
        tmesh.unshard_weights_by_features(None, 3)


def test_make_mesh_defaults_to_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    m = tmesh.make_mesh()
    assert m.slots() == [torch.device("cuda", i) for i in range(3)]


def test_replicate_puts_the_tree_on_the_lead_device():
    m = _port_mesh(3)
    tree = {"w": np.arange(3.0), "b": [torch.ones(2)]}
    out = tmesh.replicate(tree, m)
    assert out["w"].device == m.lead and out["b"][0].device == m.lead
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"])


def _csr(rng, n=61, d=9, max_row=6, dtype=np.float32):
    counts = rng.integers(0, max_row, n)
    counts[3] = 17  # one heavy row
    indptr = np.concatenate([[0], np.cumsum(counts)])
    nnz = int(indptr[-1])
    indices = rng.integers(0, d, nnz).astype(np.int32)
    values = rng.standard_normal(nnz).astype(dtype)
    return indptr, indices, values, d


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("with_csc", [True, False])
def test_shard_csr_batch_equals_jax(n, masked, with_csc):
    rng = np.random.default_rng(7 + n)
    indptr, indices, values, d = _csr(rng)
    rows = len(indptr) - 1
    y = (rng.random(rows) < 0.5).astype(np.float32)
    mask = (rng.random(rows) < 0.8).astype(np.float32) if masked else None
    jX = JCSR.from_csr_arrays(indptr, indices, values, d,
                              with_csc=with_csc)
    tX = CSRMatrix.from_csr_arrays(indptr, indices, values, d,
                                   with_csc=with_csc, device="cpu")
    jb = jmesh.shard_csr_batch(_jax_mesh(n), jX, y, mask)
    tb = tmesh.shard_csr_batch(_port_mesh(n), tX, y, mask)
    assert isinstance(tb.X, RowShardedCSR)
    assert tb.X.shape == jb.X.shape and tb.X.n_shards == jb.X.n_shards
    assert tb.X.rows_per_shard == jb.X.rows_per_shard
    assert tb.X.nnz_per_shard == jb.X.nnz_per_shard
    names = ["row_ids", "col_ids", "values"]
    if with_csc:
        names += ["csc_row_ids", "csc_col_ids", "csc_values"]
    for name in names:
        np.testing.assert_array_equal(getattr(tb.X, name).numpy(),
                                      np.asarray(getattr(jb.X, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tb.y.gather().numpy(), np.asarray(jb.y))
    np.testing.assert_array_equal(tb.mask.gather().numpy(),
                                  np.asarray(jb.mask))


def test_csr_layout_with_a_budget_equals_jax():
    rng = np.random.default_rng(3)
    indptr, indices, values, d = _csr(rng, n=40)
    rows = len(indptr) - 1
    y = (rng.random(rows) < 0.5).astype(np.float32)
    jX = JCSR.from_csr_arrays(indptr, indices, values, d)
    tX = CSRMatrix.from_csr_arrays(indptr, indices, values, d,
                                   device="cpu")
    jb = jmesh.shard_csr_batch(_jax_mesh(3), jX, y, nnz_per_shard=256)
    tb = tmesh.shard_csr_batch(_port_mesh(3), tX, y, nnz_per_shard=256)
    assert tb.X.nnz_per_shard == jb.X.nnz_per_shard == 256
    for name in ("row_ids", "col_ids", "values"):
        np.testing.assert_array_equal(getattr(tb.X, name).numpy(),
                                      np.asarray(getattr(jb.X, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tb.mask.gather().numpy(),
                                  np.asarray(jb.mask))
    with pytest.raises(ValueError, match="nnz_per_shard"):
        tmesh.shard_csr_batch(_port_mesh(3), tX, y, nnz_per_shard=4)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_csr_shard_layout_arrays_equal_jax(n_shards):
    rng = np.random.default_rng(11)
    indptr, indices, values, d = _csr(rng, n=50)
    rows = len(indptr) - 1
    row_ids = np.repeat(np.arange(rows), np.diff(indptr))
    y = rng.standard_normal(rows).astype(np.float32)
    kw = dict(with_csc=True, reduce_max=lambda v: int(v) + 1)
    a = jmesh.csr_shard_layout(row_ids, indices, values, y, None, rows, d,
                               n_shards, balance=True, **kw)
    b = tmesh.csr_shard_layout(row_ids, indices, values, y, None, rows, d,
                               n_shards, **kw)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_bf16_values_keep_their_bits():
    rng = np.random.default_rng(5)
    indptr, indices, values, d = _csr(rng, n=20)
    tX = CSRMatrix.from_csr_arrays(
        indptr, indices, torch.from_numpy(values).to(torch.bfloat16), d,
        device="cpu")
    tb = tmesh.shard_csr_batch(_port_mesh(2), tX, np.zeros(20))
    ref = tmesh.shard_csr_batch(_port_mesh(2), CSRMatrix.from_csr_arrays(
        indptr, indices, tX.values.float(), d, device="cpu"), np.zeros(20))
    assert tb.X.dtype == torch.bfloat16
    np.testing.assert_array_equal(tb.X.values.float().numpy(),
                                  ref.X.values.numpy())


@pytest.mark.parametrize("n_shards,capacity", [(1, 40), (3, 14), (8, 6),
                                               (5, 100)])
def test_greedy_balance_equals_jax(n_shards, capacity):
    counts = np.random.default_rng(n_shards).integers(0, 30, 40)
    counts[[4, 9]] = 0  # ties
    ref = jnative.greedy_balance(counts, n_shards, capacity)
    for got in (native.greedy_balance(counts, n_shards, capacity),
                native.greedy_balance_python(counts, n_shards, capacity)):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    assert native.pop_fallback_event("shard_balance.so") is None
    with pytest.raises(ValueError, match="exceed"):
        native.greedy_balance(counts, 2, 3)


def test_balancer_source_is_a_copy():
    ours = (ROOT / "spark_agd_tpu_torch/native/shard_balance.cpp")
    theirs = (ROOT / "spark_agd_tpu/native/shard_balance.cpp")
    assert ours.read_bytes() == theirs.read_bytes()
    make = (ROOT / "spark_agd_tpu_torch/native/Makefile").read_text()
    assert "shard_balance.so: shard_balance.cpp" in make
