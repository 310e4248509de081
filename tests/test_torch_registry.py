"""The port's model registry, on the CPU: publish, load and verify in the
JAX package's manifest and npz formats (a generation set published by
either package loads and serves in the other), round trips of every
model class, CRC tampering and torn writes refused with the fallback
walk, ``refresh`` hot swaps, ``previous``/``repoint`` rollbacks and
``gc`` — the registry cases of ``tests/test_serve.py`` and
``tests/test_pipeline.py``, held to the JAX registry where both run."""

import json
import os

import numpy as np
import pytest
import torch

from spark_agd_tpu.models import glm as jglm, mlp as jmlp
from spark_agd_tpu.serve import ModelRegistry as JRegistry
from spark_agd_tpu.serve import engine as jengine
from spark_agd_tpu_torch.models import glm as tglm, mlp as tmlp
from spark_agd_tpu_torch.resilience import manifest as mf
from spark_agd_tpu_torch.resilience.faults import (scramble_file,
                                                   truncate_file)
from spark_agd_tpu_torch.serve import ModelRegistry, ServeEngine
from spark_agd_tpu_torch.serve.engine import ServeSpecMismatch
from spark_agd_tpu_torch.utils.checkpoint import CheckpointCorruptError

D = 10
MAX_BATCH = 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _logistic(seed=1, d=D):
    r = np.random.default_rng(seed)
    return tglm.LogisticRegressionModel(
        _t(r.normal(size=d).astype(np.float32)), float(r.normal()) * 0.1)


def _models(pkg):
    """One model of each servable class, the same arrays in either
    package (``pkg`` "jax" or "torch")."""
    r = np.random.default_rng(11)
    w = r.normal(size=D).astype(np.float32)
    W = r.normal(size=(D, 4)).astype(np.float32)
    c = r.normal(size=4).astype(np.float32)
    params = {k: np.asarray(v) for k, v in
              jmlp.init_mlp_params(D, 5, 3, seed=2).items()}
    if pkg == "jax":
        g, m, wrap = jglm, jmlp, np.asarray
    else:
        g, m, wrap = tglm, tmlp, _t
    return {
        "logistic": g.LogisticRegressionModel(wrap(w), 0.3),
        "logistic_nothr": g.LogisticRegressionModel(wrap(w), 0.3,
                                                    threshold=None),
        "svm": g.SVMModel(wrap(w), -0.1),
        "linear": g.LinearRegressionModel(wrap(w), 1.5),
        "softmax": g.SoftmaxRegressionModel(wrap(W), wrap(c)),
        "mlp": m.MLPModel({k: wrap(v) for k, v in params.items()}),
    }


def _X(n, seed=7, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(
        np.float32)


def _registry(path, **kw):
    return ModelRegistry(str(path), device="cpu", **kw)


def _ops(model):
    return ("predict", "predict_proba") if hasattr(
        model, "predict_proba") else ("predict",)


def test_publish_commits_shard_then_manifest(tmp_path):
    reg = _registry(tmp_path)
    assert reg.publish(_logistic()) == 1
    names = sorted(os.listdir(tmp_path))
    assert "manifest.json" in names
    assert any(n.startswith("manifest-g00000001") for n in names)
    assert any(n.startswith("shard-g00000001.h000") for n in names)


@pytest.mark.parametrize("kind", sorted(_models("torch")))
def test_round_trip_bit_identical_every_class(tmp_path, kind):
    model = _models("torch")[kind]
    reg = _registry(tmp_path)
    restored = reg.load(reg.publish(model)).model
    assert type(restored) is type(model)
    X = _t(_X(9))
    for op in _ops(model):
        assert torch.equal(getattr(model, op)(X), getattr(restored, op)(X))


@pytest.mark.parametrize("n", [1, 4, MAX_BATCH],
                         ids=["batch1", "boundary", "max_batch"])
def test_served_round_trip_bit_identical_at_edge_sizes(tmp_path, n):
    model = _logistic()
    reg = _registry(tmp_path)
    gen = reg.publish(model)
    eng = ServeEngine(model, generation=0, max_batch=MAX_BATCH,
                      min_bucket=4, device="cpu")
    X = _X(n, seed=n)
    before = [eng.predict(X, op) for op in _ops(model)]
    eng.bind(reg.load(gen).model, gen)
    after = [eng.predict(X, op) for op in _ops(model)]
    for b, a in zip(before, after):
        assert np.array_equal(b, a)


def test_generations_increment(tmp_path):
    reg = _registry(tmp_path)
    assert reg.newest_generation() == 0
    assert reg.publish(_logistic(1)) == 1
    assert reg.publish(_logistic(2)) == 2
    assert reg.newest_generation() == 2
    assert reg.load().generation == 2  # HEAD points at the newest


def test_missing_generation_raises_lookup(tmp_path):
    reg = _registry(tmp_path)
    with pytest.raises(LookupError, match="no committed"):
        reg.load()
    assert reg.load_newest() is None


def test_crc_tamper_refused_and_falls_back(tmp_path):
    reg = _registry(tmp_path)
    m1 = _logistic(1)
    reg.publish(m1)
    gen2 = reg.publish(_logistic(2))
    scramble_file(os.path.join(tmp_path,
                               reg.load(gen2).manifest.shards[0].path))
    with pytest.raises(CheckpointCorruptError, match="CRC32"):
        reg.load(gen2)
    loaded = reg.load_newest()
    assert loaded.generation == 1
    assert torch.equal(loaded.model.weights, m1.weights)


def test_torn_write_refused(tmp_path):
    reg = _registry(tmp_path)
    gen = reg.publish(_logistic())
    truncate_file(os.path.join(tmp_path,
                               reg.load(gen).manifest.shards[0].path),
                  keep_fraction=0.4)
    with pytest.raises(CheckpointCorruptError, match="torn|size"):
        reg.load(gen)
    assert reg.load_newest() is None  # nothing intact remains


def test_refresh_binds_the_newest(tmp_path):
    reg = _registry(tmp_path)
    m1, m2 = _logistic(1), _logistic(2)
    reg.publish(m1)
    eng = ServeEngine(m1, generation=0, max_batch=8, device="cpu")
    assert reg.refresh(eng) == 1
    assert reg.refresh(eng) is None  # already current: no-op
    reg.publish(m2)
    assert reg.refresh(eng) == 2
    assert eng.generation == 2 and eng.hot_swaps == 2
    X = _X(5)
    np.testing.assert_allclose(eng.predict(X, "predict_proba"),
                               m2.predict_proba(_t(X)).numpy(), rtol=1e-6)


def test_refresh_propagates_spec_mismatch(tmp_path):
    reg = _registry(tmp_path)
    reg.publish(_logistic(1))
    eng = ServeEngine(_logistic(1), generation=0, max_batch=8,
                      device="cpu")
    assert reg.refresh(eng) == 1
    reg.publish(_logistic(3, d=D + 3))
    with pytest.raises(ServeSpecMismatch):
        reg.refresh(eng)
    assert reg.current.generation == 1 and eng.generation == 1


def test_gc_keeps_newest(tmp_path):
    reg = _registry(tmp_path, keep=2)
    for s in range(1, 5):
        reg.publish(_logistic(s))
    assert mf.committed_generations(str(tmp_path)) == [4, 3]
    assert reg.load_newest().generation == 4
    reg.keep = 1
    reg.gc()
    assert mf.committed_generations(str(tmp_path)) == [4]


def _publish_n(tmp_path, n=3):
    reg = _registry(tmp_path)
    for i in range(n):
        reg.publish(_logistic(seed=i + 1))
    return reg


def _scramble_gen(tmp_path, generation):
    man = mf.load_manifest(str(tmp_path), generation)
    scramble_file(str(tmp_path / man.shards[0].path), seed=3)


def test_previous_walks_back_from_head(tmp_path):
    reg = _publish_n(tmp_path)
    assert reg.previous() == 2
    assert reg.previous(2) == 1
    assert reg.previous(1) is None


def test_repoint_moves_head_only(tmp_path):
    reg = _publish_n(tmp_path)
    assert reg.repoint(1).generation == 1
    assert reg.current.generation == 1
    assert mf.load_manifest(str(tmp_path)).generation == 1
    assert mf.committed_generations(str(tmp_path)) == [3, 2, 1]
    assert _registry(tmp_path).load().generation == 1
    # forward counting: no collision with the still-committed later ones
    assert reg.publish(_logistic(seed=9)) == 4


def test_repoint_missing_generation_raises(tmp_path):
    with pytest.raises(LookupError):
        _publish_n(tmp_path).repoint(17)


def test_repoint_binds_engine(tmp_path):
    reg = _publish_n(tmp_path)
    engine = ServeEngine(reg.load(3).model, generation=3, max_batch=8,
                         min_bucket=4, device="cpu")
    reg.repoint(2, engine=engine)
    assert engine.generation == 2 and engine.hot_swaps == 1


def test_previous_skips_torn_generation_and_repoint_refuses_it(tmp_path):
    reg = _publish_n(tmp_path)
    _scramble_gen(tmp_path, 2)
    assert reg.previous(3) == 1
    with pytest.raises(CheckpointCorruptError):
        reg.repoint(2)
    assert reg.load().generation == 3  # HEAD never moved


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_generation_set_loads_and_serves_in_the_other_package(tmp_path,
                                                                writer):
    """Each model class published by one package's registry loads in the
    other's, with the same arrays, and the port engine serves it as the
    JAX engine does (rtol 1e-6 at f32)."""
    jmodels, tmodels = _models("jax"), _models("torch")
    kinds = sorted(jmodels)
    if writer == "jax":
        pub = JRegistry(str(tmp_path), keep=len(kinds))
        gens = [pub.publish(jmodels[k]) for k in kinds]
    else:
        pub = _registry(tmp_path, keep=len(kinds))
        gens = [pub.publish(tmodels[k]) for k in kinds]
    treg, jreg = _registry(tmp_path, keep=8), JRegistry(str(tmp_path),
                                                        keep=8)
    assert gens == list(range(1, len(kinds) + 1))
    assert treg.newest_generation() == jreg.newest_generation() == gens[-1]
    head = json.loads((tmp_path / "manifest.json").read_text())
    assert head["generation"] == gens[-1]
    X = _X(9)
    for kind, gen in zip(kinds, gens):
        tl, jl = treg.load(gen), jreg.load(gen)
        assert type(tl.model).__name__ == type(jl.model).__name__
        assert tl.manifest.shards[0].crc32 == jl.manifest.shards[0].crc32
        te = ServeEngine(tl.model, generation=gen, max_batch=MAX_BATCH,
                         min_bucket=4, device="cpu")
        je = jengine.ServeEngine(jl.model, generation=gen,
                                 max_batch=MAX_BATCH, min_bucket=4)
        for op in te.ops:
            np.testing.assert_allclose(te.predict(X, op),
                                       np.asarray(je.predict(X, op)),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{kind} {op}")


def test_a_port_tamper_is_refused_by_the_jax_registry_too(tmp_path):
    reg = _publish_n(tmp_path, 2)
    _scramble_gen(tmp_path, 2)
    assert JRegistry(str(tmp_path)).load_newest().generation == 1
    assert reg.load_newest().generation == 1


def test_telemetry_is_refused_and_the_device_rule_holds(tmp_path,
                                                        monkeypatch):
    with pytest.raises(NotImplementedError, match="observability"):
        ModelRegistry(str(tmp_path), telemetry=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelRegistry(str(tmp_path))
