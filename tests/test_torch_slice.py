"""The port's first slice end to end, on the CPU, against the JAX package.

The whole main path — ``AcceleratedGradientDescent(FusedLogisticGradient(),
SquaredL2Updater()).optimize`` — against the JAX builder with
``PallasLogisticGradient(interpret=True)`` at f32 (loss history rtol
1e-4, as ``tests/test_pallas.py`` holds the fused AGD run); the import
boundary (the port never imports ``jax`` or ``spark_agd_tpu``); the
device rule (entry points raise without CUDA unless told ``device="cpu"``);
the on-device generators and the weight conversion."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import spark_agd_tpu as jpkg
from spark_agd_tpu.ops.pallas_kernels import PallasLogisticGradient
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.parallel import mesh as tmesh
from spark_agd_tpu_torch import convert
from spark_agd_tpu_torch.data import device_synth, synthetic
from spark_agd_tpu_torch.ops import fused_kernels as fk

ROOT = Path(__file__).resolve().parents[1]


def _logistic_data(n=256, d=24, seed=8):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w_true = rng.standard_normal(d) / np.sqrt(d)
    y = (rng.random(n) < 1 / (1 + np.exp(-3 * X @ w_true)))
    return X, y.astype(np.float32)


def test_slice_matches_jax_pallas_builder():
    X, y = _logistic_data()
    w0 = np.zeros(X.shape[1], np.float32)
    j_agd = (jpkg.AcceleratedGradientDescent(
        PallasLogisticGradient(interpret=True), jpkg.SquaredL2Updater())
        .setRegParam(0.1).setNumIterations(10).set_mesh(False))
    jw = j_agd.optimize((X, y), w0)
    t_agd = (port.AcceleratedGradientDescent(port.FusedLogisticGradient(),
                                             port.SquaredL2Updater())
             .setRegParam(0.1).setNumIterations(10).set_device("cpu"))
    tw = t_agd.optimize((X, y), w0)
    assert tw.dtype == torch.float32 and tw.device.type == "cpu"
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-3,
                               atol=1e-5)
    _, jh = jpkg.run((X, y), PallasLogisticGradient(interpret=True),
                     jpkg.SquaredL2Updater(), reg_param=0.1,
                     num_iterations=10, initial_weights=w0, mesh=False)
    _, th, res = port.run((X, y), port.FusedLogisticGradient(),
                          port.SquaredL2Updater(), reg_param=0.1,
                          num_iterations=10, initial_weights=w0,
                          device="cpu", return_result=True)
    assert len(th) == len(jh) == int(res.num_iters)
    np.testing.assert_allclose(th, jh, rtol=1e-4)
    assert th[-1] < th[0]


def test_runner_prepares_once_and_refits_identically():
    X, y = _logistic_data(seed=9)

    class Counting(port.FusedLogisticGradient):
        prepares = 0

        def prepare(self, X, y, mask=None):
            self.prepares += 1
            return super().prepare(X, y, mask)

    g = Counting()
    fit = port.make_runner((X, y), g, port.SquaredL2Updater(),
                           reg_param=0.1, num_iterations=6, device="cpu")
    staged = fit.data_args[0]
    assert isinstance(staged, fk.StagedDense)
    a, b = fit(np.zeros(X.shape[1], np.float32)), \
        fit(np.zeros(X.shape[1], np.float32))
    assert g.prepares == 1
    assert torch.equal(a.weights, b.weights)
    assert torch.equal(a.loss_history, b.loss_history)


def test_masked_rows_change_the_fit_like_jax():
    X, y = _logistic_data(seed=10)
    mask = (np.random.default_rng(1).random(len(y)) < 0.6).astype(np.float32)
    w0 = np.zeros(X.shape[1], np.float32)
    _, jh = jpkg.run((X, y, mask), PallasLogisticGradient(interpret=True),
                     jpkg.SquaredL2Updater(), reg_param=0.1,
                     num_iterations=6, initial_weights=w0, mesh=False)
    _, th = port.run((X, y, mask), port.FusedLogisticGradient(),
                     port.SquaredL2Updater(), reg_param=0.1,
                     num_iterations=6, initial_weights=w0, device="cpu")
    np.testing.assert_allclose(th, jh, rtol=1e-4)


_IMPORT_PROBE = """
import sys
before = set(sys.modules)
import spark_agd_tpu_torch
import spark_agd_tpu_torch.api, spark_agd_tpu_torch.convert
import spark_agd_tpu_torch.data.device_synth
import spark_agd_tpu_torch.data.synthetic
import spark_agd_tpu_torch.ops.fused_kernels
import spark_agd_tpu_torch.models, spark_agd_tpu_torch.models.glm
import spark_agd_tpu_torch.models.evaluation
import spark_agd_tpu_torch.utils.checkpoint
import spark_agd_tpu_torch.core.gd, spark_agd_tpu_torch.core.prng
import spark_agd_tpu_torch.core.lbfgs, spark_agd_tpu_torch.core.host_lbfgs
import spark_agd_tpu_torch.models.mlp
import spark_agd_tpu_torch.data.streaming, spark_agd_tpu_torch.data.ingest
import spark_agd_tpu_torch.core.host_agd, spark_agd_tpu_torch.utils.logging
import spark_agd_tpu_torch.obs.schema, spark_agd_tpu_torch.resilience.retry
import spark_agd_tpu_torch.parallel.mesh, spark_agd_tpu_torch.parallel.multihost
import spark_agd_tpu_torch.parallel.dist_smooth
import spark_agd_tpu_torch.parallel.dryrun, spark_agd_tpu_torch.native
new = set(sys.modules) - before
bad = sorted(m for m in new if m == "jax" or m.startswith("jax.")
             or m == "spark_agd_tpu" or m.startswith("spark_agd_tpu."))
print("BAD" if bad or "jax" in sys.modules else "CLEAN", bad)
"""


def test_port_never_imports_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("CLEAN"), out.stdout


def _imported_modules(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _is_jax_side(name: str) -> bool:
    return any(name == p or name.startswith(p + ".")
               for p in ("jax", "jaxlib", "spark_agd_tpu"))


@pytest.mark.parametrize("rel", ["chip_smoke.py"] + sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "spark_agd_tpu_torch").rglob("*.py")))
def test_sources_import_nothing_of_jax(rel):
    names = _imported_modules(ROOT / rel)
    assert not [n for n in names if _is_jax_side(n)], names


# the JAX package root's public names the port does not export yet, each
# with the slice that brings it
ROOT_NAMES_TO_PORT = {
    "Telemetry": "A.12, the observability slice",
}

# the JAX ``serve`` package's names that wait for the replica fleet and
# its router (A.11b)
SERVE_NAMES_TO_PORT = {
    name: "A.11b, the replica fleet and its router"
    for name in ("ReplicaHandle", "ReplicaServer", "discover_replicas",
                 "FleetRouter", "NoReplicasLeft", "ReplicaLatencyTracker",
                 "RouteResult")
}


def _root_public_names(path: Path):
    """The names a package ``__init__.py`` binds: what it imports and
    defines at module level, private ones left out."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_port_root_exports_every_name_of_the_jax_root():
    jax_names = _root_public_names(ROOT / "spark_agd_tpu" / "__init__.py")
    assert {"make_mesh", "ShardedBatch", "run"} <= jax_names
    missing = sorted(n for n in jax_names if not hasattr(port, n))
    assert missing == sorted(ROOT_NAMES_TO_PORT), missing
    for name in ("ShardedBatch", "make_mesh", "replicate", "shard_batch",
                 "shard_csr_batch"):
        assert getattr(port, name) is getattr(tmesh, name)


@pytest.mark.parametrize("pkg", ["serve", "pipeline"])
def test_port_subpackage_exports_the_jax_names(pkg):
    jax_names = _root_public_names(ROOT / "spark_agd_tpu" / pkg
                                   / "__init__.py")
    port_names = _root_public_names(ROOT / "spark_agd_tpu_torch" / pkg
                                    / "__init__.py")
    waiting = SERVE_NAMES_TO_PORT if pkg == "serve" else {}
    assert set(waiting) <= jax_names
    assert port_names == jax_names - set(waiting)
    jall = __import__(f"spark_agd_tpu.{pkg}", fromlist=["__all__"]).__all__
    tall = getattr(port, pkg).__all__ if pkg == "serve" else __import__(
        f"spark_agd_tpu_torch.{pkg}", fromlist=["__all__"]).__all__
    assert sorted(tall) == sorted(n for n in jall if n not in waiting)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _logistic_data(n=16, d=3)
    w0 = np.zeros(3, np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.run((X, y), port.LogisticGradient(), port.SquaredL2Updater(),
                 initial_weights=w0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.make_runner((X, y), port.LogisticGradient(),
                         port.SquaredL2Updater())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.AcceleratedGradientDescent(
            port.FusedLogisticGradient(),
            port.SquaredL2Updater()).optimize((X, y), w0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_synth.class_logistic(8, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_synth.planted_softmax(8, 3, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_synth.softmax_params(3, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.run((X, y), port.LogisticGradient(), port.SquaredL2Updater(),
                 initial_weights=w0, device="cuda")
    # set_device("cpu") is the explicit opt-out
    w = (port.AcceleratedGradientDescent(port.LogisticGradient(),
                                         port.SquaredL2Updater())
         .setNumIterations(2).set_device("cpu").optimize((X, y), w0))
    assert w.device.type == "cpu"


@pytest.mark.parametrize("option", [
    # a mesh with a model axis and the sharded update are ported: the one
    # computes what JAX computes, the other without a mesh raises JAX's
    # ValueError
    dict(mesh=tmesh.make_mesh({"data": 1, "model": 2}, devices=["cpu"] * 2)),
    # the supervised path is ported: with it, the options of later
    # slices still raise
    dict(resilience=True, telemetry=object()),
    dict(checkpointer=object(), resilience=True, journal="j.wal"),
    dict(journal="j.wal"), dict(telemetry=object()),
    dict(sharded_update=True)], ids=lambda o: next(iter(o)))
def test_later_slice_options_raise(option):
    X, y = _logistic_data(n=16, d=3)
    if "mesh" in option:
        import jax
        from spark_agd_tpu.parallel import mesh as jmesh

        kw = dict(num_iterations=3, initial_weights=np.zeros(3))
        tw, th = port.run((X.astype(np.float64), y.astype(np.float64)),
                          port.LogisticGradient(), port.SquaredL2Updater(),
                          device="cpu", **kw, **option)
        jw, jh = jpkg.run(
            (X.astype(np.float64), y.astype(np.float64)),
            jpkg.LogisticGradient(), jpkg.SquaredL2Updater(),
            mesh=jmesh.make_mesh({"data": 1, "model": 2},
                                 devices=jax.devices()[:2]), **kw)
        np.testing.assert_allclose(th, np.asarray(jh), rtol=1e-9)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-9)
        return
    if "sharded_update" in option:
        with pytest.raises(ValueError, match="requires a mesh"):
            jpkg.run((X, y), jpkg.LogisticGradient(),
                     jpkg.SquaredL2Updater(), mesh=False,
                     initial_weights=np.zeros(3, np.float32), **option)
        with pytest.raises(ValueError, match="requires a mesh"):
            port.run((X, y), port.LogisticGradient(),
                     port.SquaredL2Updater(),
                     initial_weights=np.zeros(3, np.float32), device="cpu",
                     **option)
        return
    with pytest.raises(NotImplementedError, match="later slice"):
        port.run((X, y), port.LogisticGradient(), port.SquaredL2Updater(),
                 initial_weights=np.zeros(3, np.float32), device="cpu",
                 **option)


def test_single_device_mesh_values_are_accepted():
    X, y = _logistic_data(n=16, d=3)
    for mesh in (None, False):
        w, h = port.run((X, y), port.LogisticGradient(),
                        port.SquaredL2Updater(), num_iterations=2,
                        initial_weights=np.zeros(3, np.float32),
                        device="cpu", mesh=mesh)
        assert len(h) == 2
    # a mesh with a model axis is taken too (the model-parallel slice)
    mm = tmesh.make_mesh({"data": 1, "model": 2}, devices=["cpu"] * 2)
    opt = port.AcceleratedGradientDescent(port.LogisticGradient(),
                                          port.SquaredL2Updater())
    assert opt.set_mesh(mm) is opt
    w = opt.set_num_iterations(2).optimize((X, y), np.zeros(3, np.float32))
    assert w.shape == (3,) and bool(torch.isfinite(w).all())


def test_builder_setters_and_aliases():
    b = port.AcceleratedGradientDescent(port.LogisticGradient(),
                                        port.SquaredL2Updater())
    assert b.setConvergenceTol(1e-3) is b
    (b.setNumIterations(7).setRegParam(0.2).setL0(2.0).setLexact(9.0)
     .setBeta(0.6).setAlpha(0.8).setMayRestart(False)
     .setGradient(port.HingeGradient()).setUpdater(port.L1Prox())
     .set_loss_mode("y"))
    assert (b._convergence_tol, b._num_iterations, b._reg_param, b._l0,
            b._l_exact, b._beta, b._alpha, b._may_restart, b._loss_mode) \
        == (1e-3, 7, 0.2, 2.0, 9.0, 0.6, 0.8, False, "y")
    assert isinstance(b._gradient, port.HingeGradient)
    assert isinstance(b._updater, port.L1Prox)
    jb = jpkg.AcceleratedGradientDescent(None, None)
    for name in dir(jb):
        if name.startswith("set"):
            assert hasattr(b, name), name


def test_class_logistic_on_cpu():
    X, y = device_synth.class_logistic(1000, 16, seed=3, device="cpu")
    assert X.shape == (1000, 16) and X.dtype == torch.float32
    assert y.shape == (1000,) and set(y.unique().tolist()) <= {0.0, 1.0}
    X2, y2 = device_synth.class_logistic(1000, 16, seed=3, device="cpu")
    assert torch.equal(X, X2) and torch.equal(y, y2)
    # the class means sit at ±mu with ‖mu‖ ≈ sep = 1
    mu = (X[y == 1].mean(0) - X[y == 0].mean(0)) / 2
    assert 0.6 < float(mu.norm()) < 1.6


def test_planted_dense_linreg_on_cpu():
    X, y = device_synth.planted_dense_linreg(600, 8, noise=0.0, seed=2,
                                             device="cpu")
    w = torch.linalg.lstsq(X, y[:, None]).solution[:, 0]
    assert float((X @ w - y).abs().max()) < 1e-4


def test_planted_softmax_on_cpu(monkeypatch):
    n, d, k = 600, 12, 5
    monkeypatch.setattr(device_synth, "_BLOCK_ROWS", 256)  # three blocks
    X, y = device_synth.planted_softmax(n, d, k, seed=4, device="cpu")
    assert X.shape == (n, d) and X.dtype == torch.float32
    assert y.shape == (n,) and y.dtype == torch.int32
    assert int(y.min()) >= 0 and int(y.max()) < k
    assert len(y.unique()) == k
    X2, y2 = device_synth.planted_softmax(n, d, k, seed=4, device="cpu")
    assert torch.equal(X, X2) and torch.equal(y, y2)
    # the in-place block fill equals generating each block on its own
    W = device_synth.softmax_params(d, k, seed=4, device="cpu")
    assert W.shape == (d, k)
    blocks = [device_synth.softmax_block(W, min(256, n - r0), seed=4,
                                         block=b)
              for b, r0 in enumerate(range(0, n, 256))]
    assert torch.equal(X, torch.cat([b[0] for b in blocks]))
    assert torch.equal(y, torch.cat([b[1] for b in blocks]))
    # labels follow the planted model: its argmax beats chance
    acc = float(((X @ W).argmax(1) == y).float().mean())
    assert acc > 1.5 / k
    # another seed, other data
    X3, _ = device_synth.planted_softmax(n, d, k, seed=5, device="cpu")
    assert not torch.equal(X, X3)


def test_numpy_synthetic_copy_matches_the_jax_package():
    from spark_agd_tpu.data import synthetic as jsyn

    for a, b in zip(synthetic.generate_gd_input(0.5, 2.0, 50, 7),
                    jsyn.generate_gd_input(0.5, 2.0, 50, 7)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        synthetic.with_intercept_column(np.ones((3, 2))),
        jsyn.with_intercept_column(np.ones((3, 2))))
    for a, b in zip(synthetic.generate_linear_input(np.ones(3), 20, 1),
                    jsyn.generate_linear_input(np.ones(3), 20, 1)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(synthetic.generate_multiclass_input(20, 4, 3, 2),
                    jsyn.generate_multiclass_input(20, 4, 3, 2)):
        np.testing.assert_array_equal(a, b)


def test_weights_round_trip():
    tree = {"w": np.arange(4.0), "b": [np.ones(2, np.float32)]}
    t = convert.weights_from_numpy(tree, "cpu")
    assert t["w"].dtype == torch.float64 and t["b"][0].dtype == torch.float32
    back = convert.weights_to_numpy(t)
    np.testing.assert_array_equal(back["w"], tree["w"])
    np.testing.assert_array_equal(back["b"][0], tree["b"][0])
    t32 = convert.weights_from_numpy(tree, "cpu", dtype=torch.float32)
    assert t32["w"].dtype == torch.float32


def test_chip_smoke_refuses_without_cuda():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
