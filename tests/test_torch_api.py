"""The port's API surface against the JAX package's: the keywords a
reference call site passes (``dist_mode=``, ``verbose=``) either work or
raise the port's ``NotImplementedError`` naming a later slice, never a
``TypeError``; the packaging ships the native parser's sources; the
Optimizer family's names are exported."""

import inspect
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

import spark_agd_tpu as jpkg
from spark_agd_tpu import api as japi
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch import api as tapi

ROOT = Path(__file__).resolve().parents[1]


def _data(n=64, d=4, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = (rng.random(n) < 1 / (1 + np.exp(-X[:, 0]))).astype(float)
    return X, y


@pytest.mark.parametrize("name", ["run", "make_runner", "run_lbfgs",
                                  "make_lbfgs_runner", "run_minibatch_sgd",
                                  "streaming_sweep", "streaming_lbfgs_sweep"])
def test_port_takes_every_keyword_of_the_jax_entry_point(name):
    jparams = inspect.signature(getattr(japi, name)).parameters
    tparams = inspect.signature(getattr(tapi, name)).parameters
    missing = [p for p in jparams if p not in tparams]
    assert not missing, missing
    for p in jparams:
        if jparams[p].default is not inspect.Parameter.empty \
                and p not in ("mesh",):
            assert tparams[p].default == jparams[p].default, p


@pytest.mark.parametrize("mode", ["shard_map", "auto"])
def test_dist_mode_is_accepted_and_inert_without_a_mesh(mode):
    X, y = _data()
    kw = dict(reg_param=0.1, num_iterations=6, initial_weights=np.zeros(4),
              device="cpu")
    w, h = port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                    dist_mode=mode, **kw)
    w_ref, h_ref = port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                            **kw)
    assert torch.equal(w, w_ref) and np.array_equal(h, h_ref)
    fit = port.make_runner((X, y), port.LogisticGradient(), port.L2Prox(),
                           reg_param=0.1, num_iterations=6, dist_mode=mode,
                           device="cpu")
    assert torch.equal(fit(np.zeros(4)).weights, w_ref)
    opt = (port.AcceleratedGradientDescent(port.LogisticGradient(),
                                           port.L2Prox())
           .setRegParam(0.1).setNumIterations(6).set_device("cpu"))
    assert opt.set_dist_mode(mode) is opt and opt._dist_mode == mode
    assert opt.setDistMode(mode) is opt
    assert torch.equal(opt.optimize((X, y), np.zeros(4)), w_ref)
    # the JAX package accepts the same call on one device
    jpkg.run((X, y), jpkg.LogisticGradient(), jpkg.L2Prox(),
             reg_param=0.1, num_iterations=2, initial_weights=np.zeros(4),
             mesh=False, dist_mode=mode)


def test_unknown_dist_mode_raises_value_error():
    X, y = _data()
    with pytest.raises(ValueError, match="dist_mode"):
        port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                 initial_weights=np.zeros(4), device="cpu",
                 dist_mode="gspmd")
    with pytest.raises(ValueError, match="dist_mode"):
        port.make_runner((X, y), port.LogisticGradient(), port.L2Prox(),
                         device="cpu", dist_mode="")
    opt = port.AcceleratedGradientDescent(port.LogisticGradient(),
                                          port.L2Prox()).set_device("cpu")
    with pytest.raises(ValueError, match="dist_mode"):
        opt.set_dist_mode("pmap").optimize((X, y), np.zeros(4))


def test_verbose_true_logs_the_fits_lines_and_false_logs_none(caplog):
    """``verbose=True`` raised until ``utils/logging.py`` and
    ``obs/schema.py`` were ported; it now logs the fit's lines (as the
    JAX package does), and ``verbose=False`` logs nothing."""
    import logging

    X, y = _data()
    kw = dict(initial_weights=np.zeros(4), num_iterations=2, device="cpu")
    with caplog.at_level(logging.INFO, logger="spark_agd_tpu"):
        w, h = port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                        verbose=True, **kw)
    lines = [r.getMessage() for r in caplog.records
             if r.name == "spark_agd_tpu"]
    assert len(h) == 2 and len(lines) == 3
    assert lines[0].startswith("iter=1 ")
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="spark_agd_tpu"):
        w, h = port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                        verbose=False, **kw)
    assert len(h) == 2
    assert not [r for r in caplog.records if r.name == "spark_agd_tpu"]


def test_pyproject_ships_the_native_parser_sources():
    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    data = cfg["tool"]["setuptools"]["package-data"]
    assert data["spark_agd_tpu_torch.native"] == ["*.cpp", "Makefile"]
    assert data["spark_agd_tpu.native"] == ["*.cpp", "Makefile"]
    assert data["spark_agd_tpu_torch"] == ["csrc/*.cu", "csrc/*.cuh"]
    native = ROOT / "spark_agd_tpu_torch" / "native"
    assert list(native.glob("*.cpp")) and (native / "Makefile").is_file()


EXPORTS = [
    "run_minibatch_sgd", "run_minibatch_agd", "LBFGS", "LBFGSConfig",
    "LBFGSResult", "run_lbfgs", "run_owlqn", "make_lbfgs_runner",
    "make_lbfgs_objective", "run_lbfgs_host", "run_owlqn_host",
    "HostLBFGSResult", "HostLBFGSWarm", "LogisticRegressionWithLBFGS",
    "SoftmaxRegressionWithLBFGS", "MLPClassifierWithAGD", "MLPModel",
    "mlp_gradient", "GDResult"]


@pytest.mark.parametrize("name", EXPORTS)
def test_optimizer_family_is_exported_as_in_the_jax_package(name):
    from spark_agd_tpu.core import gd
    from spark_agd_tpu.models import glm, mlp

    assert hasattr(port, name), name
    assert any(hasattr(m, name) for m in (jpkg, gd, glm, mlp)), name
