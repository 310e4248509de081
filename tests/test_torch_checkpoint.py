"""The port's checkpoints (``utils/checkpoint.py``) against the JAX
package's, on the CPU.

The same numpy inputs, made from a seed, go through both packages.  A run
split into segments gives the straight run's bits (``rtol=0, atol=0``),
fused and host drivers, f64 and f32; the npz format, the ``.bak``
fallback and the typed corruption errors are the JAX package's; the
lanes and L-BFGS / OWL-QN resume exactly; ``problem_fingerprint`` is the
JAX string for every weight tree the port's trainers build; and a
checkpoint written by either package is finished by the other, held to
the uninterrupted JAX fit at the f64 standard of
``tests/test_agd_core.py`` (the same ``num_iters``, histories within
1e-9 relative, weights within 3e-7)."""

import dataclasses
import logging
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu.core import agd as jagd
from spark_agd_tpu.core import host_lbfgs as jhost_lbfgs
from spark_agd_tpu.core import lbfgs as jlbfgs, smooth as jsmooth
from spark_agd_tpu.ops import losses as jlosses, prox as jprox
from spark_agd_tpu.utils import checkpoint as jckpt
from spark_agd_tpu_torch.core import agd, host_agd, host_lbfgs
from spark_agd_tpu_torch.core import lbfgs as lbfgs_lib, smooth as tsmooth
from spark_agd_tpu_torch.models import mlp as tmlp
from spark_agd_tpu_torch.ops import losses, prox
from spark_agd_tpu_torch.utils import checkpoint as ckpt

DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32,
                                                      torch.float32)}


def _data(n=400, d=3, seed=42, dtype=np.float64):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.standard_normal((n, d - 1)),
                        np.ones((n, 1))], axis=1).astype(dtype)
    w_true = np.linspace(-1.5, 2.0, d)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ w_true))).astype(dtype)
    return X, y


def _port_problem(dtype=np.float64, reg=0.1, **kw):
    X, y = _data(dtype=dtype, **kw)
    build, args = tsmooth.make_smooth_staged(
        losses.LogisticGradient(), torch.from_numpy(X), torch.from_numpy(y))
    sm, sl = build(*args)
    px, rv = tsmooth.make_prox(prox.L2Prox(), reg)
    w0 = torch.zeros(X.shape[1], dtype=torch.from_numpy(X).dtype)
    return sm, sl, px, rv, w0


def _jax_problem(reg=0.1, **kw):
    X, y = _data(**kw)
    Xd, yd = jnp.asarray(X), jnp.asarray(y)
    sm = jsmooth.make_smooth(jlosses.LogisticGradient(), Xd, yd)
    sl = jsmooth.make_smooth_loss(jlosses.LogisticGradient(), Xd, yd)
    px, rv = jsmooth.make_prox(jprox.L2Prox(), reg)
    return sm, sl, px, rv, jnp.zeros(X.shape[1])


def _run(problem, n, warm=None, tol=0.0):
    sm, sl, px, rv, w0 = problem
    cfg = agd.AGDConfig(convergence_tol=tol, num_iterations=n)
    return agd.run_agd(sm, px, rv, w0, cfg, smooth_loss=sl, warm=warm)


def _np(t):
    return t.detach().cpu().numpy()


def _hold_f64(mine_w, mine_hist, mine_iters, ref):
    """The f64 standard against an uninterrupted JAX ``AGDResult``."""
    n = int(ref.num_iters)
    assert mine_iters == n
    np.testing.assert_allclose(np.asarray(mine_hist),
                               np.asarray(ref.loss_history)[:n], rtol=1e-9)
    np.testing.assert_allclose(np.asarray(mine_w), np.asarray(ref.weights),
                               rtol=3e-7, atol=1e-12)


# ---------------------------------------------------------------------------
# segment boundaries are invisible to the math


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("driver", ["fused", "host"])
def test_split_run_gives_the_straight_runs_bits(dtype, driver, tmp_path):
    problem = _port_problem(DTYPES[dtype][0])
    sm, sl, px, rv, w0 = problem
    single = _run(problem, 12)
    if driver == "fused":
        first = _run(problem, 5)
        second = _run(problem, 7, warm=ckpt.warm_from_result(first, 5))
        hist = torch.cat([first.loss_history[:5], second.loss_history[:7]])
    else:
        cfg = lambda k: agd.AGDConfig(convergence_tol=0.0, num_iterations=k)
        first = host_agd.run_agd_host(sm, px, rv, w0, cfg(5), smooth_loss=sl)
        second = host_agd.run_agd_host(
            sm, px, rv, w0, cfg(7), smooth_loss=sl,
            warm=ckpt.warm_from_result(first, 5))
        hist = np.concatenate([first.loss_history, second.loss_history])
    np.testing.assert_allclose(_np(second.weights), _np(single.weights),
                               rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(hist),
                               _np(single.loss_history[:12]), rtol=0,
                               atol=0)
    # and through the checkpointed driver, in segments of 5
    out = ckpt.run_agd_checkpointed(
        sm, px, rv, w0, agd.AGDConfig(convergence_tol=0.0,
                                      num_iterations=12),
        path=str(tmp_path / "run.npz"), segment_iters=5, smooth_loss=sl,
        driver=driver)
    assert out.num_iters == 12 and out.resumed_from == 0
    assert torch.equal(out.weights, single.weights)
    np.testing.assert_array_equal(
        out.loss_history, single.loss_history[:12].to(torch.float64).numpy())


def test_checkpointed_run_takes_jax_steps_and_resumes_as_a_no_op(tmp_path):
    problem = _port_problem()
    sm, sl, px, rv, w0 = problem
    cfg = agd.AGDConfig(convergence_tol=0.0, num_iterations=12)
    p = str(tmp_path / "run.npz")
    out = ckpt.run_agd_checkpointed(sm, px, rv, w0, cfg, path=p,
                                    segment_iters=5, smooth_loss=sl)
    jsm, jsl, jpx, jrv, jw0 = _jax_problem()
    ref = jagd.run_agd(jsm, jpx, jrv, jw0,
                       jagd.AGDConfig(convergence_tol=0.0, num_iterations=12),
                       smooth_loss=jsl)
    _hold_f64(_np(out.weights), out.loss_history, out.num_iters, ref)
    again = ckpt.run_agd_checkpointed(sm, px, rv, w0, cfg, path=p,
                                      segment_iters=5, smooth_loss=sl)
    assert again.resumed_from == 12 and again.num_iters == 12
    assert torch.equal(again.weights, out.weights)


def test_staged_split_and_the_host_driver_refuses_staged(tmp_path):
    X, y = _data()
    staged = tsmooth.make_smooth_staged(
        losses.LogisticGradient(), torch.from_numpy(X), torch.from_numpy(y))
    _, _, px, rv, w0 = _port_problem()
    closure = _run(_port_problem(), 12)
    cfg = agd.AGDConfig(convergence_tol=0.0, num_iterations=12)
    p = str(tmp_path / "staged.npz")
    out = ckpt.run_agd_checkpointed(None, px, rv, w0, cfg, path=p,
                                    segment_iters=5, staged=staged)
    assert torch.equal(out.weights, closure.weights)
    with pytest.raises(ValueError, match="fused driver only"):
        ckpt.run_agd_checkpointed(None, px, rv, w0, cfg, path=p,
                                  segment_iters=5, staged=staged,
                                  driver="host")
    with pytest.raises(ValueError, match="driver"):
        ckpt.run_agd_checkpointed(None, px, rv, w0, cfg, path=p,
                                  driver="banana")


def test_kill_and_resume_and_convergence_stop_segments(tmp_path):
    problem = _port_problem()
    sm, sl, px, rv, w0 = problem
    p = str(tmp_path / "killed.npz")
    ckpt.run_agd_checkpointed(
        sm, px, rv, w0, agd.AGDConfig(convergence_tol=0.0, num_iterations=6),
        path=p, segment_iters=3, smooth_loss=sl)
    out = ckpt.run_agd_checkpointed(
        sm, px, rv, w0, agd.AGDConfig(convergence_tol=0.0,
                                      num_iterations=12),
        path=p, segment_iters=3, smooth_loss=sl)
    assert out.resumed_from == 6
    assert torch.equal(out.weights, _run(problem, 12).weights)
    # a converged run leaves a terminal checkpoint: rerunning is a no-op
    p2 = str(tmp_path / "conv.npz")
    cfg = agd.AGDConfig(convergence_tol=1e-3, num_iterations=100)
    conv = ckpt.run_agd_checkpointed(sm, px, rv, w0, cfg, path=p2,
                                     segment_iters=10, smooth_loss=sl)
    assert conv.num_iters == int(_run(problem, 100, tol=1e-3).num_iters)
    assert conv.num_iters < 100
    again = ckpt.run_agd_checkpointed(sm, px, rv, w0, cfg, path=p2,
                                      segment_iters=10, smooth_loss=sl)
    assert again.resumed_from == conv.num_iters
    np.testing.assert_array_equal(again.loss_history, conv.loss_history)


def test_host_driver_kill_after_the_first_segment_resumes(tmp_path):
    problem = _port_problem()
    sm, sl, px, rv, w0 = problem
    cfg = agd.AGDConfig(num_iterations=6, convergence_tol=0.0)
    path = str(tmp_path / "h.npz")

    class Stop(Exception):
        pass

    real = ckpt.save_checkpoint
    calls = {"n": 0}

    def save_then_die(*a, **k):
        real(*a, **k)
        calls["n"] += 1
        if calls["n"] == 1:
            raise Stop()

    with mock.patch.object(ckpt, "save_checkpoint", save_then_die):
        with pytest.raises(Stop):
            ckpt.run_agd_checkpointed(sm, px, rv, w0, cfg, path=path,
                                      segment_iters=2, smooth_loss=sl,
                                      driver="host")
    resumed = ckpt.run_agd_checkpointed(sm, px, rv, w0, cfg, path=path,
                                        segment_iters=2, smooth_loss=sl,
                                        driver="host")
    assert resumed.resumed_from == 2 and resumed.num_iters == 6
    straight = host_agd.run_agd_host(sm, px, rv, w0, cfg, smooth_loss=sl)
    np.testing.assert_array_equal(resumed.loss_history,
                                  straight.loss_history)
    assert torch.equal(resumed.weights, straight.weights)


def test_resilience_retries_a_segment_from_its_saved_carry(tmp_path):
    from spark_agd_tpu_torch.resilience import RetryPolicy, faults

    problem = _port_problem()
    sm, sl, px, rv, w0 = problem
    flaky_sm = faults.flaky(sm, 1, exc=RuntimeError)
    out = ckpt.run_agd_checkpointed(
        flaky_sm, px, rv, w0,
        agd.AGDConfig(convergence_tol=0.0, num_iterations=8),
        path=str(tmp_path / "r.npz"), segment_iters=4, smooth_loss=sl,
        resilience=RetryPolicy(backoff_base=0.0, jitter=0.0))
    assert flaky_sm.calls() > 1
    assert torch.equal(out.weights, _run(problem, 8).weights)


# ---------------------------------------------------------------------------
# the file: roundtrip, fingerprint, trees


def test_save_load_roundtrip_and_missing_file(tmp_path):
    problem = _port_problem()
    res = _run(problem, 4)
    warm = ckpt.warm_from_result(res, 4)
    p = str(tmp_path / "ck.npz")
    hist = res.loss_history[:4].numpy()
    ckpt.save_checkpoint(p, warm, hist)
    ck = ckpt.load_checkpoint(p, problem[4])
    assert torch.equal(ck.warm.x, warm.x) and torch.equal(ck.warm.z, warm.z)
    assert ck.warm.theta == float(warm.theta)
    assert ck.warm.big_l == float(warm.big_l)
    assert ck.warm.bts == bool(warm.bts) and ck.warm.prior_iters == 4
    assert not ck.converged and not ck.aborted and ck.extras == {}
    np.testing.assert_array_equal(ck.loss_history, hist)
    assert ckpt.load_checkpoint(str(tmp_path / "nope.npz"),
                                problem[4]) is None
    # the JAX package reads the same file to the same carry
    jck = jckpt.load_checkpoint(p, jnp.zeros(3))
    np.testing.assert_array_equal(np.asarray(jck.warm.x), _np(warm.x))
    assert jck.warm.theta == ck.warm.theta and jck.warm.prior_iters == 4


def test_fingerprint_mismatch_raises_and_more_iterations_resume(tmp_path):
    sm, sl, px, rv, w0 = _port_problem()
    p = str(tmp_path / "fp.npz")
    ckpt.run_agd_checkpointed(
        sm, px, rv, w0, agd.AGDConfig(convergence_tol=0.0, num_iterations=4),
        path=p, segment_iters=2, smooth_loss=sl)
    with pytest.raises(ValueError, match="different problem"):
        ckpt.run_agd_checkpointed(
            sm, px, rv, w0, agd.AGDConfig(convergence_tol=0.0,
                                          num_iterations=8, l0=2.0),
            path=p, segment_iters=2, smooth_loss=sl)
    out = ckpt.run_agd_checkpointed(
        sm, px, rv, w0, agd.AGDConfig(convergence_tol=0.0, num_iterations=8),
        path=p, segment_iters=2, smooth_loss=sl)
    assert out.resumed_from == 4 and out.num_iters == 8


def test_tree_weights_roundtrip_onto_the_templates_device(tmp_path):
    tree = {"W": torch.ones((3, 2)), "b": torch.arange(2.0)}
    warm = agd.AGDWarmState(x=tree, z=tree, theta=np.inf, big_l=1.0,
                            bts=True, prior_iters=0)
    p = str(tmp_path / "tree.npz")
    ckpt.save_checkpoint(p, warm)
    loaded = ckpt.load_checkpoint(p, tree).warm
    assert set(loaded.x) == {"W", "b"}
    assert torch.equal(loaded.x["W"], torch.ones((3, 2)))
    assert loaded.x["b"].device == tree["b"].device
    assert loaded.theta == np.inf
    jtree = jckpt.load_checkpoint(p, {"W": jnp.ones((3, 2)),
                                      "b": jnp.zeros(2)}).warm.x
    np.testing.assert_array_equal(np.asarray(jtree["b"]), [0.0, 1.0])


def _trainer_trees():
    """(port tree, JAX tree) pairs: the weight trees the trainers build."""
    mlp = tmlp.init_mlp_params(5, 4, 3, seed=0, dtype=torch.float64,
                                device="cpu")
    return {
        "glm_f64": (torch.zeros(7, dtype=torch.float64), jnp.zeros(7)),
        "glm_f32": (torch.zeros(7), jnp.zeros(7, jnp.float32)),
        "softmax": (torch.zeros((6, 4)), jnp.zeros((6, 4), jnp.float32)),
        "mlp": (mlp, {k: jnp.asarray(_np(v)) for k, v in mlp.items()}),
        "tuple": ((torch.zeros(2),), (jnp.zeros(2, jnp.float32),)),
        "nested": ({"a": [torch.zeros(1), (torch.zeros(2, 2),)]},
                   {"a": [jnp.zeros(1, jnp.float32),
                          (jnp.zeros((2, 2), jnp.float32),)]}),
        "bf16": (torch.zeros(3, dtype=torch.bfloat16),
                 jnp.zeros(3, jnp.bfloat16)),
    }


@pytest.mark.parametrize("name", ["glm_f64", "glm_f32", "softmax", "mlp",
                                  "tuple", "nested", "bf16"])
def test_problem_fingerprint_is_the_jax_string(name):
    tree, jtree = _trainer_trees()[name]
    for cfg, jcfg in ((agd.AGDConfig(), jagd.AGDConfig()),
                      (agd.AGDConfig(l0=2, beta=1.0, loss_mode="y"),
                       jagd.AGDConfig(l0=2, beta=1.0, loss_mode="y")),
                      (lbfgs_lib.LBFGSConfig(num_corrections=4),
                       jlbfgs.LBFGSConfig(num_corrections=4))):
        assert ckpt.problem_fingerprint(tree, cfg) \
            == jckpt.problem_fingerprint(jtree, jcfg)


# ---------------------------------------------------------------------------
# cross-package resume


def _cross_problem():
    return _port_problem(), _jax_problem()


def test_a_jax_checkpoint_is_finished_by_the_port(tmp_path):
    (sm, sl, px, rv, w0), (jsm, jsl, jpx, jrv, jw0) = _cross_problem()
    p = str(tmp_path / "jax_then_port.npz")
    jckpt.run_agd_checkpointed(
        jsm, jpx, jrv, jw0,
        jagd.AGDConfig(convergence_tol=0.0, num_iterations=5),
        path=p, segment_iters=5, smooth_loss=jsl)
    out = ckpt.run_agd_checkpointed(
        sm, px, rv, w0, agd.AGDConfig(convergence_tol=0.0,
                                      num_iterations=14),
        path=p, segment_iters=3, smooth_loss=sl)
    assert out.resumed_from == 5
    ref = jagd.run_agd(jsm, jpx, jrv, jw0,
                       jagd.AGDConfig(convergence_tol=0.0,
                                      num_iterations=14), smooth_loss=jsl)
    _hold_f64(_np(out.weights), out.loss_history, out.num_iters, ref)


def test_a_port_checkpoint_is_finished_by_jax(tmp_path):
    (sm, sl, px, rv, w0), (jsm, jsl, jpx, jrv, jw0) = _cross_problem()
    p = str(tmp_path / "port_then_jax.npz")
    ckpt.run_agd_checkpointed(
        sm, px, rv, w0, agd.AGDConfig(convergence_tol=0.0, num_iterations=6),
        path=p, segment_iters=4, smooth_loss=sl)
    out = jckpt.run_agd_checkpointed(
        jsm, jpx, jrv, jw0,
        jagd.AGDConfig(convergence_tol=0.0, num_iterations=14),
        path=p, segment_iters=4, smooth_loss=jsl)
    assert out.resumed_from == 6
    ref = jagd.run_agd(jsm, jpx, jrv, jw0,
                       jagd.AGDConfig(convergence_tol=0.0,
                                      num_iterations=14), smooth_loss=jsl)
    _hold_f64(out.weights, out.loss_history, out.num_iters, ref)


def test_a_converged_jax_checkpoint_is_terminal_in_the_port(tmp_path):
    (sm, sl, px, rv, w0), (jsm, jsl, jpx, jrv, jw0) = _cross_problem()
    p = str(tmp_path / "conv.npz")
    jout = jckpt.run_agd_checkpointed(
        jsm, jpx, jrv, jw0,
        jagd.AGDConfig(convergence_tol=1e-3, num_iterations=100),
        path=p, segment_iters=10, smooth_loss=jsl)
    out = ckpt.run_agd_checkpointed(
        sm, px, rv, w0, agd.AGDConfig(convergence_tol=1e-3,
                                      num_iterations=100),
        path=p, segment_iters=10, smooth_loss=sl)
    assert out.resumed_from == out.num_iters == jout.num_iters < 100
    np.testing.assert_array_equal(_np(out.weights), np.asarray(jout.weights))


# ---------------------------------------------------------------------------
# the lanes


def _lanes_problem(k=3, n=300, d=4, seed=6):
    X, y = _data(n=n, d=d, seed=seed)
    sm, sl = tsmooth.lanes_smooth(
        losses.LogisticGradient(),
        *losses.LogisticGradient().prepare(torch.from_numpy(X),
                                           torch.from_numpy(y), None))
    px, rv = host_agd.make_prox_multi(prox.L2Prox(),
                                      [0.3, 0.03, 0.003][:k])
    w0 = torch.zeros((k, d), dtype=torch.float64)
    return sm, sl, px, rv, w0


def test_lanes_kill_and_resume_gives_the_straight_bits(tmp_path):
    sm, sl, px, rv, w0 = _lanes_problem()
    cfg = agd.AGDConfig(convergence_tol=1e-6, num_iterations=30)
    straight = host_agd.run_agd_host_multi(sm, px, rv, w0, cfg,
                                           smooth_loss_multi=sl)
    p = str(tmp_path / "multi.npz")
    part = ckpt.run_agd_multi_checkpointed(
        sm, px, rv, w0, dataclasses.replace(cfg, num_iterations=7), path=p,
        segment_iters=3, smooth_loss_multi=sl)
    assert (part.num_iters == 7).all()
    full = ckpt.run_agd_multi_checkpointed(sm, px, rv, w0, cfg, path=p,
                                           segment_iters=4,
                                           smooth_loss_multi=sl)
    assert (full.resumed_from == 7).all()
    assert torch.equal(full.weights, straight.weights)
    np.testing.assert_array_equal(full.num_iters, straight.num_iters)
    np.testing.assert_array_equal(full.converged, straight.converged)
    np.testing.assert_array_equal(full.loss_history, straight.loss_history)
    ckpt.save_checkpoint(p, agd.AGDWarmState.initial(torch.zeros(4),
                                                     agd.AGDConfig()))
    with pytest.raises(ValueError, match="single-run"):
        ckpt.load_multi_checkpoint(p, w0)


# ---------------------------------------------------------------------------
# L-BFGS and OWL-QN


def _objective(reg=0.04, seed=5, n=300, d=8):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = (rng.random(n) < 0.5).astype(np.float64)
    sm = tsmooth.make_smooth(losses.LogisticGradient(), torch.from_numpy(X),
                             torch.from_numpy(y))
    return lbfgs_lib.make_objective(sm, prox.SquaredL2Updater(), reg), d


LBFGS_CFG = lbfgs_lib.LBFGSConfig(convergence_tol=1e-11, num_iterations=40)


def test_lbfgs_segmented_and_killed_runs_give_the_straight_bits(tmp_path):
    obj, d = _objective()
    w0 = torch.zeros(d, dtype=torch.float64)
    straight = host_lbfgs.run_lbfgs_host(obj, w0, LBFGS_CFG)
    seg = ckpt.run_lbfgs_checkpointed(obj, w0, LBFGS_CFG,
                                      str(tmp_path / "lb.npz"),
                                      segment_iters=2)
    assert seg.resumed_from == 0 and seg.converged == straight.converged
    assert seg.num_iters == straight.num_iters
    assert torch.equal(seg.weights, straight.weights)
    np.testing.assert_array_equal(seg.loss_history, straight.loss_history)
    path = str(tmp_path / "killed.npz")
    part = ckpt.run_lbfgs_checkpointed(
        obj, w0, dataclasses.replace(LBFGS_CFG, num_iterations=4), path,
        segment_iters=2)
    assert part.num_iters == 4 and not part.converged
    full = ckpt.run_lbfgs_checkpointed(obj, w0, LBFGS_CFG, path,
                                       segment_iters=3)
    assert full.resumed_from == 4
    assert torch.equal(full.weights, straight.weights)
    np.testing.assert_array_equal(full.loss_history, straight.loss_history)


def test_lbfgs_terminal_checkpoint_and_wrong_loaders(tmp_path):
    obj, d = _objective()
    w0 = torch.zeros(d, dtype=torch.float64)
    path = str(tmp_path / "lb.npz")
    first = ckpt.run_lbfgs_checkpointed(obj, w0, LBFGS_CFG, path,
                                        segment_iters=5)
    assert first.converged
    calls = []
    again = ckpt.run_lbfgs_checkpointed(
        lambda w: (calls.append(1), obj(w))[1], w0, LBFGS_CFG, path,
        segment_iters=5)
    assert calls == [] and again.num_iters == first.num_iters
    with pytest.raises(ValueError, match="L-BFGS checkpoint"):
        ckpt.load_checkpoint(path, w0)
    agd_path = str(tmp_path / "agd.npz")
    ckpt.save_checkpoint(agd_path, agd.AGDWarmState.initial(
        w0, agd.AGDConfig()))
    with pytest.raises(ValueError, match="not an L-BFGS"):
        ckpt.load_lbfgs_checkpoint(agd_path, w0)


def test_owlqn_kill_and_resume_and_the_strength_fingerprint(tmp_path):
    obj, d = _objective(reg=0.0)
    w0 = torch.zeros(d, dtype=torch.float64)
    straight = host_lbfgs.run_owlqn_host(obj, w0, 0.05, LBFGS_CFG)
    path = str(tmp_path / "owl.npz")
    part = ckpt.run_lbfgs_checkpointed(
        obj, w0, dataclasses.replace(LBFGS_CFG, num_iterations=3), path,
        segment_iters=2, l1_reg=0.05)
    assert part.num_iters == 3
    full = ckpt.run_lbfgs_checkpointed(obj, w0, LBFGS_CFG, path,
                                       segment_iters=4, l1_reg=0.05)
    assert full.resumed_from == 3
    assert torch.equal(full.weights, straight.weights)
    np.testing.assert_array_equal(full.loss_history, straight.loss_history)
    with pytest.raises(ValueError, match="different problem"):
        ckpt.run_lbfgs_checkpointed(obj, w0, LBFGS_CFG, path,
                                    segment_iters=4, l1_reg=0.2)


def test_a_jax_lbfgs_checkpoint_is_finished_by_the_port(tmp_path):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((300, 8))
    y = (rng.random(300) < 0.5).astype(np.float64)
    jsm = jsmooth.make_smooth(jlosses.LogisticGradient(), jnp.asarray(X),
                              jnp.asarray(y))
    jobj = jlbfgs.make_objective(jsm, jprox.SquaredL2Updater(), 0.04)
    jcfg = jlbfgs.LBFGSConfig(convergence_tol=1e-11, num_iterations=40)
    path = str(tmp_path / "jlb.npz")
    jckpt.run_lbfgs_checkpointed(
        jobj, np.zeros(8), dataclasses.replace(jcfg, num_iterations=4),
        path, segment_iters=2)
    obj, d = _objective()
    out = ckpt.run_lbfgs_checkpointed(
        obj, torch.zeros(d, dtype=torch.float64), LBFGS_CFG, path,
        segment_iters=3)
    assert out.resumed_from == 4
    ref = jhost_lbfgs.run_lbfgs_host(jobj, np.zeros(8), jcfg)
    assert out.num_iters == ref.num_iters
    np.testing.assert_allclose(out.loss_history, ref.loss_history,
                               rtol=1e-9)
    np.testing.assert_allclose(_np(out.weights), np.asarray(ref.weights),
                               rtol=3e-7, atol=1e-12)


# ---------------------------------------------------------------------------
# corruption: typed errors and the .bak generation


def _save(path, iters, problem):
    res = _run(problem, iters)
    warm = ckpt.warm_from_result(res, iters)
    ckpt.save_checkpoint(path, warm, res.loss_history[:iters].numpy())
    return warm


def _truncate_to(path, keep):
    with open(path, "r+b") as f:
        f.truncate(keep)


def _size(path):
    with open(path, "rb") as f:
        return len(f.read())


@pytest.mark.parametrize("cut", ["third", "tail", "garbage"])
def test_a_torn_file_raises_the_typed_error(cut, tmp_path):
    problem = _port_problem()
    path = str(tmp_path / "c.npz")
    if cut == "garbage":
        with open(path, "wb") as f:
            f.write(b"\x00not a zip archive at all\xff" * 40)
    else:
        _save(path, 4, problem)
        _truncate_to(path, _size(path) // 3 if cut == "third"
                     else _size(path) - 30)
    with pytest.raises(ckpt.CheckpointCorruptError, match="c.npz"):
        ckpt.load_checkpoint(path, problem[4])
    with pytest.raises(jckpt.CheckpointCorruptError):
        jckpt.load_checkpoint(path, jnp.zeros(3))


def test_a_rewritten_entry_fails_its_crc(tmp_path):
    """An archive rewritten with one entry changed (its zip CRCs
    consistent) fails the ``__crc32__`` check, in both packages."""
    problem = _port_problem()
    path = str(tmp_path / "c.npz")
    _save(path, 4, problem)
    with np.load(path) as data:
        entries = {k: np.asarray(data[k]) for k in data.files}
    entries["x_0"] = entries["x_0"] + 1.0
    with open(path, "wb") as f:
        np.savez(f, **entries)
    with pytest.raises(ckpt.CheckpointCorruptError, match="CRC32"):
        ckpt.load_checkpoint(path, problem[4])
    with pytest.raises(jckpt.CheckpointCorruptError, match="CRC32"):
        jckpt.load_checkpoint(path, jnp.zeros(3))


def test_the_bak_generation_is_the_fallback(tmp_path, caplog):
    problem = _port_problem()
    path = str(tmp_path / "c.npz")
    warm_old = _save(path + ".bak", 3, problem)
    _save(path, 6, problem)
    _truncate_to(path, 10)
    with caplog.at_level(logging.WARNING, logger="spark_agd_tpu"):
        loaded = ckpt.load_checkpoint(path, problem[4])
    assert int(loaded.warm.prior_iters) == 3
    assert torch.equal(loaded.warm.x, warm_old.x)
    assert any("falling back" in r.message for r in caplog.records)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_checkpoint(path, problem[4], fallback_to_bak=False)
    with open(path + ".bak", "wb") as f:
        f.write(b"also garbage")
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_checkpoint(path, problem[4])


def test_multi_and_lbfgs_loaders_raise_the_typed_error(tmp_path):
    path = str(tmp_path / "g.npz")
    with open(path, "wb") as f:
        f.write(b"garbage")
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_multi_checkpoint(path, torch.zeros((2, 3)))
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_lbfgs_checkpoint(path, torch.zeros(3))


def test_rider_entries_ride_and_may_not_collide(tmp_path):
    problem = _port_problem()
    warm = ckpt.warm_from_result(_run(problem, 2), 2)
    path = str(tmp_path / "r.npz")
    ckpt.save_checkpoint(path, warm, extra={"stream_pass": np.asarray(1)})
    assert ckpt.load_checkpoint(path, problem[4]).extras == {
        "stream_pass": 1}
    assert jckpt.load_checkpoint(path, jnp.zeros(3)).extras == {
        "stream_pass": 1}
    with pytest.raises(ValueError, match="collides"):
        ckpt.save_checkpoint(path, warm, extra={"theta": 1.0})


def test_the_port_module_keeps_the_jax_entry_names():
    assert ckpt.CRC_ENTRY == jckpt.CRC_ENTRY
    warm = agd.AGDWarmState.initial(torch.zeros(2), agd.AGDConfig())
    jwarm = jagd.AGDWarmState.initial(jnp.zeros(2), jagd.AGDConfig())
    assert set(ckpt.warm_payload(warm, extra={"stream_n": 1})) \
        == set(jckpt.warm_payload(jwarm, extra={"stream_n": 1}))


def test_atomic_savez_writes_the_jax_bytes(tmp_path):
    """The bytes of a checkpoint file are the JAX package's for the same
    payload (the zip entries' timestamps held to one second)."""
    warm = ckpt.host_warm(agd.AGDWarmState.initial(
        torch.arange(5, dtype=torch.float64), agd.AGDConfig()))
    payload = ckpt.warm_payload(warm, np.linspace(1.0, 0.5, 7),
                                fingerprint="fp", extra={"stream_pass": 3})
    with mock.patch("time.time", return_value=1.7e9):
        ckpt.atomic_savez(str(tmp_path / "port.npz"), payload)
        jckpt.atomic_savez(str(tmp_path / "jax.npz"), payload)
    assert (tmp_path / "port.npz").read_bytes() \
        == (tmp_path / "jax.npz").read_bytes()
    assert ckpt.read_npz_entries(str(tmp_path / "port.npz")).keys() \
        == payload.keys()
