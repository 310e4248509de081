"""The GD comparator (``core/gd.py``, ``api.run_minibatch_sgd``,
``api.run_minibatch_agd``) and its sampler (``core/prng.py``) against
the JAX package, on the CPU.

The sampler gives ``jax.random.bernoulli``'s bits: 64-bit words for an
f64 draw (a Python-float ``p`` under x64, as this suite runs JAX), 32-bit
words for an f32 draw (``jnp.float32(p)``, the TPU's mode without x64).
GD at f64 takes the JAX trajectory step for step: loss histories within
1e-9 relative (NaN entries equal), weights within 3e-7 (the oracle
tolerances of ``tests/test_agd_core.py:75-88``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu import api as japi
from spark_agd_tpu.ops import losses as jlosses, prox as jprox
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.core import gd, prng
from spark_agd_tpu_torch.ops import fused_kernels as fk


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("it", [1, 2, 50])
@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_sampler_gives_jax_bernoulli_bits(seed, it, dtype):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), it)
    tkey = prng.fold_in(prng.prng_key(seed), it)
    assert tkey == tuple(int(v) for v in np.asarray(key))
    tdt = torch.float32 if dtype == "f32" else torch.float64
    for n in (1, 7, 4_099):
        for p in (0.37, 0.5, 0.9):
            jp = jnp.float32(p) if dtype == "f32" else p
            want = np.asarray(jax.random.bernoulli(key, jp, (n,)))
            got = prng.bernoulli(tkey, p, n, dtype=tdt, device="cpu")
            assert got.dtype == torch.bool and got.shape == (n,)
            np.testing.assert_array_equal(got.numpy(), want)
        mask = prng.sample_mask(seed, it, 0.37, n, dtype=tdt, device="cpu")
        assert mask.dtype == tdt
        np.testing.assert_array_equal(
            mask.numpy(), np.asarray(jax.random.bernoulli(
                key, jnp.float32(0.37) if dtype == "f32" else 0.37,
                (n,))).astype(mask.numpy().dtype))


def test_sampler_edges():
    key = prng.fold_in(prng.prng_key(3), 1)
    assert not prng.bernoulli(key, 0.0, 64, dtype=torch.float64,
                              device="cpu").any()
    assert prng.bernoulli(key, 1.0, 64, dtype=torch.float64,
                          device="cpu").all()
    with pytest.raises(ValueError, match="f32 or f64"):
        prng.bernoulli(key, 0.5, 4, dtype=torch.float16, device="cpu")
    # the raw hash against JAX's threefry_2x32 at a few counters
    from jax._src import prng as jprng

    k = jnp.asarray([7, 11], jnp.uint32)
    c = jnp.arange(6, dtype=jnp.uint32)
    want = np.asarray(jprng.threefry_2x32(k, c))
    x0, x1 = prng.threefry2x32(7, 11, torch.arange(3), torch.arange(3, 6))
    np.testing.assert_array_equal(np.concatenate([x0.numpy(), x1.numpy()]),
                                  want)


def _problem(seed=5, n=320, d=6, kind="logistic"):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    w_true = rng.normal(size=d)
    if kind == "logistic":
        y = (rng.random(n) < 1 / (1 + np.exp(-X @ w_true))).astype(float)
    else:
        y = X @ w_true + 0.1 * rng.normal(size=n)
    return X, y


UPDATERS = {
    "simple": (jprox.SimpleUpdater, port.SimpleUpdater, 0.0),
    "l2": (jprox.SquaredL2Updater, port.SquaredL2Updater, 0.1),
    "l1": (jprox.L1Updater, port.L1Updater, 0.05),
}


def _gd_both(X, y, kind, name, frac, iters=25, step=1.0, mask=None,
             seed=42):
    jp, tp, reg = UPDATERS[name]
    loss = "logistic" if kind == "logistic" else "least_squares"
    data = (X, y) if mask is None else (X, y, mask)
    w0 = np.zeros(X.shape[1])
    jw, jh = japi.run_minibatch_sgd(
        data, jlosses.GRADIENTS[loss](), jp(), step, iters, reg, frac, w0,
        seed, mesh=False)
    tw, th = port.run_minibatch_sgd(
        data, port.GRADIENTS[loss](), tp(), step, iters, reg, frac, w0,
        seed, device="cpu")
    return (np.asarray(jw), np.asarray(jh)), (tw, th)


def _assert_same(j, t):
    (jw, jh), (tw, th) = j, t
    assert th.shape == jh.shape and th.dtype == jh.dtype
    np.testing.assert_array_equal(np.isnan(th), np.isnan(jh))
    np.testing.assert_allclose(th, jh, rtol=1e-9)
    np.testing.assert_allclose(tw.numpy(), jw, rtol=3e-7, atol=1e-12)


@pytest.mark.parametrize("frac", [1.0, 0.3], ids=["full", "sampled"])
@pytest.mark.parametrize("name", sorted(UPDATERS))
def test_gd_matches_jax_step_for_step(name, frac):
    X, y = _problem()
    _assert_same(*_gd_both(X, y, "logistic", name, frac))


def test_gd_least_squares_with_a_padding_mask_matches_jax():
    X, y = _problem(seed=6, kind="least_squares")
    mask = (np.random.default_rng(2).random(len(y)) < 0.8).astype(float)
    _assert_same(*_gd_both(X, y, "least_squares", "l2", 0.5, step=0.1,
                           mask=mask))


def test_gd_all_empty_samples_record_nan_and_skip_the_update():
    X, y = _problem(n=40)
    j, t = _gd_both(X, y, "logistic", "l2", 1e-9, iters=6)
    _assert_same(j, t)
    assert np.isnan(t[1]).all()
    assert not t[0].any()  # no update: the zero start stands


def test_gd_some_empty_samples_match_jax():
    """Three rows at fraction 0.3: some iterations draw no row."""
    X, y = _problem(n=3)
    j, t = _gd_both(X, y, "logistic", "simple", 0.3, iters=20)
    assert np.isnan(t[1]).any() and not np.isnan(t[1]).all()
    _assert_same(j, t)


def test_gd_f32_draws_32_bit_words():
    """An f32 carry samples with 32-bit words: the JAX package's masks
    without x64, ``bernoulli(key, float32(p))``."""
    X, y = _problem(n=500)
    X32, y32 = X.astype(np.float32), y.astype(np.float32)
    seen = []

    class Recording(port.LogisticGradient):
        def batch_loss_and_grad(self, weights, X, y, mask=None):
            seen.append(mask.clone())
            return super().batch_loss_and_grad(weights, X, y, mask)

    port.run_minibatch_sgd((X32, y32), Recording(), port.SimpleUpdater(),
                           num_iterations=3, minibatch_fraction=0.4,
                           initial_weights=np.zeros(6, np.float32), seed=9,
                           device="cpu")
    for it, m in enumerate(seen, start=1):
        key = jax.random.fold_in(jax.random.PRNGKey(9), it)
        want = np.asarray(jax.random.bernoulli(key, jnp.float32(0.4),
                                               (500,)))
        assert m.dtype == torch.float32
        np.testing.assert_array_equal(m.numpy() > 0, want)


def test_fused_gd_stages_once_and_launches_per_iteration(monkeypatch):
    """``FusedLogisticGradient`` is prepared once; each sampled iteration
    folds its sample into the staged mask (X never staged again) and
    makes one kernel call; on the CPU the plain version, equal to the
    plain loss at f32."""
    X, y = _problem(n=400)
    X32, y32 = X.astype(np.float32), y.astype(np.float32)
    stagings, xs = [], []
    real_stage = fk.stage_dense
    monkeypatch.setattr(fk, "stage_dense",
                        lambda *a: stagings.append(1) or real_stage(*a))

    class Counting(port.FusedLogisticGradient):
        def batch_loss_and_grad(self, weights, X, y, mask=None):
            assert isinstance(X, fk.StagedDense)
            xs.append(X.X.data_ptr())
            return super().batch_loss_and_grad(weights, X, y, mask)

    w0 = np.zeros(6, np.float32)
    wf, hf = port.run_minibatch_sgd(
        (X32, y32), Counting(), port.SquaredL2Updater(), 1.0, 12, 0.1, 0.5,
        w0, 4, device="cpu")
    assert len(stagings) == 1 and len(xs) == 12 and len(set(xs)) == 1
    wp, hp = port.run_minibatch_sgd(
        (X32, y32), port.LogisticGradient(), port.SquaredL2Updater(), 1.0,
        12, 0.1, 0.5, w0, 4, device="cpu")
    assert wf.dtype == torch.float32 and hf.dtype == np.float32
    np.testing.assert_allclose(hf, hp, rtol=1e-5)
    np.testing.assert_allclose(wf.numpy(), wp.numpy(), rtol=1e-4, atol=1e-6)


def test_staged_dense_masked_composes_with_the_padding_mask():
    X = torch.randn(6, 3)
    staged = fk.stage_dense(X, torch.zeros(6),
                            torch.tensor([1.0, 1, 0, 1, 1, 0]))
    out = staged.masked(torch.tensor([1.0, 0, 1, 1, 0, 1],
                                     dtype=torch.float64))
    assert out.X is staged.X and out.y is staged.y
    np.testing.assert_array_equal(out.m.numpy(), [1, 0, 0, 1, 0, 0])
    assert out.m.dtype == torch.float32 and int(out.n_valid) == 2


def test_core_gd_on_dict_weights_through_custom_gradient():
    """The comparator maps over a dict of weights like the AGD core."""
    X, y = _problem(n=64, d=3)
    Xt, yt = torch.tensor(X), torch.tensor(y)

    def loss_sum(w, X, y, mask=None):
        z = X @ w["a"] + w["b"]
        per = torch.logaddexp(z, torch.zeros_like(z)) - y * z
        return (per if mask is None else per * mask).sum()

    w0 = {"a": torch.zeros(3, dtype=torch.float64),
          "b": torch.zeros((), dtype=torch.float64)}
    res = gd.run_minibatch_sgd(port.CustomGradient(loss_sum, True),
                               port.L2Prox(), Xt, yt, w0, num_iterations=10,
                               reg_param=0.01, minibatch_fraction=0.5)
    h = res.loss_history.numpy()
    assert np.isfinite(h).all() and h[-1] < h[0]
    assert set(res.weights) == {"a", "b"}


@pytest.mark.parametrize("masked", [False, True])
def test_run_minibatch_agd_matches_jax(masked):
    X, y = _problem(seed=7)
    data = (X, y)
    if masked:
        data = (X, y, (np.arange(len(y)) % 4 != 0).astype(np.float64))
    kw = dict(reg_param=0.1, num_iterations=20, initial_weights=np.zeros(6),
              return_result=True)
    jw, jh, jr = japi.run_minibatch_agd(
        data, jlosses.LogisticGradient(), jprox.SquaredL2Updater(),
        minibatch_fraction=0.5, seed=3, mesh=False, **kw)
    tw, th, tr = port.run_minibatch_agd(
        data, port.LogisticGradient(), port.SquaredL2Updater(),
        minibatch_fraction=0.5, seed=3, device="cpu", **kw)
    assert int(tr.num_iters) == int(jr.num_iters)
    assert int(tr.num_backtracks) == int(jr.num_backtracks)
    np.testing.assert_allclose(th, jh, rtol=1e-9)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=3e-7,
                               atol=1e-12)


def test_run_minibatch_agd_keeps_a_tensor_mask_on_its_device():
    """A tensor mask takes the numpy sample on its own device (the JAX
    code's ``np.asarray(mask) * sample`` cannot read a CUDA mask)."""
    X, y = _problem(seed=8)
    mask = torch.ones(len(y), dtype=torch.float64)
    kw = dict(reg_param=0.1, num_iterations=5, initial_weights=np.zeros(6),
              device="cpu")
    wa, ha = port.run_minibatch_agd((X, y, mask), port.LogisticGradient(),
                                    port.SquaredL2Updater(),
                                    minibatch_fraction=0.5, seed=1, **kw)
    wb, hb = port.run_minibatch_agd((X, y), port.LogisticGradient(),
                                    port.SquaredL2Updater(),
                                    minibatch_fraction=0.5, seed=1, **kw)
    assert torch.equal(wa, wb) and np.array_equal(ha, hb)


def test_minibatch_entry_points_reject_what_they_do_not_take(monkeypatch):
    X, y = _problem(n=16)
    with pytest.raises(ValueError, match="minibatch_fraction"):
        port.run_minibatch_agd((X, y), port.LogisticGradient(),
                               port.L2Prox(), minibatch_fraction=0.0)
    with pytest.raises(ValueError, match="initial_weights"):
        port.run_minibatch_sgd((X, y), port.LogisticGradient(),
                               port.L2Prox(), device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        port.run_minibatch_sgd((X, y), port.LogisticGradient(),
                               port.L2Prox(), initial_weights=np.zeros(6),
                               mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.run_minibatch_sgd((X, y), port.LogisticGradient(),
                               port.L2Prox(), initial_weights=np.zeros(6))
