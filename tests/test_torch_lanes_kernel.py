"""The lanes of the port's margin losses against the JAX package.

``fused_margin_lanes_loss_grad`` evaluates K weight vectors at once, the
counterpart of ``jax.vmap`` of the Pallas margin kernel over the weights
(what ``api.sweep`` runs).  On the CPU its wrapper runs the plain
version; these tests hold it, through ``FusedMarginGradient.prepare`` and
``lanes_loss_and_grad``, to ``jax.vmap`` of
``PallasMarginGradient(interpret=True).batch_loss_and_grad`` at the
tolerances of ``tests/test_pallas.py`` (loss rtol 1e-5, gradient
rtol/atol 1e-4), and the plain losses' lanes to ``jax.vmap`` of the jnp
losses at f64 within 1e-12.  The CUDA kernel runs only on the card
(``test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu.ops import losses as jlosses
from spark_agd_tpu.ops.pallas_kernels import PallasMarginGradient
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.ops import fused_kernels as fk, losses

LOSSES = ["logistic", "least_squares", "hinge"]
WIDTHS = (1, 3, 33, 130)
LANES = (1, 3, 8)


def _data(d, n=37, k=8, seed=0):
    """37 rows: Pallas pads them to its tiles, the CUDA kernel masks the
    ragged edge itself."""
    rng = np.random.default_rng(seed + d)
    X = rng.standard_normal((n, d)).astype(np.float32)
    W = (rng.standard_normal((k, d)) / np.sqrt(d)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    return X, W, y, mask


def _pallas_lanes(name, X, W, y, mask):
    """``jax.vmap`` of the Pallas kernel (interpret mode) over W's rows."""
    g = PallasMarginGradient(jlosses.GRADIENTS[name](), interpret=True)
    Xp, yp, mp = g.prepare(jnp.asarray(X), jnp.asarray(y),
                           None if mask is None else jnp.asarray(mask))
    return jax.vmap(lambda w: g.batch_loss_and_grad(w, Xp, yp, mp))(
        jnp.asarray(W))


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", LOSSES)
def test_lanes_match_vmapped_pallas_interpret(name, dtype, masked):
    for d in WIDTHS:
        X, W, y, mask = _data(d)
        m = mask if masked else None
        Xt = torch.from_numpy(X).to(dtype)
        # the JAX side reads the same bf16 values
        Xj = np.asarray(jnp.asarray(Xt.to(torch.float32).numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
        p_loss, p_grad, p_n = _pallas_lanes(name, Xj, W, y, m)
        g = fk.FusedMarginGradient(losses.GRADIENTS[name]())
        staged, _, _ = g.prepare(Xt, torch.from_numpy(y),
                                 None if m is None else torch.from_numpy(m))
        for k in LANES:
            loss, grad, n = g.lanes_loss_and_grad(torch.from_numpy(W[:k]),
                                                  staged, None)
            assert loss.shape == (k,) and grad.shape == (k, d)
            np.testing.assert_allclose(loss.numpy(), np.asarray(p_loss)[:k],
                                       rtol=1e-5, err_msg=f"d={d} k={k}")
            np.testing.assert_allclose(grad.numpy(), np.asarray(p_grad)[:k],
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"d={d} k={k}")
            np.testing.assert_array_equal(n.numpy(), np.asarray(p_n)[:k])


@pytest.mark.parametrize("name", LOSSES)
def test_plain_lanes_match_vmapped_jnp_at_f64(name):
    """Shared mask, per-lane (N, K) masks and no mask, dense and CSR."""
    rng = np.random.default_rng(5)
    n, d, k = 61, 9, 4
    X = rng.standard_normal((n, d))
    X[rng.random((n, d)) < 0.6] = 0.0
    W = rng.standard_normal((k, d)) / 3
    y = (rng.random(n) < 0.5).astype(float)
    shared = (rng.random(n) < 0.8).astype(float)
    per_lane = (rng.random((n, k)) < 0.7).astype(float)
    jg, tg = jlosses.GRADIENTS[name](), losses.GRADIENTS[name]()
    rows, cols = np.nonzero(X)
    Xc = port.CSRMatrix(torch.from_numpy(rows), torch.from_numpy(cols),
                        torch.from_numpy(X[rows, cols]), (n, d))
    for masks in (None, shared, per_lane):
        if masks is None or masks.ndim == 1:
            ref = jax.vmap(lambda w: jg.batch_loss_and_grad(
                w, jnp.asarray(X), jnp.asarray(y),
                None if masks is None else jnp.asarray(masks)))(
                    jnp.asarray(W))
        else:
            ref = jax.vmap(lambda w, m: jg.batch_loss_and_grad(
                w, jnp.asarray(X), jnp.asarray(y), m),
                in_axes=(0, 1))(jnp.asarray(W), jnp.asarray(masks))
        tm = None if masks is None else torch.from_numpy(masks)
        for Xa in (torch.from_numpy(X), tg.prepare(Xc, None)[0]):
            loss, grad, cnt = tg.lanes_loss_and_grad(
                torch.from_numpy(W), Xa, torch.from_numpy(y), tm)
            np.testing.assert_allclose(loss.numpy(), np.asarray(ref[0]),
                                       rtol=1e-12)
            np.testing.assert_allclose(grad.numpy(), np.asarray(ref[1]),
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref[2]))


def test_default_lanes_run_lane_by_lane_for_other_losses():
    """The softmax loss (and any non-margin loss) takes the default:
    ``batch_loss_and_grad`` lane by lane, equal to ``jax.vmap``."""
    rng = np.random.default_rng(6)
    n, d, c, k = 40, 5, 3, 3
    X = rng.standard_normal((n, d))
    W = rng.standard_normal((k, d, c)) / 3
    y = rng.integers(0, c, n)
    masks = (rng.random((n, k)) < 0.7).astype(float)
    ref = jax.vmap(lambda w, m: jlosses.SoftmaxGradient(c)
                   .batch_loss_and_grad(w, jnp.asarray(X), jnp.asarray(y),
                                        m), in_axes=(0, 1))(
        jnp.asarray(W), jnp.asarray(masks))
    loss, grad, cnt = losses.SoftmaxGradient(c).lanes_loss_and_grad(
        torch.from_numpy(W), torch.from_numpy(X), torch.from_numpy(y),
        torch.from_numpy(masks))
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref[0]), rtol=1e-12)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref[1]),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref[2]))


def test_sweep_calls_the_lanes_wrapper_once_per_round(monkeypatch):
    """Through ``FusedLogisticGradient`` a sweep evaluates every lane in
    one call of the lanes wrapper per evaluation round (on the card, one
    launch of the lanes kernel), and never the solo wrapper."""
    X, W, y, _ = _data(7, n=80)
    calls = {"lanes": 0, "solo": 0, "rounds": 0}
    lanes, solo = fk.fused_margin_lanes_loss_grad, fk.fused_margin_loss_grad

    def count_lanes(*a):
        calls["lanes"] += 1
        return lanes(*a)

    def count_solo(*a):
        calls["solo"] += 1
        return solo(*a)

    monkeypatch.setattr(fk, "fused_margin_lanes_loss_grad", count_lanes)
    monkeypatch.setattr(fk, "fused_margin_loss_grad", count_solo)
    g = port.FusedLogisticGradient()
    rounds = g.lanes_loss_and_grad

    def count_rounds(*a):
        calls["rounds"] += 1
        return rounds(*a)

    monkeypatch.setattr(g, "lanes_loss_and_grad", count_rounds)
    res = port.sweep((X, y), g, port.SquaredL2Updater(), [0.1, 0.01, 1.0],
                     num_iterations=6, convergence_tol=0.0,
                     initial_weights=np.zeros(7, np.float32), device="cpu")
    assert res.weights.shape == (3, 7)
    assert calls["solo"] == 0
    assert calls["lanes"] == calls["rounds"] >= 6


def test_lanes_refuse_per_lane_masks_and_stage_unprepared_calls():
    X, W, y, mask = _data(4)
    g = port.FusedLogisticGradient()
    staged = g.prepare(torch.from_numpy(X), torch.from_numpy(y))[0]
    with pytest.raises(ValueError, match="per-lane masks"):
        g.lanes_loss_and_grad(torch.from_numpy(W), staged, None,
                              torch.ones(37, 8))
    loss, grad, n = g.lanes_loss_and_grad(
        torch.from_numpy(W), torch.from_numpy(X), torch.from_numpy(y),
        torch.from_numpy(mask))
    ref = losses.LogisticGradient().lanes_loss_and_grad(
        torch.from_numpy(W), torch.from_numpy(X), torch.from_numpy(y),
        torch.from_numpy(mask))
    np.testing.assert_allclose(loss.numpy(), ref[0].numpy(), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), ref[1].numpy(), rtol=1e-4,
                               atol=1e-4)
    assert int(n[0]) == int((mask > 0).sum())


# ---------------------------------------------------------------------------
# A plain model of the card's tensor-core arithmetic (the lanes kernel's
# "lanes_mma" mode, csrc/tf32_mma.cuh): every f32 operand split into TF32
# halves, W into three parts, the products summed in f32
# ---------------------------------------------------------------------------

def _tf32(a, nearest=True):
    """``a`` (f32) cut to TF32's 10 mantissa bits: to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds; or truncated."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    if nearest:
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
    """a = hi + lo (+ about 2^-22 a), both TF32."""
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _split_w(w):
    """w = hi + lo + lo2 exactly, each TF32."""
    hi = _tf32(w)
    rest = w - hi
    lo = _tf32(rest, nearest=False)
    return hi, lo, rest - lo


def _logistic_f32(dots, y):
    m = -dots
    per = np.log1p(np.exp(-np.abs(m))) + np.maximum(m, 0) - (1 - y) * m
    return per.astype(np.float32), (1 / (1 + np.exp(-dots)) - y).astype(
        np.float32)


def _mma_model(X, W, y, mask, passes=3):
    """The kernel's loss and gradient sums: the dots as x_hi w_hi + (x_hi
    w_lo + x_lo w_hi + x_hi w_lo2), the gradient as M_hi^T x_hi + (M_lo^T
    x_hi + M_hi^T x_lo), each product exact in f32 and summed in f32;
    ``passes=1`` keeps the hi*hi products alone."""
    xh, xl = _split(X)
    wh, wl, wl2 = _split_w(W)
    big = xh @ wh.T
    small = xh @ wl.T + xl @ wh.T + xh @ wl2.T
    dots = big + small if passes == 3 else big
    per, mult = _logistic_f32(dots, y[:, None])
    M = (mult * mask[:, None]).astype(np.float32)
    mh, ml = _split(M)
    grad = mh.T @ xh
    if passes == 3:
        grad = grad + (ml.T @ xh + mh.T @ xl)
    loss = (per.astype(np.float64) * mask[:, None]).sum(0)
    return loss, grad


def _lane_errors(loss, grad, ref_loss, ref_grad):
    """The worst (loss relative error, gradient error over its tolerance:
    rtol 1e-4 of each entry plus 1e-4 of the lane's largest)."""
    loss_err = np.max(np.abs(loss - ref_loss) / np.abs(ref_loss))
    tol = 1e-4 * np.abs(ref_grad) + 1e-4 * np.abs(ref_grad).max(
        axis=1, keepdims=True)
    return loss_err, np.max(np.abs(grad - ref_grad) / tol)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_three_pass_tf32_model_holds_to_f64_at_k8(masked):
    """At K = 8 the split products stay within the tolerances of
    ``tests/test_pallas.py`` of the f64 sums (``jax.vmap`` of the jnp
    logistic loss at f64), as the plain f32 version does, and at least a
    hundred times closer to them than the hi*hi products alone."""
    X, W, y, mask = _data(130, n=4_099, k=8, seed=3)
    m = mask if masked else np.ones_like(mask)
    ref = jax.vmap(lambda w: jlosses.LogisticGradient().batch_loss_and_grad(
        w, jnp.asarray(X, jnp.float64), jnp.asarray(y, jnp.float64),
        jnp.asarray(m, jnp.float64)))(jnp.asarray(W, jnp.float64))
    ref_loss, ref_grad = np.asarray(ref[0]), np.asarray(ref[1])
    staged = fk.stage_dense(torch.from_numpy(X), torch.from_numpy(y),
                            torch.from_numpy(m))
    plain = fk.fused_margin_lanes_loss_grad_reference(
        losses.LogisticGradient(), torch.from_numpy(W), staged)
    plain_errs = _lane_errors(plain[0].double().numpy(),
                              plain[1].double().numpy(), ref_loss, ref_grad)
    three = _lane_errors(*_mma_model(X, W, y, m), ref_loss, ref_grad)
    one = _lane_errors(*_mma_model(X, W, y, m, passes=1), ref_loss, ref_grad)
    for loss_err, grad_ratio in (plain_errs, three):
        assert loss_err <= 1e-5 and grad_ratio <= 1.0
    assert three[1] * 100 <= one[1]


def test_tf32_rounding_keeps_ten_bits_to_nearest():
    """``_tf32`` as ``cvt.rna`` rounds: 10 explicit mantissa bits, half
    an ulp up away from zero, and the three-part split of W exact."""
    one_ulp = np.float32(2.0 ** -10)
    v = np.array([1 + one_ulp / 2, 1 + one_ulp / 2 - 2 ** -20, -(1 + one_ulp
                  / 2), 3.0], np.float32)
    np.testing.assert_array_equal(
        _tf32(v), np.array([1 + one_ulp, 1, -(1 + one_ulp), 3], np.float32))
    w = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi, lo, lo2 = _split_w(w)
    for part in (hi, lo, lo2):
        np.testing.assert_array_equal(_tf32(part, nearest=False), part)
    np.testing.assert_array_equal((hi.astype(np.float64) + lo + lo2), w)
