"""The softmax kernel at every class count and width, against the JAX
package.

The CUDA softmax kernel reads X once where W, the gradient accumulator
and a row tile fit a block's shared memory (up to 32 classes), and runs
a two-pass mode everywhere else (``csrc/softmax_loss_grad.cu``).  On the
CPU ``FusedSoftmaxGradient`` runs the plain version that both modes are
held to on the card (``test_torch_cuda.py``).  Here it is held to
``PallasSoftmaxGradient(interpret=True)`` and the jnp ``SoftmaxGradient``
at shapes past the one-read kernel's reach (40 and 100 classes; 3,000
columns at 10 classes), at the tolerances of ``tests/test_pallas.py``
(loss rtol 1e-5, gradient rtol/atol 1e-4).  A plain numpy model of the
two-pass mode's arithmetic (class chunks with an online max and sum of
exponentials, row chunks, row groups summed with compensation) is held
to the jnp loss at f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu.ops import losses as jlosses
from spark_agd_tpu.ops.pallas_kernels import PallasSoftmaxGradient
from spark_agd_tpu_torch.ops import fused_kernels as fk, losses

# (rows, columns, classes): past 32 classes, past shared memory at 10
# classes (the one-read kernel stops near 2,600 f32 columns there), and
# 100 classes at a narrow width
SHAPES = [(16, 785, 40), (16, 3000, 10), (64, 33, 100)]


def _data(n, d, k, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    W = (rng.standard_normal((d, k)) / np.sqrt(d)).astype(np.float32)
    y = rng.integers(0, k, n).astype(np.float32)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    return X, W, y, mask


def _port(k, X, W, y, mask):
    g = fk.FusedSoftmaxGradient(losses.SoftmaxGradient(k))
    staged, _, _ = g.prepare(X, torch.from_numpy(y),
                             None if mask is None else torch.from_numpy(mask))
    assert isinstance(staged, fk.StagedDense)
    return g.batch_loss_and_grad(torch.from_numpy(W), staged, None, None)


def _pallas(k, X, W, y, mask):
    g = PallasSoftmaxGradient(jlosses.SoftmaxGradient(k), interpret=True)
    args = g.prepare(X, jnp.asarray(y),
                     None if mask is None else jnp.asarray(mask))
    return g.batch_loss_and_grad(jnp.asarray(W), *args)


def _close(loss, grad, ref_loss, ref_grad):
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    np.testing.assert_allclose(np.asarray(grad), np.asarray(ref_grad),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("n,d,k", SHAPES,
                         ids=[f"{n}x{d}-K{k}" for n, d, k in SHAPES])
def test_matches_pallas_interpret_and_softmax_gradient(n, d, k, masked):
    X, W, y, mask = _data(n, d, k, seed=d + k)
    m = mask if masked else None
    loss, grad, count = _port(k, torch.from_numpy(X), W, y, m)
    assert loss.dtype == torch.float32 and grad.shape == (d, k)
    p_loss, p_grad, p_n = _pallas(k, jnp.asarray(X), W, y, m)
    _close(loss, grad, p_loss, p_grad)
    j_loss, j_grad, j_n = jlosses.SoftmaxGradient(k).batch_loss_and_grad(
        jnp.asarray(W), jnp.asarray(X), jnp.asarray(y),
        None if m is None else jnp.asarray(m))
    _close(loss, grad, j_loss, j_grad)
    assert int(count) == int(j_n) == int(p_n)


def test_bf16_x_past_32_classes():
    """bf16 X stays bf16 when staged and is widened to f32: held to the
    Pallas kernel and the jnp loss on the same bf16 X."""
    n, d, k = SHAPES[0]
    X, W, y, mask = _data(n, d, k, seed=11)
    X16 = torch.from_numpy(X).to(torch.bfloat16)
    loss, grad, _ = _port(k, X16, W, y, mask)
    Xj = jnp.asarray(X16.to(torch.float32).numpy()).astype(jnp.bfloat16)
    p_loss, p_grad, _ = _pallas(k, Xj, W, y, mask)
    _close(loss, grad, p_loss, p_grad)
    j_loss, j_grad, _ = jlosses.SoftmaxGradient(k).batch_loss_and_grad(
        jnp.asarray(W), Xj, jnp.asarray(y), jnp.asarray(mask))
    _close(loss, grad, j_loss, j_grad)


def _kahan(values):
    s = c = 0.0
    for v in values:
        t = s + (v - c)
        c = (t - s) - (v - c)
        s = t
    return s


def _two_pass_model(X, W, y, m, chunk_rows, groups):
    """The two-pass mode's arithmetic in numpy (f64): pass 1 forms the
    logits a class chunk at a time (16 classes up to 16, else 64),
    keeping each row's max and sum of exponentials online, then writes
    ``(softmax - onehot) * m``; pass 2 sums ``X.T @ resid`` over row
    groups of each row chunk, 32 rows a step added with compensation,
    the chunks added in order; the partials and the loss are summed last
    with compensation."""
    n, d = X.shape
    k = W.shape[1]
    kc = 16 if k <= 16 else 64
    classes = np.arange(k, dtype=np.float64)
    losses_, partials = [], np.zeros((groups, d, k))
    for r0 in range(0, n, chunk_rows):
        Xc, yc, mc = X[r0:r0 + chunk_rows], y[r0:r0 + chunk_rows], \
            m[r0:r0 + chunk_rows]
        rows = Xc.shape[0]
        run_max = np.full(rows, -np.inf)
        run_sum = np.zeros(rows)
        z = np.empty((rows, k))
        for k0 in range(0, k, kc):
            zc = Xc @ W[:, k0:k0 + kc]
            z[:, k0:k0 + kc] = zc
            new_max = np.maximum(run_max, zc.max(axis=1))
            scale = np.where(run_max == -np.inf, 0.0,
                             np.exp(run_max - new_max))
            run_sum = run_sum * scale + np.exp(zc - new_max[:, None]).sum(1)
            run_max = new_max
        lse = run_max + np.log(run_sum)
        onehot = classes[None, :] == yc[:, None]
        picked = np.where(onehot, z, 0.0).sum(1)
        losses_.extend((lse - picked) * mc)
        resid = (np.exp(z - lse[:, None]) - onehot) * mc[:, None]
        per_group = -(-rows // groups)  # ceil, then up to 32 rows
        per_group = -(-per_group // 32) * 32
        for g in range(groups):
            g0, g1 = min(rows, g * per_group), min(rows, (g + 1) * per_group)
            steps = [Xc[s:min(g1, s + 32)].T @ resid[s:min(g1, s + 32)]
                     for s in range(g0, g1, 32)]
            acc = np.zeros((d, k))
            comp = np.zeros((d, k))
            for v in steps:  # elementwise Kahan over the steps
                t = acc + (v - comp)
                comp = (t - acc) - (v - comp)
                acc = t
            partials[g] += acc
    grad = np.zeros((d, k))
    comp = np.zeros((d, k))
    for v in partials:
        t = grad + (v - comp)
        comp = (t - grad) - (v - comp)
        grad = t
    return _kahan(losses_), grad


@pytest.mark.parametrize("k", [1, 10, 16, 17, 64, 65, 100, 300])
def test_two_pass_arithmetic_matches_the_jnp_loss_at_f64(k):
    """Class chunks of 16 and 64 and their edges, row chunks that do not
    divide N, more row groups than some chunks fill: the online max and
    sum of exponentials give the jnp loss and gradient to f64 rounding."""
    n, d = 203, 37
    rng = np.random.default_rng(k)
    X = rng.standard_normal((n, d))
    W = rng.standard_normal((d, k)) * 2.0  # spread logits: maxima move
    y = rng.integers(0, k, n).astype(np.float64)
    m = (rng.random(n) < 0.8).astype(np.float64)
    loss, grad = _two_pass_model(X, W, y, m, chunk_rows=96, groups=3)
    j_loss, j_grad, _ = jlosses.SoftmaxGradient(k).batch_loss_and_grad(
        jnp.asarray(W), jnp.asarray(X), jnp.asarray(y), jnp.asarray(m))
    assert loss == pytest.approx(float(j_loss), rel=1e-12)
    np.testing.assert_allclose(grad, np.asarray(j_grad), rtol=1e-10,
                               atol=1e-12)


def test_stage_softmax_takes_every_class_count_on_the_cpu():
    """No class limit is left: any count from 1 up stages; fewer than
    one class is refused."""
    X = torch.zeros((3, 5))
    for k in (1, 33, 1000):
        assert fk.stage_softmax(X, torch.zeros(3), k).X is X
    with pytest.raises(ValueError, match="1 or more"):
        fk.stage_softmax(X, torch.zeros(3), 0)
    assert not hasattr(fk, "max_classes") and not hasattr(fk,
                                                          "check_classes")
