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
two-pass mode's arithmetic in its order of sums (class tiles with an
online max and sum of exponentials, row stages summed with compensation,
row groups, row chunks) is held to the jnp loss at f64."""

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


def _class_tile(k):
    """The two-pass mode's class tile (``tp_class_tile``)."""
    return 16 if k <= 16 else 32 if k <= 32 else 64 if k <= 64 else 128


def _kahan_rows(acc, comp, v):
    """One compensated add of the array ``v`` into ``(acc, comp)``."""
    t = acc + (v - comp)
    return t, (t - acc) - (v - comp)


def _two_pass_model(X, W, y, m, chunk_rows, groups):
    """The two-pass mode's arithmetic on f32 X in numpy (f64), in its
    order of sums: pass 1 walks row tiles (256, 128 or 64 rows as the
    class tile is 16-32, 64 or 128 classes) and forms the logits a class
    tile at a time, D in 8-column steps summed plainly (the kernel's
    64-column stages, 32 at class tiles of 16-32, add no rounding of
    their own), keeping each row's max and sum of exponentials online
    across the class tiles, then writes ``(softmax - onehot) * m``; each
    row tile's losses are summed with compensation into its partial.
    Pass 2 sums ``X.T @ resid`` over the row groups of each row chunk,
    in stages of 64 rows (32 at class tiles of 16-32) of 8-row steps
    (the steps summed plainly, the stages with compensation), the chunks
    added in order; the partials and the loss are summed last with
    compensation."""
    n, d = X.shape
    k = W.shape[1]
    kt = _class_tile(k)
    tile_rows = 32 * 8 // (1 if kt <= 32 else kt // 32)
    step = 32 if kt <= 32 else 64
    classes = np.arange(k, dtype=np.float64)
    loss_partials, partials = [], np.zeros((groups, d, k))
    for r0 in range(0, n, chunk_rows):
        Xc, yc, mc = X[r0:r0 + chunk_rows], y[r0:r0 + chunk_rows], \
            m[r0:r0 + chunk_rows]
        rows = Xc.shape[0]
        resid = np.empty((rows, k))
        for t0 in range(0, rows, tile_rows):
            Xt = Xc[t0:t0 + tile_rows]
            yt, mt = yc[t0:t0 + tile_rows], mc[t0:t0 + tile_rows]
            run_max = np.full(Xt.shape[0], -np.inf)
            run_sum = np.zeros(Xt.shape[0])
            z = np.empty((Xt.shape[0], k))
            for k0 in range(0, k, kt):
                zc = np.zeros((Xt.shape[0], min(kt, k - k0)))
                for c0 in range(0, d, 8):  # 8-column steps, summed plainly
                    zc += Xt[:, c0:c0 + 8] @ W[c0:c0 + 8, k0:k0 + kt]
                z[:, k0:k0 + kt] = zc
                new_max = np.maximum(run_max, zc.max(axis=1))
                scale = np.where(run_max == -np.inf, 0.0,
                                 np.exp(run_max - new_max))
                run_sum = run_sum * scale + np.exp(
                    zc - new_max[:, None]).sum(1)
                run_max = new_max
            lse = run_max + np.log(run_sum)
            onehot = classes[None, :] == yt[:, None]
            picked = np.where(onehot, z, 0.0).sum(1)
            loss_partials.append(_kahan((lse - picked) * mt))
            resid[t0:t0 + tile_rows] = (np.exp(z - lse[:, None])
                                        - onehot) * mt[:, None]
        per_group = -(-rows // groups)  # ceil, then up to a stage
        per_group = -(-per_group // step) * step
        for g in range(groups):
            g0, g1 = min(rows, g * per_group), min(rows, (g + 1) * per_group)
            acc = np.zeros((d, k))
            comp = np.zeros((d, k))
            for s in range(g0, g1, step):  # stages, with compensation
                stage = np.zeros((d, k))
                for r in range(s, min(g1, s + step), 8):  # steps, plainly
                    stage += Xc[r:min(g1, r + 8)].T @ resid[r:min(g1, r + 8)]
                acc, comp = _kahan_rows(acc, comp, stage)
            partials[g] += acc
    grad = np.zeros((d, k))
    comp = np.zeros((d, k))
    for v in partials:
        grad, comp = _kahan_rows(grad, comp, v)
    return _kahan(loss_partials), grad


@pytest.mark.parametrize("k", [1, 10, 16, 17, 33, 64, 65, 100, 128, 129,
                               300])
def test_two_pass_arithmetic_matches_the_jnp_loss_at_f64(k):
    """Class tiles of 16, 32, 64 and 128 and their edges, row chunks that
    do not divide N, more row groups than some chunks fill: the online
    max and sum of exponentials give the jnp loss and gradient to f64
    rounding."""
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
