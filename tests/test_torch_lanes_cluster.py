"""The lanes kernel's cluster mode, modelled on the CPU, against the JAX
package.

Past what one block's shared memory holds, the CUDA lanes kernel reads X
once for up to 16 lanes across a thread block cluster
(``csrc/margin_lanes_loss_grad.cu``, its "lanes_cluster" mode): each of
the cluster's C blocks owns a column slice of every 16-row tile and the
same slice of the lanes' W, forms its partial dots on the tensor cores
(3xTF32: every f32 operand split into TF32 halves, W into three parts),
stores them into every block's shared memory, and each block adds the C
partials in rank order, applies the loss middle and adds its slice of
each tile's gradient product into registers with compensation; the
clusters' partials are added last, in order, with compensation.  The
kernel runs only on the card (``test_torch_cuda.py`` holds it to its
plain version there).  Here a numpy model of that order of sums in f32,
and the port's plain version ``fused_margin_lanes_loss_grad_reference``,
are each held to ``spark_agd_tpu.ops.pallas_kernels.fused_margin_loss_grad``
under ``jax.vmap`` over the lanes in interpret mode (what ``api.sweep``
runs) and to the jnp ``batch_loss_and_grad`` at f64 (x64:
``tests/conftest.py``), at the kernel tolerances of
``tests/test_pallas.py:44,57`` (loss rtol 1e-5, gradient rtol/atol
1e-4)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu.ops import losses as jlosses
from spark_agd_tpu.ops.pallas_kernels import (
    fused_margin_loss_grad as pallas_margin_loss_grad,
    pad_dense,
)
from spark_agd_tpu_torch.ops import fused_kernels as fk, losses

LOSSES = ["logistic", "least_squares", "hinge"]
# the kernel's constants: rows a tile, columns a slice is a multiple of
TILE, SLICE_ALIGN = 16, 32
f32 = np.float32


def _slices(d, ranks):
    """Each rank's (first column, columns): slices of a multiple of
    SLICE_ALIGN columns, the last rank the rest (``cluster_slice``)."""
    per_rank = -(-d // ranks)
    slice_ = -(-per_rank // SLICE_ALIGN) * SLICE_ALIGN
    out = [(q * slice_, slice_) for q in range(ranks - 1)]
    out.append(((ranks - 1) * slice_, d - (ranks - 1) * slice_))
    assert all(cols >= 1 for _, cols in out)
    return out


def _tf32(a, nearest=True):
    """``a`` (f32) cut to TF32's 10 mantissa bits: to nearest, ties away
    from zero (``to_tf32``), or truncated."""
    bits = np.ascontiguousarray(a, f32).view(np.uint32)
    if nearest:
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(f32)


def _split(a):
    """a = hi + lo (+ about 2^-22 a), both TF32 (``split_tf32``)."""
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _split_w(w):
    """w = hi + lo + lo2 exactly, each TF32 (``split_w``)."""
    hi = _tf32(w)
    rest = w - hi
    lo = _tf32(rest, nearest=False)
    return hi, lo, rest - lo


def _kahan_add(acc, comp, v):
    """One compensated add of v into (acc, comp), elementwise in f32."""
    v = (v - comp).astype(f32)
    t = (acc + v).astype(f32)
    return t, ((t - acc).astype(f32) - v).astype(f32)


def _kahan(values):
    s = c = np.zeros_like(values[0]) if len(values) else f32(0)
    for v in values:
        s, c = _kahan_add(s, c, v)
    return s


def _middle(name, dots, y):
    """``loss_middle`` (``csrc/margin_middle.cuh``) in f32, elementwise."""
    with np.errstate(over="ignore"):
        if name == "logistic":
            m = -dots
            sp = (np.log1p(np.exp(-np.abs(m))) + np.maximum(m, 0)).astype(f32)
            per = (sp - ((1 - y) * m).astype(f32)).astype(f32)
            mult = (1 / (1 + np.exp(-dots)) - y).astype(f32)
        elif name == "least_squares":
            diff = (dots - y).astype(f32)
            per, mult = (diff * diff).astype(f32), (2 * diff).astype(f32)
        else:
            s = (2 * y - 1).astype(f32)
            margin = (1 - s * dots).astype(f32)
            per = np.where(margin > 0, margin, 0).astype(f32)
            mult = np.where(margin > 0, -s, 0).astype(f32)
    return per, mult


def _cluster_model(name, X, W, y, m, ranks, clusters):
    """The cluster mode's loss and gradient of each lane in f32, in the
    kernel's order of sums.  The lanes run in a bucket of 8 or 16 (the
    lanes past K read zero weights).  The clusters take contiguous row
    ranges of ceil(n / clusters) rows, walked in 16-row tiles; a tile's
    dots are each rank's partial (hi*hi, plus the small passes x_hi w_lo
    + x_lo w_hi + x_hi w_lo2, over the rank's slice) added in rank order;
    the middle runs on the whole dot; rank 0's thread (row r, lane k)
    counts the loss of row r of every tile with compensation, and those
    are summed over r in order; each rank's slice of a tile's gradient
    product (M_hi^T x_hi + (M_lo^T x_hi + M_hi^T x_lo)) is added into
    the cluster's sums with compensation; the clusters' partials are
    added in order with compensation (``lanes_reduce``)."""
    n, d = X.shape
    k = W.shape[0]
    kb = 8 if k <= 8 else 16
    Wb = np.zeros((kb, d), f32)
    Wb[:k] = W
    parts = _slices(d, ranks)
    per_cluster = -(-n // clusters)
    cluster_loss, cluster_grad = [], []
    for c in range(clusters):
        r0, r1 = min(n, c * per_cluster), min(n, (c + 1) * per_cluster)
        g = np.zeros((kb, d), f32)
        g_comp = np.zeros((kb, d), f32)
        row_loss = np.zeros((TILE, kb), f32)
        row_comp = np.zeros((TILE, kb), f32)
        for t0 in range(r0, r1, TILE):
            rows = min(TILE, r1 - t0)
            dots = np.zeros((rows, kb), f32)
            for c0, cols in parts:
                xh, xl = _split(X[t0:t0 + rows, c0:c0 + cols])
                wh, wl, wl2 = _split_w(Wb[:, c0:c0 + cols])
                big = xh @ wh.T
                small = (xh @ wl.T + xl @ wh.T + xh @ wl2.T).astype(f32)
                dots = (dots + (big + small).astype(f32)).astype(f32)
            per, mult = _middle(name, dots, y[t0:t0 + rows, None])
            live = np.arange(kb) < k
            M = np.where(live, (mult * m[t0:t0 + rows, None]).astype(f32), 0)
            pm = np.where(live, (per * m[t0:t0 + rows, None]).astype(f32), 0)
            row_loss[:rows], row_comp[:rows] = _kahan_add(
                row_loss[:rows], row_comp[:rows], pm.astype(f32))
            mh, ml = _split(M.astype(f32))
            for c0, cols in parts:
                xh, xl = _split(X[t0:t0 + rows, c0:c0 + cols])
                prod = ((mh.T @ xh).astype(f32)
                        + (ml.T @ xh + mh.T @ xl).astype(f32)).astype(f32)
                sl = slice(c0, c0 + cols)
                g[:, sl], g_comp[:, sl] = _kahan_add(g[:, sl], g_comp[:, sl],
                                                     prod)
        cluster_loss.append(_kahan(list(row_loss))[:k])
        cluster_grad.append(g[:k])
    if not clusters or n == 0:
        return np.zeros(k, f32), np.zeros((k, d), f32)
    return _kahan(cluster_loss), _kahan(cluster_grad)


def _data(n, d, k, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(f32)
    W = (rng.standard_normal((k, d)) / np.sqrt(d)).astype(f32)
    y = (rng.random(n) < 0.5).astype(f32)
    mask = (rng.random(n) < 0.7).astype(f32)
    return X, W, y, mask


def _close(loss, grad, ref_loss, ref_grad):
    np.testing.assert_allclose(np.asarray(loss, np.float64),
                               np.asarray(ref_loss, np.float64), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(grad, np.float64),
                               np.asarray(ref_grad, np.float64),
                               rtol=1e-4, atol=1e-4)


# (rows, columns, ranks, clusters): 301 columns in 2 ranks (160, 141)
# over 2 clusters of 19 rows (a tile and a ragged 3); 1,003 in 4 ranks
# (256, 256, 256, 235) over 3 clusters of 13 rows (one ragged tile each);
# 481 in 16 ranks of 32 columns and a last of 1, one cluster of 40 rows
CASES = [(37, 301, 2, 2), (37, 1003, 4, 3), (40, 481, 16, 1)]
MAX_LANES = 16


@functools.cache
def _references(n, d, name, masked):
    """The JAX package's results for all MAX_LANES lanes of one shape:
    the vmapped Pallas kernel (interpret mode) and the jnp loss at f64."""
    X, W, y, mask = _data(n, d, MAX_LANES, seed=n + d)
    m = jnp.asarray(mask) if masked else None
    padded = pad_dense(jnp.asarray(X), jnp.asarray(y), m)
    pallas = jax.vmap(lambda w: pallas_margin_loss_grad(
        jlosses.GRADIENTS[name](), w, padded, interpret=True))(
            jnp.asarray(W))
    exact = jax.vmap(lambda w: jlosses.GRADIENTS[name]().batch_loss_and_grad(
        w, jnp.asarray(X, jnp.float64), jnp.asarray(y, jnp.float64),
        None if m is None else jnp.asarray(mask, jnp.float64))[:2])(
            jnp.asarray(W, jnp.float64))
    return ([np.asarray(a) for a in pallas], [np.asarray(a) for a in exact])


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("k", [1, 3, 8, 9, 16])
@pytest.mark.parametrize("n,d,ranks,clusters", CASES,
                         ids=[f"{c[0]}x{c[1]}-C{c[2]}-clusters{c[3]}"
                              for c in CASES])
def test_cluster_order_of_sums_matches_the_jax_package(n, d, ranks,
                                                       clusters, k, name,
                                                       masked):
    X, W, y, mask = _data(n, d, MAX_LANES, seed=n + d)
    W = W[:k]
    m = mask if masked else np.ones(n, f32)
    loss, grad = _cluster_model(name, X, W, y, m, ranks, clusters)
    (p_loss, p_grad), (j_loss, j_grad) = _references(n, d, name, masked)
    _close(loss, grad, j_loss[:k], j_grad[:k])
    _close(loss, grad, p_loss[:k], p_grad[:k])
    # the port's plain version, which the kernel is held to on the card
    staged = fk.stage_dense(torch.from_numpy(X), torch.from_numpy(y),
                            torch.from_numpy(mask) if masked else None)
    r_loss, r_grad = fk.fused_margin_lanes_loss_grad_reference(
        losses.GRADIENTS[name](), torch.from_numpy(W), staged)
    _close(r_loss.numpy(), r_grad.numpy(), j_loss[:k], j_grad[:k])
    _close(r_loss.numpy(), r_grad.numpy(), p_loss[:k], p_grad[:k])


def test_model_drops_no_rank_and_no_small_pass():
    """The model is the kernel's arithmetic and not the plain product's:
    a model that leaves out the last rank's partial dots, or keeps the
    hi*hi products alone, misses the f64 sums by far more than the
    tolerance."""
    n, d, ranks = 37, 1003, 4
    X, W, y, mask = _data(n, d, MAX_LANES, seed=n + d)
    _, (j_loss, j_grad) = _references(n, d, "logistic", False)
    m = np.ones(n, f32)
    Xc = X.copy()
    Xc[:, _slices(d, ranks)[-1][0]:] = 0  # the last rank's columns gone
    loss, grad = _cluster_model("logistic", Xc, W, y, m, ranks, 1)
    assert np.max(np.abs(grad - j_grad)) > 1e-2
    hi = _tf32(X)
    loss, grad = _cluster_model("logistic", hi, _tf32(W), y, m, ranks, 1)
    assert np.max(np.abs(grad - j_grad)
                  / (1e-4 + 1e-4 * np.abs(j_grad))) > 1.0


@pytest.mark.parametrize("name", LOSSES)
def test_no_rows_give_zeros(name):
    """N = 0: every cluster's range is empty; the losses and gradients are
    exact zeros, as the plain version and the jnp loss give."""
    X, W, y, mask = _data(0, 301, 3, seed=1)
    loss, grad = _cluster_model(name, X, W, y, mask, 2, 2)
    assert not loss.any() and not grad.any() and grad.shape == (3, 301)
    exact = jax.vmap(lambda w: jlosses.GRADIENTS[name]().batch_loss_and_grad(
        w, jnp.asarray(X, jnp.float64), jnp.asarray(y, jnp.float64),
        jnp.asarray(mask, jnp.float64))[:2])(jnp.asarray(W, jnp.float64))
    _close(loss, grad, *exact)
    staged = fk.stage_dense(torch.from_numpy(X), torch.from_numpy(y),
                            torch.from_numpy(mask))
    r_loss, r_grad = fk.fused_margin_lanes_loss_grad_reference(
        losses.GRADIENTS[name](), torch.from_numpy(W), staged)
    assert not r_loss.any() and not r_grad.any()
