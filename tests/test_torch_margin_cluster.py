"""The margin kernel's cluster mode, modelled on the CPU, against the JAX
package.

Past one block's shared-memory tile the CUDA margin kernel reads X once
across a thread block cluster (``csrc/margin_loss_grad.cu``, its
"cluster" mode): each of the cluster's C blocks owns a column slice of
every row, forms its partial dots, stores them into every block's shared
memory, and each block adds the C partials in rank order, applies the
loss middle and sums its slice of the gradient over the cluster's rows;
the clusters' partials are added last with compensation.  The kernel
runs only on the card (``test_torch_cuda.py`` holds it to its plain
version there).  Here a numpy model of that order of sums in f32 (the
column slices, the threads' columns, the shuffle tree, the warps, the
ranks in order, the middle, the per-slice gradient sums, the clusters
with compensation), and the port's plain version
``fused_margin_loss_grad_reference``, are each held to
``spark_agd_tpu.ops.pallas_kernels.fused_margin_loss_grad`` in interpret
mode and to the jnp ``batch_loss_and_grad`` (x64: ``tests/conftest.py``)
at the kernel tolerances of ``tests/test_pallas.py:44,57`` (loss rtol
1e-5, gradient rtol/atol 1e-4)."""

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
# the kernel's constants: threads a block, columns a slice is a multiple
# of, rows a stage at most
THREADS, SLICE_ALIGN, MAX_ROWS = 512, 32, 8
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


def _kahan(values):
    s = c = f32(0)
    for v in values:
        yv = f32(v) - c
        t = f32(s + yv)
        c = f32(f32(t - s) - yv)
        s = t
    return s


def _middle(name, dot, y):
    """``loss_middle`` (``csrc/margin_middle.cuh``) in f32."""
    if name == "logistic":
        m = -dot
        sp = f32(np.log1p(np.exp(-np.abs(m), dtype=f32), dtype=f32)
                 + np.maximum(m, f32(0)))
        per = f32(sp - f32(f32(1) - y) * m)
        mult = f32(f32(1) / f32(f32(1) + np.exp(-dot, dtype=f32)) - y)
    elif name == "least_squares":
        diff = f32(dot - y)
        per, mult = f32(diff * diff), f32(f32(2) * diff)
    else:
        s = f32(f32(2) * y - f32(1))
        margin = f32(f32(1) - s * dot)
        per = margin if margin > 0 else f32(0)
        mult = -s if margin > 0 else f32(0)
    return per, mult


def _partial_dot(x, w):
    """One rank's partial dot of one row slice: each thread's columns
    (t, t + THREADS, ...) summed in order with fma, a shuffle tree in
    each warp (lane l adds lane l ^ off, off = 16 ... 1), then the warps'
    sums in order."""
    cols = x.shape[0]
    per_thread = -(-cols // THREADS)
    acc = np.zeros(THREADS, f32)
    xp = np.zeros(per_thread * THREADS, f32)
    wp = np.zeros(per_thread * THREADS, f32)
    xp[:cols], wp[:cols] = x, w
    for j in range(per_thread):
        seg = slice(j * THREADS, (j + 1) * THREADS)
        acc = (xp[seg].astype(np.float64) * wp[seg] + acc).astype(f32)
    lanes = acc.reshape(THREADS // 32, 32)
    for off in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[:, np.arange(32) ^ off]).astype(f32)
    p = f32(0)
    for v in lanes[:, 0]:
        p = f32(p + v)
    return p


def _cluster_model(name, X, w, y, m, ranks, clusters, rows):
    """The cluster mode's loss and gradient in f32, in the kernel's order
    of sums: the clusters take contiguous row ranges of ceil(n /
    clusters) rows, walked in stages of ``rows`` rows; each row's dot is
    the ranks' partials added in rank order; rank 0's thread r counts the
    losses of row r of every stage (with compensation), summed over r in
    order; each rank's slice of the gradient is an fma sum over the
    cluster's rows in order; the clusters' partials are added with
    compensation."""
    n, d = X.shape
    parts = _slices(d, ranks)
    per_cluster = -(-n // clusters)
    cluster_loss, cluster_grad = [], []
    for k in range(clusters):
        r0, r1 = min(n, k * per_cluster), min(n, (k + 1) * per_cluster)
        g = np.zeros(d, f32)
        row_loss = [[f32(0), f32(0)] for _ in range(MAX_ROWS)]  # Kahan
        for s0 in range(r0, r1, rows):
            for r, i in enumerate(range(s0, min(s0 + rows, r1))):
                dot = f32(0)
                for c0, cols in parts:
                    dot = f32(dot + _partial_dot(X[i, c0:c0 + cols],
                                                 w[c0:c0 + cols]))
                per, mult = _middle(name, dot, y[i])
                acc, comp = row_loss[r]
                v = f32(f32(per * m[i]) - comp)
                t = f32(acc + v)
                row_loss[r] = [t, f32(f32(t - acc) - v)]
                g = (X[i].astype(np.float64) * f32(mult * m[i])
                     + g).astype(f32)
        cluster_loss.append(_kahan([acc for acc, _ in row_loss]))
        cluster_grad.append(g)
    loss = _kahan(cluster_loss)
    grad = np.array([_kahan(col) for col in np.array(cluster_grad).T]
                    if clusters else np.zeros(d), f32)
    return loss, grad


def _data(n, d, seed, bf16):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(f32)
    if bf16:  # the values bf16 X holds, widened to f32
        X = torch.from_numpy(X).to(torch.bfloat16).to(torch.float32).numpy()
    w = (rng.standard_normal(d) / np.sqrt(d)).astype(f32)
    y = (rng.random(n) < 0.5).astype(f32)
    mask = (rng.random(n) < 0.7).astype(f32)
    return X, w, y, mask


def _close(loss, grad, ref_loss, ref_grad):
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5,
                                        abs=1e-30)
    np.testing.assert_allclose(np.asarray(grad, np.float64),
                               np.asarray(ref_grad, np.float64),
                               rtol=1e-4, atol=1e-4)


def _jnp(name, X, w, y, mask):
    loss, grad, _ = jlosses.GRADIENTS[name]().batch_loss_and_grad(
        jnp.asarray(w, jnp.float64), jnp.asarray(X, jnp.float64),
        jnp.asarray(y), None if mask is None else jnp.asarray(mask))
    return loss, grad


def _pallas(name, X, w, y, mask, bf16):
    Xj = jnp.asarray(X).astype(jnp.bfloat16) if bf16 else jnp.asarray(X)
    padded = pad_dense(Xj, jnp.asarray(y),
                       None if mask is None else jnp.asarray(mask))
    return pallas_margin_loss_grad(jlosses.GRADIENTS[name](),
                                   jnp.asarray(w), padded, interpret=True)


def _plain(name, X, w, y, mask, bf16):
    Xt = torch.from_numpy(X)
    staged = fk.stage_dense(Xt.to(torch.bfloat16) if bf16 else Xt,
                            torch.from_numpy(y),
                            None if mask is None else torch.from_numpy(mask))
    return fk.fused_margin_loss_grad_reference(
        losses.GRADIENTS[name](), torch.from_numpy(w), staged)


# (rows, columns, ranks, clusters, rows a stage): ragged slices (1,003
# columns in 4 ranks: 256, 256, 256, 235) over 3 clusters of 86 rows;
# fewer rows than a stage; one row; 16 ranks of 544 columns (two on some
# threads) and a last slice of 40; 2 ranks of 1,056 and 993 columns (three
# on some threads) over 5 clusters
CASES = [(257, 1003, 4, 3, 2), (5, 1003, 4, 2, 8), (1, 777, 4, 1, 4),
         (40, 8200, 16, 3, 1), (33, 2049, 2, 5, 2)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("n,d,ranks,clusters,rows", CASES,
                         ids=[f"{c[0]}x{c[1]}-C{c[2]}-K{c[3]}-R{c[4]}"
                              for c in CASES])
def test_cluster_order_of_sums_matches_the_jax_package(n, d, ranks,
                                                       clusters, rows, name,
                                                       masked, bf16):
    X, w, y, mask = _data(n, d, seed=n + d + ranks, bf16=bf16)
    m = mask if masked else None
    loss, grad = _cluster_model(name, X, w, y,
                                mask if masked else np.ones(n, f32), ranks,
                                clusters, rows)
    j_loss, j_grad = _jnp(name, X, w, y, m)
    _close(loss, grad, j_loss, j_grad)
    p_loss, p_grad = _pallas(name, X, w, y, m, bf16)
    _close(loss, grad, p_loss, p_grad)
    # the port's plain version, which the kernel is held to on the card
    r_loss, r_grad = _plain(name, X, w, y, m, bf16)
    _close(r_loss, r_grad.numpy(), j_loss, j_grad)
    _close(r_loss, r_grad.numpy(), p_loss, p_grad)


@pytest.mark.parametrize("name", LOSSES)
def test_no_rows_give_zeros(name):
    """N = 0: every cluster's range is empty; the loss and the gradient
    are exact zeros, as the plain version and the jnp loss give."""
    X, w, y, mask = _data(0, 1003, seed=1, bf16=False)
    loss, grad = _cluster_model(name, X, w, y, mask, 4, 3, 2)
    assert float(loss) == 0.0 and not grad.any() and grad.shape == (1003,)
    j_loss, j_grad = _jnp(name, X, w, y, mask)
    _close(loss, grad, j_loss, j_grad)
    r_loss, r_grad = _plain(name, X, w, y, mask, False)
    assert float(r_loss) == 0.0 and not r_grad.any()

