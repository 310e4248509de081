"""The margin kernel's stream mode, modelled on the CPU, against the JAX
package.

From a few hundred columns up to 8,192 f32 or 16,384 bf16 columns the
CUDA margin kernel streams contiguous stages of rows through a ring in
one block's shared memory (``csrc/margin_loss_grad.cu``, its "stream"
mode, ``fused_kernels.tile_max_width`` + 1 to ``max_width`` on the
card): each of a block's 512
threads owns the columns t, t + 512, ... with w and the gradient sums in
registers; each thread's partial dots of a stage's R rows are reduced
across its warp and scattered so that one lane holds each row's
(``reduce_scatter``), the warps' partials are added in warp order, the
loss middle runs once a row, and every thread adds mult * x into its
columns; the blocks' partials are added last with compensation.  The
kernel runs only on the card (``test_torch_cuda.py`` holds it to its
plain version there).  Here a numpy model of that order of sums in f32
(the threads' columns, the reduce-scatter and the warps in order, the
middle, the register sums, the blocks with compensation), and the port's
plain version ``fused_margin_loss_grad_reference``, are each held to
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
# the kernel's constants: threads a block, warps, columns a thread at
# most, bytes of X a stage at most
THREADS, WARPS, MAX_COLS, STAGE_BYTES = 512, 16, 32, 64 * 1024
f32 = np.float32
LANES = np.arange(32)


def _bucket(d):
    """The register bucket J of width d (``with_stream_bucket``): 1, 2,
    then multiples of 4."""
    need = -(-d // THREADS)
    assert need <= MAX_COLS
    j = 1
    while j < need:
        j = 2 * j if j < 4 else j + 4
    return j


def _stage_rows(j, itemsize):
    """Rows a stage for bucket j (``stream_rows``): a power of 2, at most
    32, whose rows of THREADS * j columns take at most STAGE_BYTES."""
    rows = 32
    while rows * THREADS * j * itemsize > STAGE_BYTES:
        rows //= 2
    assert rows >= 1
    return rows


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


def _stage_dots(Xs, w, j, r):
    """The whole dots of a stage's rows ``Xs`` (here x d, here <= R) in
    the kernel's order: thread t's fma over its columns t + THREADS i (i <
    j) for each row; in each warp the R partials reduced and scattered in
    log2(R) halving steps (lane l keeps the upper half where bit 16 >> I
    is set, adding its partner's), then plain xor steps, so that lane
    u * (32 / R) holds row u's warp sum; the warps' sums added in order
    (R = ``r``, the stage's rows)."""
    here, d = Xs.shape
    cols = np.zeros((r, j * THREADS), f32)
    cols[:here, :d] = Xs
    wp = np.zeros(j * THREADS, f32)
    wp[:d] = w
    p = np.zeros((THREADS, r), f32)  # thread t's partial of row u
    for i in range(j):
        seg = slice(i * THREADS, (i + 1) * THREADS)
        p = (cols[:, seg].T.astype(np.float64) * wp[seg][:, None]
             + p).astype(f32)
    v = p.reshape(WARPS, 32, r)
    q = r.bit_length() - 1
    for step in range(q):
        half, off = r >> (step + 1), 16 >> step
        upper = ((LANES & off) != 0)[None, :, None]
        partner = v[:, LANES ^ off, :]
        hi, lo = slice(half, 2 * half), slice(0, half)
        v = np.where(upper, v[:, :, hi] + partner[:, :, hi],
                     v[:, :, lo] + partner[:, :, lo]).astype(f32)
    dot = v[:, :, 0]
    off = 16 >> q
    while off > 0:
        dot = (dot + dot[:, LANES ^ off]).astype(f32)
        off >>= 1
    out = []
    for u in range(here):
        acc = f32(0)
        for part in dot[:, u * (32 // r)]:
            acc = f32(acc + part)
        out.append(acc)
    return out


def _stream_model(name, X, w, y, m, blocks, itemsize):
    """The stream mode's loss and gradient in f32, in the kernel's order
    of sums: the blocks take contiguous row ranges of ceil(n / blocks)
    rows, walked in stages of R rows; thread r counts the losses of row
    r of every stage (with compensation), summed over r in order; each
    column's gradient is an fma sum over the block's rows in order; the
    blocks' partials are added with compensation (``reduce_partials``).
    ``itemsize``: the bytes of an element of X (4 f32, 2 bf16), which
    set the rows of a stage."""
    n, d = X.shape
    j = _bucket(d)
    r = _stage_rows(j, itemsize)
    per_block = -(-n // blocks)
    block_loss, block_grad = [], []
    for b in range(blocks):
        r0, r1 = min(n, b * per_block), min(n, (b + 1) * per_block)
        g = np.zeros(d, f32)
        row_loss = [[f32(0), f32(0)] for _ in range(r)]  # Kahan
        for s0 in range(r0, r1, r):
            rows = range(s0, min(s0 + r, r1))
            dots = _stage_dots(X[s0:rows.stop], w, j, r)
            mults = []
            for u, (i, dot) in enumerate(zip(rows, dots)):
                per, mult = _middle(name, dot, y[i])
                acc, comp = row_loss[u]
                v = f32(f32(per * m[i]) - comp)
                t = f32(acc + v)
                row_loss[u] = [t, f32(f32(t - acc) - v)]
                mults.append(f32(mult * m[i]))
            for i, mu in zip(rows, mults):
                g = (X[i].astype(np.float64) * mu + g).astype(f32)
        block_loss.append(_kahan([acc for acc, _ in row_loss]))
        block_grad.append(g)
    loss = _kahan(block_loss)
    grad = np.array([_kahan(col) for col in np.array(block_grad).T], f32)
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


# (rows, columns, blocks): one column a thread on 257 and 289 threads
# (past the warp-rows mode, about the narrowest f32 widths the mode
# takes, from 265; stages of 32 rows, a ragged last stage); 1,000 columns (two on most threads, stages of 16 f32 or 32 bf16
# rows) with fewer rows than a stage in each block; one row of 2,000; a
# ragged 2,001 (four columns on some threads, three on most) over 3
# blocks; 5,000 (stages of 2 or 4) and the widest f32 X the mode takes,
# 8,192 (16 columns a thread, stages of 2 or 4 rows)
CASES = [(70, 257, 2), (70, 289, 2), (9, 1000, 2), (1, 2000, 1), (41, 2001, 3),
         (7, 5000, 2), (3, 8_192, 2)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("n,d,blocks", CASES,
                         ids=[f"{c[0]}x{c[1]}-B{c[2]}" for c in CASES])
def test_stream_order_of_sums_matches_the_jax_package(n, d, blocks, name,
                                                      masked, bf16):
    X, w, y, mask = _data(n, d, seed=n + d + blocks, bf16=bf16)
    m = mask if masked else None
    loss, grad = _stream_model(name, X, w, y,
                               mask if masked else np.ones(n, f32), blocks,
                               2 if bf16 else 4)
    j_loss, j_grad = _jnp(name, X, w, y, m)
    _close(loss, grad, j_loss, j_grad)
    p_loss, p_grad = _pallas(name, X, w, y, m, bf16)
    _close(loss, grad, p_loss, p_grad)
    # the port's plain version, which the kernel is held to on the card
    r_loss, r_grad = _plain(name, X, w, y, m, bf16)
    _close(r_loss, r_grad.numpy(), j_loss, j_grad)
    _close(r_loss, r_grad.numpy(), p_loss, p_grad)


@pytest.mark.parametrize("d", [289, 1000, 2001], ids=str)
def test_stage_dots_keep_each_row_in_place(d):
    """The reduce-scatter hands each row's sum to the lane the kernel
    reads it from: a full stage's dots match the f64 dots row by row, and
    permuting the stage's rows permutes its dots bit for bit."""
    j = _bucket(d)
    r = _stage_rows(j, 4)
    X, w, _, _ = _data(r, d, seed=3, bf16=False)
    dots = _stage_dots(X, w, j, r)
    np.testing.assert_allclose(dots, X.astype(np.float64) @ w, rtol=1e-5,
                               atol=1e-6)
    perm = np.random.default_rng(0).permutation(r)
    assert _stage_dots(X[perm], w, j, r) == [dots[i] for i in perm]


@pytest.mark.parametrize("name", LOSSES)
def test_no_rows_give_zeros(name):
    """N = 0: the one block's range is empty; the loss and the gradient
    are exact zeros, as the plain version and the jnp loss give."""
    X, w, y, mask = _data(0, 1000, seed=1, bf16=False)
    loss, grad = _stream_model(name, X, w, y, mask, 1, 4)
    assert float(loss) == 0.0 and not grad.any() and grad.shape == (1000,)
    j_loss, j_grad = _jnp(name, X, w, y, mask)
    _close(loss, grad, j_loss, j_grad)
    r_loss, r_grad = _plain(name, X, w, y, mask, False)
    assert float(r_loss) == 0.0 and not r_grad.any()
