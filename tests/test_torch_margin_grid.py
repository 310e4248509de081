"""The margin kernel's grid mode, modelled on the CPU, against the JAX
package.

Past the cluster mode's reach the CUDA margin kernel reads X once across
one block on every SM of the card (``csrc/margin_loss_grad.cu``, its
"grid" mode, ``fused_kernels.cluster_max_width`` + 1 to
``grid_max_width`` on the card, and f32 rows that are not 16-byte
aligned from ``grid_unaligned_from_width``): block b owns a column slice
of every row (X's 32-column units dealt in order, the first ``units %
blocks`` blocks one more than the rest, so that none is empty); each of
its 512
threads owns the slice's columns t, t + 512, ... with w and the gradient
sums in registers; a stage's partial dots are reduced and scattered
across each warp (``reduce_scatter`` of 8 rows), the warps' partials
added in warp order and stored in L2; every block then adds all the
blocks' partials of a row in the same fixed order (lane l the blocks l,
l + 32, ... in turn, then a shuffle tree), applies the loss middle, and
adds mult * x into its columns; block 0 alone counts the loss, with
compensation.  The kernel runs only on the card (``test_torch_cuda.py``
holds it to its plain version there).  Here a numpy model of that order
of sums in f32, and the port's plain version
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
# the kernel's constants: threads a block, warps, columns a slice unit,
# rows of a stage at most (the reduce-scatter's width)
THREADS, WARPS, UNIT, MAX_ROWS = 512, 16, 32, 8
f32 = np.float32
LANES = np.arange(32)


def _slices(d, blocks):
    """Each block's (first column, columns) (``grid_slice``): the units
    of UNIT columns dealt in order, the first ``units % blocks`` blocks
    one unit more than the rest, the last unit ragged."""
    units = -(-d // UNIT)
    q, r = divmod(units, blocks)
    out = []
    for b in range(blocks):
        first = b * q + min(b, r)
        end = min(d, (first + q + (b < r)) * UNIT)
        out.append((first * UNIT, end - first * UNIT))
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


def _stage_partials(Xs, w):
    """One block's partial dots of a stage's rows ``Xs`` (here x cols,
    here <= MAX_ROWS) over its slice, in the kernel's order: thread t's
    fma over its columns t + THREADS i for each row; in each warp the
    MAX_ROWS rows reduced and scattered in log2(MAX_ROWS) halving steps
    (lane l keeps the upper half where bit 16 >> I is set, adding its
    partner's), then plain xor steps, so that lane u * (32 / MAX_ROWS)
    holds row u's warp sum; the warps' sums added in order from 0."""
    here, cols = Xs.shape
    j = -(-cols // THREADS)
    x = np.zeros((MAX_ROWS, j * THREADS), f32)
    x[:here, :cols] = Xs
    wp = np.zeros(j * THREADS, f32)
    wp[:cols] = w
    p = np.zeros((THREADS, MAX_ROWS), f32)  # thread t's partial of row u
    for i in range(j):
        seg = slice(i * THREADS, (i + 1) * THREADS)
        p = (x[:, seg].T.astype(np.float64) * wp[seg][:, None]
             + p).astype(f32)
    v = p.reshape(WARPS, 32, MAX_ROWS)
    q = MAX_ROWS.bit_length() - 1
    for step in range(q):
        half, off = MAX_ROWS >> (step + 1), 16 >> step
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
        for part in dot[:, u * (32 // MAX_ROWS)]:
            acc = f32(acc + part)
        out.append(acc)
    return out


def _whole_dot(partials):
    """A row's dot from the blocks' partials, as every block adds them:
    lane l the blocks l, l + 32, ... in turn from 0, then a shuffle tree
    (lane l adds lane l ^ off, off = 16 ... 1); lane 0's value."""
    lanes = np.zeros(32, f32)
    for b, part in enumerate(partials):
        lanes[b % 32] = f32(lanes[b % 32] + part)
    for off in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[LANES ^ off]).astype(f32)
    return lanes[0]


def _grid_model(name, X, w, y, m, blocks, rows):
    """The grid mode's loss and gradient in f32, in the kernel's order of
    sums: every block walks all the rows in stages of ``rows`` rows; each
    row's dot is the blocks' partials added as ``_whole_dot`` adds them;
    block 0's lane 0 of warp u counts the losses of row u of every stage
    (with compensation), summed over u in order; each column's gradient
    is an fma sum over the rows in order, by the one thread that owns
    it."""
    n, d = X.shape
    parts = _slices(d, blocks)
    assert all(cols >= 1 for _, cols in parts)
    g = np.zeros(d, f32)
    row_loss = [[f32(0), f32(0)] for _ in range(MAX_ROWS)]  # Kahan
    for s0 in range(0, n, rows):
        stage = range(s0, min(s0 + rows, n))
        per_block = [_stage_partials(X[stage.start:stage.stop, c0:c0 + cols],
                                     w[c0:c0 + cols])
                     for c0, cols in parts]
        for u, i in enumerate(stage):
            dot = _whole_dot([p[u] for p in per_block])
            per, mult = _middle(name, dot, y[i])
            acc, comp = row_loss[u]
            v = f32(f32(per * m[i]) - comp)
            t = f32(acc + v)
            row_loss[u] = [t, f32(f32(t - acc) - v)]
            g = (X[i].astype(np.float64) * f32(mult * m[i]) + g).astype(f32)
    return _kahan([acc for acc, _ in row_loss]), g


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


# (rows, columns, blocks, rows a stage): 32 units in 3 blocks (11, 11
# and a ragged 10) over stages of 8 with a ragged last stage; 65 units in
# 7 blocks of 9-10, stages of 3; 129 units in 16 blocks (one of 9, the
# rest 8, two columns a thread nowhere) in stages of 7; 100 columns in 3
# blocks, where a slice of ceil(100 / 3) rounded up to the unit (64)
# would leave the last block nothing (64, 32, 4 columns here)
CASES = [(37, 1_000, 3, 8), (20, 2_049, 7, 3), (9, 4_100, 16, 7),
         (11, 100, 3, 5)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("n,d,blocks,rows", CASES,
                         ids=[f"{c[0]}x{c[1]}-B{c[2]}-R{c[3]}"
                              for c in CASES])
def test_grid_order_of_sums_matches_the_jax_package(n, d, blocks, rows,
                                                    name, masked, bf16):
    X, w, y, mask = _data(n, d, seed=n + d + blocks, bf16=bf16)
    m = mask if masked else None
    loss, grad = _grid_model(name, X, w, y,
                             mask if masked else np.ones(n, f32), blocks,
                             rows)
    j_loss, j_grad = _jnp(name, X, w, y, m)
    _close(loss, grad, j_loss, j_grad)
    p_loss, p_grad = _pallas(name, X, w, y, m, bf16)
    _close(loss, grad, p_loss, p_grad)
    # the port's plain version, which the kernel is held to on the card
    r_loss, r_grad = _plain(name, X, w, y, m, bf16)
    _close(r_loss, r_grad.numpy(), j_loss, j_grad)
    _close(r_loss, r_grad.numpy(), p_loss, p_grad)


# (columns, blocks): the H100's 132 blocks one column past the cluster
# mode's reach, at phase 31's width and at the grid mode's reach; the
# CPU cases; a block a unit
SLICE_CASES = [(262_145, 132), (500_000, 132), (2_162_688, 132),
               (100, 3), (1_000, 32), (4_100, 16), (33, 2)]


@pytest.mark.parametrize("d,blocks", SLICE_CASES,
                         ids=[f"{d}-B{b}" for d, b in SLICE_CASES])
def test_slices_cover_the_row_and_leave_no_block_empty(d, blocks):
    """The slices tile [0, d) in order, each starts on a unit, each has
    columns, and they differ by at most a unit: where a slice of ceil(d
    / blocks) columns rounded up to the unit would leave the last block
    nothing or less than a unit (262,145 columns in 132 blocks: 131 x
    2,016 columns pass the row's end)."""
    parts = _slices(d, blocks)
    assert parts[0][0] == 0
    for (c0, cols), (c1, _) in zip(parts, parts[1:]):
        assert c0 + cols == c1 and c1 % UNIT == 0
    assert sum(cols for _, cols in parts) == d
    assert min(cols for _, cols in parts) >= 1
    full = [cols for _, cols in parts[:-1]]
    assert max(full) - min(full) <= UNIT if full else True
    assert max(cols for _, cols in parts) <= THREADS * 32
    ceil_slice = -(-(-(-d // blocks)) // UNIT) * UNIT
    if d in (262_145, 100):
        assert (blocks - 1) * ceil_slice >= d  # the rule this one replaces


@pytest.mark.parametrize("name", LOSSES)
def test_no_rows_give_zeros(name):
    """N = 0: no stage; the loss and the gradient are exact zeros, as the
    plain version and the jnp loss give."""
    X, w, y, mask = _data(0, 1_000, seed=1, bf16=False)
    loss, grad = _grid_model(name, X, w, y, mask, 3, 8)
    assert float(loss) == 0.0 and not grad.any() and grad.shape == (1_000,)
    j_loss, j_grad = _jnp(name, X, w, y, mask)
    _close(loss, grad, j_loss, j_grad)
    r_loss, r_grad = _plain(name, X, w, y, mask, False)
    assert float(r_loss) == 0.0 and not r_grad.any()
