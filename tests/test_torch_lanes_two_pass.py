"""The lanes kernel's two-pass mode, modelled on the CPU, against the JAX
package.

Past the reach of its cluster mode, the CUDA lanes kernel reads X twice
(``csrc/margin_lanes_loss_grad.cu``, its "lanes_two_pass" mode), both
products on the tensor cores (3xTF32: every f32 operand split into TF32
halves, W into three parts).  Pass 1 forms the dots of 256-row tiles
over D in 32-column stages (of f32 X), each block over one of the plan's
D splits: each k8 step's hi*hi product starts from zero and is added to
the stage's sum with a rounded f32 add, the small products run on in the
compensation, and each stage's sum is added to the sum over stages with
compensation.  The middle adds the splits' partial dots in split order,
applies the loss middle, writes m * mult and sums m * per a thread at a
time (a grid-stride loop over (row, lane) elements that keeps a thread's
lane), then over each block's threads in a fixed tree.  Pass 2 forms X^T
M over row groups in 32-row stages, the stages added with compensation;
the groups' gradients and the middle blocks' losses are added last, in
order, with compensation.  The kernel runs only on the card
(``test_torch_cuda.py`` holds it to its plain version there).  Here a
numpy model of that order of sums in f32, and the port's plain version
``fused_margin_lanes_loss_grad_reference``, are each held to
``spark_agd_tpu.ops.pallas_kernels.fused_margin_loss_grad`` under
``jax.vmap`` over the lanes in interpret mode (what ``api.sweep`` runs)
and to the jnp ``batch_loss_and_grad`` at f64 (x64:
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
# the kernel's constants for f32 X: pass 1's rows a tile and columns a
# stage, pass 2's rows a stage, a k8 step, the middle's threads a block
TILE_ROWS, STEP, ROWS2, K8, THREADS = 256, 32, 32, 8, 256
f32 = np.float32


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


def _kahan(values, like):
    s = c = np.zeros_like(like)
    for v in values:
        s, c = _kahan_add(s, c, v)
    return s


def _stage_add(total, ncomp, big):
    """``tp_add_stage``: the stage's sum plus the compensation (the small
    products ride in it) into the sum over stages."""
    v = (big + ncomp).astype(f32)
    s = (total + v).astype(f32)
    return s, (v - (s - total).astype(f32)).astype(f32)


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


def _round_up(v, m):
    return -(-v // m) * m


def _pass1(X, Wb, splits, passes=4):
    """Each D split's partial dots (splits, n, lanes): 256-row tiles (the
    rows independent, so the tile only bounds the rows a block holds), the
    split's columns in STEP-column stages, each k8 step's x_hi w_hi from
    zero into the stage's sum, x_hi w_lo + x_lo w_hi + x_hi w_lo2 into the
    compensation (``passes=1`` keeps the hi*hi products alone)."""
    n, d = X.shape
    cols = _round_up(-(-d // splits), STEP)
    out = np.zeros((splits, n, Wb.shape[0]), f32)
    for t0 in range(0, n, TILE_ROWS):
        xh, xl = _split(X[t0:t0 + TILE_ROWS])
        wh, wl, wl2 = _split_w(Wb)
        for s in range(splits):
            total = np.zeros((xh.shape[0], Wb.shape[0]), f32)
            ncomp = np.zeros_like(total)
            for c0 in range(s * cols, min(d, (s + 1) * cols), STEP):
                big = np.zeros_like(total)
                for j in range(c0, min(d, (s + 1) * cols, c0 + STEP), K8):
                    sl = slice(j, min(d, j + K8))
                    big = (big + (xh[:, sl] @ wh[:, sl].T).astype(f32)
                           ).astype(f32)
                    if passes > 1:
                        ncomp = (ncomp + (xh[:, sl] @ wl[:, sl].T
                                          + xl[:, sl] @ wh[:, sl].T
                                          + xh[:, sl] @ wl2[:, sl].T)
                                 .astype(f32)).astype(f32)
                total, ncomp = _stage_add(total, ncomp, big)
            out[s, t0:t0 + TILE_ROWS] = (total + ncomp).astype(f32)
    return out


def _middle_pass(name, Z, y, m, k, blocks):
    """``lanes_tp_middle`` on `blocks` blocks: the splits' dots added in
    order, the middle, M = m * mult (0 past lane k); each thread's m * per
    over its elements (row * ms + lane, lane = thread % ms, a stride of
    blocks * THREADS) with compensation, then each block's threads in a
    fixed tree.  Returns (M (n, ms), the blocks' losses (blocks, k))."""
    splits, n, ms = Z.shape
    z = np.zeros((n, ms), f32)
    for s in range(splits):
        z = (z + Z[s]).astype(f32)
    per, mult = _middle(name, z, y[:, None])
    live = np.arange(ms) < k
    M = np.where(live, (mult * m[:, None]).astype(f32), f32(0))
    pm = np.where(live, (per * m[:, None]).astype(f32), f32(0)).reshape(-1)
    block_loss = []
    for b in range(blocks):
        acc = np.zeros(THREADS, f32)
        comp = np.zeros(THREADS, f32)
        e0 = b * THREADS
        while e0 < n * ms:
            e = e0 + np.arange(THREADS)
            v = np.where(e < n * ms, pm[np.minimum(e, n * ms - 1)], f32(0))
            # a thread past the elements adds nothing: its Kahan add of 0
            # leaves (acc, comp) as they are
            new_acc, new_comp = _kahan_add(acc, comp, v.astype(f32))
            acc = np.where(e < n * ms, new_acc, acc)
            comp = np.where(e < n * ms, new_comp, comp)
            e0 += blocks * THREADS
        w = THREADS // 2
        while w >= ms:
            acc[:w] = (acc[:w] + acc[w:2 * w]).astype(f32)
            w //= 2
        block_loss.append(acc[:k].copy())
    return M, block_loss


def _pass2(X, M, groups, passes=3):
    """Each row group's G (lanes, d): ROWS2-row stages, each k8 step's
    M_hi^T x_hi from zero into the stage's sum, M_lo^T x_hi + M_hi^T x_lo
    into the compensation, the stages added with compensation."""
    n, d = X.shape
    per_group = _round_up(-(-n // groups), ROWS2) if n else 0
    out = []
    for g in range(groups):
        r0, r1 = min(n, g * per_group), min(n, (g + 1) * per_group)
        total = np.zeros((d, M.shape[1]), f32)
        ncomp = np.zeros_like(total)
        for s0 in range(r0, r1, ROWS2):
            big = np.zeros_like(total)
            for j in range(s0, min(r1, s0 + ROWS2), K8):
                xh, xl = _split(X[j:min(r1, j + K8)])
                mh, ml = _split(M[j:min(r1, j + K8)])
                big = (big + (xh.T @ mh).astype(f32)).astype(f32)
                if passes > 1:
                    ncomp = (ncomp + (xh.T @ ml + xl.T @ mh).astype(f32)
                             ).astype(f32)
            total, ncomp = _stage_add(total, ncomp, big)
        out.append((total + ncomp).astype(f32).T)
    return out


def _two_pass_model(name, X, W, y, m, splits, groups, blocks, passes=4):
    """The two-pass mode's loss and gradient of each lane in f32, in the
    kernel's order of sums, for a plan of `splits` D splits, `groups`
    pass-2 row groups and `blocks` middle blocks.  The lanes run in a
    bucket of 8 or 16 (the dots of lanes past K are not read)."""
    n, d = X.shape
    k = W.shape[0]
    ms = 8 if k <= 8 else 16
    Wb = np.zeros((ms, d), f32)
    Wb[:k] = W
    Z = _pass1(X, Wb, splits, passes)
    M, block_loss = _middle_pass(name, Z, y, m, k, blocks)
    grads = _pass2(X, M, groups, 3 if passes > 1 else 1)
    loss = _kahan(block_loss, np.zeros(k, f32))
    grad = _kahan([g[:k] for g in grads], np.zeros((k, d), f32))
    return loss, grad


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


# (rows, columns, D splits, row groups, middle blocks): 300 rows are a
# tile and a ragged 44; 301 columns end in a ragged 13-column stage (an
# odd width); 1,003 in 3 splits of 352, 352 and 299 columns (the last
# split's last stage ragged), 3 groups of 128, 128 and 44 rows, one
# middle block striding over every element; 640 columns (20 whole
# stages) in 2 splits over 257 rows (a second tile of one row)
CASES = [(300, 301, 1, 2, 3), (300, 1003, 3, 3, 1), (257, 640, 2, 1, 5)]
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
@pytest.mark.parametrize("n,d,splits,groups,blocks", CASES,
                         ids=[f"{c[0]}x{c[1]}-splits{c[2]}-groups{c[3]}"
                              for c in CASES])
def test_two_pass_order_of_sums_matches_the_jax_package(
        n, d, splits, groups, blocks, k, name, masked):
    X, W, y, mask = _data(n, d, MAX_LANES, seed=n + d)
    W = W[:k]
    m = mask if masked else np.ones(n, f32)
    loss, grad = _two_pass_model(name, X, W, y, m, splits, groups, blocks)
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


def test_split_order_does_not_change_the_sums():
    """One split or three: the same sums within the kernel tolerances
    (the splits only cut D for the grid; the middle adds them in
    order)."""
    n, d = 300, 1003
    X, W, y, mask = _data(n, d, MAX_LANES, seed=n + d)
    one = _two_pass_model("logistic", X, W[:8], y, mask, 1, 1, 1)
    three = _two_pass_model("logistic", X, W[:8], y, mask, 3, 3, 4)
    _close(*three, *one)


def test_model_drops_no_split_and_no_small_pass():
    """The model is the kernel's arithmetic and not the plain product's:
    a model that leaves out the last split's columns, or keeps the hi*hi
    products alone, misses the f64 sums by far more than the
    tolerance."""
    n, d, splits = 300, 1003, 3
    X, W, y, mask = _data(n, d, MAX_LANES, seed=n + d)
    _, (j_loss, j_grad) = _references(n, d, "logistic", False)
    m = np.ones(n, f32)
    Xc = X.copy()
    Xc[:, 2 * 352:] = 0  # the last split's columns gone
    _, grad = _two_pass_model("logistic", Xc, W, y, m, splits, 1, 1)
    assert np.max(np.abs(grad - j_grad)) > 1e-2
    _, grad = _two_pass_model("logistic", X, W, y, m, splits, 1, 1,
                              passes=1)
    assert np.max(np.abs(grad - j_grad)
                  / (1e-4 + 1e-4 * np.abs(j_grad))) > 1.0


@pytest.mark.parametrize("name", LOSSES)
def test_no_rows_give_zeros(name):
    """N = 0: no tile, no element of the middle and empty row groups; the
    losses and gradients are exact zeros, as the plain version and the
    jnp loss give."""
    X, W, y, mask = _data(0, 301, 3, seed=1)
    loss, grad = _two_pass_model(name, X, W, y, mask, 1, 1, 1)
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
