"""On-device synthetic data: generated where it is consumed.

Counterpart of ``spark_agd_tpu/data/device_synth.py:60-234``, with
``planted_mlp`` (``:154-167``).  The data
is drawn by a ``torch.Generator`` on the target device from ``seed``, so
no bulk host-to-device copy happens.  X is allocated once and filled in
row blocks in place: at the benchmark scale (10M x 1000 f32, 40 GB) a
second full-size temporary would not fit beside it, and at BASELINE
config 4's 8.1M x 784 the trainer's intercept copy must fit beside X.
The JAX package's threefry bits and these Philox bits differ for the
same seed, so the two packages' datasets agree in distribution, not
value by value.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .._device import resolve_device

_BLOCK_ROWS = 1 << 18


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def class_logistic(n: int, d: int, sep: float = 1.0, *, seed: int = 0,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-class Gaussian mixture whose Bayes posterior is a logistic
    model: y ~ Bernoulli(1/2), x | y ~ N(±mu, I) with ``‖mu‖ ≈ sep``.
    Returns ``(X f32[n, d], y f32[n])`` with y in {0, 1}."""
    dev = resolve_device(device)
    gen = _generator(dev, seed)
    y = (torch.rand(n, generator=gen, device=dev) < 0.5).to(torch.float32)
    mu = (sep / math.sqrt(d)) * torch.randn(d, generator=gen, device=dev)
    signs = 2.0 * y - 1.0
    X = torch.empty((n, d), dtype=torch.float32, device=dev)
    for r0 in range(0, n, _BLOCK_ROWS):
        block = X[r0:r0 + _BLOCK_ROWS]
        block.normal_(generator=gen)
        block.addr_(signs[r0:r0 + _BLOCK_ROWS], mu)  # += sign ⊗ mu
    return X, y


def planted_dense_linreg(n: int, d: int, noise: float = 0.1, *,
                         seed: int = 0, device=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense least squares with a planted weight vector
    ``w ~ N(0, I/d)``: ``y = X @ w + noise * e``."""
    dev = resolve_device(device)
    gen = _generator(dev, seed)
    w = torch.randn(d, generator=gen, device=dev) / math.sqrt(d)
    X = torch.empty((n, d), dtype=torch.float32, device=dev)
    y = torch.empty(n, dtype=torch.float32, device=dev)
    for r0 in range(0, n, _BLOCK_ROWS):
        block = X[r0:r0 + _BLOCK_ROWS]
        block.normal_(generator=gen)
        e = torch.randn(block.shape[0], generator=gen, device=dev)
        y[r0:r0 + _BLOCK_ROWS] = block @ w + noise * e
    return X, y


def softmax_params(d: int, k: int, *, seed: int = 0,
                   device=None) -> torch.Tensor:
    """The planted softmax weight matrix ``W ~ N(0, I/d)``, (d, k) f32 —
    one definition shared by :func:`planted_softmax` and a caller that
    generates blocks itself with :func:`softmax_block`."""
    dev = resolve_device(device)
    return torch.randn((d, k), generator=_generator(dev, seed),
                       device=dev) / math.sqrt(d)


def _block_seed(seed: int, block: int) -> int:
    """The seed of row block ``block``: a fixed odd-multiplier mix, so
    blocks draw independent streams."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(block) + 1) % (1 << 63)


def softmax_block(W: torch.Tensor, rows: int, *, seed: int, block: int,
                  out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row block ``block`` of the planted softmax data on W's device:
    ``X ~ N(0, I)`` and labels by the Gumbel-max trick (exactly a
    categorical sample of ``softmax(X @ W)``), int32.  The block draws
    from its own generator, seeded by ``(seed, block)``, so the data does
    not depend on whether the caller fills one array or streams blocks.
    ``out``, a (rows, d) f32 tensor, is filled in place."""
    d, k = W.shape
    gen = _generator(W.device, _block_seed(seed, block))
    X = (torch.empty((rows, d), dtype=torch.float32, device=W.device)
         if out is None else out)
    X.normal_(generator=gen)
    gumbel = -torch.empty((rows, k), dtype=torch.float32,
                          device=W.device).exponential_(generator=gen).log()
    y = torch.argmax(X @ W + gumbel, dim=1).to(torch.int32)
    return X, y


def planted_softmax(n: int, d: int, k: int, *, seed: int = 0, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense multiclass data from the planted softmax model
    (:func:`softmax_params`): ``(X f32[n, d], y int32[n])`` with labels in
    ``[0, k)``.  X is filled in place, a row block at a time, with
    :func:`softmax_block`."""
    dev = resolve_device(device)
    W = softmax_params(d, k, seed=seed, device=dev)
    X = torch.empty((n, d), dtype=torch.float32, device=dev)
    y = torch.empty(n, dtype=torch.int32, device=dev)
    for block, r0 in enumerate(range(0, n, _BLOCK_ROWS)):
        rows = min(_BLOCK_ROWS, n - r0)
        _, y[r0:r0 + rows] = softmax_block(W, rows, seed=seed, block=block,
                                           out=X[r0:r0 + rows])
    return X, y


def planted_mlp(n: int, d: int, h: int, gain: float = 4.0, *,
                seed: int = 0, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary labels from a planted two-layer tanh MLP (BASELINE config
    5's data): ``X ~ N(0, I)``, ``W1 ~ N(0, I/d)`` (d, h), ``W2 ~ N(0,
    I/h)`` (h,), ``y ~ Bernoulli(sigmoid(gain * tanh(X @ W1) @ W2))``.
    Returns ``(X f32[n, d], y int32[n])``."""
    dev = resolve_device(device)
    gen = _generator(dev, seed)
    W1 = torch.randn((d, h), generator=gen, device=dev) / math.sqrt(d)
    W2 = torch.randn(h, generator=gen, device=dev) / math.sqrt(h)
    X = torch.empty((n, d), dtype=torch.float32, device=dev)
    y = torch.empty(n, dtype=torch.int32, device=dev)
    for r0 in range(0, n, _BLOCK_ROWS):
        block = X[r0:r0 + _BLOCK_ROWS]
        block.normal_(generator=gen)
        p = torch.sigmoid(gain * (torch.tanh(block @ W1) @ W2))
        u = torch.rand(block.shape[0], generator=gen, device=dev)
        y[r0:r0 + _BLOCK_ROWS] = (u < p).to(torch.int32)
    return X, y


def _planted_sparse_labels(gen, values, col_ids, n_rows: int, n_features: int,
                           row_width: int, scale: float) -> torch.Tensor:
    """Labels of the planted sparse logistic model: ``w ~ N(0, I) /
    scale``, the margin of row r the sum of its ``row_width`` entries'
    ``values * w[col_ids]`` (rows are runs of ``row_width`` entries, so
    the sum is a reshape, in a fixed order), ``y ~ Bernoulli(sigmoid)``."""
    dev = values.device
    w = torch.randn(n_features, generator=gen, device=dev) / scale
    margins = (values * torch.index_select(w, 0, col_ids)) \
        .view(n_rows, row_width).sum(dim=1)
    u = torch.rand(n_rows, generator=gen, device=dev)
    return (u < torch.sigmoid(margins)).to(torch.float32)


def planted_sparse_parts(n_rows: int, n_features: int, nnz_per_row: int, *,
                         seed: int = 0, device=None):
    """COO parts of a planted sparse logistic problem, made on the device:
    ``(row_ids int32, col_ids int32, values f32, y f32)`` with exactly
    ``nnz_per_row`` entries a row, row-sorted by construction.  Column ids
    are uniform over ``[0, n_features)`` (a row may repeat one), values
    N(0, 1), the planted weights N(0, 1) / sqrt(nnz_per_row) so each
    margin has unit variance, labels in {0, 1} from the sigmoid.  Wrap
    the parts in ``CSRMatrix(..., rows_sorted=True)``."""
    dev = resolve_device(device)
    gen = _generator(dev, seed)
    nnz = n_rows * nnz_per_row
    col_ids = torch.randint(0, n_features, (nnz,), generator=gen, device=dev,
                            dtype=torch.int32)
    values = torch.randn(nnz, generator=gen, device=dev)
    row_ids = torch.arange(n_rows, dtype=torch.int32, device=dev) \
        .repeat_interleave(nnz_per_row)
    y = _planted_sparse_labels(gen, values, col_ids, n_rows, n_features,
                               nnz_per_row, math.sqrt(nnz_per_row))
    return row_ids, col_ids, values, y


def planted_sparse_parts_varied(n_rows: int, n_features: int, nnz_mean: int,
                                sigma: float = 0.5, max_factor: int = 3, *,
                                seed: int = 0, device=None):
    """:func:`planted_sparse_parts` with a long-tailed count of nonzeros a
    row: log-normal counts (``mu = ln(nnz_mean) - sigma^2 / 2``, so the
    mean lands on ``nnz_mean``), rounded and clipped to ``[1,
    max_factor * nnz_mean]``.  Every row holds ``max_factor * nnz_mean``
    entries; those past the row's count keep their random column id and
    get value 0 (inert padding), so margins, gradients and the nonzero
    histogram follow the drawn counts."""
    dev = resolve_device(device)
    gen = _generator(dev, seed)
    width = max_factor * nnz_mean
    mu = math.log(nnz_mean) - 0.5 * sigma * sigma
    counts = torch.clamp(torch.round(torch.exp(
        mu + sigma * torch.randn(n_rows, generator=gen, device=dev))),
        1, width).to(torch.int32)
    nnz = n_rows * width
    col_ids = torch.randint(0, n_features, (nnz,), generator=gen, device=dev,
                            dtype=torch.int32)
    live = torch.arange(width, dtype=torch.int32, device=dev)[None, :] \
        < counts[:, None]
    values = torch.where(live.reshape(-1),
                         torch.randn(nnz, generator=gen, device=dev), 0.0)
    row_ids = torch.arange(n_rows, dtype=torch.int32, device=dev) \
        .repeat_interleave(width)
    y = _planted_sparse_labels(gen, values, col_ids, n_rows, n_features,
                               width, math.sqrt(nnz_mean))
    return row_ids, col_ids, values, y
