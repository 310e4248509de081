"""On-device synthetic data: generated where it is consumed.

Counterpart of ``spark_agd_tpu/data/device_synth.py:60-151``.  The data
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
