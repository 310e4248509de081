"""On-device synthetic data: generated where it is consumed.

Counterpart of ``spark_agd_tpu/data/device_synth.py:60-116``.  The data
is drawn by a ``torch.Generator`` on the target device from ``seed``, so
no bulk host-to-device copy happens.  X is allocated once and filled in
row blocks in place: at the benchmark scale (10M x 1000 f32, 40 GB) a
second full-size temporary would not fit beside it.  The JAX package's
threefry bits and these Philox bits differ for the same seed, so the two
packages' datasets agree in distribution, not value by value.
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
