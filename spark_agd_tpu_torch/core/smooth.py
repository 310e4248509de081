"""Builders turning (Gradient, data) into the ``smooth(w) -> (f, g)`` the
optimizer core consumes.

Counterpart of ``spark_agd_tpu/core/smooth.py``: mean loss and mean
gradient over one device-resident batch (the reference's
``applySmooth``).  ``gradient.prepare`` runs once, when the data is
placed, never inside the optimizer loop.  :func:`lanes_smooth` is the
K-lane form the sweeps and cross-validation drive (the counterpart of
``jax.vmap`` over the smooth).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..ops.losses import Gradient
from ..ops.prox import Prox, lane_view
from . import tvec


def make_smooth_staged(gradient: Gradient, X, y, mask=None):
    """``(build, data_args)``: ``gradient.prepare`` runs ONCE here and the
    prepared operands come back as ``data_args``; ``build(*data_args)``
    returns the ``(smooth, smooth_loss)`` closures over them.  The split
    keeps the JAX package's shape, where the operands ride through
    ``jax.jit`` as arguments."""
    X, y, mask = gradient.prepare(X, y, mask)

    def build(Xa, ya, ma):
        def smooth(w):
            return gradient.mean_loss_and_grad(w, Xa, ya, ma)

        def smooth_loss(w):
            loss_sum, _, n = gradient.batch_loss_and_grad(w, Xa, ya, ma)
            return loss_sum / n.to(loss_sum.dtype)

        return smooth, smooth_loss

    return build, (X, y, mask)


def make_smooth(gradient: Gradient, X, y, mask=None) -> Callable:
    """``smooth(w) -> (mean_loss, mean_grad)`` over one batch."""
    build, args = make_smooth_staged(gradient, X, y, mask)
    return build(*args)[0]


def make_smooth_loss(gradient: Gradient, X, y, mask=None) -> Callable:
    """Loss-only evaluation, used by ``loss_mode='x'`` when backtracking
    is off (it runs the full loss-and-gradient evaluation)."""
    build, args = make_smooth_staged(gradient, X, y, mask)
    return build(*args)[1]


def make_prox(p: Prox, reg_param: float):
    """Close a ``Prox`` over its regularization parameter: the pair
    ``(prox(w, g, step), reg_value(w))`` the core consumes."""

    def prox(w, g, step):
        return p.prox(w, g, step, reg_param)

    def reg_value(w):
        return p.reg_value(w, reg_param)

    return prox, reg_value


def lanes_smooth(gradient: Gradient, X, y, masks=None):
    """``(smooth_multi, smooth_loss_multi)`` over prepared operands for K
    lanes at once (:func:`lanes_pair`), each lane over its own count
    (``masks``: ``None``, a shared (N,) mask or an (N, K) mask, a column
    a lane).  One call evaluates every lane: through
    ``gradient.lanes_loss_and_grad``, which reads X once for all of them
    where the gradient has a lanes kernel."""
    return lanes_pair(lambda W: gradient.lanes_loss_and_grad(W, X, y, masks))


def lanes_pair(sums: Callable):
    """``(smooth_multi, smooth_loss_multi)`` of a K-lane sums function
    ``sums(W) -> ((K,) loss sums, gradient sums stacked like W, (K,)
    counts)``: ``smooth_multi(W) -> ((K,) mean losses, mean gradients)``
    and ``smooth_loss_multi(W) -> (K,) mean losses``."""

    def smooth_multi(W):
        loss_sum, grad_sum, n = sums(W)
        n = n.to(loss_sum.dtype)
        inv = 1.0 / n
        return loss_sum / n, tvec.tmap(lambda g: lane_view(inv, g) * g,
                                       grad_sum)

    def smooth_loss_multi(W):
        loss_sum, _, n = sums(W)
        return loss_sum / n.to(loss_sum.dtype)

    return smooth_multi, smooth_loss_multi


def lanes_mean_or_nan(loss_sum, n):
    """``(K,)`` mean losses of loss sums over counts; a lane that selected
    no rows reads NaN, never a perfect 0.0."""
    n = n.to(loss_sum.dtype)
    return torch.where(n > 0, loss_sum / torch.clamp_min(n, 1), math.nan)
