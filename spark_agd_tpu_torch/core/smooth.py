"""Builders turning (Gradient, data) into the ``smooth(w) -> (f, g)`` the
optimizer core consumes.

Counterpart of ``spark_agd_tpu/core/smooth.py``: mean loss and mean
gradient over one device-resident batch (the reference's
``applySmooth``).  ``gradient.prepare`` runs once, when the data is
placed, never inside the optimizer loop.
"""

from __future__ import annotations

from typing import Callable

from ..ops.losses import Gradient
from ..ops.prox import Prox


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
