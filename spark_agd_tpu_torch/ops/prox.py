"""Proximal operators — the ``Updater`` contract in PyTorch.

Counterpart of ``spark_agd_tpu/ops/prox.py``.  ``prox(w, g, step, reg)
-> (w_new, reg_value_at_w_new)`` with no hidden step rescaling, and
``reg_value(w, reg)``.  The identity ``prox(w, g, 0, reg) == (w,
reg_value(w, reg))`` holds for every operator: the AGD loss history
relies on it.  ``reg_value`` follows spark-mllib 1.3.0: L2 is
``reg/2·‖w'‖²`` at the new weights, L1 is ``reg·‖w'‖₁``.  Operators map
leafwise over a tensor or a dict/list/tuple of tensors.
"""

from __future__ import annotations

import torch

from ..core import tvec


def _scalar_zero(w):
    """A 0-d zero in the weights' dtype, on their device."""
    ls = tvec.leaves(w)
    if not ls:
        return torch.zeros((), dtype=torch.float32)
    dt = ls[0].dtype
    for x in ls[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.zeros((), dtype=dt, device=ls[0].device)


def _soft(v, thresh):
    return torch.sign(v) * torch.clamp_min(v.abs() - thresh, 0.0)


class Prox:
    """Protocol: proximity operator of a (possibly zero) penalty."""

    def prox(self, w, g, step, reg):
        """Return ``(w_new, reg_value_at_w_new)``; must satisfy
        ``prox(w, g, 0.0, reg) == (w, reg_value(w, reg))``."""
        raise NotImplementedError

    def reg_value(self, w, reg):
        raise NotImplementedError

    def smooth_penalty(self, w, reg):
        """``(value, grad)`` of the penalty at ``w``, or ``None`` when the
        penalty is not differentiable (the L-BFGS seam)."""
        return None

    def owlqn_decomposition(self, reg):
        """``(l1_coeff, smooth_fn)`` splitting the penalty into an
        ``l1_coeff·‖w‖₁`` part plus a differentiable remainder, or
        ``None`` when it fits neither form."""
        if self.smooth_penalty(torch.zeros(()), float(reg)) is None:
            return None
        return 0.0, lambda w: self.smooth_penalty(w, reg)


class IdentityProx(Prox):
    """No penalty: plain gradient step (MLlib ``SimpleUpdater``)."""

    def prox(self, w, g, step, reg):
        w_new = tvec.tmap(lambda wi, gi: wi - step * gi, w, g)
        return w_new, _scalar_zero(w)

    def reg_value(self, w, reg):
        return _scalar_zero(w)

    def smooth_penalty(self, w, reg):
        return _scalar_zero(w), tvec.zeros_like(w)


class L2Prox(Prox):
    """Exact prox of ``(reg/2)·‖w‖²``: ``(w - step·g) / (1 + step·reg)``."""

    def prox(self, w, g, step, reg):
        shrink = 1.0 / (1.0 + step * reg)
        w_new = tvec.tmap(lambda wi, gi: (wi - step * gi) * shrink, w, g)
        return w_new, self.reg_value(w_new, reg)

    def reg_value(self, w, reg):
        return 0.5 * reg * tvec.sq_norm(w)

    def smooth_penalty(self, w, reg):
        return self.reg_value(w, reg), tvec.scale(reg, w)


class MLlibSquaredL2Updater(L2Prox):
    """spark-mllib 1.3.0 ``SquaredL2Updater``: the linearized step
    ``w' = (1 - step·reg)·w - step·g``, penalty at the new weights."""

    def prox(self, w, g, step, reg):
        w_new = tvec.tmap(
            lambda wi, gi: (1.0 - step * reg) * wi - step * gi, w, g)
        return w_new, self.reg_value(w_new, reg)


class L1Prox(Prox):
    """Prox of ``reg·‖w‖₁``: soft-thresholding by ``step·reg``."""

    def prox(self, w, g, step, reg):
        thresh = step * reg
        w_new = tvec.tmap(lambda wi, gi: _soft(wi - step * gi, thresh), w, g)
        return w_new, self.reg_value(w_new, reg)

    def reg_value(self, w, reg):
        return reg * tvec.l1_norm(w)

    def owlqn_decomposition(self, reg):
        return float(reg), lambda w: (_scalar_zero(w), tvec.zeros_like(w))


class ElasticNetProx(Prox):
    """Prox of ``reg·(l1_ratio·‖w‖₁ + (1-l1_ratio)/2·‖w‖²)``:
    soft-threshold then shrink."""

    def __init__(self, l1_ratio: float = 0.5):
        self.l1_ratio = float(l1_ratio)

    def prox(self, w, g, step, reg):
        l1 = reg * self.l1_ratio
        l2 = reg * (1.0 - self.l1_ratio)
        thresh = step * l1
        shrink = 1.0 / (1.0 + step * l2)
        w_new = tvec.tmap(
            lambda wi, gi: _soft(wi - step * gi, thresh) * shrink, w, g)
        return w_new, self.reg_value(w_new, reg)

    def reg_value(self, w, reg):
        l1 = reg * self.l1_ratio
        l2 = reg * (1.0 - self.l1_ratio)
        return l1 * tvec.l1_norm(w) + 0.5 * l2 * tvec.sq_norm(w)

    def owlqn_decomposition(self, reg):
        l2 = reg * (1.0 - self.l1_ratio)
        return (float(reg * self.l1_ratio),
                lambda w: (0.5 * l2 * tvec.sq_norm(w), tvec.scale(l2, w)))


# The names user code migrating from the reference knows.
SimpleUpdater = IdentityProx
SquaredL2Updater = MLlibSquaredL2Updater
L1Updater = L1Prox

PROXES = {
    "identity": IdentityProx,
    "l2": L2Prox,
    "l2_mllib": MLlibSquaredL2Updater,
    "l1": L1Prox,
    "elastic_net": ElasticNetProx,
}
