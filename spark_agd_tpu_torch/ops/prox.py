"""Proximal operators — the ``Updater`` contract in PyTorch.

Counterpart of ``spark_agd_tpu/ops/prox.py``.  ``prox(w, g, step, reg)
-> (w_new, reg_value_at_w_new)`` with no hidden step rescaling, and
``reg_value(w, reg)``.  The identity ``prox(w, g, 0, reg) == (w,
reg_value(w, reg))`` holds for every operator: the AGD loss history
relies on it.  ``reg_value`` follows spark-mllib 1.3.0: L2 is
``reg/2·‖w'‖²`` at the new weights, L1 is ``reg·‖w'‖₁``.  Operators map
leafwise over a tensor or a dict/list/tuple of tensors.

The K-lane forms (``prox_lanes``, ``reg_value_lanes``; the counterpart
of ``jax.vmap`` over ``prox``, as ``core/host_agd.py:make_prox_multi``
and the sweeps use it) take weights stacked on a leading lane axis and
a ``(K,)`` tensor of steps and of strengths, broadcast over each lane;
the built-in operators share one formula between the two forms.
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


def lane_view(v, leaf):
    """The ``(K,)`` per-lane values ``v`` shaped to broadcast over a leaf
    stacked on a leading lane axis, on the leaf's device."""
    return v.to(leaf.device).reshape((-1,) + (1,) * (leaf.dim() - 1))


def _lane_sq_norm(W):
    return tvec.lane_dot(W, W)


def _lane_l1_norm(W):
    ls = [x.abs().reshape(x.shape[0], -1).sum(1) for x in tvec.leaves(W)]
    return sum(ls[1:], ls[0])


def _lane_zero(W):
    """``(K,)`` zeros in the stacked weights' dtype, on their device."""
    z = _scalar_zero(W)
    return torch.zeros(tvec.leaves(W)[0].shape[0], dtype=z.dtype,
                       device=z.device)


class _Norms:
    """The reductions a penalty is made of: over the whole tree (solo) or
    over each lane of a stacked tree."""

    def __init__(self, sq, l1, zero):
        self.sq, self.l1, self.zero = sq, l1, zero


_SOLO = _Norms(tvec.sq_norm, tvec.l1_norm, _scalar_zero)
_LANES = _Norms(_lane_sq_norm, _lane_l1_norm, _lane_zero)


class Prox:
    """Protocol: proximity operator of a (possibly zero) penalty."""

    def prox(self, w, g, step, reg):
        """Return ``(w_new, reg_value_at_w_new)``; must satisfy
        ``prox(w, g, 0.0, reg) == (w, reg_value(w, reg))``."""
        raise NotImplementedError

    def reg_value(self, w, reg):
        raise NotImplementedError

    def prox_lanes(self, W, G, steps, regs):
        """K lanes at once: ``W``, ``G`` stacked on a leading lane axis,
        ``steps`` and ``regs`` ``(K,)`` tensors; returns ``(W_new, (K,)
        reg values)``.  This default runs :meth:`prox` lane by lane."""
        outs = [self.prox(tvec.lane(W, k), tvec.lane(G, k), float(steps[k]),
                          float(regs[k])) for k in range(len(regs))]
        return (tvec.stack_lanes([o[0] for o in outs]),
                torch.stack([torch.as_tensor(o[1]) for o in outs]))

    def reg_value_lanes(self, W, regs):
        """``(K,)`` penalties of the lanes of ``W`` at ``regs``."""
        return torch.stack([torch.as_tensor(
            self.reg_value(tvec.lane(W, k), float(regs[k])))
            for k in range(len(regs))])

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


class _Leafwise(Prox):
    """An operator that updates each leaf on its own (``_leaf``) and whose
    penalty is made of norms (``_penalty``): the solo and the K-lane
    forms run the same formulas."""

    def _leaf(self, wi, gi, step, reg):
        raise NotImplementedError

    def _penalty(self, w, reg, norms: _Norms):
        raise NotImplementedError

    def prox(self, w, g, step, reg):
        w_new = tvec.tmap(lambda wi, gi: self._leaf(wi, gi, step, reg), w, g)
        return w_new, self.reg_value(w_new, reg)

    def reg_value(self, w, reg):
        return self._penalty(w, reg, _SOLO)

    def prox_lanes(self, W, G, steps, regs):
        W_new = tvec.tmap(lambda wi, gi: self._leaf(
            wi, gi, lane_view(steps, wi), lane_view(regs, wi)), W, G)
        return W_new, self.reg_value_lanes(W_new, regs)

    def reg_value_lanes(self, W, regs):
        return self._penalty(W, regs.to(tvec.leaves(W)[0].device), _LANES)


class IdentityProx(_Leafwise):
    """No penalty: plain gradient step (MLlib ``SimpleUpdater``)."""

    def _leaf(self, wi, gi, step, reg):
        return wi - step * gi

    def _penalty(self, w, reg, norms):
        return norms.zero(w)

    def smooth_penalty(self, w, reg):
        return _scalar_zero(w), tvec.zeros_like(w)


class L2Prox(_Leafwise):
    """Exact prox of ``(reg/2)·‖w‖²``: ``(w - step·g) / (1 + step·reg)``."""

    def _leaf(self, wi, gi, step, reg):
        return (wi - step * gi) * (1.0 / (1.0 + step * reg))

    def _penalty(self, w, reg, norms):
        return 0.5 * reg * norms.sq(w)

    def smooth_penalty(self, w, reg):
        return self.reg_value(w, reg), tvec.scale(reg, w)


class MLlibSquaredL2Updater(L2Prox):
    """spark-mllib 1.3.0 ``SquaredL2Updater``: the linearized step
    ``w' = (1 - step·reg)·w - step·g``, penalty at the new weights."""

    def _leaf(self, wi, gi, step, reg):
        return (1.0 - step * reg) * wi - step * gi


class L1Prox(_Leafwise):
    """Prox of ``reg·‖w‖₁``: soft-thresholding by ``step·reg``."""

    def _leaf(self, wi, gi, step, reg):
        return _soft(wi - step * gi, step * reg)

    def _penalty(self, w, reg, norms):
        return reg * norms.l1(w)

    def owlqn_decomposition(self, reg):
        return float(reg), lambda w: (_scalar_zero(w), tvec.zeros_like(w))


class ElasticNetProx(_Leafwise):
    """Prox of ``reg·(l1_ratio·‖w‖₁ + (1-l1_ratio)/2·‖w‖²)``:
    soft-threshold then shrink."""

    def __init__(self, l1_ratio: float = 0.5):
        self.l1_ratio = float(l1_ratio)

    def _leaf(self, wi, gi, step, reg):
        l1 = reg * self.l1_ratio
        l2 = reg * (1.0 - self.l1_ratio)
        return _soft(wi - step * gi, step * l1) * (1.0 / (1.0 + step * l2))

    def _penalty(self, w, reg, norms):
        l1 = reg * self.l1_ratio
        l2 = reg * (1.0 - self.l1_ratio)
        return l1 * norms.l1(w) + 0.5 * l2 * norms.sq(w)

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
