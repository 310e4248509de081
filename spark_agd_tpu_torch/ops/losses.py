"""Batched loss/gradient plugins — the ``Gradient`` contract in PyTorch.

Counterpart of ``spark_agd_tpu/ops/losses.py``.  Every plugin returns
**sums** ``(loss_sum, grad_sum, count)``; the caller takes the mean.
Formulas follow spark-mllib 1.3.0 exactly as the JAX package does:

- ``LogisticGradient``: loss ``softplus(-x·w) - (1-y)(-x·w)``, grad
  ``(sigmoid(x·w) - y)·x`` (labels in {0,1}).  ``softplus`` is the exact
  ``logaddexp(x, 0)`` (``torch.nn.functional.softplus`` switches to ``x``
  above its threshold of 20, which ``jax.nn.softplus`` does not).
- ``LeastSquaresGradient``: loss ``(x·w - y)^2``, grad ``2(x·w - y)·x``.
- ``HingeGradient``: labels mapped to {-1,+1}; active when
  ``s·(x·w) < 1``; loss ``1 - s(x·w)``, grad ``-s·x``.
- ``SoftmaxGradient``: weight matrix ``(D, K)``, loss
  ``-log softmax(x·W)[y]``, grad ``x ⊗ (softmax - onehot)``.
- ``CustomGradient``: any batch loss over a tree of tensors,
  differentiated with ``torch.autograd``.

X is a dense (strided) tensor or an ``ops.sparse.CSRMatrix``; the same
classes serve both, the products going through ``ops.sparse`` for CSR, as
the JAX losses do.  torch's own sparse layouts raise ``TypeError``.

``lanes_loss_and_grad`` evaluates K weight vectors stacked on a leading
lane axis at once (the counterpart of ``jax.vmap`` of
``batch_loss_and_grad`` over the weights, as the sweeps and
cross-validation use it), each lane under the shared mask or its own
column of an (N, K) mask.  The margin losses form both products for all
lanes (``X @ Wᵀ``, then ``multᵀ @ X``); any other loss runs lane by
lane.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core import tvec
from . import sparse
from .sparse import CSRMatrix


def check_layout(X):
    """Raise ``TypeError`` unless ``X`` is a dense (strided) tensor or a
    :class:`~spark_agd_tpu_torch.ops.sparse.CSRMatrix`."""
    if isinstance(X, CSRMatrix) or (isinstance(X, torch.Tensor)
                                    and X.layout == torch.strided):
        return
    raise TypeError(
        "the PyTorch port takes X as a dense (strided) torch.Tensor or a "
        "spark_agd_tpu_torch.ops.sparse.CSRMatrix; got "
        f"{type(X).__name__}"
        + (f" with layout {X.layout} (build a CSRMatrix from its arrays)"
           if isinstance(X, torch.Tensor) else ""))


def _count(X, mask=None) -> torch.Tensor:
    """Valid example count (rows with mask > 0) as a 0-d int64 tensor."""
    if mask is None:
        return torch.tensor(X.shape[0], dtype=torch.int64, device=X.device)
    return (mask > 0).sum().to(torch.int64)


def _lane_mask(masks, k: int):
    """Lane ``k``'s mask: the shared (N,) mask, or column ``k`` of an
    (N, K) one."""
    if masks is None or masks.dim() == 1:
        return masks
    return masks[:, k]


def _lane_counts(X, masks, k: int) -> torch.Tensor:
    """``(K,)`` int64 valid-row counts of ``k`` lanes."""
    if masks is not None and masks.dim() == 2:
        return (masks > 0).sum(0).to(torch.int64)
    return _count(X, masks).expand(k)


def _mm(X, w):
    """``X @ w`` in the promoted dtype of the two (a bf16 X meets f32
    weights in f32, as ``jnp.matmul`` promotes); a CSRMatrix goes through
    ``sparse.matvec``."""
    if isinstance(X, CSRMatrix):
        return sparse.matvec(X, w)
    dt = torch.promote_types(X.dtype, w.dtype)
    return X.to(dt) @ w.to(dt)


def _rmm(X, r):
    """``X.T @ r`` in the promoted dtype (``sparse.rmatvec`` for CSR)."""
    if isinstance(X, CSRMatrix):
        return sparse.rmatvec(X, r)
    dt = torch.promote_types(X.dtype, r.dtype)
    return X.to(dt).T @ r.to(dt)


class Gradient:
    """Protocol: ``batch_loss_and_grad(weights, X, y, mask=None) ->
    (loss_sum, grad_sum, count)``, with ``grad_sum`` shaped like
    ``weights`` and ``count`` a 0-d tensor.  ``mask`` (optional, (N,) of
    {0,1}) excludes rows from all three sums."""

    def batch_loss_and_grad(self, weights, X, y, mask=None):
        raise NotImplementedError

    def prepare(self, X, y, mask=None):
        """One-time staging, called by the smooth factory when the data
        is placed (outside the optimizer loop).  The default checks X's
        layout and builds a CSRMatrix's column-sorted twin when it lacks
        one: every transpose product runs on the twin here, so it is
        built once now rather than at each evaluation (the JAX package
        builds it when ``want_csc`` asks, else scatters)."""
        check_layout(X)
        if isinstance(X, CSRMatrix) and not X.has_csc:
            X = X.with_csc()
        return X, y, mask

    def mean_loss_and_grad(self, weights, X, y, mask=None):
        loss_sum, grad_sum, n = self.batch_loss_and_grad(weights, X, y, mask)
        n = n.to(loss_sum.dtype)
        return loss_sum / n, tvec.scale(1.0 / n, grad_sum)

    def lanes_loss_and_grad(self, W, X, y, masks=None):
        """K lanes at once: ``W`` stacked on a leading lane axis, ``masks``
        ``None``, a shared (N,) mask or an (N, K) mask, a column a lane.
        Returns ``((K,) loss sums, gradient sums stacked like W, (K,)
        counts)``.  This default runs ``batch_loss_and_grad`` lane by
        lane."""
        k = tvec.leaves(W)[0].shape[0]
        outs = [self.batch_loss_and_grad(tvec.lane(W, i), X, y,
                                         _lane_mask(masks, i))
                for i in range(k)]
        return (torch.stack([o[0] for o in outs]),
                tvec.stack_lanes([o[1] for o in outs]),
                torch.stack([o[2] for o in outs]))


class MarginGradient(Gradient):
    """A GLM loss that is a per-row function of the margin ``x·w``.

    Subclasses define ``dots_loss_and_mult(dots, y) -> (per, mult)``:
    the per-example loss and gradient multiplier (``grad = X.T @ mult``).
    The fused kernel (``ops/fused_kernels.py``) computes the same middle.
    """

    def dots_loss_and_mult(self, dots, y):
        raise NotImplementedError

    def batch_loss_and_grad(self, weights, X, y, mask=None):
        check_layout(X)
        dots = _mm(X, weights)
        per, mult = self.dots_loss_and_mult(dots, y.to(dots.dtype))
        if mask is not None:
            m = mask.to(dots.dtype)
            per = per * m
            mult = mult * m
        return per.sum(), _rmm(X, mult), _count(X, mask)

    def lanes_loss_and_grad(self, W, X, y, masks=None):
        """Both products for all K lanes of the (K, D) ``W``: the margins
        ``X @ Wᵀ`` (N, K), then ``multᵀ @ X``."""
        check_layout(X)
        dots = _mm(X, W.T)
        per, mult = self.dots_loss_and_mult(dots, y.to(dots.dtype)[:, None])
        if masks is not None:
            m = masks.to(dots.dtype)
            m = m[:, None] if m.dim() == 1 else m
            per = per * m
            mult = mult * m
        return per.sum(0), _rmm(X, mult).T, _lane_counts(X, masks,
                                                          W.shape[0])


class LogisticGradient(MarginGradient):
    """Binary logistic loss (labels in {0,1}), stable via softplus."""

    def dots_loss_and_mult(self, dots, y):
        margins = -dots
        per = torch.logaddexp(margins, torch.zeros_like(margins)) \
            - (1.0 - y) * margins
        mult = torch.sigmoid(-margins) - y
        return per, mult


class LeastSquaresGradient(MarginGradient):
    """Squared error, 1.3 convention: ``diff^2`` / ``2·diff·x``."""

    def dots_loss_and_mult(self, dots, y):
        diff = dots - y
        return diff * diff, 2.0 * diff


class HingeGradient(MarginGradient):
    """SVM hinge loss; {0,1} labels rescaled to {-1,+1}."""

    def dots_loss_and_mult(self, dots, y):
        s = 2.0 * y - 1.0
        margin = 1.0 - s * dots
        active = margin > 0.0
        zero = torch.zeros_like(margin)
        return torch.where(active, margin, zero), torch.where(active, -s, zero)


class SoftmaxGradient(Gradient):
    """Multinomial softmax regression with weight matrix ``(D, K)``
    (plain PyTorch; ``ops.fused_kernels.FusedSoftmaxGradient`` runs the
    same loss through the CUDA softmax kernel)."""

    def __init__(self, num_classes: int):
        self.num_classes = int(num_classes)

    def batch_loss_and_grad(self, weights, X, y, mask=None):
        check_layout(X)
        logits = _mm(X, weights)  # (N, K)
        logz = torch.logsumexp(logits, dim=-1)
        labels = y.to(torch.int64)
        picked = torch.gather(logits, 1, labels[:, None])[:, 0]
        per = logz - picked
        probs = torch.exp(logits - logz[:, None])
        onehot = torch.nn.functional.one_hot(
            labels, self.num_classes).to(logits.dtype)
        resid = probs - onehot
        if mask is not None:
            m = mask.to(logits.dtype)
            per = per * m
            resid = resid * m[:, None]
        return per.sum(), _rmm(X, resid), _count(X, mask)


class CustomGradient(Gradient):
    """Wrap any batch loss ``fn(weights, X, y) -> loss_sum`` over a tensor
    or a dict/list/tuple of tensors; the gradient comes from
    ``torch.autograd``."""

    def __init__(self, loss_sum_fn: Callable[..., torch.Tensor],
                 supports_mask: bool = False):
        """``supports_mask=True`` declares that ``loss_sum_fn`` takes a
        fourth ``mask`` argument; without it masked calls raise rather
        than silently mis-sum."""
        self._fn = loss_sum_fn
        self._supports_mask = supports_mask

    def batch_loss_and_grad(self, weights, X, y, mask=None):
        if mask is not None and not self._supports_mask:
            raise ValueError(
                "this CustomGradient's loss_sum_fn does not take a mask; "
                "construct it with supports_mask=True and handle the "
                "mask argument in the loss")
        w = tvec.tmap(lambda t: t.detach().requires_grad_(True), weights)
        with torch.enable_grad():
            args = (w, X, y) if mask is None else (w, X, y, mask)
            loss = self._fn(*args)
            flat = tvec.leaves(w)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        by_id = {id(t): torch.zeros_like(t) if g is None else g
                 for t, g in zip(flat, grads)}
        grad_sum = tvec.tmap(lambda t: by_id[id(t)], w)
        return loss.detach(), grad_sum, _count(X, mask)


GRADIENTS = {
    "logistic": LogisticGradient,
    "least_squares": LeastSquaresGradient,
    "hinge": HingeGradient,
    "softmax": SoftmaxGradient,
}
