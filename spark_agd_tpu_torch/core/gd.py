"""Mini-batch gradient descent with spark-mllib 1.3.0 semantics.

Counterpart of ``spark_agd_tpu/core/gd.py``: the GD comparator the
reference's tests hold AGD against (MLlib's
``GradientDescent.runMiniBatchSGD``).  The same semantics:

- the per-iteration step ``step_size / sqrt(iter)`` (1-based), MLlib's
  hidden rescaling, applied here because the prox operators carry none;
- loss-history entry i = the smooth loss at the pre-update weights plus
  the regularization value of the previous update, seeded by an updater
  call with step 0 at the initial weights;
- a Bernoulli sample per iteration (``minibatch_fraction < 1``), the
  means divided by the realised batch size; an empty sample records NaN
  and skips the update;
- no convergence test: every iteration runs.

The JAX loop is one ``lax.fori_loop``; here it is a Python loop.
``gradient.prepare`` runs once, and each iteration's sample is folded
into the prepared mask (for the fused kernels, into the staged ``m`` and
``n_valid``), so X is staged once and an iteration is one smooth
evaluation: one kernel launch on the fused path.  The samples are JAX's
bits (``core.prng``), drawn on X's device with the carry dtype's width.
Over a mesh (:func:`run_minibatch_sgd_mesh`) each slot takes its block
of one global draw, as the JAX loop does inside ``shard_map``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from . import prng, tvec
from ..ops.fused_kernels import StagedDense
from ..ops.losses import Gradient
from ..ops.prox import Prox


class GDResult(NamedTuple):
    """``weights`` on the data's device; ``loss_history`` a CPU tensor
    of the carry dtype, one entry per iteration (NaN for an empty
    sample)."""

    weights: Any
    loss_history: torch.Tensor


def _with_sample(X, y, mask, sample):
    """Prepared operands with the rows outside ``sample`` masked out as
    well; X itself is never copied."""
    if isinstance(X, StagedDense):
        return X.masked(sample), y, mask
    return X, y, sample if mask is None else sample * mask.to(sample.dtype)


def run_minibatch_sgd(
    gradient: Gradient,
    updater: Prox,
    X,
    y,
    initial_weights,
    *,
    step_size: float = 1.0,
    num_iterations: int = 100,
    reg_param: float = 0.0,
    minibatch_fraction: float = 1.0,
    mask=None,
    seed: int = 42,
) -> GDResult:
    """MLlib-1.3 ``runMiniBatchSGD`` over ``(X, y, mask)`` placed on one
    device.  ``mask`` is the data's padding mask; the samples compose
    with it."""
    Xp, yp, mp = gradient.prepare(X, y, mask)
    rows = Xp.X if isinstance(Xp, StagedDense) else Xp  # tensor or CSR

    def sums(w, sample):
        ops = (Xp, yp, mp) if sample is None \
            else _with_sample(Xp, yp, mp, sample)
        return gradient.batch_loss_and_grad(w, *ops)

    return _loop(sums, updater, initial_weights, rows.shape[0], rows.device,
                 step_size=step_size, num_iterations=num_iterations,
                 reg_param=reg_param, minibatch_fraction=minibatch_fraction,
                 seed=seed)


def run_minibatch_sgd_mesh(
    gradient: Gradient,
    updater: Prox,
    batch,
    mesh,
    initial_weights,
    *,
    step_size: float = 1.0,
    num_iterations: int = 100,
    reg_param: float = 0.0,
    minibatch_fraction: float = 1.0,
    seed: int = 42,
) -> GDResult:
    """:func:`run_minibatch_sgd` over a dense ``parallel.mesh.ShardedBatch``
    (JAX ``core/gd.py`` inside a ``shard_map`` body): every iteration
    draws one sample over the global padded rows on the lead device, each
    slot takes its block of it, and the slots' sums are combined
    (``parallel.dist_smooth``) before the means; so an N-slot run takes
    the samples of a single-device run on the identically padded rows.
    ``initial_weights`` lie on the mesh's lead device."""
    from ..parallel import dist_smooth, multihost

    X, y, mask = batch
    prepared = dist_smooth._prepare_shards(
        gradient, X.shards, y.shards, None if mask is None else mask.shards)
    rank = multihost.process_index() if mesh.process_count > 1 else 0
    first = rank * len(X.shards)
    offsets = [(first + i) * X.rows_per_shard for i in range(len(X.shards))]

    def sums(w, sample):
        ops = prepared
        if sample is not None:
            ops = [None if p is None else _with_sample(
                *p, sample[off:off + xs.shape[0]].to(xs.device))
                   for p, off, xs in zip(prepared, offsets, X.shards)]
        return dist_smooth._slot_sums(gradient, mesh, ops, w, X.dtype)

    return _loop(sums, updater, initial_weights, X.shape[0], mesh.lead,
                 step_size=step_size, num_iterations=num_iterations,
                 reg_param=reg_param, minibatch_fraction=minibatch_fraction,
                 seed=seed)


def _loop(sums, updater, w, n_rows: int, device, *, step_size,
          num_iterations, reg_param, minibatch_fraction, seed) -> GDResult:
    """The GD iterations over ``sums(w, sample) -> (loss_sum, grad_sum,
    n)``, ``sample`` None for the full batch or the iteration's (n_rows,)
    draw on ``device``."""
    full_batch = minibatch_fraction >= 1.0
    dt = torch.float32
    for leaf in tvec.leaves(w):
        dt = torch.promote_types(dt, leaf.dtype)

    def s(v) -> torch.Tensor:
        return torch.tensor(float(v), dtype=dt)

    reg_val = updater.prox(w, tvec.zeros_like(w), 0.0, reg_param)[1] \
        .detach().to(dtype=dt).reshape(()).cpu()
    hist = torch.zeros((num_iterations,), dtype=dt)

    for i in range(num_iterations):
        it = i + 1  # MLlib iterations are 1-based
        sample = None
        if not full_batch:
            sample = prng.sample_mask(seed, it, minibatch_fraction, n_rows,
                                      dtype=dt, device=device)
        loss_sum, grad_sum, n = sums(w, sample)
        # the two control scalars in one copy
        loss_sum, nf = torch.stack([loss_sum.detach().to(dt),
                                    n.to(dt)]).cpu()
        if not bool(nf > 0):
            hist[i] = math.nan  # empty sample: MLlib logs and skips
            continue
        hist[i] = loss_sum / nf + reg_val
        this_step = s(step_size) / torch.sqrt(s(it))
        g_mean = tvec.scale(float(1.0 / nf), grad_sum)
        w, reg_new = updater.prox(w, g_mean, float(this_step), reg_param)
        reg_val = reg_new.detach().to(dtype=dt).reshape(()).cpu()
    return GDResult(weights=w, loss_history=hist)
