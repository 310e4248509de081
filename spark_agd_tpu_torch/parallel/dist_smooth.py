"""Distributed ``smooth`` builders: the ``treeAggregate`` replacement.

Counterpart of ``spark_agd_tpu/parallel/dist_smooth.py``.  The
reference's one distributed computation (``applySmooth``, reference
``AcceleratedGradientDescent.scala:192-208``) broadcasts the weights, sums
``(loss, grad, count)`` partials up an aggregation tree and divides by the
count on the driver.  Here, over a data-axis :class:`~.mesh.Mesh`:

- each shard is prepared once, when the smooth is built
  (``gradient.prepare``: the fused kernels stage their operands, views of
  X; a CSR shard builds its twin and its reduction plans), as JAX lays the
  shards out once;
- an evaluation copies ``w`` to each slot's device (no copy on the lead
  device), runs ``gradient.batch_loss_and_grad`` on each slot's shard (one
  launch of the fused kernel a slot: the seqOp), moves the slots' sums to
  the lead device and adds them in slot order (the combOp, in a fixed
  order: the same bits run to run);
- on a mesh across processes one collective follows: every rank gathers
  every rank's packed ``(Σloss, Σgrad, n)`` and adds them in rank order,
  so every rank holds the same bits (``parallel.multihost``).

Both modes return the reference's contract: ``smooth(w) -> (mean_loss,
mean_grad)`` over the valid (unmasked) rows, the division once, after the
combine.  ``mode="auto"`` is JAX's GSPMD mode, where XLA partitions a
global evaluation from the placements; the port has no partitioner and
writes out each layout the JAX package partitions:

- a ``model`` axis with a plain ``SoftmaxGradient`` (JAX's W placed
  ``P(None, "model")``): each (data, model) slot forms its logits
  ``X_d @ W_m`` over its classes; each row's max and sum of
  exponentials are combined over the model slots of its data index in
  slot order; each slot forms its residual columns and ``X_d.T @
  resid_m``, and the data slots' sums are added as always.  A
  ``FusedSoftmaxGradient`` gathers W's classes onto each data slot
  instead and launches the softmax kernel once a data slot;
- a feature-sharded dense batch (``mesh.shard_batch_by_features``) and
  a margin loss: each model slot's partial dots ``X_m @ w_m``, summed
  over the model slots in slot order, the per-row middle
  (``dots_loss_and_mult``), then each slot's column product;
- anything else (weights with no axis to split): once a data index, as
  the ``shard_map`` mode.

:func:`psum_scatter_combine` is the sharded update's combine
(``parallel.sharded_update``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..core import tvec
from ..ops.losses import (Gradient, MarginGradient, SoftmaxGradient,
                          _count, _mm, _rmm)
from ..ops.sparse import CSRMatrix, RowShardedCSR
from . import mesh as mesh_lib
from . import multihost

# Launches of the per-slot evaluations since import or the last reset:
# slots x evaluations on a mesh fit (chip_smoke holds it to the kernels'
# own counts), and the evaluations themselves.
slot_evaluations = 0
mesh_evaluations = 0


def reset_counts():
    global slot_evaluations, mesh_evaluations
    slot_evaluations = mesh_evaluations = 0


def make_dist_smooth(
    gradient: Gradient,
    X,
    y=None,
    mask=None,
    *,
    mesh: "mesh_lib.Mesh",
    mode: str = "shard_map",
    data_axis: str = mesh_lib.DATA_AXIS,
) -> Tuple[Callable, Callable]:
    """Build ``(smooth, smooth_loss)`` over mesh-sharded data.

    Preferred input: the ``ShardedBatch`` of ``mesh.shard_batch`` as the
    single ``X`` argument, so its padding mask cannot be dropped.  Raw
    (X, y) arrays are sharded on the fly."""
    build, args = make_dist_smooth_staged(
        gradient, X, y, mask, mesh=mesh, mode=mode, data_axis=data_axis)
    return build(*args)


def make_dist_smooth_staged(
    gradient: Gradient,
    X,
    y=None,
    mask=None,
    *,
    mesh: "mesh_lib.Mesh",
    mode: str = "shard_map",
    data_axis: str = mesh_lib.DATA_AXIS,
):
    """``(build, data_args)`` split of :func:`make_dist_smooth`, the shape
    of ``core.smooth.make_smooth_staged``: ``data_args`` are the prepared
    shards (each slot's operands), ``build(*data_args)`` returns the
    ``(smooth, smooth_loss)`` closures over them."""
    if isinstance(X, mesh_lib.ShardedBatch):
        if y is not None or mask is not None:
            raise ValueError(
                "pass either a ShardedBatch or raw (X, y[, mask]), not both")
        X, y, mask = X
    elif y is None:
        raise ValueError("y is required when X is a raw array")
    if isinstance(X, mesh_lib.ShardedCols):
        if X.mesh != mesh:
            raise ValueError("the batch was placed on another mesh than "
                             "the one given; re-shard it or pass its own "
                             "mesh")
        if mode != "auto":
            raise ValueError(
                "a feature-sharded batch (shard_batch_by_features) "
                "requires mode='auto': the shard_map mode shards rows")
        return _make_feature_cols(gradient, X, y, mask, mesh)
    mesh_lib.check_data_mesh(mesh, data_axis)
    if not isinstance(X, (mesh_lib.ShardedRows, RowShardedCSR)):
        X, y, mask = mesh_lib.shard_batch(mesh, X, y, mask, axis=data_axis)
    elif X.mesh != mesh:
        raise ValueError("the batch was placed on another mesh than the "
                         "one given; re-shard it or pass its own mesh")
    return _staged_builders(gradient, X, y, mask, mesh=mesh, mode=mode,
                            data_axis=data_axis)


def _staged_builders(gradient, X, y, mask, *, mesh, mode, data_axis):
    if mode not in ("shard_map", "auto"):
        raise ValueError(f"unknown mode {mode!r}")
    if isinstance(X, RowShardedCSR):
        if mode != "shard_map":
            raise ValueError(
                "row-sharded CSR data requires mode='shard_map' (the JAX "
                "partitioner cannot see through the local segment sum's "
                "row-id indirection, so the JAX package refuses it too)")
        return _make_shard_map(gradient, X, y, mask, mesh)
    if mode == "auto" and mesh.shape.get(mesh_lib.MODEL_AXIS, 1) > 1 \
            and isinstance(gradient, SoftmaxGradient):
        return _make_class_sharded(gradient, X, y, mask, mesh, data_axis)
    # weights with no axis to split: JAX's partitioner computes the
    # shard_map mode's per-shard sums, once a data index
    return _make_shard_map(gradient, X, y, mask, mesh)


def _finish(loss_sum, grad_sum, n):
    nf = n.to(loss_sum.dtype)
    return loss_sum / nf, tvec.scale(1.0 / nf, grad_sum)


def _pair_builder(eval_fn, args):
    """The one ``(build, data_args)`` shape every mode returns:
    ``build(*args)`` closes the ``(smooth, smooth_loss)`` contract (mean
    over valid rows, division after the combine) over the prepared
    shards, with ``eval_fn(w, *args) -> (Σloss, Σgrad, n)`` the only
    per-mode part."""

    def build(*a):
        def smooth(w):
            ls, gs, n = eval_fn(w, *a)
            return _finish(ls, gs, n)

        def smooth_loss(w):
            ls, _, n = eval_fn(w, *a)
            return ls / n.to(ls.dtype)

        return smooth, smooth_loss

    return build, args


def scalar_combine(ls, n, mesh):
    """``(Σloss, n)`` of this process joined across processes: one
    all-gather of their bytes, added in rank order (every rank the same
    bits); as they are in a single process."""
    if not mesh.in_group:
        return ls, n
    leaves = [ls.reshape(-1), n.reshape(-1)]
    ls_s, n_s = _join_ranks(leaves, kind="scalars")
    return ls_s.reshape(ls.shape), n_s.reshape(n.shape)


def psum_scatter_combine(ls, gs, n, mesh, layout):
    """The reduce-scatter twin of the replicated combine (arXiv
    2004.13336): the control scalars (Σloss, n) are joined across
    processes as always (a few bytes), but the gradient becomes one
    reduce-scatter a leaf, so each data slot receives only its shard of
    the summed gradient, and the update that consumes it runs on 1/N of
    the elements.  ``ls``, ``gs``, ``n``: this process's slot-order sums;
    ``layout``: the ``parallel.sharded_update.ShardLayout`` of the
    weights, whose :meth:`gather` is the matching all-gather.  Returns
    ``(Σloss, the sharded Σgrad, n)``."""
    ls, n = scalar_combine(ls, n, mesh)
    return ls, layout.scatter(gs, mesh), n


def _combine(mesh, parts, slots: int):
    """Add the slots' ``(Σloss, Σgrad, n)`` on the lead device in slot
    order (:func:`_slot_order_sum`), then across processes
    (:func:`_across_processes`).  ``slots`` counts this process's slots
    that held rows; returns the sums and that count over the whole
    group."""
    ls, gs, n = _slot_order_sum(mesh.lead, parts)
    if mesh.in_group:
        return _across_processes(ls, gs, n, slots)
    return ls, gs, n, slots


def _slot_order_sum(lead, parts):
    """The slots' ``(Σloss, Σgrad, n)`` added on ``lead`` in slot
    order."""
    ls = gs = n = None
    for p_ls, p_gs, p_n in parts:
        p_ls = p_ls.to(lead)
        p_gs = tvec.tmap(lambda g: g.to(lead), p_gs)
        p_n = p_n.to(device=lead, dtype=torch.int64)
        if ls is None:
            ls, gs, n = p_ls, p_gs, p_n
        else:
            ls, gs, n = ls + p_ls, tvec.add(gs, p_gs), n + p_n
    return ls, gs, n


def _join_ranks(leaves, kind: str):
    """The ranks' sums of the 1-D tensors ``leaves`` (one device): one
    all-gather of each rank's packed bytes, added in rank order on every
    rank (the same bits on every rank, so every rank takes the same
    branches)."""
    packed = torch.cat([t.contiguous().view(torch.uint8) for t in leaves])
    parts = multihost.all_gather_bytes(packed, kind=kind)
    sizes = [t.numel() * t.element_size() for t in leaves]

    def unpack(buf):
        out, off = [], 0
        for t, nb in zip(leaves, sizes):
            out.append(buf[off:off + nb].clone().view(t.dtype))
            off += nb
        return out

    acc = unpack(parts[0])
    for buf in parts[1:]:
        acc = [a + b for a, b in zip(acc, unpack(buf))]
    return acc


def _across_processes(ls, gs, n, slots: int):
    """Join the ranks' sums (:func:`_join_ranks`, kind ``"sums"``).  The
    group's count of slots that held rows rides along as a tensor, read
    only where it is needed."""
    leaves = [ls.reshape(-1)] + [g.reshape(-1) for g in tvec.leaves(gs)] \
        + [n.reshape(-1),
           torch.full((1,), slots, dtype=torch.int64, device=n.device)]
    acc = _join_ranks(leaves, kind="sums")
    it = iter(acc[1:-2])
    return (acc[0].reshape(ls.shape),
            tvec.unflatten_like(gs, (x.reshape(g.shape) for x, g in
                                     zip(it, tvec.leaves(gs)))),
            acc[-2].reshape(n.shape), acc[-1].reshape(()))


def _zero_sums(w, dtype, device, lanes: bool = False):
    """``(Σloss, Σgrad, n)`` of no rows: zeros in the dtypes a slot's
    evaluation gives (its data's ``dtype`` promoted with each leaf's);
    ``lanes``: ``w`` is stacked on a lane axis, the loss sums and counts
    ``(K,)``."""
    first = tvec.leaves(w)[0]
    shape = (first.shape[0],) if lanes else ()
    return (torch.zeros(shape, dtype=torch.promote_types(dtype, first.dtype),
                        device=device),
            tvec.tmap(lambda a: torch.zeros(
                a.shape, dtype=torch.promote_types(dtype, a.dtype),
                device=device), w),
            torch.zeros(shape, dtype=torch.int64, device=device))


def _slot_sums(gradient, mesh, prepared, w, dtype, *, combine: bool = True,
               lanes: bool = False):
    """Each slot's ``(Σloss, Σgrad, n)`` at ``w``, added in slot order on
    the lead device and (``combine``) across processes; ``w`` is copied
    once to each device other than the lead's.  ``lanes``: ``w`` is
    stacked on a lane axis and each slot makes one
    ``gradient.lanes_loss_and_grad`` call (one launch of the lanes kernel
    through ``FusedMarginGradient``), the loss sums and counts ``(K,)``.
    ``dtype`` is the data's (:func:`_reduce_parts`)."""
    ev = gradient.lanes_loss_and_grad if lanes \
        else gradient.batch_loss_and_grad
    copies = {}
    parts = []
    for dev, ops in zip(mesh.slots(), prepared):
        if ops is None:
            continue
        wd = copies.get(dev)
        if wd is None:
            wd = copies[dev] = tvec.tmap(lambda a: a.to(dev), w)
        parts.append(ev(wd, *ops))
    return _reduce_parts(mesh, parts, w, dtype, combine=combine, lanes=lanes)


def _reduce_parts(mesh, parts, w, dtype, *, combine: bool = True,
                  lanes: bool = False):
    """The slots' evaluated ``(Σloss, Σgrad, n)`` parts (one a slot that
    held rows) added in slot order on the lead device and (``combine``)
    across processes, the evaluations counted.  A process whose slots
    hold no rows (they lie past the batch's last row) still joins the
    group's collective, with zero sums of the dtypes the other ranks send
    (``dtype``, the data's, promoted with ``w``'s); the batch raises only
    when it is empty on every rank."""
    global slot_evaluations, mesh_evaluations
    slot_evaluations += len(parts)
    mesh_evaluations += 1
    had = len(parts)
    if not had:
        if not mesh.in_group:
            raise ValueError("every shard of the batch is empty")
        parts = [_zero_sums(w, dtype, mesh.lead, lanes)]
    if not combine:
        return _slot_order_sum(mesh.lead, parts)
    ls, gs, n, total = _combine(mesh, parts, had)
    if not had and not int(total):  # read only where this rank had none
        raise ValueError("every shard of the batch is empty, on every rank")
    return ls, gs, n


def shard_operands(gradient: Gradient, X, y, mask,
                   check_rows: bool = False) -> list:
    """The per-slot operand triples of a row-sharded batch (dense
    ``ShardedRows`` or ``RowShardedCSR``, whose mask is required), each
    prepared once (``gradient.prepare``; a CSR shard's twin and reduction
    plans too; None for a slot with no rows, which adds nothing): the one
    definition every mesh path evaluates.  ``check_rows``: a gradient
    whose ``prepare`` re-pads rows is refused, as cross-validation needs
    the rows as they are."""
    if isinstance(X, RowShardedCSR) and mask is None:
        raise ValueError(
            "RowShardedCSR requires its padding mask; build the batch "
            "with parallel.mesh.shard_csr_batch")
    out = []
    for i, xs in enumerate(X.shards):
        if xs.shape[0] == 0:
            out.append(None)
            continue
        ops = gradient.prepare(xs, y.shards[i],
                               None if mask is None else mask.shards[i])
        if isinstance(ops[0], CSRMatrix):
            ops[0].plan()
        if check_rows and getattr(ops[0], "shape",
                                  (None,))[0] != xs.shape[0]:
            raise ValueError(
                "cross_validate drives masks through the kernels, so a "
                "gradient whose prepare() re-pads rows (e.g. the fused "
                "layouts) is not supported here; use the plain gradients")
        out.append(ops)
    return out


def _make_shard_map(gradient, X, y, mask, mesh):
    """Data parallelism over row shards: a slot's evaluation on its
    shard, one combine.  A ``RowShardedCSR`` shard goes through the same
    loss as the single-device sparse path; its mask is required, so the
    shards' padding rows stay out of every sum.  With
    ``FusedMarginGradient`` or ``FusedSoftmaxGradient`` (JAX's
    ``_make_shard_map_pallas``) each dense shard is staged once here, and
    staging keeps a contiguous f32 or bf16 shard as the view of X it is,
    so the card holds X once whatever the slot count; each slot then
    launches the CUDA kernel on its own shard."""
    from ..ops.fused_kernels import StagedDense

    prepared = shard_operands(gradient, X, y, mask)
    for xs, ops in zip(X.shards, prepared):
        if ops is not None and isinstance(ops[0], StagedDense) \
                and xs.dtype in (torch.float32, torch.bfloat16) \
                and ops[0].X.data_ptr() != xs.data_ptr():
            raise AssertionError("staging copied a shard of X")
    return _pair_builder(
        lambda w, *p: _slot_sums(gradient, mesh, p, w, X.dtype),
        tuple(prepared))


def csr_shard_sums(gradient, X, y, mask, mesh):
    """The per-slot operands of a ``RowShardedCSR`` batch, each shard
    prepared once (its twin and reduction plans), and ``ev(w) -> (Σloss,
    Σgrad, n)`` over them.  Returns ``(ev, prepared)``."""
    prepared = shard_operands(gradient, X, y, mask)
    return (lambda w: _slot_sums(gradient, mesh, prepared, w, X.dtype)), \
        prepared


def _class_spans(k: int, parts: int):
    """``[(c0, c1)...]``: the classes of each model slot, an even split
    of ``ceil(k / parts)`` each (the last may be short or empty)."""
    per = -(-k // parts)
    return [(min(i * per, k), min((i + 1) * per, k)) for i in range(parts)]


def class_sharded_sums(gradient: SoftmaxGradient, X, y, mask, W,
                       row_slots):
    """One data index's ``(Σloss, Σgrad, n)`` of the softmax loss with
    W's classes split over the model slots ``row_slots``: each slot forms
    its logits ``X @ W_m``; every row's max and sum of exponentials are
    combined over the slots in slot order on X's device; each slot forms
    its residual columns and ``X.T @ resid_m``, and the gradient's
    columns are joined on W's device."""
    home = X.device
    labels = y.to(device=home, dtype=torch.int64)
    spans = [sp for sp in _class_spans(gradient.num_classes,
                                       len(row_slots)) if sp[1] > sp[0]]
    logits = [_mm(X.to(dev), W[:, c0:c1].to(dev))
              for dev, (c0, c1) in zip(row_slots, spans)]
    row_max = None
    for lg in logits:
        m = lg.max(dim=1).values.to(home)
        row_max = m if row_max is None else torch.maximum(row_max, m)
    sum_exp = None
    picked = torch.zeros_like(row_max)
    for lg, (c0, c1) in zip(logits, spans):
        e = torch.exp(lg - row_max.to(lg.device)[:, None]).sum(dim=1)
        sum_exp = e.to(home) if sum_exp is None else sum_exp + e.to(home)
        mine = (labels >= c0) & (labels < c1)
        local = (labels - c0).clamp(0, c1 - c0 - 1).to(lg.device)
        got = torch.gather(lg, 1, local[:, None])[:, 0].to(home)
        picked = torch.where(mine, got, picked)
    logz = row_max + torch.log(sum_exp)
    per = logz - picked
    m = None if mask is None else mask.to(device=home, dtype=per.dtype)
    if m is not None:
        per = per * m
    grads = []
    for lg, dev, (c0, c1) in zip(logits, row_slots, spans):
        resid = torch.exp(lg - logz.to(lg.device)[:, None])
        # the slot's columns of the one-hot labels, made in place
        resid -= (labels.to(lg.device)[:, None] == torch.arange(
            c0, c1, device=lg.device)).to(lg.dtype)
        if m is not None:
            resid = resid * m.to(lg.device)[:, None]
        grads.append(_rmm(X.to(dev), resid).to(W.device))
    return per.sum(), torch.cat(grads, dim=1), _count(X, mask)


def _make_class_sharded(gradient, X, y, mask, mesh, data_axis):
    """JAX's tensor-parallel softmax (W placed ``P(None, "model")``,
    partitioned by GSPMD) written out: :func:`class_sharded_sums` a data
    index, the data indices' sums added in slot order and across
    processes as always."""
    if mesh_lib.MODEL_AXIS in mesh.processes:
        raise ValueError("the model axis of a mesh spans one process")
    grid = mesh.grid(data_axis, mesh_lib.MODEL_AXIS)
    triples = tuple(shard_operands(gradient, X, y, mask))

    def ev(W, *triples):
        parts = [class_sharded_sums(gradient, *ops, W, row)
                 for row, ops in zip(grid, triples) if ops is not None]
        return _reduce_parts(mesh, parts, W, X.dtype)

    return _pair_builder(ev, triples)


def column_sharded_sums(gradient: MarginGradient, slots, width: int, y,
                        mask, lead) -> Callable:
    """``ev(w, *shards) -> (Σloss, Σgrad, n)`` of a margin loss over X's
    columns split across model slots: ``shards[i]`` (dense or
    ``CSRMatrix``, on ``slots[i]``) holds the columns of ``w[i *
    width:]``, as many as it has.  Each slot's partial dots ``X_i @
    w_i``, summed over the slots in slot order on ``lead``, the per-row
    middle (``dots_loss_and_mult``) masked by ``mask``, then each slot's
    ``X_i.T @ mult`` into its span of a gradient shaped like ``w`` (the
    columns past a shard's own, padding, stay exactly zero).  ``y`` and
    ``mask`` lie on ``lead``.  The one combine is the cross-slot sum of
    the (N,) partial dots."""

    def ev(w, *shards):
        global slot_evaluations, mesh_evaluations
        spans = [(i * width, i * width + xs.shape[1])
                 for i, xs in enumerate(shards)]
        dots = None
        for xs, dev, (a, b) in zip(shards, slots, spans):
            part = _mm(xs, w[a:b].to(dev))
            dots = part.to(lead) if dots is None else dots + part.to(lead)
        slot_evaluations += len(shards)
        mesh_evaluations += 1
        per, mult = gradient.dots_loss_and_mult(dots, y.to(dots.dtype))
        if mask is not None:
            m = mask.to(dots.dtype)
            per, mult = per * m, mult * m
        g = torch.zeros(w.shape, dtype=torch.promote_types(
            dots.dtype, w.dtype), device=w.device)
        for xs, dev, (a, b) in zip(shards, slots, spans):
            g[a:b] = _rmm(xs, mult.to(dev)).to(w.device)
        return per.sum(), g, _count(dots, mask)

    return ev


def _make_feature_cols(gradient, X, y, mask, mesh):
    """Dense D-axis parallelism over a :class:`~.mesh.ShardedCols` batch
    (JAX's GSPMD partition of a margin GLM with X placed
    ``P(None, "model")`` and w ``P("model")``) through
    :func:`column_sharded_sums`; the pad columns' gradient is exactly
    zero.  The products are plain, as in the JAX package, so a fused
    gradient, whose kernel reads whole rows, is refused."""
    from ..ops.fused_kernels import FusedMarginGradient

    if not isinstance(gradient, MarginGradient) \
            or isinstance(gradient, FusedMarginGradient):
        raise TypeError(
            "a feature-sharded dense batch needs a plain margin-form GLM "
            "loss (a MarginGradient such as LogisticGradient; the fused "
            f"kernels read whole rows); got {type(gradient).__name__}")
    lead = mesh.lead
    ev = column_sharded_sums(
        gradient, mesh.axis_slots(X.axis), X.cols_per_shard, y.to(lead),
        None if mask is None else mask.to(lead), lead)
    return _pair_builder(ev, tuple(X.shards))
