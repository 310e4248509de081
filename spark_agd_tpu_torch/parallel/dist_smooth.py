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
combine.  ``mode="auto"`` (JAX's GSPMD mode) computes the same per-shard
sums: the port has no partitioner.  A mesh with a ``model`` axis (JAX's
tensor-parallel softmax) and ``psum_scatter_combine`` (the sharded
update) come with a later slice and raise.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .._later import reject_a8
from ..core import tvec
from ..ops.losses import Gradient
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
        return _make_shard_map_csr(gradient, X, y, mask, mesh, data_axis)
    # "auto" is JAX's GSPMD mode, where XLA partitions a global-array
    # evaluation; the port has no partitioner, so both modes compute the
    # same per-shard sums
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


def psum_scatter_combine(ls, gs, n, data_axis, layout):
    """The reduce-scatter combine of the sharded update: comes with
    ``parallel/sharded_update.py`` in a later slice and raises."""
    reject_a8("model_axis", "psum_scatter_combine (the sharded update)")


def _prepare_shards(gradient, xs, ys, ms):
    """``gradient.prepare`` once a shard (a shard with no real rows is
    left out: it adds nothing); a CSR shard's reduction plans are worked
    out here too.  Returns one operand triple a slot (None for an empty
    one)."""
    out = []
    for i, Xs in enumerate(xs):
        if Xs.shape[0] == 0:
            out.append(None)
            continue
        ops = gradient.prepare(Xs, ys[i], None if ms is None else ms[i])
        if isinstance(ops[0], CSRMatrix):
            ops[0].plan()
        out.append(ops)
    return out


def _combine(mesh, parts, slots: int):
    """Add the slots' ``(Σloss, Σgrad, n)`` on the lead device in slot
    order, then across processes (:func:`_across_processes`).  ``slots``
    counts this process's slots that held rows; returns the sums and that
    count over the whole group."""
    lead = mesh.lead
    ls = gs = n = None
    for p_ls, p_gs, p_n in parts:
        p_ls = p_ls.to(lead)
        p_gs = tvec.tmap(lambda g: g.to(lead), p_gs)
        p_n = p_n.to(device=lead, dtype=torch.int64)
        if ls is None:
            ls, gs, n = p_ls, p_gs, p_n
        else:
            ls, gs, n = ls + p_ls, tvec.add(gs, p_gs), n + p_n
    if mesh.in_group:
        return _across_processes(ls, gs, n, slots)
    return ls, gs, n, slots


def _across_processes(ls, gs, n, slots: int):
    """Join the ranks' sums: one all-gather of each rank's packed bytes,
    added in rank order on every rank (the same bits on every rank, so
    every rank takes the same branches).  The group's count of slots that
    held rows rides along as a tensor, read only where it is needed."""
    leaves = [ls.reshape(1)] + [g.reshape(-1) for g in tvec.leaves(gs)] \
        + [n.reshape(1),
           torch.full((1,), slots, dtype=torch.int64, device=n.device)]
    packed = torch.cat([t.contiguous().view(torch.uint8) for t in leaves])
    parts = multihost.all_gather_bytes(packed)
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
    it = iter(acc[1:-2])
    return (acc[0].reshape(()),
            tvec.unflatten_like(gs, (x.reshape(g.shape) for x, g in
                                     zip(it, tvec.leaves(gs)))),
            acc[-2].reshape(()), acc[-1].reshape(()))


def _zero_sums(w, dtype, device):
    """``(Σloss, Σgrad, n)`` of no rows: zeros in the dtypes a slot's
    evaluation gives (its data's ``dtype`` promoted with each leaf's)."""
    first = tvec.leaves(w)[0]
    return (torch.zeros((), dtype=torch.promote_types(dtype, first.dtype),
                        device=device),
            tvec.tmap(lambda a: torch.zeros(
                a.shape, dtype=torch.promote_types(dtype, a.dtype),
                device=device), w),
            torch.zeros((), dtype=torch.int64, device=device))


def _slot_sums(gradient, mesh, prepared, w, dtype):
    """Each slot's ``(Σloss, Σgrad, n)`` at ``w``, combined; ``w`` is
    copied once to each device other than the lead's.  ``dtype`` is the
    data's: a process whose slots hold no rows (they lie past the batch's
    last row) still joins the group's collective, with zero sums of the
    dtypes the other ranks send; the batch raises only when it is empty
    on every rank."""
    global slot_evaluations, mesh_evaluations
    copies = {}
    parts = []
    for dev, ops in zip(mesh.slots(), prepared):
        if ops is None:
            continue
        wd = copies.get(dev)
        if wd is None:
            wd = copies[dev] = tvec.tmap(lambda a: a.to(dev), w)
        parts.append(gradient.batch_loss_and_grad(wd, *ops))
        slot_evaluations += 1
    mesh_evaluations += 1
    had = len(parts)
    if not had:
        if not mesh.in_group:
            raise ValueError("every shard of the batch is empty")
        parts = [_zero_sums(w, dtype, mesh.lead)]
    ls, gs, n, total = _combine(mesh, parts, had)
    if not had and not int(total):  # read only where this rank had none
        raise ValueError("every shard of the batch is empty, on every rank")
    return ls, gs, n


def _make_shard_map(gradient, X, y, mask, mesh):
    """Data parallelism over dense shards: a slot's evaluation on its
    shard, one combine.  With ``FusedMarginGradient`` or
    ``FusedSoftmaxGradient`` (JAX's ``_make_shard_map_pallas``) each
    shard is staged once here, and staging keeps a contiguous f32 or
    bf16 shard as the view of X it is, so the card holds X once whatever
    the slot count; each slot then launches the CUDA kernel on its own
    shard."""
    from ..ops.fused_kernels import StagedDense

    prepared = _prepare_shards(
        gradient, X.shards, y.shards, None if mask is None else mask.shards)
    for xs, ops in zip(X.shards, prepared):
        if ops is not None and isinstance(ops[0], StagedDense) \
                and xs.dtype in (torch.float32, torch.bfloat16) \
                and ops[0].X.data_ptr() != xs.data_ptr():
            raise AssertionError("staging copied a shard of X")
    return _pair_builder(
        lambda w, *p: _slot_sums(gradient, mesh, p, w, X.dtype),
        tuple(prepared))


def csr_shard_args(X: RowShardedCSR, y, mask) -> tuple:
    """The per-slot operand triples ``(local CSR, y, mask)`` that
    :func:`csr_shard_sums` evaluates: one definition for every caller."""
    if mask is None:
        raise ValueError(
            "RowShardedCSR requires its padding mask; build the batch "
            "with parallel.mesh.shard_csr_batch")
    return tuple(zip(X.shards, y.shards, mask.shards))


def csr_shard_sums(gradient, X, y, mask, mesh):
    """The per-slot operands of a ``RowShardedCSR`` batch, each shard
    prepared once (its twin and reduction plans), and ``ev(w) -> (Σloss,
    Σgrad, n)`` over them: the core of the in-memory mesh path and of the
    streamed mesh path.  Returns ``(ev, prepared)``."""
    triples = csr_shard_args(X, y, mask)
    prepared = _prepare_shards(gradient, *zip(*triples))
    return (lambda w: _slot_sums(gradient, mesh, prepared, w, X.dtype)), \
        prepared


def _make_shard_map_csr(gradient, X, y, mask, mesh, data_axis):
    """Sparse DP: each slot's local CSR shard through the same loss as the
    single-device sparse path, one combine.  The mask is required: the
    shards' padding rows must stay out of every sum."""
    _, prepared = csr_shard_sums(gradient, X, y, mask, mesh)
    return _pair_builder(
        lambda w, *p: _slot_sums(gradient, mesh, p, w, X.dtype),
        tuple(prepared))
