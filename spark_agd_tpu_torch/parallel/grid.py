"""Grid fits over a mesh: the sweeps and cross-validation on sharded rows.

Counterpart of ``spark_agd_tpu/parallel/grid.py``.  The single-device
sweeps (``api.sweep``, ``api.cross_validate``, ``LBFGS.sweep``) run K
lanes in lock-step, each round one ``lanes_loss_and_grad`` call for all
of them; here the rows are sharded over the mesh's ``data`` axis as a
single fit's are (``parallel.dist_smooth``), and each round is one such
call a data slot on its shard (one launch of the lanes kernel a slot
through ``FusedMarginGradient``), the slots' ``(K,)`` loss sums, stacked
gradient sums and counts added in slot order, then across processes in
rank order.  Every lane therefore sees the same combined scalars on
every slot and rank, and the lock-step driver takes the same branches
everywhere (the JAX package's ``vmap`` inside ``shard_map``).

The data lives once a shard, shared by every lane; a ``RowShardedCSR``
batch's shards are prepared once (their twins and plans).  Cross-
validation trains each lane under its fold's complement, an (N, K) mask
a shard, so it runs the plain gradients, as on one device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core import host_agd, smooth as smooth_lib, tvec
from ..ops.losses import Gradient
from ..ops.prox import Prox
from . import dist_smooth, mesh as mesh_lib


def _lanes_sums(gradient: Gradient, mesh, operands, dtype) -> Callable:
    """``sums(W) -> ((K,) loss sums, stacked gradient sums, (K,) counts)``
    of K lanes over the slots' ``operands`` (one triple a slot, a
    triple's mask ``(N_s,)`` or ``(N_s, K)``): one
    ``lanes_loss_and_grad`` call a slot, the sums added in slot order and
    across processes."""
    return lambda W: dist_smooth._slot_sums(gradient, mesh, operands, W,
                                            dtype, lanes=True)


def mesh_lanes_smooth(gradient: Gradient, mesh, operands, dtype):
    """``(smooth_multi, smooth_loss_multi)`` of K lanes over the slots'
    ``operands``: the mesh form of ``core.smooth.lanes_smooth``, each
    lane over its own count."""
    return smooth_lib.lanes_pair(_lanes_sums(gradient, mesh, operands,
                                             dtype))


def _mean_loss_multi(gradient, mesh, operands, dtype):
    """``(K,)`` mean losses of the lanes over ``operands``; an empty
    selection reads NaN, never a perfect 0.0."""
    sums = _lanes_sums(gradient, mesh, operands, dtype)

    def mean_loss(W):
        ls, _, cnt = sums(W)
        return smooth_lib.lanes_mean_or_nan(ls, cnt)

    return mean_loss


def make_mesh_sweep_fit(gradient: Gradient, updater: Prox,
                        batch: "mesh_lib.ShardedBatch", mesh, cfg, *,
                        data_axis: str = mesh_lib.DATA_AXIS) -> Callable:
    """``fit(reg_params, initial_weights, warm=None)`` over a mesh: every
    strength's lane trains on the whole row-sharded dataset, each round
    one ``lanes_loss_and_grad`` call a slot.  Returns the batched
    ``AGDResult`` of ``api.sweep`` (a leading K axis on every field);
    ``warm`` is a batched ``AGDWarmState`` (``api.sweep_warm_state``)."""
    from .. import api

    mesh_lib.check_data_mesh(mesh, data_axis)
    ops = dist_smooth.shard_operands(gradient, *batch)
    sm, sl = mesh_lanes_smooth(gradient, mesh, ops, batch.X.dtype)
    fit_lanes = api._lanes_fit(sm, sl, updater, cfg, mesh.lead)

    def fit(reg_params, initial_weights, warm=None):
        return fit_lanes(initial_weights, reg_params, warm=warm)

    fit.data_args = ops
    return fit


def make_mesh_cv_fit(gradient: Gradient, updater: Prox,
                     batch: "mesh_lib.ShardedBatch", fold_ids, mesh, cfg,
                     *, data_axis: str = mesh_lib.DATA_AXIS) -> Callable:
    """``fit(fold_lane, reg_lane, initial_weights) -> (val_loss_flat,
    batched AGDResult)`` over a mesh: the ``cross_validate`` lane grid
    with rows sharded.

    ``fold_ids`` are sharded like the batch's rows (``ShardedRows``):
    :func:`shard_row_array` for a dense batch, or for a
    ``RowShardedCSR`` the extras channel of the sharding itself
    (``mesh.shard_csr_batch(..., extras={"fold_ids": fids})``, through
    the balancer's row permutation; padding slots read the fill value,
    which is no fold's).  Padding rows are excluded by the batch mask on
    both the train and the validation side."""
    from .. import api

    mesh_lib.check_data_mesh(mesh, data_axis)
    X, y, mask = batch
    ops = dist_smooth.shard_operands(gradient, *batch, check_rows=True)
    masks = None if mask is None else mask.shards
    slots = []
    for i, o in enumerate(ops):
        if o is None:
            slots.append(None)
            continue
        rows = o[0].shape[0]
        bm = (torch.ones(rows, dtype=torch.float32, device=o[1].device)
              if masks is None else masks[i].to(torch.float32))
        slots.append((o[0], o[1], bm, fold_ids.shards[i][:rows]
                      .to(o[1].device)))
    dtype = X.dtype

    def lane_ops(fold_lane, held: bool):
        out = []
        for s in slots:
            if s is None:
                out.append(None)
                continue
            Xs, ys, bm, fids = s
            fl = fold_lane.to(fids.device)
            sel = fids[:, None] == fl[None, :]
            out.append((Xs, ys, bm[:, None] * (sel if held else ~sel)))
        return out

    def fit(fold_lane, reg_lane, initial_weights):
        fold_lane = torch.as_tensor(np.asarray(fold_lane), dtype=torch.int32)
        regs = api._regs(reg_lane)
        train = lane_ops(fold_lane, False)
        sm, _ = mesh_lanes_smooth(gradient, mesh, train, dtype)
        w0 = tvec.tmap(lambda a: api._owned(a, mesh.lead), initial_weights)
        px, rv = host_agd.make_prox_multi(updater, regs)
        run_ = host_agd.run_lanes(
            sm, px, rv,
            host_agd.initial_carry(api._stack_lanes(w0, len(regs)), cfg),
            cfg, smooth_loss_multi=_mean_loss_multi(gradient, mesh, train,
                                                    dtype))
        del train
        res = api._batched_result(run_, cfg.num_iterations)
        val = _mean_loss_multi(gradient, mesh, lane_ops(fold_lane, True),
                               dtype)(res.weights)
        return val, res

    return fit


def shard_row_array(mesh, arr, n_padded: int,
                    axis: str = mesh_lib.DATA_AXIS, fill=0):
    """A per-row array padded to a batch's padded row count with
    ``fill`` and sharded like the batch's rows (the co-sharding
    ``shard_batch`` applies to ``y`` and the mask, for the caller's
    extras such as CV fold ids): a ``ShardedRows`` whose shards hold
    every row of their span, the padding ones included."""
    arr = np.asarray(arr)
    if arr.shape[0] > n_padded:
        raise ValueError(
            f"array rows {arr.shape[0]} exceed padded batch rows "
            f"{n_padded}")
    pad = n_padded - arr.shape[0]
    if pad:
        arr = np.concatenate(
            [arr, np.full((pad,) + arr.shape[1:], fill, arr.dtype)])
    t = torch.from_numpy(np.ascontiguousarray(arr))
    rps, spans = mesh_lib.shard_spans(mesh, n_padded, axis=axis)
    shards = [t[a:b].to(dev) for dev, (a, b) in zip(mesh.slots(), spans)]
    return mesh_lib.ShardedRows(shards, [rps - (b - a) for a, b in spans],
                                mesh, (rps * mesh.shape[axis],)
                                + tuple(arr.shape[1:]), rps)


def make_mesh_lbfgs_sweep_fit(gradient: Gradient, updater: Prox,
                              batch: "mesh_lib.ShardedBatch", mesh, cfg,
                              *, data_axis: str = mesh_lib.DATA_AXIS
                              ) -> Callable:
    """``fit(reg_params, initial_weights)`` for the quasi-Newton member
    over a mesh: K strengths' lanes in lock-step over row-sharded data,
    each evaluation round one ``lanes_loss_and_grad`` call a slot, plus
    each lane's smooth penalty (smooth penalties only).  Returns the
    batched ``LBFGSResult`` of ``api.make_lbfgs_sweep_runner``."""
    from .. import api
    from ..core import lbfgs as lbfgs_lib

    lbfgs_lib.check_smooth_penalty(updater, 1.0)
    mesh_lib.check_data_mesh(mesh, data_axis)
    ops = dist_smooth.shard_operands(gradient, *batch)
    sm, _ = mesh_lanes_smooth(gradient, mesh, ops, batch.X.dtype)

    def fit(reg_params, initial_weights):
        regs = api._lbfgs_regs(reg_params)
        w0 = tvec.tmap(lambda a: api._owned(a, mesh.lead), initial_weights)
        return lbfgs_lib.run_lbfgs_lanes(
            api._penalized_lanes(sm, updater, regs),
            api._stack_lanes(w0, len(regs)), cfg)

    fit.data_args = ops
    return fit

