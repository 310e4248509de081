"""Feature-dimension (D-axis) sharding of CSR data: the axis the reference
cannot scale.

Counterpart of ``spark_agd_tpu/parallel/feature_sharded.py``.  The
reference ships the whole weight vector to every executor an evaluation;
at url_combined's width (3,231,961 features) the weights and the
optimizer's state are what grow.  Here the columns are split over the
mesh's ``model`` axis: each model slot holds its columns' entries as a
local ``CSRMatrix``, and an evaluation assembles only the (N,) margins:

- the host lays the columns out (:func:`shard_csr_by_columns`): columns
  go to shards by greedy nnz balance (``native.greedy_balance``, so the
  ``positions`` equal the JAX package's), each shard's entries are
  re-indexed to local columns and padded to one entry count with inert
  0.0 entries at the last row and column;
- an evaluation (:func:`make_feature_sharded_smooth`, through
  ``parallel.dist_smooth.column_sharded_sums``, which the dense
  column-sharded batch shares): each slot's
  partial margins ``X_s @ w_s``, added over the slots in slot order (the
  one combine, JAX's psum over ``model``), the per-row loss and
  multiplier (``MarginGradient.dots_loss_and_mult``), then each slot's
  gradient columns ``X_s.T @ mult`` over its column-sorted twin: the
  gradient lands sharded, in the weights' padded positions.

The weights are the padded ``(n_shards * d_local,)`` vector on the mesh's
lead device (the carry's home; each evaluation hands each slot its
columns' weights); unused positions stay exactly zero through every prox
of ``ops.prox``, so :func:`unshard_weights` is lossless.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..ops.losses import MarginGradient
from ..ops.sparse import CSRMatrix
from . import dist_smooth, mesh as mesh_lib


class FeatureShardedBatch(NamedTuple):
    """A column-sharded CSR batch on a mesh.  ``shards[s]``: model slot
    s's columns as a local ``CSRMatrix`` ``(n_rows, d_local)`` on its
    device, its entries sorted by row and, when built (the default), its
    column-sorted twin; ``y`` and ``mask`` whole on the mesh's lead
    device.  ``positions`` (host, ``(n_features,)``) maps global column c
    to its padded position ``shard * d_local + local``: columns go to
    shards by greedy nnz balance, not in contiguous ranges, so a
    power-law column distribution cannot pile its entries onto one
    shard."""

    shards: List[CSRMatrix]
    y: torch.Tensor
    mask: Optional[torch.Tensor]
    positions: np.ndarray
    n_rows: int
    n_features: int
    d_local: int
    mesh: "mesh_lib.Mesh"
    axis: str = mesh_lib.MODEL_AXIS

    @property
    def has_csc(self) -> bool:
        return self.shards[0].has_csc


def shard_csr_by_columns(indptr, indices, values, n_features: int, y,
                         mesh: "mesh_lib.Mesh", mask=None,
                         axis: str = mesh_lib.MODEL_AXIS,
                         with_csc: bool = True) -> FeatureShardedBatch:
    """Host-side layout: assign columns to shards in nnz-balanced order,
    re-index entries to (shard, local), pad the shards to a common entry
    count, place each on its slot.  ``with_csc=False`` drops the
    column-sorted gradient twin (half the entry memory; the gradient
    then scatters).  Values and labels are taken in f32, as the JAX
    package takes them."""
    mesh_lib.check_mesh(mesh)
    if axis not in mesh.shape:
        raise ValueError(f"the mesh has no {axis!r} axis: {mesh}")
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    values = np.asarray(values, np.float32)
    if len(indices) and (indices.min() < 0 or indices.max() >= n_features):
        raise ValueError(
            f"column index out of range: [{indices.min()}, {indices.max()}]"
            f" vs n_features={n_features}: refusing a layout that would "
            "silently corrupt the padding tail")
    n_rows = len(indptr) - 1
    counts = np.diff(indptr)
    row_ids = np.repeat(np.arange(n_rows, dtype=np.int32), counts)

    n_shards = mesh.shape[axis]
    d_local = -(-n_features // n_shards)

    # heaviest column onto the lightest shard with room left: a shard's
    # load near max(heaviest column, total / n_shards)
    col_nnz = np.bincount(indices, minlength=n_features)
    shard_of_col, local_of_col = native.greedy_balance(
        col_nnz, n_shards, d_local)
    positions = shard_of_col * d_local + local_of_col

    e_shard = shard_of_col[indices]
    e_local = local_of_col[indices].astype(np.int32)
    eorder = np.argsort(e_shard, kind="stable")
    shard_sorted_e = e_shard[eorder]
    starts = np.searchsorted(shard_sorted_e, np.arange(n_shards))
    ends = np.searchsorted(shard_sorted_e, np.arange(n_shards),
                           side="right")
    nnz_shard = max(int((ends - starts).max()) if len(values) else 1, 1)

    lead = mesh.lead
    shards = []
    for s, dev in enumerate(mesh.axis_slots(axis)):
        # padding points at the last row / last local column, so the ids
        # stay nondecreasing; a shard's entries keep the input's row order
        R = np.full(nnz_shard, max(n_rows - 1, 0), np.int32)
        C = np.zeros(nnz_shard, np.int32)
        V = np.zeros(nnz_shard, np.float32)
        sel = eorder[starts[s]:ends[s]]
        k = len(sel)
        R[:k], C[:k], V[:k] = row_ids[sel], e_local[sel], values[sel]
        csc = {}
        if with_csc:
            Rc = np.zeros(nnz_shard, np.int32)
            Cc = np.full(nnz_shard, d_local - 1, np.int32)
            Vc = np.zeros(nnz_shard, np.float32)
            sel_c = sel[np.argsort(e_local[sel], kind="stable")]
            Rc[:k], Cc[:k], Vc[:k] = (row_ids[sel_c], e_local[sel_c],
                                      values[sel_c])
            csc = dict(csc_row_ids=torch.from_numpy(Rc).to(dev),
                       csc_col_ids=torch.from_numpy(Cc).to(dev),
                       csc_values=torch.from_numpy(Vc).to(dev))
        shards.append(CSRMatrix(
            torch.from_numpy(R).to(dev), torch.from_numpy(C).to(dev),
            torch.from_numpy(V).to(dev), (n_rows, d_local),
            rows_sorted=True, **csc).plan())
    return FeatureShardedBatch(
        shards=shards,
        y=torch.from_numpy(np.asarray(y, np.float32).copy()).to(lead),
        mask=(None if mask is None else
              torch.from_numpy(np.asarray(mask, np.float32).copy())
              .to(lead)),
        positions=positions, n_rows=n_rows, n_features=int(n_features),
        d_local=int(d_local), mesh=mesh, axis=axis)


def shard_weights(w, batch: FeatureShardedBatch, mesh: "mesh_lib.Mesh",
                  axis: str = mesh_lib.MODEL_AXIS) -> torch.Tensor:
    """A (D,) weight vector in the batch's padded positions, f32, on the
    mesh's lead device."""
    n_shards = mesh.shape[axis]
    wp = np.zeros(n_shards * batch.d_local, np.float32)
    wp[batch.positions] = np.asarray(w, np.float32)
    return torch.from_numpy(wp).to(mesh.lead)


def unshard_weights(w_sharded, batch: FeatureShardedBatch) -> np.ndarray:
    """The (D,) weights of a padded sharded state, in column order."""
    a = w_sharded.detach().cpu().numpy() \
        if isinstance(w_sharded, torch.Tensor) else np.asarray(w_sharded)
    return a[batch.positions]


def make_feature_sharded_smooth(gradient: MarginGradient,
                                batch: FeatureShardedBatch, *,
                                mesh: "mesh_lib.Mesh",
                                axis: str = mesh_lib.MODEL_AXIS) -> Tuple:
    """``(smooth, smooth_loss)`` over a column-sharded batch:
    ``smooth(w_padded) -> (mean_loss, mean_grad_padded)``, the gradient
    in the weights' padded positions, so the whole AGD loop runs on that
    state."""
    if not isinstance(gradient, MarginGradient):
        raise TypeError(
            "feature sharding needs a margin-form GLM loss "
            f"(MarginGradient); got {type(gradient).__name__}")
    slots = mesh.axis_slots(axis)
    if len(slots) != len(batch.shards):
        raise ValueError(f"the batch has {len(batch.shards)} shards, the "
                         f"mesh's {axis!r} axis {len(slots)} slots")
    ev = dist_smooth.column_sharded_sums(gradient, slots, batch.d_local,
                                         batch.y, batch.mask, mesh.lead)
    build, args = dist_smooth._pair_builder(ev, tuple(batch.shards))
    return build(*args)
