"""Partitioned-file ingest: K partition files onto a mesh.

Counterpart of ``spark_agd_tpu/data/ingest.py``.  Upstream, a Spark job
(or any writer) leaves the dataset as K partition files; here each
process of the group reads its own subset and places it on its slots of
the mesh.  The contract, as in the JAX package:

- ``paths`` is the same full partition list on every process (sorted
  here, so any consistent enumeration works);
- process p reads ``paths[p::process_count]`` (round-robin, so a
  size-skewed tail spreads), or the explicit ``assignment=``;
- the row counts and the feature width are agreed with allgathers over
  ``parallel.multihost``; each process pads its block to the common
  height with mask-0 rows, which add nothing to any sum;
- the result is a ``parallel.mesh.ShardedBatch`` holding this process's
  shards of the global batch.

A single process degenerates to: read everything, shard like
``mesh.shard_batch``.  :func:`from_partitioned_files` densifies the rows;
:func:`from_partitioned_files_csr` keeps them sparse end to end
(``mesh.csr_shard_layout``, nnz-balanced, with dimensions agreed across
processes).  A partition read runs under the shared retry engine
(``resilience.retry``), and freshly read partitions go through the
``validate=`` policy; ``data.streaming.StreamingDataset.from_libsvm_parts``
shares both.  ``telemetry=`` (an ``obs.Telemetry``) gets a ``recovery``
record a retried read and the ``data.invalid_records`` counter of the rows
``validate="drop"`` dropped, as in the JAX package.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..parallel import mesh as mesh_lib
from ..parallel import multihost
from ..resilience import retry as retry_lib
from . import libsvm

logger = logging.getLogger("spark_agd_tpu")

# transient IO mid-ingest costs a short backoff, not the whole job;
# bounded so a genuinely dead source still fails fast
DEFAULT_READ_RETRIES = retry_lib.RetryPolicy(
    max_attempts=3, backoff_base=0.05, backoff_max=2.0, jitter=0.1)


def _retrying_loader(loader: Callable, retries, telemetry) -> Callable:
    """``loader`` under the shared retrying helper (``resilience.
    retry``): transient IO errors back off and re-read; each retry is
    logged and, when a ``telemetry`` is attached, emitted as a
    ``recovery`` record."""
    policy = retries if retries is not None else DEFAULT_READ_RETRIES

    def on_retry(n_failures, exc, delay):
        logger.warning(
            "ingest read failed (%s: %s); retry %d/%d in %.2fs",
            type(exc).__name__, exc, n_failures,
            policy.max_attempts - 1, delay)

    return retry_lib.retrying(policy, label="ingest_read",
                              telemetry=telemetry,
                              on_retry=on_retry)(loader)


def _validated_parts(paths_used, parts, d, validate, telemetry):
    """Apply the ``validate=`` policy to freshly read partitions:
    ``False`` = trust the writer, ``"raise"`` = typed
    :class:`~spark_agd_tpu_torch.data.libsvm.DataValidationError` on the
    first bad partition (FATAL to the retry engine: re-reading garbage
    yields garbage), ``"drop"`` = discard invalid rows, log, and count
    them on the ``data.invalid_records`` telemetry counter."""
    if not validate:
        return parts
    if validate not in ("raise", "drop"):
        raise ValueError(
            f"validate must be False, 'raise', or 'drop'; "
            f"got {validate!r}")
    out = []
    for path, part in zip(paths_used, parts):
        mask = libsvm.invalid_row_mask(part, d)
        n_bad = int(mask.sum())
        if not n_bad:
            out.append(part)
            continue
        if validate == "raise":
            raise libsvm.DataValidationError(
                path, libsvm.describe_invalid(part, mask))
        logger.warning(
            "%s: dropping %d invalid row(s) (non-finite features/"
            "labels or out-of-range indices)", path, n_bad)
        if telemetry is not None:
            telemetry.registry.counter("data.invalid_records").inc(n_bad)
        out.append(libsvm.drop_rows(part, mask))
    return out


def _allgather_max(value: int) -> int:
    """Max of a per-process int across the group (itself in one
    process)."""
    return int(np.max(multihost.process_allgather_int64([int(value)])))


def _allgather_sum(value: int) -> int:
    """Sum of a per-process int across the group."""
    return int(np.sum(multihost.process_allgather_int64([int(value)])))


def local_partitions(paths: Sequence[str]) -> list:
    """The partition files this process reads: round-robin over the
    sorted list."""
    paths = sorted(paths)
    return paths[multihost.process_index()::multihost.process_count()]


def _mesh_for(mesh, axis):
    mesh = mesh if mesh is not None else mesh_lib.make_mesh()
    mesh_lib.check_data_mesh(mesh, axis)
    n_dev_axis = mesh.shape[axis]
    world = multihost.process_count()
    if n_dev_axis % world or (world > 1 and mesh.process_count != world):
        raise ValueError(
            f"mesh axis {axis!r} has {n_dev_axis} slots over "
            f"{mesh.process_count} processes; per-process assembly needs "
            f"the axis split evenly over the group's {world}")
    return mesh


def from_partitioned_files(
    paths: Sequence[str],
    mesh=None,
    *,
    n_features: Optional[int] = None,
    dtype=np.float32,
    binarize_labels: bool = True,
    loader: Optional[Callable[..., "libsvm.CSRData"]] = None,
    axis: str = mesh_lib.DATA_AXIS,
    retries: Optional[retry_lib.RetryPolicy] = None,
    telemetry=None,
    validate=False,
    assignment: Optional[Sequence[str]] = None,
    pad_to_rows: Optional[int] = None,
) -> mesh_lib.ShardedBatch:
    """Load one LIBSVM partition set into a mesh-sharded dense batch.

    ``loader(path, n_features=...) -> CSRData`` defaults to the LIBSVM
    reader (the native parser when built).  ``n_features`` pins the
    global width; when omitted it is the max over every process's
    partitions.  Labels are mapped to {0, 1} unless
    ``binarize_labels=False``.  Reads run under the retry engine
    (``retries``, default 3 attempts with backoff); ``validate``
    (``"raise"`` or ``"drop"``) rejects or drops rows with non-finite
    values or indices out of range.  ``telemetry``: a ``recovery``
    record a retried read; the rows dropped on the
    ``data.invalid_records`` counter.

    ``assignment``: an explicit partition list for this process instead
    of the round-robin rule (an empty list is legal: the process then
    holds mask-0 rows only and keeps its place in every collective).
    ``pad_to_rows`` (across processes only) pins the per-process block
    height instead of the allgather-max.  ``mesh`` defaults to
    ``mesh.make_mesh()`` (every visible card).  Returns a
    ``ShardedBatch`` whose mask excludes the padding rows."""
    if not paths:
        raise ValueError("no partition files")
    loader = _retrying_loader(loader or libsvm.load_libsvm, retries,
                              telemetry)
    mesh = _mesh_for(mesh, axis)
    mine = (sorted(str(p) for p in assignment)
            if assignment is not None else local_partitions(paths))
    parts = [loader(p, n_features=n_features) for p in mine]
    d = n_features or _allgather_max(
        max((part.n_features for part in parts), default=0))
    if d == 0:
        raise ValueError("could not infer n_features (all partitions "
                         "empty on this process and none given)")
    parts = _validated_parts(mine, parts, d, validate, telemetry)

    ys, Xs = [], []
    for part in parts:
        ys.append(part.binarized_labels() if binarize_labels
                  else np.asarray(part.labels))
        Xs.append(part.to_dense(d, dtype=dtype))
    n_local = int(sum(len(y) for y in ys))
    X_local = np.concatenate(Xs) if Xs else np.zeros((0, d), dtype)
    y_local = (np.concatenate(ys).astype(np.float32) if ys
               else np.zeros((0,), np.float32))

    world = multihost.process_count()
    if world == 1:
        return mesh_lib.shard_batch(mesh, X_local, y_local, axis=axis)

    # equal block heights across processes, a multiple of the slots a
    # process holds; the padding rows carry mask 0
    per_host_quantum = mesh.local_shape[axis]
    if pad_to_rows is not None:
        rows_host = int(pad_to_rows)
        if rows_host < n_local:
            raise ValueError(
                f"pad_to_rows={rows_host} < this process's {n_local} "
                "rows; the pinned block height must fit every "
                "assignment")
        if rows_host % per_host_quantum:
            raise ValueError(
                f"pad_to_rows={rows_host} must be a multiple of the "
                f"per-process slot count {per_host_quantum}")
    else:
        rows_host = _allgather_max(n_local)
        rows_host = -(-rows_host // per_host_quantum) * per_host_quantum
    pad = rows_host - n_local
    mask_local = np.concatenate(
        [np.ones(n_local, np.float32), np.zeros(pad, np.float32)])
    X_local = np.concatenate([X_local, np.zeros((pad, d), X_local.dtype)])
    y_local = np.concatenate([y_local, np.zeros(pad, np.float32)])
    return _place_local_rows(mesh, axis, X_local, y_local, mask_local,
                             rows_host * world)


def _place_local_rows(mesh, axis, X_local, y_local, mask_local, n_global):
    """This process's block (a multiple of its slot count) split evenly
    over its slots, as rows of the global ``n_global``-row batch."""
    k_local = mesh.local_shape[axis]
    rps = X_local.shape[0] // k_local
    xs, ys, ms = [], [], []
    for i, dev in enumerate(mesh.slots()):
        sl = slice(i * rps, (i + 1) * rps)
        xs.append(torch.from_numpy(np.ascontiguousarray(X_local[sl]))
                  .to(dev))
        ys.append(torch.from_numpy(y_local[sl].copy()).to(dev))
        ms.append(torch.from_numpy(mask_local[sl].copy()).to(dev))
    pads = [0] * k_local
    return mesh_lib.ShardedBatch(
        mesh_lib.ShardedRows(xs, pads, mesh, (n_global, X_local.shape[1]),
                             rps),
        mesh_lib.ShardedRows(ys, pads, mesh, (n_global,), rps),
        mesh_lib.ShardedRows(ms, pads, mesh, (n_global,), rps))


def from_partitioned_files_csr(
    paths: Sequence[str],
    mesh=None,
    *,
    n_features: Optional[int] = None,
    binarize_labels: bool = True,
    with_csc: bool = True,
    loader: Optional[Callable[..., "libsvm.CSRData"]] = None,
    axis: str = mesh_lib.DATA_AXIS,
    retries: Optional[retry_lib.RetryPolicy] = None,
    telemetry=None,
    validate=False,
) -> mesh_lib.ShardedBatch:
    """Load a LIBSVM partition set into a mesh-sharded sparse batch, with
    no densification at any point.

    The same process/partition contract as :func:`from_partitioned_files`;
    the result's ``X`` is a ``RowShardedCSR`` (local CSR shards,
    nnz-balanced within each process), which feeds the same per-shard
    sums as ``mesh.shard_csr_batch``'s.  Agreement across processes
    costs two allgather-max reductions (rows a shard, padded entries a
    shard); a process with no partitions holds padding shards only.
    ``with_csc=True`` builds each shard's column-sorted twin on the host.
    ``n_features`` pins the global width; ``telemetry`` as in
    :func:`from_partitioned_files`."""
    if not paths:
        raise ValueError("no partition files")
    loader = _retrying_loader(loader or libsvm.load_libsvm, retries,
                              telemetry)
    mesh = _mesh_for(mesh, axis)
    n_dev_axis = mesh.shape[axis]
    local_shards = mesh.local_shape[axis]

    mine = local_partitions(paths)
    parts = [loader(p, n_features=n_features) for p in mine]
    d = n_features or _allgather_max(
        max((part.n_features for part in parts), default=0))
    if d == 0:
        raise ValueError("could not infer n_features (all partitions "
                         "empty on this process and none given)")
    parts = _validated_parts(mine, parts, d, validate, telemetry)
    for p, part in zip(mine, parts):
        if len(part.indices) and int(part.indices.max()) >= d:
            raise ValueError(
                f"{p}: feature index {int(part.indices.max())} >= "
                f"n_features={d}")

    row_ids, col_ids, values, ys = [], [], [], []
    row_base = 0
    for part in parts:
        counts = np.diff(part.indptr)
        row_ids.append(row_base + np.repeat(
            np.arange(len(counts), dtype=np.int64), counts))
        col_ids.append(np.asarray(part.indices, np.int64))
        values.append(np.asarray(part.values, np.float32))
        ys.append(part.binarized_labels() if binarize_labels
                  else np.asarray(part.labels))
        row_base += len(counts)
    n_local = row_base

    def cat(xs, dt):
        return np.concatenate(xs).astype(dt) if xs else np.zeros(0, dt)

    lay = mesh_lib.csr_shard_layout(
        cat(row_ids, np.int64), cat(col_ids, np.int64),
        cat(values, np.float32), cat(ys, np.float32), None,
        n_local, d, local_shards, with_csc=with_csc,
        reduce_max=_allgather_max)
    n_rows_global = _allgather_sum(n_local)
    return mesh_lib.place_csr_layout(lay, mesh, axis, n_rows_global, d,
                                     n_shards=n_dev_axis,
                                     values_dtype=torch.float32)
