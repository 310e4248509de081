"""Meshes of devices, and the placement of data and weights on them.

Counterpart of ``spark_agd_tpu/parallel/mesh.py``.  A :class:`Mesh` is a
named grid of device slots with the JAX package's axis names
(``DATA_AXIS = "data"``, ``MODEL_AXIS = "model"``).  A slot may repeat a
device: ``["cpu"] * 8`` in the CPU tests, ``["cuda:0"] * 4`` on one card.
That is the only way torch has of holding several "devices" on one CPU or
one card, and it runs the real code: a shard per slot, one evaluation a
slot, the combine.

Where the port differs from JAX: torch has no sharded array and no
replicated carry.  The optimizer's carry lives on the mesh's lead device
(the first slot); each evaluation copies ``w`` to every other slot's
device (D floats a slot: Spark's broadcast, which JAX's replicated carry
avoids; nothing is copied for a slot on the lead device), runs each slot's
evaluation on its own shard, and adds the slots' ``(Σloss, Σgrad, n)`` on
the lead device in slot order (``parallel.dist_smooth``).  That fixed
order stands in for ``lax.psum``: no float atomics, the same bits run to
run.  :func:`replicate` returns a tree on the lead device.

A mesh may span processes (``parallel.multihost``): its ``processes``
factor multiplies an axis across the ranks of the ``torch.distributed``
group, each process holding the slots of its own block of the axis; the
in-process combine is then followed by one collective.

Placement keeps X where it can: :func:`shard_batch` gives shard i the
rows JAX gives it (an even split, the tail padded with zero rows of mask
0), as views of X, so a 40 GB X on the card is not copied.  The padding
rows add nothing to any sum, so they are not stored: a shard holds its
real rows and a count of padding rows, which :meth:`ShardedRows.gather`
materializes.

A mesh may also have a ``model`` axis (tensor parallelism).  Row-sharded
data lives on the slots of the data axis (:meth:`Mesh.slots`: index 0 on
every other axis), so a data-parallel evaluation runs once a data index,
as JAX's replicated weights compute the same sums on every model slot;
``parallel.dist_smooth`` splits a softmax's classes over the model axis,
and :func:`shard_batch_by_features` splits a dense X's columns over it
(:class:`ShardedCols`, views of X, the padding columns not stored).
"""

from __future__ import annotations

import math
import warnings
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import native
from ..core import tvec
from ..ops.sparse import CSRMatrix, RowShardedCSR

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _as_devices(devices) -> np.ndarray:
    """An object array of ``torch.device`` of ``devices``' shape."""
    arr = np.asarray(devices, dtype=object)
    flat = [torch.device(d) for d in arr.reshape(-1)]
    out = np.empty(len(flat), dtype=object)
    out[:] = flat
    return out.reshape(arr.shape)


class Mesh:
    """A named grid of device slots (counterpart of
    ``jax.sharding.Mesh``).

    ``devices``: this process's slots, an array (or nested list) of
    ``torch.device`` or device strings, one dimension an axis;
    ``axis_names``: the axes' names.  ``processes`` (``{axis: count}``,
    default none) multiplies an axis across processes: ``shape[axis]`` is
    then the local size times the count, and this process holds block
    ``rank`` of it.  ``shape`` maps each axis to its global size, as
    ``jax.sharding.Mesh.shape`` does.  ``in_group``: the mesh belongs to
    the process group (made while one is formed): its combine then ends
    with the group's collective, even in a group of one rank."""

    def __init__(self, devices, axis_names: Sequence[str], *,
                 processes: Optional[Dict[str, int]] = None,
                 in_group: bool = False):
        self.devices = _as_devices(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"devices of shape {self.devices.shape} do not match the "
                f"axes {self.axis_names}")
        if self.devices.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.processes = {n: int(c) for n, c in (processes or {}).items()
                          if int(c) != 1}
        unknown = set(self.processes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"processes name axes {sorted(unknown)} that "
                             f"the mesh does not have")
        self.local_shape = dict(zip(self.axis_names, self.devices.shape))
        self.shape = {n: s * self.processes.get(n, 1)
                      for n, s in self.local_shape.items()}
        self.in_group = bool(in_group) or self.process_count > 1

    @property
    def process_count(self) -> int:
        return int(math.prod(self.processes.values()))

    @property
    def lead(self) -> torch.device:
        """The device of the first slot: the optimizer's carry lives
        here."""
        return self.devices.reshape(-1)[0]

    def axis_slots(self, axis: str) -> list:
        """This process's slots along ``axis``, in its order, at index 0
        of every other axis."""
        i = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        idx[i] = slice(None)
        return list(self.devices[tuple(idx)])

    def slots(self) -> list:
        """This process's slots of the data axis, in its order (index 0 of
        every other axis): where row-sharded data lives.  A mesh with no
        data axis: every slot."""
        if DATA_AXIS in self.axis_names:
            return self.axis_slots(DATA_AXIS)
        return list(self.devices.reshape(-1))

    def grid(self, axis: str = DATA_AXIS, other: str = MODEL_AXIS) -> list:
        """This process's slots as rows along ``axis`` (one a data index),
        each row the slots along ``other`` in its order (``[[slot]]`` a
        row when the mesh lacks ``other``)."""
        if other not in self.axis_names:
            return [[d] for d in self.axis_slots(axis)]
        i, j = self.axis_names.index(axis), self.axis_names.index(other)
        arr = np.moveaxis(self.devices, (i, j), (0, 1))
        arr = arr.reshape(arr.shape[0], arr.shape[1], -1)[:, :, 0]
        return [list(row) for row in arr]

    def __eq__(self, other):
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and list(self.devices.reshape(-1))
                == list(other.devices.reshape(-1))
                and self.processes == other.processes
                and self.in_group == other.in_group)

    def __hash__(self):
        return hash((self.axis_names,
                     tuple(map(str, self.devices.reshape(-1))),
                     tuple(sorted(self.processes.items()))))

    def __repr__(self):
        extra = f", processes={self.processes}" if self.processes else ""
        return (f"Mesh({dict(self.shape)}, slots="
                f"{[str(d) for d in self.slots()]}{extra})")


def check_mesh(mesh: Mesh) -> Mesh:
    """``mesh`` when it is a :class:`Mesh`; anything else raises
    ``TypeError``."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh= takes a spark_agd_tpu_torch.parallel.mesh.Mesh, None "
            f"or False; got {type(mesh).__name__}")
    return mesh


def check_data_mesh(mesh: Mesh, axis: str = DATA_AXIS) -> Mesh:
    """``mesh`` when it is a :class:`Mesh` with an ``axis`` axis, where
    rows are sharded (its other axes, a ``model`` axis, hold the same
    rows: JAX replicates them there).  Anything that is not a ``Mesh``
    raises ``TypeError``; a mesh without ``axis`` raises ``ValueError``."""
    check_mesh(mesh)
    if axis not in mesh.shape:
        raise ValueError(f"the mesh has no {axis!r} axis: {mesh}")
    return mesh


def default_devices() -> list:
    """This process's devices: every visible CUDA device once; in a
    process group of more than one rank, the current CUDA device alone
    (one card a process).  Raises without a CUDA device: a CPU mesh names
    its slots (``make_mesh(devices=["cpu"] * n)``)."""
    from . import multihost

    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller names the CPU (make_mesh(devices=['cpu'] * n))")
    if multihost.process_count() > 1:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices=None) -> Mesh:
    """Build a named mesh.  ``axes`` maps axis name -> global size
    (``{"data": 4}``); ``None`` puts every device on the ``data`` axis.
    ``devices`` are this process's slots (a device may repeat); the
    default is :func:`default_devices`.  In a process group of more than
    one rank the ``data`` axis spans the ranks: its size must be a
    multiple of the group's, and each rank takes its share of slots."""
    from . import multihost

    multihost.check_launch()
    world = multihost.process_count()
    local = list(devices) if devices is not None else default_devices()
    if axes is None:
        axes = {DATA_AXIS: len(local) * world}
    names = tuple(axes)
    sizes = [int(axes[n]) for n in names]
    processes = {}
    if world > 1:
        if DATA_AXIS not in axes or axes[DATA_AXIS] % world:
            raise ValueError(
                f"mesh axes {axes}: across {world} processes the "
                f"{DATA_AXIS!r} axis must be a multiple of {world}")
        processes = {DATA_AXIS: world}
        sizes = [s // world if n == DATA_AXIS else s
                 for n, s in zip(names, sizes)]
    need = int(math.prod(sizes))
    if need > len(local):
        raise ValueError(
            f"mesh axes {axes} need {need} devices, have {len(local)}")
    arr = _as_devices(local[:need]).reshape(sizes)
    return Mesh(arr, names, processes=processes,
                in_group=multihost.is_initialized())


def replicate(tree: Any, mesh: Mesh) -> Any:
    """The weight tree on the mesh's lead device, where the optimizer's
    carry lives (JAX replicates it into every device; here each
    evaluation copies it to the other slots' devices)."""
    lead = mesh.lead
    return tvec.tmap(lambda a: (a if isinstance(a, torch.Tensor)
                                else torch.as_tensor(np.asarray(a)))
                     .to(lead), tree)


def host_tensor(a) -> torch.Tensor:
    """A tensor of ``a`` without a copy where possible: a tensor as it
    is, a numpy array shared (a bf16 array by its bits; a read-only one
    only read)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    if not a.flags.writeable:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(a)
    return torch.from_numpy(a)


class ShardedRows:
    """Rows of an array split over a mesh's data axis, one tensor a slot
    of this process (counterpart of a row-sharded ``jax.Array``).

    ``shards[i]`` holds the real rows of this process's slot i, on the
    slot's device (a view of the source where it lay there already);
    ``pads[i]`` counts the zero rows of mask 0 that pad it to
    ``rows_per_shard``: they add nothing to any sum, so they are not
    stored.  ``shape`` is the global padded shape."""

    def __init__(self, shards, pads, mesh: Mesh, shape, rows_per_shard):
        self.shards = list(shards)
        self.pads = [int(p) for p in pads]
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        self.rows_per_shard = int(rows_per_shard)

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def gather(self) -> torch.Tensor:
        """This process's shards with their padding rows, concatenated on
        the CPU (the whole padded array in a single process)."""
        parts = []
        for t, pad in zip(self.shards, self.pads):
            t = t.cpu()
            parts.append(t)
            if pad:
                parts.append(torch.zeros((pad,) + tuple(t.shape[1:]),
                                         dtype=t.dtype))
        return torch.cat(parts)

    def __repr__(self):
        return (f"ShardedRows(shape={self.shape}, dtype={self.dtype}, "
                f"shards={len(self.shards)}, pads={self.pads})")


class ShardedBatch(NamedTuple):
    """A mesh-placed (X, y, mask) triple.  Pass the whole object to
    ``make_dist_smooth`` or an entry point: the mask travels with the
    data it pads.  ``X`` is a :class:`ShardedRows` or a
    :class:`~spark_agd_tpu_torch.ops.sparse.RowShardedCSR`; ``mask`` is
    None when no padding was needed and the caller gave none."""

    X: Any
    y: Any
    mask: Optional[Any]


def shard_spans(mesh: Mesh, n: int, rows: Optional[int] = None,
                axis: str = DATA_AXIS):
    """``(rows_per_shard, [(start, stop)...])``: the real rows of each of
    this process's slots when ``n`` rows, padded to ``rows`` (default
    ``n``), are split evenly over ``axis`` (``shard_batch``'s layout; the
    rows past ``n`` are padding, which is not stored)."""
    from . import multihost

    rows = n if rows is None else max(int(rows), n)
    k, k_local = mesh.shape[axis], mesh.local_shape[axis]
    rank = multihost.process_index() if mesh.process_count > 1 else 0
    rps = -(-rows // k) if rows else 0
    spans = [(min(g * rps, n), min((g + 1) * rps, n))
             for g in range(rank * k_local, (rank + 1) * k_local)]
    return rps, spans


def shard_batch(mesh: Mesh, X, y, mask=None,
                axis: str = DATA_AXIS) -> ShardedBatch:
    """Shard (X, y) rows over ``axis``, padded to an even split.

    Shard i takes the rows JAX gives it (``shard_batch``'s even split,
    the tail padded with zero rows of mask 0, which the losses exclude
    from every sum), as views of X: a tensor already on the slot's
    device is not copied, and a host array is copied once, a shard to
    its slot.  Every process passes the same full arrays and keeps its
    own slots' rows.  Returns a :class:`ShardedBatch` whose ``mask`` is
    None when no padding was needed and the caller passed none."""
    if isinstance(X, CSRMatrix):
        return shard_csr_batch(mesh, X, y, mask, axis=axis)
    check_data_mesh(mesh, axis)
    Xt, yt = host_tensor(X), host_tensor(y)
    mt = None if mask is None else host_tensor(mask)
    n = Xt.shape[0]
    rps, spans = shard_spans(mesh, n, axis=axis)
    k = mesh.shape[axis]
    padded = rps * k != n
    xs, ys, ms = [], [], []
    for dev, (a, b) in zip(mesh.slots(), spans):
        xs.append(Xt[a:b].to(dev))
        ys.append(yt[a:b].to(dev))
        if mt is not None:
            ms.append(mt[a:b].to(dev, torch.float32))
        elif padded:
            ms.append(torch.ones(b - a, dtype=torch.float32, device=dev))
    return sharded_rows_batch(mesh, xs, ys, ms or None, spans, rps, k,
                              Xt.shape[1:], yt.shape[1:])


def sharded_rows_batch(mesh: Mesh, xs, ys, ms, spans, rps: int, k: int,
                       x_tail, y_tail) -> ShardedBatch:
    """The :class:`ShardedBatch` of one dense shard a slot (``ms`` None
    when no mask is needed) over ``k`` shards in all, each slot's
    ``(start, stop)`` in ``spans`` and its padding rows up to ``rps`` not
    stored; ``x_tail`` and ``y_tail`` are X's and y's dimensions past the
    rows."""
    pads = [rps - (b - a) for a, b in spans]
    rows = rps * k
    return ShardedBatch(
        ShardedRows(xs, pads, mesh, (rows,) + tuple(x_tail), rps),
        ShardedRows(ys, pads, mesh, (rows,) + tuple(y_tail), rps),
        None if ms is None else ShardedRows(ms, pads, mesh, (rows,), rps))


class ShardedCols:
    """The columns of a dense X split over a mesh's model axis, one tensor
    a model slot of this process (counterpart of an X placed
    ``P(None, "model")``).

    The width pads with zero columns to an even split of ``cols_per_shard``
    a slot, as JAX pads it; ``shards[i]`` holds slot i's real columns (a
    view of X where X lay on the slot's device already) and ``pads[i]``
    counts its zero columns, which add nothing to any product and are not
    stored.  ``shape`` is the padded ``(n, d_pad)``."""

    def __init__(self, shards, pads, mesh: Mesh, shape, cols_per_shard,
                 axis: str = MODEL_AXIS):
        self.shards = list(shards)
        self.pads = [int(p) for p in pads]
        self.mesh = mesh
        self.shape = tuple(int(v) for v in shape)
        self.cols_per_shard = int(cols_per_shard)
        self.axis = axis

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return 2

    def gather(self) -> torch.Tensor:
        """The whole padded X on the CPU."""
        parts = []
        for t, pad in zip(self.shards, self.pads):
            parts.append(t.cpu())
            if pad:
                parts.append(torch.zeros((t.shape[0], pad), dtype=t.dtype))
        return torch.cat(parts, dim=1)

    def __repr__(self):
        return (f"ShardedCols(shape={self.shape}, dtype={self.dtype}, "
                f"shards={len(self.shards)}, pads={self.pads})")


def shard_batch_by_features(mesh: Mesh, X, y, mask=None,
                            axis: str = MODEL_AXIS) -> ShardedBatch:
    """Shard a dense batch's feature columns over ``axis`` (dense D-axis
    parallelism, the dense twin of ``feature_sharded``'s CSR layout).

    Columns pad with zeros to an even split (not stored:
    :class:`ShardedCols`); y and the mask stay whole on the mesh's lead
    device.  Consume with ``make_dist_smooth(..., mode="auto")`` and
    weights placed by :func:`shard_weights_by_features`, which zero-pads
    them to the batch's width: a pad column is inert only while its
    weight is zero (its gradient is zero, and every prox of ``ops.prox``
    keeps 0 at 0)."""
    if isinstance(X, CSRMatrix):
        raise ValueError(
            "shard_batch_by_features is the DENSE D-axis layout; for "
            "sparse data use parallel.feature_sharded."
            "shard_csr_by_columns")
    check_mesh(mesh)
    if axis not in mesh.shape:
        raise ValueError(f"the mesh has no {axis!r} axis: {mesh}")
    if mesh.process_count > 1:
        raise ValueError("shard_batch_by_features lays out one process's "
                         "slots; the model axis does not span processes")
    Xt = host_tensor(X)
    if Xt.dim() != 2:
        raise ValueError(f"X must be 2-D; got shape {tuple(Xt.shape)}")
    n, d = Xt.shape
    k = mesh.shape[axis]
    cps = -(-d // k)
    xs, pads = [], []
    for i, dev in enumerate(mesh.axis_slots(axis)):
        a, b = min(i * cps, d), min((i + 1) * cps, d)
        xs.append(Xt[:, a:b].to(dev))
        pads.append(cps - (b - a))
    lead = mesh.lead
    yt = host_tensor(y).to(lead)
    mt = None if mask is None else host_tensor(mask).to(lead,
                                                         torch.float32)
    return ShardedBatch(ShardedCols(xs, pads, mesh, (n, cps * k), cps,
                                    axis), yt, mt)


def shard_weights_by_features(w, batch: ShardedBatch, mesh: Mesh,
                              axis: str = MODEL_AXIS) -> torch.Tensor:
    """A (D,) (or (D, K)) weight array for a
    :func:`shard_batch_by_features` batch: zero-padded to the batch's
    padded width, on the mesh's lead device, where the optimizer's carry
    lives (each evaluation hands every model slot its rows of it).
    Invert with :func:`unshard_weights_by_features`."""
    wt = host_tensor(w)
    d_pad = batch.X.shape[1]
    if wt.shape[0] > d_pad:
        raise ValueError(f"weights width {wt.shape[0]} exceeds the "
                         f"batch's padded feature width {d_pad}")
    wp = torch.zeros((d_pad,) + tuple(wt.shape[1:]), dtype=wt.dtype)
    wp[:wt.shape[0]] = wt
    return wp.to(mesh.lead)


def unshard_weights_by_features(w_sharded, d: int) -> np.ndarray:
    """The unpadded (d, ...) weights of a D-padded state (the pad tail is
    exact zeros by the inert-column contract)."""
    a = w_sharded.detach().cpu().numpy() \
        if isinstance(w_sharded, torch.Tensor) else np.asarray(w_sharded)
    return a[:d]


def _values_numpy(values: torch.Tensor) -> np.ndarray:
    """CSR values on the host; bf16 by its bits (int16), so the layout
    copies them exactly."""
    v = values.detach().cpu()
    if v.dtype == torch.bfloat16:
        return v.view(torch.int16).numpy()
    return v.numpy()


def csr_batch_layout(mesh: Mesh, X: CSRMatrix, y, mask=None,
                     axis: str = DATA_AXIS,
                     nnz_per_shard: Optional[int] = None, *,
                     extras: Optional[Dict[str, Any]] = None,
                     extras_fill=-1) -> dict:
    """The host half of :func:`shard_csr_batch`: the per-shard layout of
    one process's CSR batch (:func:`csr_shard_layout`) in numpy, before
    any of it is placed on a slot."""
    check_data_mesh(mesh, axis)
    n_rows, n_features = X.shape
    if n_rows == 0:
        raise ValueError("cannot shard an empty CSR batch")
    if mesh.process_count > 1:
        raise ValueError(
            "shard_csr_batch lays out one process's rows; across processes "
            "use data.ingest.from_partitioned_files_csr")
    row_ids = X.row_ids.cpu().numpy()
    col_ids = X.col_ids.cpu().numpy()
    values = _values_numpy(X.values)
    if nnz_per_shard is not None:
        # streamed batches arrive padded with inert 0.0 entries piled onto
        # the last row slot: dropped before balancing (each shard re-pads
        # to the budget), or they would pose as one enormous row
        keep = values != 0
        if not keep.all():
            row_ids, col_ids, values = (row_ids[keep], col_ids[keep],
                                        values[keep])
    y_np = host_tensor(y).cpu().numpy() if isinstance(y, torch.Tensor) \
        else np.asarray(y)
    m_np = None if mask is None else (
        mask.cpu().numpy() if isinstance(mask, torch.Tensor)
        else np.asarray(mask))
    return csr_shard_layout(
        row_ids, col_ids, values, y_np, m_np, n_rows, n_features,
        mesh.shape[axis], with_csc=X.has_csc or X.want_csc,
        nnz_per_shard=nnz_per_shard, extras=extras,
        extras_fill=extras_fill)


def shard_csr_batch(mesh: Mesh, X: CSRMatrix, y, mask=None,
                    axis: str = DATA_AXIS,
                    nnz_per_shard: Optional[int] = None,
                    extras: Optional[Dict[str, Any]] = None,
                    extras_fill=-1):
    """Shard a CSR batch's rows over the mesh ``axis`` (sparse DP).

    The layout is JAX's (:func:`csr_shard_layout`, computed on the host):
    rows assigned nnz-balanced (heaviest row onto the lightest shard);
    each shard's entries re-indexed to local row ids, sorted by local row
    and padded to one common entry count with inert 0.0 entries; row
    slots past a shard's real rows carry mask 0.  Each shard becomes a
    local ``CSRMatrix`` on its slot's device.  ``nnz_per_shard`` pins the
    padded entry count (the streamed path's fixed budget; a batch that
    cannot fit raises ``ValueError``).

    ``extras``: per-row arrays (each ``(n_rows, ...)``, in the input row
    order) carried through the balancer's row permutation beside ``y``,
    e.g. cross-validation fold ids.  Then the return is ``(ShardedBatch,
    placed)``, each placed extra a :class:`ShardedRows` laid out as the
    batch's ``y``; padding slots read ``extras_fill``."""
    lay = csr_batch_layout(mesh, X, y, mask, axis, nnz_per_shard,
                           extras=extras, extras_fill=extras_fill)
    batch = place_csr_layout(lay, mesh, axis, X.shape[0], X.shape[1],
                             values_dtype=X.values.dtype)
    if extras is None:
        return batch
    rps, k = lay["rps"], lay["R"].shape[0]
    placed = {}
    for name in extras:
        e = torch.from_numpy(np.ascontiguousarray(lay["E_" + name]))
        placed[name] = ShardedRows(
            [e[s].to(dev) for s, dev in enumerate(mesh.slots())],
            [0] * k, mesh, (k * rps,) + tuple(e.shape[2:]), rps)
    return batch, placed


def csr_shard_layout(row_ids, col_ids, values, y, mask, n_rows: int,
                     n_features: int, n_shards: int, *,
                     with_csc: bool = False,
                     nnz_per_shard: Optional[int] = None,
                     reduce_max=None,
                     extras: Optional[Dict[str, Any]] = None,
                     extras_fill=-1) -> dict:
    """Host (numpy) construction of the per-shard CSR layout: the core of
    :func:`shard_csr_batch`, shared with multi-process ingest
    (``data.ingest.from_partitioned_files_csr``), which builds each
    process's local shards with dimensions agreed across processes.

    ``reduce_max(int) -> int`` equalizes the two cross-process dimensions
    (rows a shard before balancing, padded entries a shard after): an
    allgather-max across processes, identity (default) in one.  Returns
    ``dict(R, C, V[, Rc, Cc, Vc], Y, M, rps, nnz_shard)`` with 2-D
    ``(n_shards, ...)`` arrays, and ``E_<name>`` ``(n_shards, rps,
    ...)`` for each of ``extras`` (per-row arrays in the input row order,
    scattered as ``y`` is; padding slots ``extras_fill``).  The same code
    as the JAX package's with its default ``balance=True``, so the same
    arrays."""
    extras = {name: np.asarray(a) for name, a in (extras or {}).items()}
    for name, arr in extras.items():
        # before the balance, sort and pad: a wrong length fails free
        if arr.shape[:1] != (n_rows,):
            raise ValueError(
                f"extras[{name!r}] has "
                f"{arr.shape[0] if arr.ndim else 0} rows, expected "
                f"{n_rows}")
    red = reduce_max or (lambda v: int(v))
    rps = red(max(1, -(-n_rows // n_shards) if n_rows else 1))

    if n_rows:
        # heaviest row onto the lightest shard with room left: bounds the
        # padded entries a shard near max(heaviest row, total / n_shards);
        # C++ core with a bit-identical Python loop
        counts = np.bincount(row_ids, minlength=n_rows)
        shard_of_row, local_of_row = native.greedy_balance(
            counts, n_shards, rps)
    else:  # a process with no partitions still takes part in the layout
        shard_of_row = np.zeros(0, np.int64)
        local_of_row = np.zeros(0, np.int64)

    e_shard = shard_of_row[row_ids]
    e_local = local_of_row[row_ids].astype(np.int32)
    eorder = np.argsort(e_shard, kind="stable")
    shard_sorted = e_shard[eorder]
    starts = np.searchsorted(shard_sorted, np.arange(n_shards))
    ends = np.searchsorted(shard_sorted, np.arange(n_shards), side="right")
    nnz_needed = max(int((ends - starts).max()) if len(values) else 1, 1)
    if nnz_per_shard is not None:
        if nnz_needed > nnz_per_shard:
            raise ValueError(
                f"a shard holds {nnz_needed} entries > nnz_per_shard="
                f"{nnz_per_shard}; raise the budget (streaming callers: "
                f"make_streaming_smooth's csr_nnz_per_shard: one shape "
                f"must fit every macro-batch)")
        nnz_shard = int(nnz_per_shard)
    else:
        nnz_shard = red(nnz_needed)

    # padding entries point at the last local row and column with value
    # 0.0, so each shard's ids stay nondecreasing
    R = np.full((n_shards, nnz_shard), rps - 1, np.int32)
    C = np.zeros((n_shards, nnz_shard), np.int32)
    V = np.zeros((n_shards, nnz_shard), values.dtype)
    out = dict(R=R, C=C, V=V, rps=rps, nnz_shard=nnz_shard)
    if with_csc:
        Rc = np.zeros((n_shards, nnz_shard), np.int32)
        Cc = np.full((n_shards, nnz_shard), n_features - 1, np.int32)
        Vc = np.zeros((n_shards, nnz_shard), values.dtype)
        out.update(Rc=Rc, Cc=Cc, Vc=Vc)
    for s in range(n_shards):
        sel = eorder[starts[s]:ends[s]]
        sel_r = sel[np.argsort(e_local[sel], kind="stable")]
        k = len(sel)
        R[s, :k] = e_local[sel_r]
        C[s, :k] = col_ids[sel_r]
        V[s, :k] = values[sel_r]
        if with_csc:  # the column-sorted twin of the same entries
            sel_c = sel[np.argsort(col_ids[sel], kind="stable")]
            Rc[s, :k] = e_local[sel_c]
            Cc[s, :k] = col_ids[sel_c]
            Vc[s, :k] = values[sel_c]

    Y = np.zeros((n_shards, rps), y.dtype if n_rows else np.float32)
    M = np.zeros((n_shards, rps), np.float32)
    if n_rows:
        Y[shard_of_row, local_of_row] = y
        M[shard_of_row, local_of_row] = (
            np.ones(n_rows, np.float32) if mask is None
            else np.asarray(mask, np.float32))
    out.update(Y=Y, M=M)
    for name, arr in extras.items():
        E = np.full((n_shards, rps) + arr.shape[1:], extras_fill,
                    arr.dtype)
        if n_rows:
            E[shard_of_row, local_of_row] = arr
        out["E_" + name] = E
    return out


def _values_from_numpy(v: np.ndarray, dtype) -> torch.Tensor:
    """The inverse of :func:`_values_numpy`."""
    t = torch.from_numpy(np.ascontiguousarray(v))
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


# the stacked (n_shards, ...) arrays of a layout, in the order a placer
# copies them: the entries, the twin's where there is one, labels, mask
CSR_LAYOUT_LEAVES = ("R", "C", "V", "Rc", "Cc", "Vc", "Y", "M")


def csr_layout_tensors(lay: dict, values_dtype=None) -> dict:
    """The layout's stacked arrays as CPU tensors, without a copy (the
    values in ``values_dtype``, bf16 by its bits)."""
    out = {}
    for name in CSR_LAYOUT_LEAVES:
        if name in lay:
            a = lay[name]
            out[name] = (_values_from_numpy(a, values_dtype)
                         if name in ("V", "Vc")
                         else torch.from_numpy(np.ascontiguousarray(a)))
    return out


def csr_batch_of_shards(per_slot: dict, mesh: Mesh, n_rows: int,
                        n_features: int, rps: int,
                        n_shards: Optional[int] = None) -> ShardedBatch:
    """The :class:`ShardedBatch` of placed layout leaves: ``per_slot``
    maps each name of :data:`CSR_LAYOUT_LEAVES` present to one tensor a
    slot of this process, on the slot's device."""
    slots = mesh.slots()
    shards = []
    for s in range(len(slots)):
        csc = {}
        if "Rc" in per_slot:
            csc = dict(csc_row_ids=per_slot["Rc"][s],
                       csc_col_ids=per_slot["Cc"][s],
                       csc_values=per_slot["Vc"][s])
        shards.append(CSRMatrix(per_slot["R"][s], per_slot["C"][s],
                                per_slot["V"][s], (rps, n_features),
                                rows_sorted=True, **csc))
    k = n_shards if n_shards is not None else len(slots)
    Xs = RowShardedCSR(shards, (n_rows, n_features), rps, k, mesh=mesh)
    pads = [0] * len(slots)
    return ShardedBatch(
        Xs, ShardedRows(per_slot["Y"], pads, mesh, (k * rps,), rps),
        ShardedRows(per_slot["M"], pads, mesh, (k * rps,), rps))


def place_csr_layout(lay: dict, mesh: Mesh, axis: str, n_rows: int,
                     n_features: int, *, n_shards: Optional[int] = None,
                     values_dtype=None) -> ShardedBatch:
    """Place a :func:`csr_shard_layout` result: shard s of the layout
    becomes a local ``CSRMatrix`` (rows_per_shard, D) on this process's
    slot s, with its twin where the layout has one.  ``n_shards`` is the
    global count (default: the layout's)."""
    slots = mesh.slots()
    if lay["R"].shape[0] != len(slots):
        raise ValueError(f"the layout has {lay['R'].shape[0]} shards, the "
                         f"mesh {len(slots)} slots in this process")
    per_slot = {name: [t[s].to(dev) for s, dev in enumerate(slots)]
                for name, t in csr_layout_tensors(lay, values_dtype).items()}
    return csr_batch_of_shards(per_slot, mesh, n_rows, n_features,
                               lay["rps"], n_shards)
