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
materializes.  A mesh with another axis than ``data`` larger than one
(tensor parallelism), and the feature-sharded layouts, come with a later
slice and raise.
"""

from __future__ import annotations

import math
import warnings
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import native
from .._later import reject_a8
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

    def slots(self) -> list:
        """This process's slots in the order of the data axis."""
        return list(self.devices.reshape(-1))

    def __eq__(self, other):
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and self.slots() == other.slots()
                and self.processes == other.processes
                and self.in_group == other.in_group)

    def __hash__(self):
        return hash((self.axis_names, tuple(map(str, self.slots())),
                     tuple(sorted(self.processes.items()))))

    def __repr__(self):
        extra = f", processes={self.processes}" if self.processes else ""
        return (f"Mesh({dict(self.shape)}, slots="
                f"{[str(d) for d in self.slots()]}{extra})")


def check_data_mesh(mesh: Mesh, axis: str = DATA_AXIS) -> Mesh:
    """``mesh`` when it is a data-parallel mesh this slice runs: a
    :class:`Mesh` whose axes other than ``axis`` have size 1.  A
    ``model`` axis (tensor parallelism) raises ``NotImplementedError``
    naming the slice that brings it; anything that is not a ``Mesh``
    raises ``TypeError``."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh= takes a spark_agd_tpu_torch.parallel.mesh.Mesh, None "
            f"or False; got {type(mesh).__name__}")
    if axis not in mesh.shape:
        raise ValueError(f"the mesh has no {axis!r} axis: {mesh}")
    others = {n: s for n, s in mesh.shape.items() if n != axis and s > 1}
    if others:
        reject_a8("model_axis", f"a mesh with the axes {others} beside "
                                f"{axis!r}")
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


def shard_batch_by_features(mesh: Mesh, X, y, mask=None,
                            axis: str = MODEL_AXIS):
    """The dense D-axis layout (JAX ``mesh.py:103``): comes with the
    tensor-parallel slice and raises."""
    reject_a8("feature_sharding", "shard_batch_by_features")


def shard_weights_by_features(w, batch, mesh: Mesh, axis: str = MODEL_AXIS):
    """Comes with the tensor-parallel slice and raises."""
    reject_a8("feature_sharding", "shard_weights_by_features")


def unshard_weights_by_features(w_sharded, d: int):
    """Comes with the tensor-parallel slice and raises."""
    reject_a8("feature_sharding", "unshard_weights_by_features")


def _values_numpy(values: torch.Tensor) -> np.ndarray:
    """CSR values on the host; bf16 by its bits (int16), so the layout
    copies them exactly."""
    v = values.detach().cpu()
    if v.dtype == torch.bfloat16:
        return v.view(torch.int16).numpy()
    return v.numpy()


def csr_batch_layout(mesh: Mesh, X: CSRMatrix, y, mask=None,
                     axis: str = DATA_AXIS,
                     nnz_per_shard: Optional[int] = None) -> dict:
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
        nnz_per_shard=nnz_per_shard)


def shard_csr_batch(mesh: Mesh, X: CSRMatrix, y, mask=None,
                    axis: str = DATA_AXIS,
                    nnz_per_shard: Optional[int] = None) -> ShardedBatch:
    """Shard a CSR batch's rows over the mesh ``axis`` (sparse DP).

    The layout is JAX's (:func:`csr_shard_layout`, computed on the host):
    rows assigned nnz-balanced (heaviest row onto the lightest shard);
    each shard's entries re-indexed to local row ids, sorted by local row
    and padded to one common entry count with inert 0.0 entries; row
    slots past a shard's real rows carry mask 0.  Each shard becomes a
    local ``CSRMatrix`` on its slot's device.  ``nnz_per_shard`` pins the
    padded entry count (the streamed path's fixed budget; a batch that
    cannot fit raises ``ValueError``)."""
    lay = csr_batch_layout(mesh, X, y, mask, axis, nnz_per_shard)
    return place_csr_layout(lay, mesh, axis, X.shape[0], X.shape[1],
                            values_dtype=X.values.dtype)


def csr_shard_layout(row_ids, col_ids, values, y, mask, n_rows: int,
                     n_features: int, n_shards: int, *,
                     with_csc: bool = False,
                     nnz_per_shard: Optional[int] = None,
                     reduce_max=None) -> dict:
    """Host (numpy) construction of the per-shard CSR layout: the core of
    :func:`shard_csr_batch`, shared with multi-process ingest
    (``data.ingest.from_partitioned_files_csr``), which builds each
    process's local shards with dimensions agreed across processes.

    ``reduce_max(int) -> int`` equalizes the two cross-process dimensions
    (rows a shard before balancing, padded entries a shard after): an
    allgather-max across processes, identity (default) in one.  Returns
    ``dict(R, C, V[, Rc, Cc, Vc], Y, M, rps, nnz_shard)`` with 2-D
    ``(n_shards, ...)`` arrays.  The same code as the JAX package's with
    its default ``balance=True``, so the same arrays."""
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
