"""Meshes across processes over ``torch.distributed``.

Counterpart of ``spark_agd_tpu/parallel/multihost.py``.  The JAX package
joins a ``jax.distributed`` job, after which every process runs the same
program over a mesh of global devices.  Here a process joins a
``torch.distributed`` process group (:func:`initialize`), and a mesh's
``data`` axis may span the group's ranks: each rank holds the slots of its
own block of the axis (:func:`make_hybrid_mesh`, or ``mesh.make_mesh``
once the group exists).  ``parallel.dist_smooth`` then adds the slots'
sums in the process and joins the ranks' sums with one collective, every
rank adding them in rank order, so every rank holds the same bits and
takes the same backtrack, restart and stop branches: the reference's
"every host executes the same program".

Single-process runs (tests, one card) need none of it: the helpers fall
back to one rank, so code written against this module runs unchanged.
``parallel/shmap.py`` of the JAX package (a JAX version shim) has no
counterpart.
"""

from __future__ import annotations

import datetime
import math
import os
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from . import mesh as mesh_lib

# every collective of a group made by initialize() gives up after this
# long: a rank that took another branch must not hang the others forever
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    """True when this process is in a ``torch.distributed`` group."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The ranks of the default group (1 without one)."""
    return _dist().get_world_size() if is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return _dist().get_rank() if is_initialized() else 0


def launcher_markers() -> list:
    """Environment markers saying this process is part of a multi-process
    launch: the JAX package's (a coordinator address, SLURM, MPI, several
    TPU workers) and torchrun's (``WORLD_SIZE`` above 1 beside ``RANK``,
    ``TORCHELASTIC_RUN_ID``).  In such a launch a process that skipped
    :func:`initialize` would run one independent fit of N, wrong results
    and no error, so :func:`check_launch` raises there."""
    env = os.environ
    found = []
    for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
              "MEGASCALE_COORDINATOR_ADDRESS"):
        if env.get(k):
            found.append(k)
    hosts = [h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",")
             if h.strip()]
    if len(hosts) > 1:
        found.append("TPU_WORKER_HOSTNAMES")
    # only launcher-owned variables: NPROC, a common name for a core
    # count, is not one
    for k in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"):
        v = env.get(k, "")
        if v.isdigit() and int(v) > 1:
            found.append(k)
    world = env.get("WORLD_SIZE", "")
    if world.isdigit() and int(world) > 1 and env.get("RANK"):
        found.append("WORLD_SIZE")
    if env.get("TORCHELASTIC_RUN_ID") and not (world.isdigit()
                                               and int(world) <= 1):
        found.append("TORCHELASTIC_RUN_ID")
    return found


def check_launch() -> None:
    """Raise when a multi-process launch is detected
    (:func:`launcher_markers`) but this process has joined no group: the
    mesh it is about to build would hold one process's devices alone."""
    if is_initialized():
        return
    markers = launcher_markers()
    if markers:
        raise RuntimeError(
            "multi-process launcher environment detected "
            f"({', '.join(markers)}) but this process has not joined a "
            "process group; call parallel.multihost.initialize() at "
            "program start")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None, device=None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the process group (idempotent).

    Explicit arguments (``"host:port"``, the rank count, this rank) form
    a group over TCP; with none, a launcher's environment (torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``) forms it; in
    a single process with neither, there is nothing to join and the call
    returns.  ``backend`` is torch's: NCCL for a CUDA device and gloo for
    the CPU when not given (``device``, default the current CUDA device
    where there is one, or ``LOCAL_RANK``'s under torchrun, becomes the
    current device).  Two ranks on one card need ``backend="gloo"``:
    NCCL refuses them.  ``timeout`` bounds every collective of the group.
    A group that cannot be formed raises: a run that asked for several
    processes must not degrade to independent ones."""
    if is_initialized():
        return  # a second call
    explicit = any(a is not None for a in (coordinator_address,
                                           num_processes, process_id))
    markers = launcher_markers()
    if not explicit and not markers:
        return  # one process: nothing to join
    env = os.environ
    if explicit:
        if coordinator_address is None:
            raise ValueError("initialize: coordinator_address is required "
                             "with num_processes / process_id")
        world = int(num_processes if num_processes is not None
                    else env.get("WORLD_SIZE", 0))
        rank = int(process_id if process_id is not None
                   else env.get("RANK", -1))
        if world < 1 or not 0 <= rank < world:
            raise ValueError(f"initialize: rank {rank} of {world} "
                             f"processes")
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=world, rank=rank)
    else:
        init = dict(init_method="env://")
    if device is None and torch.cuda.is_available():
        local = env.get("LOCAL_RANK", "")
        device = (torch.device("cuda", int(local)) if local.isdigit()
                  else torch.device("cuda", torch.cuda.current_device()))
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev is not None and dev.type == "cuda" \
            else "gloo"
    dist = _dist()
    try:
        dist.init_process_group(backend=backend, timeout=timeout, **init)
    except Exception as e:  # noqa: BLE001 — re-raised, named
        where = (f"explicit arguments ({coordinator_address}, "
                 f"{num_processes}, {process_id})" if explicit else
                 f"multi-process launcher environment detected "
                 f"({', '.join(markers)})")
        raise RuntimeError(
            f"torch.distributed.init_process_group({backend!r}) failed "
            f"for {where}: {type(e).__name__}: {e}") from e


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if is_initialized():
        _dist().destroy_process_group()


def make_hybrid_mesh(ici_axes: Dict[str, int],
                     dcn_axes: Optional[Dict[str, int]] = None, *,
                     devices=None) -> "mesh_lib.Mesh":
    """A mesh whose axis sizes are ``ici * dcn``: the ICI factor maps to
    this process's local devices (its slots), the DCN factor to the
    processes of the group, so the slots of one process are contiguous
    on each axis and the heavy combine runs within the process.  In a
    single process (or with no DCN factor) it is a plain ``make_mesh`` of
    the same axis names and sizes, as the JAX package falls back without
    slice structure, so calling code never branches.  ``devices``: this
    process's devices (default ``mesh.default_devices()``; name the CPU's
    slots here)."""
    check_launch()
    dcn_axes = dcn_axes or {}
    names = list(dict.fromkeys(list(ici_axes) + list(dcn_axes)))
    ici = [int(ici_axes.get(n, 1)) for n in names]
    dcn = [int(dcn_axes.get(n, 1)) for n in names]
    world = process_count()
    if world <= 1:
        return mesh_lib.make_mesh({n: i * d for n, i, d in
                                   zip(names, ici, dcn)}, devices=devices)
    if math.prod(dcn) != world:
        raise ValueError(f"dcn axes {dcn_axes} make {math.prod(dcn)} "
                         f"processes; the group has {world}")
    local = (list(devices) if devices is not None
             else mesh_lib.default_devices())
    need = math.prod(ici)
    if need > len(local):
        raise ValueError(f"ici axes {ici_axes} need {need} devices, this "
                         f"process has {len(local)}")
    return mesh_lib.Mesh(
        mesh_lib._as_devices(local[:need]).reshape(ici), names,
        processes=dict(zip(names, dcn)), in_group=True)


def is_primary_host() -> bool:
    """True on the one process that owns singleton side effects (rank 0);
    trivially true in a single process."""
    return process_index() == 0


def process_tag() -> str:
    """A short per-process tag for file names: ``""`` in a single process,
    ``"h003"``-style in a group."""
    if process_count() <= 1:
        return ""
    return f"h{process_index():03d}"


def host_suffixed(path: str) -> str:
    """``path`` with this process's tag before the extension
    (``run.jsonl`` -> ``run.h003.jsonl``); identity in a single
    process."""
    tag = process_tag()
    if not tag:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.{tag}{ext}"


def local_rows_slice(n_rows: int, process_index: int,
                     process_count: int) -> slice:
    """The row range process ``process_index`` of ``process_count`` owns
    (ceil-divided blocks; the last may be short).  A pure function of its
    arguments."""
    per = -(-n_rows // process_count)
    return slice(process_index * per,
                 min((process_index + 1) * per, n_rows))


def rank_among(members, process_index: int) -> int:
    """This process's rank within an explicit member list (sorted
    original process indices): the re-indexing a degraded continuation
    needs.  A pure function."""
    members = sorted(int(p) for p in members)
    try:
        return members.index(int(process_index))
    except ValueError:
        raise ValueError(
            f"process {process_index} is not among {members}") from None


def process_local_rows(n_rows: int) -> slice:
    """The row range this process should load."""
    return local_rows_slice(n_rows, process_index(), process_count())


def _collective_device(group=None) -> torch.device:
    """Where a collective's tensors must lie: the current CUDA device for
    an NCCL group, the CPU otherwise (gloo carries CUDA tensors through
    the host: the port copies them there itself)."""
    if _dist().get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# The collectives this process has issued since import or the last
# reset_census(): kind -> {"count", "bytes", "max_bytes"}, bytes as this
# rank sent them.  Kinds: "scalars" (control scalars and row counts, an
# all-gather of a few bytes added in rank order: the JAX package's
# scalar psums), "sums" (a replicated combine's packed loss, gradient
# and count, the same: JAX's all-reduce of the gradient), "all-gather"
# (all_gather_flat: the sharded update's weights) and "reduce-scatter"
# (reduce_scatter_flat: its gradient).
census: Dict[str, Dict[str, int]] = {}


def reset_census() -> None:
    census.clear()


def _count_collective(kind: str, nbytes: int) -> None:
    c = census.setdefault(kind, {"count": 0, "bytes": 0, "max_bytes": 0})
    c["count"] += 1
    c["bytes"] += int(nbytes)
    c["max_bytes"] = max(c["max_bytes"], int(nbytes))


def all_gather_bytes(t: torch.Tensor, group=None,
                     kind: str = "scalars") -> list:
    """Every rank's copy of the uint8 tensor ``t`` (one shape on every
    rank), in rank order, on ``t``'s device; counted in :data:`census`
    under ``kind``."""
    dist = _dist()
    dev = _collective_device(group)
    src = t.to(dev)
    out = [torch.empty_like(src)
           for _ in range(dist.get_world_size(group))]
    _count_collective(kind, src.numel())
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


def all_gather_flat(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's 1-D ``t`` (one length on every rank) concatenated in
    rank order (``all_gather_into_tensor``), on ``t``'s device."""
    dist = _dist()
    dev = _collective_device(group)
    src = t.contiguous().to(dev)
    out = torch.empty(src.numel() * dist.get_world_size(group),
                      dtype=src.dtype, device=dev)
    _count_collective("all-gather", src.numel() * src.element_size())
    with warnings.catch_warnings():
        # newer torch names it all_gather_single; the card's has this name
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, src, group=group)
    return out.to(t.device)


def reduce_scatter_flat(t: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's chunk of the ranks' sum of the 1-D ``t`` (one length, a
    multiple of the group's size, on every rank): chunk ``rank`` of
    ``world`` equal chunks (``reduce_scatter_tensor``), on ``t``'s
    device.  Only this rank holds its chunk, so no other rank needs the
    same bits of it."""
    dist = _dist()
    world = dist.get_world_size(group)
    if t.numel() % world:
        raise ValueError(f"reduce_scatter_flat: {t.numel()} elements do "
                         f"not split over {world} ranks")
    dev = _collective_device(group)
    src = t.contiguous().to(dev)
    out = torch.empty(src.numel() // world, dtype=src.dtype, device=dev)
    _count_collective("reduce-scatter", src.numel() * src.element_size())
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(t.device)


def process_allgather_int64(values) -> np.ndarray:
    """Allgather one small row of non-negative int64s a process -> a
    ``(process_count, k)`` array, row ``p`` from process ``p``; a barrier
    too.  A single process returns ``values[None, :]`` without any
    collective."""
    row = np.atleast_1d(np.asarray(values, np.int64))
    if (row < 0).any():
        raise ValueError("process_allgather_int64 carries non-negative "
                         f"values only, got {row}")
    if process_count() <= 1:
        return row[None, :]
    t = torch.from_numpy(row.copy()).view(torch.uint8)
    parts = all_gather_bytes(t)
    return np.stack([p.cpu().view(torch.int64).numpy() for p in parts])
