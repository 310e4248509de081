"""Fused GLM loss+gradient kernels: one read of X per smooth evaluation.

Counterpart of ``spark_agd_tpu/ops/pallas_kernels.py``.  The smooth
evaluation is bound by device-memory bandwidth, and two library products
(``X @ w`` then ``X.T @ mult``) read the (N, D) data matrix twice.  The
CUDA kernels keep each row tile in shared memory (or, for narrow X, each
row in registers) between the two products and reduce per-block
partials in a fixed order, so X is read once and the result is
deterministic:

- ``csrc/margin_loss_grad.cu``: logistic, least-squares and hinge losses
  (the margin half).  :func:`fused_margin_loss_grad` is its wrapper,
  :func:`fused_margin_loss_grad_reference` its plain version, and
  :class:`FusedMarginGradient` wraps a margin
  :class:`~spark_agd_tpu_torch.ops.losses.MarginGradient` (counterpart of
  ``PallasMarginGradient``).  It takes X of every width:
  :func:`launch_shape` picks a register mode for narrow X, a mode that
  streams rows through whole warps up to :func:`warp_rows_max_width`
  columns (:func:`warp_rows_takes`), a few rows a block in shared
  memory up to :func:`tile_max_width` columns, a mode that streams
  stages of rows through a ring in one block's shared memory up
  to :func:`max_width` columns, a mode that holds each row across the
  shared memory of a thread block cluster up to :func:`cluster_max_width`
  columns, a mode that holds it across a block on every SM, the partial
  dots swapped through L2, up to :func:`grid_max_width` columns (X still
  read once), and past that a two-pass mode that reads X twice (as the
  Pallas wrapper's fallback past its VMEM budget does).
- ``csrc/margin_lanes_loss_grad.cu``: the same three losses for K
  weight vectors at once (the lanes of a sweep; counterpart of the margin
  kernel under ``jax.vmap``, which Pallas runs as one pass of X per
  lane).  :func:`fused_margin_lanes_loss_grad` is its wrapper and
  :func:`fused_margin_lanes_loss_grad_reference` its plain version;
  ``FusedMarginGradient.lanes_loss_and_grad`` calls it.  It reads X once
  for up to :func:`max_lanes` lanes: in one block a row while the lanes'
  W fits in shared memory beside a row tile (both products on the tensor
  cores where that mode is faster), from :func:`lanes_cluster_min_width`
  across a thread block cluster, up to :func:`lanes_max_width` columns;
  twice past that, both products on the tensor cores over row tiles and
  column blocks (its two-pass mode, which the plan gives every width past
  the largest cluster that was timed faster).  More lanes run in chunks
  of :func:`max_lanes`, one launch each.
- ``csrc/softmax_loss_grad.cu``: the multinomial softmax with a (D, K)
  weight matrix.  :func:`fused_softmax_loss_grad` is its wrapper,
  :func:`fused_softmax_loss_grad_reference` its plain version, and
  :class:`FusedSoftmaxGradient` wraps a
  :class:`~spark_agd_tpu_torch.ops.losses.SoftmaxGradient` (counterpart of
  ``PallasSoftmaxGradient``).  It takes every width and class count:
  :func:`softmax_launch_shape` picks the one-read kernel where W, the
  gradient accumulator and a row tile fit shared memory (up to 32
  classes, :func:`softmax_one_read_max_width` columns), and a two-pass
  mode everywhere else (as the Pallas wrapper computes through the jnp
  loss past its VMEM budget).

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version, which computes the same function in
f32 with ``torch`` products.  ``prepare`` stages the operands once at
data-placement time, without copying a contiguous f32 or bf16 X.

Both kernels read dense X.  A :class:`~spark_agd_tpu_torch.ops.sparse.CSRMatrix`
is routed by ``prepare`` to the wrapped loss, whose products go through
``ops.sparse`` (as ``PallasMarginGradient``/``PallasSoftmaxGradient``
route CSR to the jnp losses); no kernel is launched for it.

The launch shapes and the limits come from the CUDA sources
(``margin_plan``/``margin_max_width``,
``margin_cluster_max_width``, ``margin_grid_max_width``, ``softmax_plan``/
``softmax_one_read_max_width``), which alone know the kernels'
shared-memory layouts and ask the card which clusters it schedules.

``launch_count``, ``lanes_launch_count`` and ``softmax_launch_count``
count kernel launches, so a run can show that its main path went through
the kernels; ``margin_mode_launches`` and ``lanes_mode_launches`` split
the margin kernels' counts by mode, ``softmax_mode_launches`` the
softmax kernel's.  ``FusedSoftmaxGradient`` runs its
lanes lane by lane, one softmax launch each, as Pallas batches its
kernel.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch

from . import _cuda_build
from .losses import (
    Gradient,
    HingeGradient,
    LeastSquaresGradient,
    LogisticGradient,
    MarginGradient,
    SoftmaxGradient,
    _count,
    check_layout,
)
from .sparse import CSRMatrix

_LOSS_CODES = {LogisticGradient: 0, LeastSquaresGradient: 1,
               HingeGradient: 2}
_X_TYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since import (or since a caller reset them to 0); the
# margin kernel's also by mode name (a mode not launched reads 0).
launch_count = 0
lanes_launch_count = 0
softmax_launch_count = 0
margin_mode_launches = collections.Counter()
lanes_mode_launches = collections.Counter()
softmax_mode_launches = collections.Counter()


def reset_launch_counts():
    """Set every launch count to 0."""
    global launch_count, lanes_launch_count, softmax_launch_count
    launch_count = lanes_launch_count = softmax_launch_count = 0
    margin_mode_launches.clear()
    lanes_mode_launches.clear()
    softmax_mode_launches.clear()


@dataclass(frozen=True)
class StagedDense:
    """Operands staged once for the kernel (counterpart of
    ``PaddedDense``, without padding): ``X`` (N, D) contiguous f32 or
    bf16, ``y`` and ``m`` (N,) contiguous f32 (``m`` is 0 on masked
    rows), ``n_valid`` the 0-d valid-row count."""

    X: torch.Tensor
    y: torch.Tensor
    m: torch.Tensor
    n_valid: torch.Tensor

    def masked(self, keep: torch.Tensor) -> "StagedDense":
        """The same X and y with the rows where ``keep`` is 0 masked out
        as well (a GD iteration's sample); X is not copied."""
        m = self.m * keep.to(self.m.dtype)
        return StagedDense(self.X, self.y, m, _count(self.X, m))


def _stage(X, y, mask, kernel: str, check) -> StagedDense:
    """Stage (X, y, mask) for a kernel.  A contiguous f32 or bf16 X is
    used as it is, never copied; any other dtype becomes f32.  For a CUDA
    X, ``check(d, dtype)`` raises ``ValueError`` here, before any copy,
    when the kernel cannot take it."""
    check_layout(X)
    if isinstance(X, CSRMatrix):
        raise TypeError(f"the {kernel} kernel reads dense X; a CSRMatrix "
                        f"goes through the sparse products (the fused "
                        f"gradients' prepare routes it there)")
    if X.dim() != 2:
        raise ValueError(f"the {kernel} kernel takes a 2-D X; got shape "
                         f"{tuple(X.shape)}")
    if X.is_cuda:
        check(X.shape[1], X.dtype)
    if X.dtype not in _X_TYPES:
        X = X.to(torch.float32)
    X = X.contiguous()
    n = X.shape[0]
    yf = y.to(device=X.device, dtype=torch.float32).reshape(n).contiguous()
    if mask is None:
        m = torch.ones(n, dtype=torch.float32, device=X.device)
    else:
        m = mask.to(device=X.device,
                    dtype=torch.float32).reshape(n).contiguous()
    return StagedDense(X, yf, m, _count(X, mask))


def stage_dense(X, y, mask=None) -> StagedDense:
    """Stage (X, y, mask) for the margin kernel, which takes every
    width; a CUDA X with no columns raises ``ValueError``."""
    return _stage(X, y, mask, "margin", check_width)


def stage_softmax(X, y, num_classes: int, mask=None) -> StagedDense:
    """Stage (X, labels, mask) for the softmax kernel (labels as f32
    class indices), which takes every width and class count; fewer than
    one class, or a CUDA X with no columns, raises ``ValueError``."""
    if int(num_classes) < 1:
        raise ValueError(f"fused_softmax_loss_grad: {num_classes} classes; "
                         f"the kernel takes 1 or more")
    return _stage(X, y, mask, "softmax", check_width)


def fused_margin_loss_grad_reference(gradient: MarginGradient, w,
                                     staged: StagedDense):
    """The plain version: the kernel's function in f32, with two torch
    products.  Returns ``(loss_sum, grad_sum)``, 0-d and (D,) f32."""
    X = staged.X.to(torch.float32)
    dots = X @ w.to(torch.float32)
    per, mult = gradient.dots_loss_and_mult(dots, staged.y)
    return (per * staged.m).sum(), (mult * staged.m) @ X


@functools.cache
def _device_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# The margin and softmax kernels' launch functions: (X, x_type, y, mask,
# W, n, d, the loss code or the class count, the int[] plan that
# margin_plan or softmax_plan fills, partial_loss, partial_grad, the
# scratch of the two-pass modes (the margin kernel's (N,) multipliers,
# the softmax kernel's chunk x K residuals; the margin kernel's grid mode
# its tagged partial dots; NULL otherwise), loss, grad, stream) -> CUDA
# error code.
_HEAD = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
_PLAN_ARGTYPES = _HEAD + [ctypes.POINTER(ctypes.c_int)] \
    + [ctypes.c_void_p] * 6


def _load(name: str, prefix: str, argtypes, source=None):
    """Build (at first use) and load ``csrc/<name>.cu`` (or ``source``, a
    path to another version of it), with its launch function ``<name>``
    typed by ``argtypes`` and ``<prefix>_error_string`` typed; returns
    ``(ctypes library, BuiltLibrary)``."""
    built = _cuda_build.build(name, [source or f"{name}.cu"])
    lib = ctypes.CDLL(str(built.path))
    getattr(lib, name).argtypes = argtypes
    getattr(lib, name).restype = ctypes.c_int
    getattr(lib, f"{prefix}_error_string").argtypes = [ctypes.c_int]
    getattr(lib, f"{prefix}_error_string").restype = ctypes.c_char_p
    return lib, built


def _launch(lib, name: str, prefix: str, code: int, W,
            staged: StagedDense, plan, partials, mult_rows=None):
    """Launch ``lib``'s ``name`` on the current stream with ``code`` (the
    loss code or the class count) and ``plan`` (the plan arguments, see
    ``_PLAN_ARGTYPES``).  The scratch (``partials`` = (the count of loss
    partials, the count of gradient partials, each of W's size), and
    with ``mult_rows`` the (mult_rows,) floats of the two-pass modes or
    the grid mode, NULL at 0) and the outputs, ``loss`` () and ``grad``
    shaped like W, are allocated here; raises if the launch fails."""
    X = staged.X
    n, d = X.shape
    kw = dict(dtype=torch.float32, device=X.device)
    partial_loss = torch.empty(partials[0], **kw)
    partial_grad = torch.empty(partials[1] * W.numel(), **kw)
    scratch = []
    if mult_rows is not None:
        mult = torch.empty(mult_rows, **kw)
        scratch = [mult.data_ptr() if mult_rows else None]
    loss = torch.empty((), **kw)
    grad = torch.empty(W.shape, **kw)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = getattr(lib, name)(
            X.data_ptr(), _X_TYPES[X.dtype], staged.y.data_ptr(),
            staged.m.data_ptr(), W.data_ptr(), n, d, code, *plan,
            partial_loss.data_ptr(), partial_grad.data_ptr(), *scratch,
            loss.data_ptr(), grad.data_ptr(), stream)
    if err != 0:
        message = getattr(lib, f"{prefix}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({message})")
    return loss, grad


# The margin library's functions besides its launch: (name, argument
# types, result type).  A source from before a mode lacks the functions
# that came with it.
_MARGIN_FUNCTIONS = (
    ("margin_plan", [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                     ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
     ctypes.c_int),
    ("margin_mode_name", [ctypes.c_int], ctypes.c_char_p),
    ("margin_mode_plan", [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
    ("margin_tile_max_width", [ctypes.c_int], ctypes.c_int64),
    ("margin_max_width", [ctypes.c_int], ctypes.c_int64),
    ("margin_cluster_max_width", [ctypes.c_int], ctypes.c_int64),
    ("margin_grid_max_width", [ctypes.c_int], ctypes.c_int64),
    ("margin_grid_unaligned_from_width", [ctypes.c_int], ctypes.c_int64),
    ("margin_scratch_floats", [ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_int)],
     ctypes.c_int64),
    ("margin_warp_rows_max_width", [], ctypes.c_int64),
    ("margin_warp_rows_takes", [ctypes.c_int64, ctypes.c_int],
     ctypes.c_int),
)


@functools.cache
def library(source=None):
    """Build (at first use) and load ``csrc/margin_loss_grad.cu``, or
    ``source``: a path to another version of it with its C interface,
    for side-by-side timings, with every function of
    ``_MARGIN_FUNCTIONS`` that it has typed; returns ``(ctypes library,
    BuiltLibrary)``."""
    lib, built = _load("margin_loss_grad", "margin", _PLAN_ARGTYPES,
                       source)
    for name, argtypes, restype in _MARGIN_FUNCTIONS:
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = restype
    return lib, built


def _itemsize(dtype) -> int:
    """Bytes of an X element in the kernel: bf16 stays bf16, any other
    dtype is staged as f32."""
    return 2 if dtype == torch.bfloat16 else 4


def tile_max_width(dtype) -> int:
    """The widest X, in columns, that the kernel takes in its "tile" mode
    (from the warp-rows hand-over on; bf16 X of odd width from 129): a
    few rows a block in shared memory, where the card timed it faster
    than the stream mode.  Wider X takes the stream mode."""
    return int(library()[0].margin_tile_max_width(_itemsize(dtype)))


def max_width(dtype) -> int:
    """The widest X, in columns, that the kernel takes in one block a row
    for ``dtype`` (its "stream" mode past :func:`tile_max_width`: a row's
    columns in the registers of one block's threads).  Wider X takes the
    cluster mode, up to :func:`cluster_max_width`."""
    lib, _ = library()
    return int(lib.margin_max_width(_itemsize(dtype)))


def _width_query(name: str, dtype) -> int:
    width = int(getattr(library()[0], name)(_itemsize(dtype)))
    if width < 0:
        raise RuntimeError(f"{name} failed: CUDA error {-width}")
    return width


def cluster_max_width(dtype) -> int:
    """The widest X, in columns, that the kernel takes in its "cluster"
    mode for ``dtype`` on the current device (past :func:`max_width`): a
    row across the shared memory of a thread block cluster that the card
    schedules (0 where it schedules none); f32 X whose rows are not
    16-byte aligned only short of :func:`grid_unaligned_from_width`.
    Wider X takes the grid mode, up to :func:`grid_max_width`."""
    return _width_query("margin_cluster_max_width", dtype)


def grid_max_width(dtype) -> int:
    """The widest X, in columns, that the kernel reads once for ``dtype``
    on the current device (counterpart of
    ``PallasMarginGradient._supported_width``): its "grid" mode, past
    :func:`cluster_max_width`, holds each row across a block on every SM
    (0 where it takes no width past the cluster mode).  Wider X takes the
    two-pass mode."""
    return _width_query("margin_grid_max_width", dtype)


def grid_unaligned_from_width(dtype) -> int:
    """The narrowest X, in columns, of rows that are not 16-byte aligned
    (``d * itemsize % 16 != 0``) that the kernel takes in its grid mode
    where the cluster mode would also take it, as the card timed it
    faster: f32 only (0 for bf16)."""
    return int(library()[0].margin_grid_unaligned_from_width(
        _itemsize(dtype)))


def warp_rows_max_width() -> int:
    """The widest X, in columns, that the kernel streams through whole
    warps (its "warp_rows" mode, from 33 columns on): the hand-over to
    the tile.  bf16 X of odd width takes the mode up to 128 columns
    only (:func:`warp_rows_takes`)."""
    return int(library()[0].margin_warp_rows_max_width())


def warp_rows_takes(d: int, dtype) -> bool:
    """Whether X of width ``d`` and ``dtype`` takes the warp-rows mode."""
    return bool(library()[0].margin_warp_rows_takes(d, _itemsize(dtype)))


def check_width(d: int, dtype):
    """Raise ``ValueError`` when the kernel cannot take X of width ``d``:
    only for no columns, since its modes cover every width."""
    if d < 1:
        raise ValueError(f"fused_margin_loss_grad: X has {d} columns; the "
                         f"kernel takes 1 or more")


class MarginPlan(NamedTuple):
    """A launch plan of the margin kernel (``margin_plan``): ``mode``
    ("narrow", "warp_rows", "tile", "stream", "cluster", "grid" or
    "two_pass"); ``tile_rows``, the
    rows of a tile (tile mode), the register bucket (narrow mode), the
    columns a lane owns (warp-rows mode), the stages of the ring (stream
    mode), the rows of a stage (cluster and grid modes) or 0; ``grid``,
    the blocks of the (first) launch; ``partials``, the gradient partials
    summed at the end (the grid, the row groups of the two-pass mode's
    second pass, or the clusters; 0 in the grid mode, whose blocks write
    the outputs); ``cluster``, the blocks of a cluster
    (cluster mode, else 0); ``raw``, the ints as ``margin_plan`` filled
    them (its mode code first), passed back at launch."""

    mode: str
    tile_rows: int
    grid: int
    partials: int
    cluster: int
    raw: tuple


def plan_for(lib, n: int, d: int, itemsize: int, sms: int) -> MarginPlan:
    """``lib``'s plan for X (n, d) of ``itemsize``-byte elements on the
    current device, of ``sms`` SMs; raises ``ValueError`` where it has
    none.  A source from before the cluster mode fills four of the five
    ints and leaves ``cluster`` at 0."""
    plan = (ctypes.c_int * 5)()
    if lib.margin_plan(n, d, itemsize, sms, plan) != 0:
        raise ValueError(f"fused_margin_loss_grad: no launch plan for X "
                         f"({n}, {d}) of {itemsize}-byte elements")
    return MarginPlan(lib.margin_mode_name(plan[0]).decode(), *plan[1:5],
                      tuple(plan))


def _mode_codes(mode_name) -> dict:
    """``{name: code}`` of a library's modes, from its ``*_mode_name``
    (NULL past the last code)."""
    codes = {}
    for code in range(16):
        name = mode_name(code)
        if name is None:
            break
        codes[name.decode()] = code
    return codes


def mode_plan_for(lib, n: int, d: int, itemsize: int, sms: int, mode: str,
                  cluster: int = 0) -> MarginPlan:
    """``lib``'s plan of the named ``mode`` (and, for "cluster", clusters
    of ``cluster`` blocks) for X (n, d), whether or not ``margin_plan``
    gives that mode this width (``margin_mode_plan``: "tile", "stream",
    "cluster", and from the grid mode's source on "grid" and "two_pass";
    for timing modes side by side); raises ``ValueError`` where the mode
    does not take it."""
    codes = _mode_codes(lib.margin_mode_name)
    plan = (ctypes.c_int * 5)()
    if mode not in codes or lib.margin_mode_plan(
            n, d, itemsize, sms, codes[mode], cluster, plan) != 0:
        raise ValueError(f"fused_margin_loss_grad: the {mode} mode takes no "
                         f"X ({n}, {d}) of {itemsize}-byte elements")
    return MarginPlan(mode, *plan[1:5], tuple(plan))


def launch_shape(X) -> MarginPlan:
    """The kernel's :class:`MarginPlan` for the CUDA tensor ``X`` (N, D)
    on its device; raises ``ValueError`` when the kernel cannot take
    it."""
    n, d = X.shape
    check_width(d, X.dtype)
    return _device_plan(X.device.index, n, d, X.element_size())


@functools.lru_cache(maxsize=256)
def _device_plan(index: int, n: int, d: int, itemsize: int) -> MarginPlan:
    """The plan on CUDA device ``index``, worked out once a shape (the
    cluster mode's asks the card which clusters it schedules)."""
    with torch.cuda.device(index):
        return plan_for(library()[0], n, d, itemsize, _device_sms(index))


def margin_launch(lib, code: int, w, staged: StagedDense,
                  plan: MarginPlan):
    """Launch ``lib``'s ``margin_loss_grad`` with ``plan`` on the current
    stream for the loss ``code``; returns ``(loss, grad)``.  Raises if
    the launch fails (a cluster or cooperative launch that the card
    refuses too: no other mode is launched in its place)."""
    raw = (ctypes.c_int * len(plan.raw))(*plan.raw)
    n = staged.X.shape[0]
    if hasattr(lib, "margin_scratch_floats"):
        scratch = int(lib.margin_scratch_floats(n, raw))
    else:  # a source from before the grid mode
        scratch = n if plan.mode == "two_pass" else 0
    return _launch(lib, "margin_loss_grad", "margin", code, w, staged,
                   [raw], (plan.grid, plan.partials), scratch)


def _check(cond: bool, msg: str, name: str = "fused_margin_loss_grad"):
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_staged(staged: StagedDense, name: str):
    """Device, dtype, contiguity and shape of X, y and m; returns (n, d)."""
    X = staged.X
    _check(X.dim() == 2 and X.is_contiguous() and X.dtype in _X_TYPES,
           "X must be a contiguous 2-D f32 or bf16 tensor", name)
    n, d = X.shape
    for label, t in (("y", staged.y), ("m", staged.m)):
        _check(t.device == X.device and t.dtype == torch.float32
               and t.is_contiguous() and tuple(t.shape) == (n,),
               f"{label} must be a contiguous f32 ({n},) tensor on "
               f"{X.device}", name)
    return n, d


def fused_margin_loss_grad(gradient: MarginGradient, w, staged: StagedDense):
    """``(loss_sum, grad_sum)`` in f32 of a logistic, least-squares or
    hinge loss, reading X once (past :func:`max_width` columns across a
    thread block cluster, past :func:`cluster_max_width` across a block
    on every SM, twice past :func:`grid_max_width`).  CPU
    operands take the plain version; CUDA operands launch the kernel on
    the current stream or raise.

    Replaces ``spark_agd_tpu/ops/pallas_kernels.py:fused_margin_loss_grad``;
    on the H100 it is bound by reading X at device-memory bandwidth."""
    global launch_count
    X = staged.X
    if X.device.type == "cpu":
        return fused_margin_loss_grad_reference(gradient, w, staged)
    if X.device.type != "cuda":
        raise ValueError(f"fused_margin_loss_grad: unsupported device "
                         f"{X.device}")
    code = _LOSS_CODES.get(type(gradient))
    if code is None:
        raise TypeError(f"the margin kernel has no loss middle for "
                        f"{type(gradient).__name__}")
    _, d = _check_staged(staged, "fused_margin_loss_grad")
    wf = w.detach().to(torch.float32).contiguous()
    _check(wf.device == X.device and tuple(wf.shape) == (d,),
           f"w must be a ({d},) tensor on {X.device}")
    plan = launch_shape(X)
    loss, grad = margin_launch(library()[0], code, wf, staged, plan)
    launch_count += 1
    margin_mode_launches[plan.mode] += 1
    return loss, grad


# ---------------------------------------------------------------------------
# The margin kernel's lanes: K weight vectors, one read of X
# ---------------------------------------------------------------------------

def fused_margin_lanes_loss_grad_reference(gradient: MarginGradient, W,
                                           staged: StagedDense):
    """The plain version: the lanes kernel's function in f32, with two
    torch products.  Returns ``(loss_sums, grad_sums)``, (K,) and (K, D)
    f32."""
    X = staged.X.to(torch.float32)
    dots = X @ W.to(torch.float32).T
    per, mult = gradient.dots_loss_and_mult(dots, staged.y[:, None])
    m = staged.m[:, None]
    return (per * m).sum(0), (mult * m).T @ X


_LANES_ARGTYPES = _HEAD + [ctypes.c_int, ctypes.POINTER(ctypes.c_int)] \
    + [ctypes.c_void_p] * 6


@functools.cache
def lanes_library(source=None):
    """Build (at first use) and load ``csrc/margin_lanes_loss_grad.cu``,
    or ``source``, another version of it; returns ``(ctypes library,
    BuiltLibrary)``.  A source from before the cluster mode lacks
    ``lanes_mode_plan``, ``lanes_mma_max_width`` and
    ``lanes_cluster_min_width``."""
    lib, built = _load("margin_lanes_loss_grad", "lanes", _LANES_ARGTYPES,
                       source)
    lib.lanes_plan.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int)]
    lib.lanes_plan.restype = ctypes.c_int
    lib.lanes_mode_name.argtypes = [ctypes.c_int]
    lib.lanes_mode_name.restype = ctypes.c_char_p
    lib.lanes_max_width.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.lanes_max_width.restype = ctypes.c_int64
    lib.lanes_max_lanes.argtypes = []
    lib.lanes_max_lanes.restype = ctypes.c_int
    if hasattr(lib, "lanes_mode_plan"):
        lib.lanes_mode_plan.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.lanes_mode_plan.restype = ctypes.c_int
        for name in ("lanes_mma_max_width", "lanes_cluster_min_width"):
            getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_int64
    return lib, built


def max_lanes() -> int:
    """The most lanes one launch of the lanes kernel takes (its largest
    lane bucket); a grid with more runs in chunks."""
    return int(lanes_library()[0].lanes_max_lanes())


def lanes_max_width(k: int, dtype) -> int:
    """The widest X that the lanes kernel's plan reads once for ``k``
    lanes on the current device: a 16-row tile fits across the shared
    memory of a thread block cluster that the card schedules and that the
    plan gives that width (its "lanes_cluster" mode, in clusters of at
    most 2-16 blocks by lanes and type: past them the two-pass mode was
    timed faster).  Wider X takes the two-pass mode."""
    width = int(lanes_library()[0].lanes_max_width(k, _itemsize(dtype)))
    if width < 0:
        raise RuntimeError(f"lanes_max_width failed: CUDA error {-width}")
    return width


def lanes_mma_max_width(k: int, dtype) -> int:
    """The widest X whose ``k`` lanes the "lanes_mma" mode's block holds
    (whether or not the plan gives it that width)."""
    return int(lanes_library()[0].lanes_mma_max_width(k, _itemsize(dtype)))


def lanes_cluster_min_width(k: int, dtype) -> int:
    """The narrowest X that the plan gives to the "lanes_cluster" mode for
    ``k`` lanes: from there up to :func:`lanes_max_width` every plan for
    ``k`` lanes is that mode's (none where that is narrower: 16 lanes of
    bf16, which the plan gives to the two-pass mode from here)."""
    return int(lanes_library()[0].lanes_cluster_min_width(k,
                                                          _itemsize(dtype)))


class LanesPlan(NamedTuple):
    """A launch plan of the lanes kernel (``lanes_plan``): ``mode``
    ("lanes_mma", "lanes_tile" or "lanes_cluster", one read of X, or
    "lanes_two_pass"); ``bucket``, the lanes compiled for (K rounded up);
    ``tile_rows``, the rows of a tile, the stages of the cluster mode's
    ring or pass 1's D splits (two-pass mode); ``grid``, the blocks of the
    launch (two-pass mode: of its middle), one loss partial each;
    ``partials``, the gradient partials summed at the end (the
    clusters in the cluster mode); ``cluster``, the blocks of a cluster
    (cluster mode, else 0); ``raw``, the six ints as ``lanes_plan`` filled
    them, passed back at launch."""

    mode: str
    bucket: int
    tile_rows: int
    grid: int
    partials: int
    cluster: int
    raw: tuple


def lanes_plan_for(lib, n: int, d: int, k: int, itemsize: int,
                   sms: int) -> LanesPlan:
    """``lib``'s plan for ``k`` lanes over X (n, d) on the current device,
    of ``sms`` SMs; raises ``ValueError`` where it has none.  A source
    from before the cluster mode fills five of the six ints and leaves
    ``cluster`` at 0."""
    plan = (ctypes.c_int * 6)()
    if lib.lanes_plan(n, d, k, itemsize, sms, plan) != 0:
        raise ValueError(f"fused_margin_lanes_loss_grad: no launch plan for "
                         f"{k} lanes over X ({n}, {d}) of {itemsize}-byte "
                         f"elements")
    return LanesPlan(lib.lanes_mode_name(plan[0]).decode(), *plan[1:],
                     tuple(plan))


def lanes_mode_plan_for(lib, n: int, d: int, k: int, itemsize: int,
                        sms: int, mode: str, cluster: int = 0) -> LanesPlan:
    """``lib``'s plan of the named ``mode`` (and, for "lanes_cluster",
    clusters of ``cluster`` blocks) for ``k`` lanes over X (n, d), whether
    or not ``lanes_plan`` gives that mode this width
    (``lanes_mode_plan``; for timing modes side by side); raises
    ``ValueError`` where the mode does not take it."""
    codes = _mode_codes(lib.lanes_mode_name)
    plan = (ctypes.c_int * 6)()
    if mode not in codes or lib.lanes_mode_plan(
            n, d, k, itemsize, sms, codes[mode], cluster, plan) != 0:
        raise ValueError(f"fused_margin_lanes_loss_grad: the {mode} mode "
                         f"takes no {k} lanes over X ({n}, {d}) of "
                         f"{itemsize}-byte elements")
    return LanesPlan(mode, *plan[1:], tuple(plan))


def lanes_launch_shape(X, k: int) -> LanesPlan:
    """The lanes kernel's :class:`LanesPlan` for ``k`` lanes (at most
    :func:`max_lanes`) over the CUDA tensor ``X`` (N, D) on its device."""
    n, d = X.shape
    check_width(d, X.dtype)
    return _device_lanes_plan(X.device.index, n, d, k, X.element_size())


@functools.lru_cache(maxsize=256)
def _device_lanes_plan(index: int, n: int, d: int, k: int,
                       itemsize: int) -> LanesPlan:
    """The plan on CUDA device ``index``, worked out once a shape (the
    cluster mode's asks the card which clusters it schedules)."""
    with torch.cuda.device(index):
        return lanes_plan_for(lanes_library()[0], n, d, k, itemsize,
                              _device_sms(index))


def lanes_launch(lib, code: int, W, staged: StagedDense, plan: LanesPlan):
    """Launch ``lib``'s ``margin_lanes_loss_grad`` with ``plan`` on the
    current stream for the (k, D) f32 ``W``; returns ``(loss (k,), grad
    (k, D))``.  Raises if the launch fails (a cluster launch that the card
    refuses too: no other mode is launched in its place)."""
    X = staged.X
    n, d = X.shape
    k = W.shape[0]
    kw = dict(dtype=torch.float32, device=X.device)
    partial_loss = torch.empty(plan.grid * k, **kw)
    partial_grad = torch.empty(plan.partials * k * d, **kw)
    # the two-pass mode's dots and multipliers: (D splits, n, 8 floats,
    # or 24 past 8 lanes); a source from before its redesign (no splits)
    # takes the (n, k) multipliers
    mult = (torch.empty(max(plan.tile_rows, 1) * n
                        * (8 if plan.bucket <= 8 else 24), **kw)
            if plan.mode == "lanes_two_pass" else None)
    loss = torch.empty(k, **kw)
    grad = torch.empty((k, d), **kw)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.margin_lanes_loss_grad(
            X.data_ptr(), _X_TYPES[X.dtype], staged.y.data_ptr(),
            staged.m.data_ptr(), W.data_ptr(), n, d, code, k,
            (ctypes.c_int * 6)(*plan.raw), partial_loss.data_ptr(),
            partial_grad.data_ptr(),
            None if mult is None else mult.data_ptr(), loss.data_ptr(),
            grad.data_ptr(), stream)
    if err != 0:
        message = lib.lanes_error_string(err).decode()
        raise RuntimeError(f"margin_lanes_loss_grad launch failed: CUDA "
                           f"error {err} ({message})")
    return loss, grad


def fused_margin_lanes_loss_grad(gradient: MarginGradient, W,
                                 staged: StagedDense):
    """``(loss_sums (K,), grad_sums (K, D))`` in f32 of a logistic,
    least-squares or hinge loss at the K rows of ``W``, reading X once
    for up to :func:`max_lanes` lanes (across a thread block cluster from
    :func:`lanes_cluster_min_width` columns, twice past
    :func:`lanes_max_width`); more lanes run in chunks, a launch each.
    CPU operands take the plain version; CUDA operands launch the
    kernel on the current stream or raise.

    Replaces ``spark_agd_tpu/ops/pallas_kernels.py:fused_margin_loss_grad``
    under ``jax.vmap`` (``api.sweep``), where Pallas adds a lane axis to
    the grid and reads X once per lane; on the H100 the lanes kernel is
    bound by reading X once at device-memory bandwidth up to about 16
    lanes."""
    global lanes_launch_count
    name = "fused_margin_lanes_loss_grad"
    X = staged.X
    if X.device.type == "cpu":
        return fused_margin_lanes_loss_grad_reference(gradient, W, staged)
    if X.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {X.device}")
    code = _LOSS_CODES.get(type(gradient))
    if code is None:
        raise TypeError(f"the margin kernel has no loss middle for "
                        f"{type(gradient).__name__}")
    _, d = _check_staged(staged, name)
    Wf = W.detach().to(torch.float32).contiguous()
    _check(Wf.device == X.device and Wf.dim() == 2 and Wf.shape[1] == d
           and Wf.shape[0] >= 1,
           f"W must be a (K, {d}) tensor on {X.device}", name)
    lib = lanes_library()[0]
    chunk = max_lanes()
    losses, grads = [], []
    for k0 in range(0, Wf.shape[0], chunk):
        Wc = Wf[k0:k0 + chunk]
        plan = lanes_launch_shape(X, Wc.shape[0])
        loss, grad = lanes_launch(lib, code, Wc, staged, plan)
        lanes_launch_count += 1
        lanes_mode_launches[plan.mode] += 1
        losses.append(loss)
        grads.append(grad)
    if len(losses) == 1:
        return losses[0], grads[0]
    return torch.cat(losses), torch.cat(grads)


class FusedMarginGradient(MarginGradient):
    """Runs a logistic, least-squares or hinge loss through the fused
    kernel on dense data (counterpart of ``PallasMarginGradient``).

    ``prepare`` (called once by the smooth factory) stages the operands
    into a :class:`StagedDense`.  CPU data takes the kernel's plain
    version; CUDA data launches the kernel at every width.  A CSRMatrix
    takes the wrapped loss's sparse products and launches nothing."""

    def __init__(self, inner: MarginGradient):
        if type(inner) not in _LOSS_CODES:
            raise TypeError(
                "FusedMarginGradient wraps LogisticGradient, "
                "LeastSquaresGradient or HingeGradient (the kernel's "
                f"loss middles); got {type(inner).__name__}")
        self.inner = inner

    def dots_loss_and_mult(self, dots, y):
        return self.inner.dots_loss_and_mult(dots, y)

    def prepare(self, X, y, mask=None):
        """Stage once: ``(StagedDense, None, None)``; a CSRMatrix gets the
        plain staging (its twin) and the sparse products."""
        if isinstance(X, StagedDense):
            return X, y, mask
        if isinstance(X, CSRMatrix):
            return Gradient.prepare(self, X, y, mask)
        return stage_dense(X, y, mask), None, None

    def batch_loss_and_grad(self, weights, X, y, mask=None):
        if isinstance(X, CSRMatrix):
            return self.inner.batch_loss_and_grad(weights, X, y, mask)
        if not isinstance(X, StagedDense):
            X = stage_dense(X, y, mask)  # unprepared call: stage per call
        loss, grad = fused_margin_loss_grad(self.inner, weights, X)
        return loss.to(weights.dtype), grad.to(weights.dtype), X.n_valid

    def lanes_loss_and_grad(self, W, X, y, masks=None):
        """All K lanes of the (K, D) ``W`` in one call of the lanes
        kernel, under the staged mask (per-lane masks are not the
        kernel's: they raise).  A CSRMatrix takes the sparse products."""
        if isinstance(X, CSRMatrix):
            return self.inner.lanes_loss_and_grad(W, X, y, masks)
        if masks is not None and (isinstance(X, StagedDense)
                                  or masks.dim() != 1):
            raise ValueError(
                "FusedMarginGradient's lanes share one mask, the staged "
                "one; per-lane masks go through the plain gradients")
        if not isinstance(X, StagedDense):
            X = stage_dense(X, y, masks)  # unprepared call: stage per call
        loss, grad = fused_margin_lanes_loss_grad(self.inner, W, X)
        return (loss.to(W.dtype), grad.to(W.dtype),
                X.n_valid.expand(W.shape[0]))


class FusedLogisticGradient(FusedMarginGradient):
    """Logistic specialization (counterpart of ``PallasLogisticGradient``)."""

    def __init__(self):
        super().__init__(LogisticGradient())


# Singleton for the back-compat wrapper, as pallas_kernels.py keeps one.
_LOGISTIC = LogisticGradient()


def fused_logistic_loss_grad(w, X, y, mask=None):
    """Back-compat wrapper (counterpart of ``pallas_kernels.py:246``):
    logistic ``(loss_sum, grad_sum)`` from raw dense operands, staged per
    call; prefer :func:`stage_dense` + :func:`fused_margin_loss_grad`
    outside tests."""
    return fused_margin_loss_grad(_LOGISTIC, w, stage_dense(X, y, mask))


# ---------------------------------------------------------------------------
# Fused softmax: the (D, K)-weight multinomial loss (BASELINE config 4)
# ---------------------------------------------------------------------------

def fused_softmax_loss_grad_reference(num_classes: int, W,
                                      staged: StagedDense):
    """The plain version: the kernel's function in f32 with two torch
    products.  Returns ``(loss_sum, grad_sum)``, 0-d and (D, K) f32."""
    X = staged.X.to(torch.float32)
    logits = X @ W.to(torch.float32)
    lse = torch.logsumexp(logits, dim=1)
    classes = torch.arange(num_classes, dtype=torch.float32,
                           device=X.device)
    onehot = (classes == staged.y[:, None]).to(torch.float32)
    # select-then-sum, as the kernel picks the label's logit
    picked = torch.where(onehot > 0, logits, 0.0).sum(dim=1)
    per = (lse - picked) * staged.m
    resid = (torch.exp(logits - lse[:, None]) - onehot) * staged.m[:, None]
    return per.sum(), X.T @ resid


@functools.cache
def softmax_library(source=None):
    """Build (at first use) and load ``csrc/softmax_loss_grad.cu``, or
    ``source``: a path to another version of it with the same C
    interface, for side-by-side timings; returns ``(ctypes library,
    BuiltLibrary)``."""
    lib, built = _load("softmax_loss_grad", "softmax", _PLAN_ARGTYPES,
                       source)
    lib.softmax_plan.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int)]
    lib.softmax_plan.restype = ctypes.c_int
    lib.softmax_mode_name.argtypes = [ctypes.c_int]
    lib.softmax_mode_name.restype = ctypes.c_char_p
    lib.softmax_one_read_max_width.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.softmax_one_read_max_width.restype = ctypes.c_int64
    return lib, built


def softmax_one_read_max_width(k: int, dtype) -> int:
    """The widest X, in columns, that the softmax kernel reads once for
    ``k`` classes and ``dtype`` (W, the gradient accumulator and a row
    tile fit a block's shared memory; 0 past 32 classes).  Wider X, or
    more classes, takes the two-pass mode."""
    lib, _ = softmax_library()
    return int(lib.softmax_one_read_max_width(k, _itemsize(dtype)))


class SoftmaxPlan(NamedTuple):
    """A launch plan of the softmax kernel (``softmax_plan``): ``mode``
    ("one_read" or "two_pass"); ``rows``, the rows of a tile (one-read)
    or the classes of a class tile (two-pass); ``grid``, the blocks of the
    (first) launch; ``partials``, the gradient partials summed at the
    end; ``chunk``, the rows of a chunk (two-pass: the residual scratch
    holds ``chunk`` x K floats; 0 one-read); ``loss_partials``; ``raw``,
    the six ints as ``softmax_plan`` filled them, passed back at
    launch."""

    mode: str
    rows: int
    grid: int
    partials: int
    chunk: int
    loss_partials: int
    raw: tuple


def softmax_plan_for(lib, n: int, d: int, k: int, itemsize: int, sms: int,
                     two_pass: bool = False) -> SoftmaxPlan:
    """``lib``'s plan for ``k`` classes over X (n, d) of ``itemsize``-byte
    elements on a card of ``sms`` SMs (``two_pass``: the two-pass mode
    even where the one-read kernel fits); raises ``ValueError`` where it
    has none."""
    plan = (ctypes.c_int * 6)()
    if lib.softmax_plan(n, d, k, itemsize, sms, int(two_pass), plan) != 0:
        raise ValueError(f"fused_softmax_loss_grad: no launch plan for {k} "
                         f"classes over X ({n}, {d}) of {itemsize}-byte "
                         f"elements")
    return SoftmaxPlan(lib.softmax_mode_name(plan[0]).decode(), *plan[1:],
                       tuple(plan))


def softmax_launch_shape(X, num_classes: int) -> SoftmaxPlan:
    """The softmax kernel's :class:`SoftmaxPlan` for the CUDA tensor
    ``X`` (N, D) and ``num_classes``: the one-read kernel where it fits,
    else the two-pass mode."""
    n, d = X.shape
    check_width(d, X.dtype)
    return softmax_plan_for(softmax_library()[0], n, d, int(num_classes),
                            X.element_size(), _device_sms(X.device.index))


def softmax_launch(lib, k: int, W, staged: StagedDense, plan: SoftmaxPlan):
    """Launch ``lib``'s ``softmax_loss_grad`` with ``plan`` on the current
    stream for the (D, k) f32 ``W``; returns ``(loss, grad)``.  Raises if
    the launch fails."""
    return _launch(lib, "softmax_loss_grad", "softmax", k, W, staged,
                   [(ctypes.c_int * 6)(*plan.raw)],
                   (plan.loss_partials, plan.partials), plan.chunk * k)


def fused_softmax_loss_grad(num_classes: int, W, staged: StagedDense):
    """``(loss_sum, grad_sum)`` in f32 of the multinomial softmax with
    weights ``W`` (D, K), at every width and class count: reading X once
    where W, the gradient accumulator and a row tile fit shared memory
    (up to 32 classes), else in two passes, both products on the tensor
    cores in either mode.  CPU operands take the plain version; CUDA
    operands launch the kernel on the current stream or raise.

    Replaces ``spark_agd_tpu/ops/pallas_kernels.py:fused_softmax_loss_grad``;
    on the H100 the one-read mode is bound by reading X once at
    device-memory bandwidth, the two-pass mode at many classes by its
    products' TF32 operations."""
    global softmax_launch_count
    name = "fused_softmax_loss_grad"
    X = staged.X
    if X.device.type == "cpu":
        return fused_softmax_loss_grad_reference(num_classes, W, staged)
    if X.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {X.device}")
    k = int(num_classes)
    _, d = _check_staged(staged, name)
    wf = W.detach().to(torch.float32).contiguous()
    _check(k >= 1 and wf.device == X.device and tuple(wf.shape) == (d, k),
           f"W must be a ({d}, {k}) tensor on {X.device}, k >= 1", name)
    plan = softmax_launch_shape(X, k)
    loss, grad = softmax_launch(softmax_library()[0], k, wf, staged, plan)
    softmax_launch_count += 1
    softmax_mode_launches[plan.mode] += 1
    return loss, grad


class FusedSoftmaxGradient(Gradient):
    """Runs :class:`SoftmaxGradient` through the fused kernel on dense
    data (counterpart of ``PallasSoftmaxGradient``).

    ``prepare`` (called once by the smooth factory) stages the operands
    into a :class:`StagedDense`.  CPU data takes the kernel's plain
    version; CUDA data launches the kernel at every width and class
    count.  A CSRMatrix takes the wrapped loss's sparse products and
    launches nothing."""

    def __init__(self, inner: SoftmaxGradient):
        if not isinstance(inner, SoftmaxGradient):
            raise TypeError("FusedSoftmaxGradient wraps SoftmaxGradient; "
                            f"got {type(inner).__name__}")
        self.inner = inner
        self.num_classes = inner.num_classes

    def prepare(self, X, y, mask=None):
        """Stage once: ``(StagedDense, None, None)``; a CSRMatrix gets the
        plain staging (its twin) and the sparse products."""
        if isinstance(X, StagedDense):
            return X, y, mask
        if isinstance(X, CSRMatrix):
            return Gradient.prepare(self, X, y, mask)
        return stage_softmax(X, y, self.num_classes, mask), None, None

    def batch_loss_and_grad(self, weights, X, y, mask=None):
        if isinstance(X, CSRMatrix):
            return self.inner.batch_loss_and_grad(weights, X, y, mask)
        if not isinstance(X, StagedDense):
            # unprepared call: stage per call
            X = stage_softmax(X, y, self.num_classes, mask)
        loss, grad = fused_softmax_loss_grad(self.num_classes, weights, X)
        return loss.to(weights.dtype), grad.to(weights.dtype), X.n_valid
