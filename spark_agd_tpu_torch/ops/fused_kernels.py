"""Fused margin loss+gradient: one read of X per smooth evaluation.

Counterpart of ``spark_agd_tpu/ops/pallas_kernels.py`` (the margin half;
the softmax kernel is ported in a later slice).  The smooth evaluation is
bound by device-memory bandwidth, and two library products (``X @ w``
then ``X.T @ mult``) read the (N, D) data matrix twice.  The CUDA kernel
``csrc/margin_loss_grad.cu`` keeps each row tile in shared memory between
the two products and reduces per-block partials in a fixed order, so X is
read once and the result is deterministic.

- :func:`fused_margin_loss_grad` is the wrapper: on a CUDA tensor it
  launches the kernel (or raises); on a CPU tensor it runs the plain
  version :func:`fused_margin_loss_grad_reference`, which computes the
  same function in f32 with two ``torch`` products.
- :class:`FusedMarginGradient` wraps a logistic, least-squares or hinge
  :class:`~spark_agd_tpu_torch.ops.losses.MarginGradient` (counterpart of
  ``PallasMarginGradient``); ``prepare`` stages the operands once at
  data-placement time, without copying a contiguous f32 or bf16 X.
  The kernel takes X up to :func:`max_width` columns (its shared-memory
  tile); a wider CUDA X raises ``ValueError``: fit it with the wrapped
  loss itself.

The launch shape (tile rows, grid) and the width limit come from the
CUDA source (``margin_plan``, ``margin_max_width``), which alone knows
the kernel's shared-memory layout.

``launch_count`` counts kernel launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import _cuda_build
from .losses import (
    HingeGradient,
    LeastSquaresGradient,
    LogisticGradient,
    MarginGradient,
    _count,
    require_dense,
)

# Kernel launches since import (or since a caller reset it to 0).
launch_count = 0

_LOSS_CODES = {LogisticGradient: 0, LeastSquaresGradient: 1,
               HingeGradient: 2}
_X_TYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def stage_dense(X, y, mask=None) -> StagedDense:
    """Stage (X, y, mask) for the kernel.  A contiguous f32 or bf16 X is
    used as it is, never copied; any other dtype becomes f32.  A CUDA X
    wider than the kernel takes raises ``ValueError`` here, before any
    copy."""
    require_dense(X)
    if X.dim() != 2:
        raise ValueError(f"the margin kernel takes a 2-D X; got shape "
                         f"{tuple(X.shape)}")
    if X.is_cuda:
        check_width(X.shape[1], X.dtype)
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


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


@functools.cache
def library():
    """Build (at first use) and load ``csrc/margin_loss_grad.cu``;
    returns ``(ctypes library, BuiltLibrary)``."""
    built = _cuda_build.build("margin_loss_grad", ["margin_loss_grad.cu"])
    lib = ctypes.CDLL(str(built.path))
    lib.margin_loss_grad.argtypes = _ARGTYPES
    lib.margin_loss_grad.restype = ctypes.c_int
    lib.margin_error_string.argtypes = [ctypes.c_int]
    lib.margin_error_string.restype = ctypes.c_char_p
    lib.margin_plan.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int)]
    lib.margin_plan.restype = ctypes.c_int
    lib.margin_max_width.argtypes = [ctypes.c_int]
    lib.margin_max_width.restype = ctypes.c_int64
    return lib, built


def _itemsize(dtype) -> int:
    """Bytes of an X element in the kernel: bf16 stays bf16, any other
    dtype is staged as f32."""
    return 2 if dtype == torch.bfloat16 else 4


def max_width(dtype) -> int:
    """The widest X, in columns, that the kernel takes for ``dtype``
    (counterpart of ``PallasMarginGradient._supported_width``)."""
    lib, _ = library()
    return int(lib.margin_max_width(_itemsize(dtype)))


def check_width(d: int, dtype):
    """Raise ``ValueError`` when the kernel cannot take X of width ``d``
    (not even one row fits its shared-memory tile)."""
    limit = max_width(dtype)
    if not 1 <= d <= limit:
        kind = "bf16" if _itemsize(dtype) == 2 else "f32"
        raise ValueError(
            f"fused_margin_loss_grad: feature width {d} is outside the "
            f"CUDA kernel's shared-memory tile (1 to {limit} columns of "
            f"{kind} X); fit this X with the plain gradient (for example "
            f"LogisticGradient) instead")


def launch_shape(X) -> tuple[int, int]:
    """``(tile_rows, grid)`` of the kernel for the CUDA tensor ``X``
    (N, D); raises ``ValueError`` when the kernel cannot take it."""
    lib, _ = library()
    rows, grid = ctypes.c_int(), ctypes.c_int()
    n, d = X.shape
    if lib.margin_plan(n, d, X.element_size(), _device_sms(X.device.index),
                       ctypes.byref(rows), ctypes.byref(grid)) != 0:
        check_width(d, X.dtype)  # raises with the limit
        raise ValueError(f"fused_margin_loss_grad: no launch shape for X "
                         f"{tuple(X.shape)} of {X.dtype}")
    return rows.value, grid.value


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"fused_margin_loss_grad: {msg}")


def fused_margin_loss_grad(gradient: MarginGradient, w, staged: StagedDense):
    """``(loss_sum, grad_sum)`` in f32 of a logistic, least-squares or
    hinge loss, reading X once.  CPU operands take the plain version;
    CUDA operands launch the kernel on the current stream or raise.

    Replaces ``spark_agd_tpu/ops/pallas_kernels.py:fused_margin_loss_grad``;
    on the H100 it is bound by reading X once at device-memory
    bandwidth."""
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
    _check(X.dim() == 2 and X.is_contiguous() and X.dtype in _X_TYPES,
           "X must be a contiguous 2-D f32 or bf16 tensor")
    n, d = X.shape
    wf = w.detach().to(torch.float32).contiguous()
    for name, t, size in (("y", staged.y, n), ("m", staged.m, n),
                          ("w", wf, d)):
        _check(t.device == X.device and t.dtype == torch.float32
               and t.is_contiguous() and tuple(t.shape) == (size,),
               f"{name} must be a contiguous f32 ({size},) tensor on "
               f"{X.device}")
    rows, grid = launch_shape(X)
    kw = dict(dtype=torch.float32, device=X.device)
    partial_loss = torch.empty(grid, **kw)
    partial_grad = torch.empty((grid, d), **kw)
    loss = torch.empty((), **kw)
    grad = torch.empty(d, **kw)
    lib, _ = library()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.margin_loss_grad(
            X.data_ptr(), _X_TYPES[X.dtype], staged.y.data_ptr(),
            staged.m.data_ptr(), wf.data_ptr(), n, d, code, rows, grid,
            partial_loss.data_ptr(), partial_grad.data_ptr(),
            loss.data_ptr(), grad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"margin_loss_grad launch failed: CUDA error "
                           f"{err} ({lib.margin_error_string(err).decode()})")
    launch_count += 1
    return loss, grad


class FusedMarginGradient(MarginGradient):
    """Runs a logistic, least-squares or hinge loss through the fused
    kernel on dense data (counterpart of ``PallasMarginGradient``).

    ``prepare`` (called once by the smooth factory) stages the operands
    into a :class:`StagedDense`.  CPU data takes the kernel's plain
    version; CUDA data launches the kernel, and raises where the kernel
    cannot take it (X wider than :func:`max_width`)."""

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
        """Stage once: ``(StagedDense, None, None)``."""
        if isinstance(X, StagedDense):
            return X, y, mask
        return stage_dense(X, y, mask), None, None

    def batch_loss_and_grad(self, weights, X, y, mask=None):
        if not isinstance(X, StagedDense):
            X = stage_dense(X, y, mask)  # unprepared call: stage per call
        loss, grad = fused_margin_loss_grad(self.inner, weights, X)
        return loss.to(weights.dtype), grad.to(weights.dtype), X.n_valid


class FusedLogisticGradient(FusedMarginGradient):
    """Logistic specialization (counterpart of ``PallasLogisticGradient``)."""

    def __init__(self):
        super().__init__(LogisticGradient())
