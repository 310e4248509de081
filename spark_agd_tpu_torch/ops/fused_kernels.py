"""Fused GLM loss+gradient kernels: one read of X per smooth evaluation.

Counterpart of ``spark_agd_tpu/ops/pallas_kernels.py``.  The smooth
evaluation is bound by device-memory bandwidth, and two library products
(``X @ w`` then ``X.T @ mult``) read the (N, D) data matrix twice.  The
CUDA kernels keep each row tile in shared memory between the two
products and reduce per-block partials in a fixed order, so X is read
once and the result is deterministic:

- ``csrc/margin_loss_grad.cu``: logistic, least-squares and hinge losses
  (the margin half).  :func:`fused_margin_loss_grad` is its wrapper,
  :func:`fused_margin_loss_grad_reference` its plain version, and
  :class:`FusedMarginGradient` wraps a margin
  :class:`~spark_agd_tpu_torch.ops.losses.MarginGradient` (counterpart of
  ``PallasMarginGradient``).  It takes X up to :func:`max_width` columns
  (its shared-memory tile); a wider CUDA X raises ``ValueError``.
- ``csrc/softmax_loss_grad.cu``: the multinomial softmax with a (D, K)
  weight matrix.  :func:`fused_softmax_loss_grad` is its wrapper,
  :func:`fused_softmax_loss_grad_reference` its plain version, and
  :class:`FusedSoftmaxGradient` wraps a
  :class:`~spark_agd_tpu_torch.ops.losses.SoftmaxGradient` (counterpart of
  ``PallasSoftmaxGradient``).  It takes up to :func:`max_classes` classes
  for a given width (W and the gradient accumulator live in shared
  memory); a CUDA input past that raises ``ValueError``.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version, which computes the same function in
f32 with ``torch`` products.  ``prepare`` stages the operands once at
data-placement time, without copying a contiguous f32 or bf16 X.

Both kernels read dense X.  A :class:`~spark_agd_tpu_torch.ops.sparse.CSRMatrix`
is routed by ``prepare`` to the wrapped loss, whose products go through
``ops.sparse`` (as ``PallasMarginGradient``/``PallasSoftmaxGradient``
route CSR to the jnp losses); no kernel is launched for it.

The launch shapes (tile rows, grid) and the limits come from the CUDA
sources (``margin_plan``/``margin_max_width``,
``softmax_plan``/``softmax_max_classes``), which alone know the kernels'
shared-memory layouts.

``launch_count`` and ``softmax_launch_count`` count kernel launches, so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

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

# Kernel launches since import (or since a caller reset them to 0).
launch_count = 0
softmax_launch_count = 0

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
    """Stage (X, y, mask) for the margin kernel; a CUDA X wider than the
    kernel takes raises ``ValueError``."""
    return _stage(X, y, mask, "margin", check_width)


def stage_softmax(X, y, num_classes: int, mask=None) -> StagedDense:
    """Stage (X, labels, mask) for the softmax kernel (labels as f32
    class indices); a CUDA X with more classes than the kernel takes at
    its width raises ``ValueError``."""
    return _stage(X, y, mask, "softmax",
                  lambda d, dtype: check_classes(num_classes, d, dtype))


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


# Both kernels' launch functions: (X, x_type, y, mask, W, n, d, loss code
# or classes, tile_rows, grid, partial_loss, partial_grad, loss, grad,
# stream) -> CUDA error code.
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _load(name: str, prefix: str, source=None):
    """Build (at first use) and load ``csrc/<name>.cu`` (or ``source``, a
    path to another version of it), with its launch function ``<name>``
    and ``<prefix>_error_string`` typed; returns ``(ctypes library,
    BuiltLibrary)``."""
    built = _cuda_build.build(name, [source or f"{name}.cu"])
    lib = ctypes.CDLL(str(built.path))
    getattr(lib, name).argtypes = _ARGTYPES
    getattr(lib, name).restype = ctypes.c_int
    getattr(lib, f"{prefix}_error_string").argtypes = [ctypes.c_int]
    getattr(lib, f"{prefix}_error_string").restype = ctypes.c_char_p
    return lib, built


def _launch(lib, name: str, prefix: str, code: int, W,
            staged: StagedDense, plan):
    """Launch ``lib``'s ``name`` on the current stream with ``code`` (the
    loss code or the class count) and ``plan`` = (tile_rows, grid).  The
    scratch and the outputs, ``loss`` () and ``grad`` shaped like W, are
    allocated here; raises if the launch fails."""
    X = staged.X
    n, d = X.shape
    rows, grid = plan
    kw = dict(dtype=torch.float32, device=X.device)
    partial_loss = torch.empty(grid, **kw)
    partial_grad = torch.empty(grid * W.numel(), **kw)
    loss = torch.empty((), **kw)
    grad = torch.empty(W.shape, **kw)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = getattr(lib, name)(
            X.data_ptr(), _X_TYPES[X.dtype], staged.y.data_ptr(),
            staged.m.data_ptr(), W.data_ptr(), n, d, code, rows, grid,
            partial_loss.data_ptr(), partial_grad.data_ptr(),
            loss.data_ptr(), grad.data_ptr(), stream)
    if err != 0:
        message = getattr(lib, f"{prefix}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({message})")
    return loss, grad


@functools.cache
def library():
    """Build (at first use) and load ``csrc/margin_loss_grad.cu``;
    returns ``(ctypes library, BuiltLibrary)``."""
    lib, built = _load("margin_loss_grad", "margin")
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
    _, d = _check_staged(staged, "fused_margin_loss_grad")
    wf = w.detach().to(torch.float32).contiguous()
    _check(wf.device == X.device and tuple(wf.shape) == (d,),
           f"w must be a ({d},) tensor on {X.device}")
    loss, grad = _launch(library()[0], "margin_loss_grad", "margin", code,
                         wf, staged, launch_shape(X))
    launch_count += 1
    return loss, grad


class FusedMarginGradient(MarginGradient):
    """Runs a logistic, least-squares or hinge loss through the fused
    kernel on dense data (counterpart of ``PallasMarginGradient``).

    ``prepare`` (called once by the smooth factory) stages the operands
    into a :class:`StagedDense`.  CPU data takes the kernel's plain
    version; CUDA data launches the kernel, and raises where the kernel
    cannot take it (X wider than :func:`max_width`).  A CSRMatrix takes
    the wrapped loss's sparse products and launches nothing."""

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
    lib, built = _load("softmax_loss_grad", "softmax", source)
    lib.softmax_plan.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
    lib.softmax_plan.restype = ctypes.c_int
    lib.softmax_max_classes.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.softmax_max_classes.restype = ctypes.c_int
    return lib, built


def max_classes(d: int, dtype) -> int:
    """The most classes the softmax kernel takes for X of width ``d``
    and ``dtype`` (0 when it cannot take this width at all)."""
    lib, _ = softmax_library()
    return int(lib.softmax_max_classes(d, _itemsize(dtype)))


def check_classes(k: int, d: int, dtype):
    """Raise ``ValueError`` when the softmax kernel cannot take ``k``
    classes for X of width ``d``: W and the gradient accumulator (D x K
    f32 each) and one row of X must fit a block's shared memory, and
    the kernel is compiled for at most 32 classes."""
    limit = max_classes(d, dtype)
    if not 1 <= k <= limit:
        kind = "bf16" if _itemsize(dtype) == 2 else "f32"
        raise ValueError(
            f"fused_softmax_loss_grad: {k} classes are outside the CUDA "
            f"kernel's limit of 1 to {limit} classes for {kind} X of "
            f"width {d}; fit this problem with the plain SoftmaxGradient "
            f"instead")


def softmax_launch_shape(X, num_classes: int) -> tuple[int, int]:
    """``(tile_rows, grid)`` of the softmax kernel for the CUDA tensor
    ``X`` (N, D) and ``num_classes``; raises ``ValueError`` when the
    kernel cannot take them."""
    lib, _ = softmax_library()
    rows, grid = ctypes.c_int(), ctypes.c_int()
    n, d = X.shape
    if lib.softmax_plan(n, d, num_classes, X.element_size(),
                        _device_sms(X.device.index), ctypes.byref(rows),
                        ctypes.byref(grid)) != 0:
        check_classes(num_classes, d, X.dtype)  # raises with the limit
        raise ValueError(f"fused_softmax_loss_grad: no launch shape for X "
                         f"{tuple(X.shape)} of {X.dtype} with "
                         f"{num_classes} classes")
    return rows.value, grid.value


def fused_softmax_loss_grad(num_classes: int, W, staged: StagedDense):
    """``(loss_sum, grad_sum)`` in f32 of the multinomial softmax with
    weights ``W`` (D, K), reading X once.  CPU operands take the plain
    version; CUDA operands launch the kernel on the current stream or
    raise.

    Replaces ``spark_agd_tpu/ops/pallas_kernels.py:fused_softmax_loss_grad``;
    on the H100 it is bound by reading X once at device-memory
    bandwidth."""
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
    _check(wf.device == X.device and tuple(wf.shape) == (d, k),
           f"W must be a ({d}, {k}) tensor on {X.device}", name)
    loss, grad = _launch(softmax_library()[0], "softmax_loss_grad",
                         "softmax", k, wf, staged,
                         softmax_launch_shape(X, k))
    softmax_launch_count += 1
    return loss, grad


class FusedSoftmaxGradient(Gradient):
    """Runs :class:`SoftmaxGradient` through the fused kernel on dense
    data (counterpart of ``PallasSoftmaxGradient``).

    ``prepare`` (called once by the smooth factory) stages the operands
    into a :class:`StagedDense`.  CPU data takes the kernel's plain
    version; CUDA data launches the kernel, and raises where the kernel
    cannot take it (more classes than :func:`max_classes` at X's
    width).  A CSRMatrix takes the wrapped loss's sparse products and
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
