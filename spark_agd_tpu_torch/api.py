"""Public API, single-device subset: the reference's surface on PyTorch.

Counterpart of ``spark_agd_tpu/api.py``: the ``AcceleratedGradientDescent``
class with its fluent setters (snake_case and camelCase), ``optimize``,
the functional ``run(...) -> (weights, loss_history)`` and
``make_runner``.  Data is ``(X, y)`` or ``(X, y, mask)``, as tensors or
numpy arrays, with X dense or an ``ops.sparse.CSRMatrix``; it is placed
on the run's device once.

The entry points run on the current CUDA device unless the caller passes
``device=`` (``"cpu"`` for the CPU); with no CUDA device and no explicit
device they raise.  Meshes, the supervised path (``resilience=``,
``checkpointer=``, ``journal=``), telemetry and the sharded update are
not in this slice: asking for them raises.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ._device import resolve_device
from .core import agd, smooth as smooth_lib, tvec
from .ops.losses import Gradient
from .ops.prox import Prox
from .ops.sparse import CSRMatrix

_LATER = "is not ported yet: the PyTorch port runs single-device fits only"


def _reject_later(**options):
    """Raise for an option of the JAX API this slice does not carry."""
    for name, value in options.items():
        if name == "mesh":
            if value is not None and value is not False:
                raise NotImplementedError(
                    f"mesh= {_LATER} (the mesh path, parallel/, arrives in "
                    f"a later slice); pass mesh=None or mesh=False")
        elif value is not None and value is not False:
            raise NotImplementedError(
                f"{name}= {_LATER} (it arrives in a later slice)")


def _normalize_data(data):
    """Accept (X, y) or (X, y, mask)."""
    if isinstance(data, (tuple, list)) and len(data) in (2, 3):
        X, y = data[0], data[1]
        return X, y, data[2] if len(data) == 3 else None
    raise TypeError("data must be (X, y) or (X, y, mask); got "
                    f"{type(data).__name__}")


def _place(a, device):
    """A tensor (or CSRMatrix) on ``device``: numpy arrays are copied
    over, tensors already there are used as they are (no copy of a large
    X)."""
    if a is None:
        return None
    if isinstance(a, (torch.Tensor, CSRMatrix)):
        return a.to(device)
    return torch.as_tensor(np.asarray(a)).to(device)


def _owned(a, device):
    """A fresh copy of an initial weight leaf on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
    return torch.tensor(np.asarray(a), device=device)


def make_runner(
    data,
    gradient: Gradient,
    updater: Prox,
    convergence_tol: float = 1e-4,
    num_iterations: int = 100,
    reg_param: float = 0.0,
    l0: float = 1.0,
    l_exact: float = math.inf,
    beta: float = 0.5,
    alpha: float = 0.9,
    may_restart: bool = True,
    *,
    mesh=None,
    loss_mode: str = "x",
    device=None,
    telemetry=None,
    sharded_update: bool = False,
):
    """Build ``fit(initial_weights) -> AGDResult`` over data placed and
    prepared once (``gradient.prepare`` runs here, not per fit)."""
    _reject_later(mesh=mesh, telemetry=telemetry,
                  sharded_update=sharded_update)
    dev = resolve_device(device)
    X, y, mask = _normalize_data(data)
    build, dargs = smooth_lib.make_smooth_staged(
        gradient, _place(X, dev), _place(y, dev), _place(mask, dev))
    px, rv = smooth_lib.make_prox(updater, reg_param)
    cfg = agd.AGDConfig(
        convergence_tol=convergence_tol, num_iterations=num_iterations,
        l0=l0, l_exact=l_exact, beta=beta, alpha=alpha,
        may_restart=may_restart, loss_mode=loss_mode)

    def fit(initial_weights):
        w0 = tvec.tmap(lambda a: _owned(a, dev), initial_weights)
        sm, sl = build(*dargs)
        return agd.run_agd(sm, px, rv, w0, cfg, smooth_loss=sl)

    fit.data_args = dargs
    return fit


def run(
    data,
    gradient: Gradient,
    updater: Prox,
    convergence_tol: float = 1e-4,
    num_iterations: int = 100,
    reg_param: float = 0.0,
    initial_weights: Any = None,
    l0: float = 1.0,
    l_exact: float = math.inf,
    beta: float = 0.5,
    alpha: float = 0.9,
    may_restart: bool = True,
    *,
    mesh=None,
    loss_mode: str = "x",
    return_result: bool = False,
    device=None,
    telemetry=None,
    resilience=None,
    checkpointer=None,
    journal=None,
    sharded_update: bool = False,
):
    """Functional entry point, signature-parity with reference ``run``.
    Returns ``(weights, loss_history)`` with ``loss_history`` a numpy
    array of one entry per executed iteration; ``return_result=True``
    also returns the full ``AGDResult``."""
    if initial_weights is None:
        raise ValueError("initial_weights is required")
    _reject_later(resilience=resilience, checkpointer=checkpointer,
                  journal=journal)
    fit = make_runner(
        data, gradient, updater, convergence_tol=convergence_tol,
        num_iterations=num_iterations, reg_param=reg_param, l0=l0,
        l_exact=l_exact, beta=beta, alpha=alpha, may_restart=may_restart,
        mesh=mesh, loss_mode=loss_mode, device=device, telemetry=telemetry,
        sharded_update=sharded_update)
    result = fit(initial_weights)
    n = int(result.num_iters)
    loss_history = result.loss_history[:n].numpy()
    if return_result:
        return result.weights, loss_history, result
    return result.weights, loss_history


class AcceleratedGradientDescent:
    """Config-holder class: the reference's setters and defaults, one
    ``optimize``; ``set_device`` picks the device (default: CUDA)."""

    def __init__(self, gradient: Gradient, updater: Prox):
        self._gradient = gradient
        self._updater = updater
        self._convergence_tol = 1e-4
        self._num_iterations = 100
        self._reg_param = 0.0
        self._l0 = 1.0
        self._l_exact = math.inf
        self._beta = 0.5
        self._alpha = 0.9
        self._may_restart = True
        self._mesh = None
        self._loss_mode = "x"
        self._device = None

    def set_convergence_tol(self, tol: float):
        self._convergence_tol = float(tol)
        return self

    def set_num_iterations(self, iters: int):
        self._num_iterations = int(iters)
        return self

    def set_reg_param(self, reg_param: float):
        self._reg_param = float(reg_param)
        return self

    def set_l0(self, l0: float):
        self._l0 = float(l0)
        return self

    def set_lexact(self, l_exact: float):
        self._l_exact = float(l_exact)
        return self

    def set_beta(self, beta: float):
        self._beta = float(beta)
        return self

    def set_alpha(self, alpha: float):
        self._alpha = float(alpha)
        return self

    def set_may_restart(self, may_restart: bool):
        self._may_restart = bool(may_restart)
        return self

    def set_gradient(self, gradient: Gradient):
        self._gradient = gradient
        return self

    def set_updater(self, updater: Prox):
        self._updater = updater
        return self

    def set_mesh(self, mesh):
        """Only ``None`` and ``False`` (single device) in this slice."""
        _reject_later(mesh=mesh)
        self._mesh = mesh
        return self

    def set_loss_mode(self, loss_mode: str):
        self._loss_mode = loss_mode
        return self

    def set_device(self, device):
        """The device the fit runs on (``None``: the current CUDA
        device, raising when there is none)."""
        self._device = device
        return self

    setConvergenceTol = set_convergence_tol
    setNumIterations = set_num_iterations
    setRegParam = set_reg_param
    setL0 = set_l0
    setLexact = set_lexact
    setBeta = set_beta
    setAlpha = set_alpha
    setMayRestart = set_may_restart
    setGradient = set_gradient
    setUpdater = set_updater

    def optimize(self, data, initial_weights: Any):
        """Run and return the solution weights, on the device that
        ``set_device`` chose."""
        weights, _ = run(
            data, self._gradient, self._updater,
            convergence_tol=self._convergence_tol,
            num_iterations=self._num_iterations,
            reg_param=self._reg_param,
            initial_weights=initial_weights,
            l0=self._l0, l_exact=self._l_exact, beta=self._beta,
            alpha=self._alpha, may_restart=self._may_restart,
            mesh=self._mesh, loss_mode=self._loss_mode,
            device=self._device)
        return weights
