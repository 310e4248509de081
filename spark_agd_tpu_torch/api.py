"""Public API, single-device subset: the reference's surface on PyTorch.

Counterpart of ``spark_agd_tpu/api.py``: the ``AcceleratedGradientDescent``
class with its fluent setters (snake_case and camelCase), ``optimize``,
the functional ``run(...) -> (weights, loss_history)``, ``make_runner``
and ``run_minibatch_agd``; the rest of the Optimizer family: the GD
comparator ``run_minibatch_sgd`` and the quasi-Newton member
(``LBFGS``, ``run_lbfgs``, ``make_lbfgs_runner``, which route L1 and
elastic-net updaters to OWL-QN).  Data is ``(X, y)`` or ``(X, y,
mask)``, as tensors or numpy arrays, with X dense or an
``ops.sparse.CSRMatrix``; it is placed on the run's device once.

The entry points run on the current CUDA device unless the caller passes
``device=`` (``"cpu"`` for the CPU); with no CUDA device and no explicit
device they raise.  ``dist_mode=`` is validated and, with no mesh,
inert, as in the JAX package.  Meshes, the supervised path
(``resilience=``, ``checkpointer=``, ``journal=``), telemetry,
``verbose=True``, the sharded update and the lanes (``LBFGS.sweep``) are
not in this slice: asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ._device import resolve_device
from .core import agd, gd, lbfgs as lbfgs_lib, smooth as smooth_lib, tvec
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


_DIST_MODES = ("shard_map", "auto")


def _check_dist_mode(dist_mode):
    """Raise ``ValueError`` for a mode the JAX package does not know; a
    known mode is inert without a mesh."""
    if dist_mode not in _DIST_MODES:
        raise ValueError(f"unknown dist_mode {dist_mode!r}; expected one "
                         f"of {_DIST_MODES}")


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
    dist_mode: str = "shard_map",
    loss_mode: str = "x",
    device=None,
    telemetry=None,
    sharded_update: bool = False,
):
    """Build ``fit(initial_weights) -> AGDResult`` over data placed and
    prepared once (``gradient.prepare`` runs here, not per fit)."""
    _check_dist_mode(dist_mode)
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
    dist_mode: str = "shard_map",
    loss_mode: str = "x",
    return_result: bool = False,
    device=None,
    telemetry=None,
    verbose: bool = False,
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
    if verbose:
        raise NotImplementedError(
            "verbose=True is not ported yet: its log lines come from "
            "utils/logging.py, which needs obs/schema.py (the obs slice "
            "arrives in a later slice); pass verbose=False")
    _reject_later(resilience=resilience, checkpointer=checkpointer,
                  journal=journal)
    fit = make_runner(
        data, gradient, updater, convergence_tol=convergence_tol,
        num_iterations=num_iterations, reg_param=reg_param, l0=l0,
        l_exact=l_exact, beta=beta, alpha=alpha, may_restart=may_restart,
        mesh=mesh, dist_mode=dist_mode, loss_mode=loss_mode, device=device,
        telemetry=telemetry, sharded_update=sharded_update)
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
        self._dist_mode = "shard_map"
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

    def set_dist_mode(self, dist_mode: str):
        """'shard_map' or 'auto' (validated when the fit runs; inert
        without a mesh)."""
        self._dist_mode = dist_mode
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
    setDistMode = set_dist_mode

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
            mesh=self._mesh, dist_mode=self._dist_mode,
            loss_mode=self._loss_mode, device=self._device)
        return weights


def run_minibatch_agd(data, gradient: Gradient, updater: Prox,
                      minibatch_fraction: float = 1.0, seed: int = 42,
                      **kwargs):
    """``runMiniBatchAGD``: full AGD (:func:`run`, which takes
    ``kwargs``) on one fixed Bernoulli subsample drawn up front with
    ``np.random.default_rng(seed)``, the JAX package's draw, so both
    packages fit the same rows."""
    if not 0.0 < minibatch_fraction <= 1.0:
        raise ValueError("minibatch_fraction must be in (0, 1]")
    if minibatch_fraction < 1.0:
        X, y, mask = _normalize_data(data)
        rng = np.random.default_rng(seed)
        sample = (rng.random(X.shape[0]) < minibatch_fraction) \
            .astype(np.float32)
        if isinstance(mask, torch.Tensor):  # the sample goes to the mask
            mask = mask * torch.from_numpy(sample).to(mask.device)
        else:
            mask = sample if mask is None else np.asarray(mask) * sample
        data = (X, y, mask)
    return run(data, gradient, updater, **kwargs)


def run_minibatch_sgd(
    data,
    gradient: Gradient,
    updater: Prox,
    step_size: float = 1.0,
    num_iterations: int = 100,
    reg_param: float = 0.0,
    minibatch_fraction: float = 1.0,
    initial_weights: Any = None,
    seed: int = 42,
    *,
    mesh=False,
    device=None,
):
    """MLlib ``GradientDescent.runMiniBatchSGD``, the oracle the
    reference tests against: returns ``(weights, loss_history)``, one
    history entry per iteration (``core.gd``).  Single device only in
    this slice (``mesh`` takes ``None`` or ``False``)."""
    if initial_weights is None:
        raise ValueError("initial_weights is required")
    _reject_later(mesh=mesh)
    dev = resolve_device(device)
    X, y, mask = _normalize_data(data)
    res = gd.run_minibatch_sgd(
        gradient, updater, _place(X, dev), _place(y, dev),
        tvec.tmap(lambda a: _owned(a, dev), initial_weights),
        step_size=step_size, num_iterations=num_iterations,
        reg_param=reg_param, minibatch_fraction=minibatch_fraction,
        mask=_place(mask, dev), seed=seed)
    return res.weights, res.loss_history.numpy()


def make_lbfgs_runner(
    data,
    gradient: Gradient,
    updater: Prox,
    num_corrections: int = 10,
    convergence_tol: float = 1e-4,
    num_iterations: int = 100,
    reg_param: float = 0.0,
    *,
    grad_tol: float = 0.0,
    mesh=None,
    dist_mode: str = "shard_map",
    device=None,
    telemetry=None,
):
    """Build ``fit(initial_weights) -> LBFGSResult`` over data placed and
    prepared once: MLlib 1.3's ``LBFGS`` with the updater's smooth
    penalty folded into the objective; an L1 or elastic-net updater
    routes to OWL-QN through ``Prox.owlqn_decomposition``, checked
    before any staging.  ``fit.algorithm`` is ``"lbfgs"`` or
    ``"owlqn"``."""
    decomp = updater.owlqn_decomposition(float(reg_param))
    if decomp is None:
        raise ValueError(
            f"{type(updater).__name__} offers neither a smooth penalty "
            "nor an L1+smooth split (Prox.owlqn_decomposition); the "
            "quasi-Newton drivers cannot represent it — use "
            "AcceleratedGradientDescent")
    l1_coeff, extra = decomp
    _check_dist_mode(dist_mode)
    _reject_later(mesh=mesh, telemetry=telemetry)
    dev = resolve_device(device)
    X, y, mask = _normalize_data(data)
    build, dargs = smooth_lib.make_smooth_staged(
        gradient, _place(X, dev), _place(y, dev), _place(mask, dev))
    cfg = lbfgs_lib.LBFGSConfig(
        num_corrections=num_corrections, convergence_tol=convergence_tol,
        num_iterations=num_iterations, grad_tol=grad_tol)
    algorithm = "owlqn" if l1_coeff > 0 else "lbfgs"

    def fit(initial_weights):
        w0 = tvec.tmap(lambda a: _owned(a, dev), initial_weights)
        sm = build(*dargs)[0]

        def objective(w):
            f, g = sm(w)
            pv, pg = extra(w)
            return f + pv, tvec.add(g, pg)

        if l1_coeff > 0:
            return lbfgs_lib.run_owlqn(objective, w0, l1_coeff, cfg)
        return lbfgs_lib.run_lbfgs(objective, w0, cfg)

    fit.algorithm = algorithm
    fit.data_args = dargs
    return fit


def run_lbfgs(
    data,
    gradient: Gradient,
    updater: Prox,
    num_corrections: int = 10,
    convergence_tol: float = 1e-4,
    num_iterations: int = 100,
    reg_param: float = 0.0,
    initial_weights: Any = None,
    *,
    grad_tol: float = 0.0,
    mesh=None,
    dist_mode: str = "shard_map",
    device=None,
    telemetry=None,
):
    """MLlib's ``LBFGS.runLBFGS``: returns the full ``LBFGSResult``."""
    if initial_weights is None:
        raise ValueError("initial_weights is required")
    fit = make_lbfgs_runner(
        data, gradient, updater, num_corrections=num_corrections,
        convergence_tol=convergence_tol, num_iterations=num_iterations,
        reg_param=reg_param, grad_tol=grad_tol, mesh=mesh,
        dist_mode=dist_mode, device=device, telemetry=telemetry)
    return fit(initial_weights)


class LBFGS:
    """Config-holder twin of MLlib 1.3's ``LBFGS(gradient, updater)``:
    the Optimizer trait's ``optimize(data, initial_weights) -> weights``,
    so it swaps with :class:`AcceleratedGradientDescent` in a trainer's
    seat; ``set_device`` picks the device (default: CUDA)."""

    def __init__(self, gradient: Gradient, updater: Prox):
        self._gradient = gradient
        self._updater = updater
        self._num_corrections = 10
        self._convergence_tol = 1e-4
        self._num_iterations = 100
        self._reg_param = 0.0
        self._grad_tol = 0.0
        self._mesh = None
        self._dist_mode = "shard_map"
        self._device = None

    def set_num_corrections(self, m: int):
        self._num_corrections = int(m)
        return self

    def set_convergence_tol(self, tol: float):
        self._convergence_tol = float(tol)
        return self

    def set_num_iterations(self, iters: int):
        self._num_iterations = int(iters)
        return self

    def set_reg_param(self, reg_param: float):
        self._reg_param = float(reg_param)
        return self

    def set_gradient(self, gradient: Gradient):
        self._gradient = gradient
        return self

    def set_updater(self, updater: Prox):
        self._updater = updater
        return self

    def set_grad_tol(self, tol: float):
        self._grad_tol = float(tol)
        return self

    def set_mesh(self, mesh):
        """Only ``None`` and ``False`` (single device) in this slice."""
        _reject_later(mesh=mesh)
        self._mesh = mesh
        return self

    def set_dist_mode(self, dist_mode: str):
        self._dist_mode = dist_mode
        return self

    def set_device(self, device):
        """The device the fit runs on (``None``: the current CUDA
        device, raising when there is none)."""
        self._device = device
        return self

    setNumCorrections = set_num_corrections
    setConvergenceTol = set_convergence_tol
    setNumIterations = set_num_iterations
    setRegParam = set_reg_param
    setGradient = set_gradient
    setUpdater = set_updater
    setGradTol = set_grad_tol
    setDistMode = set_dist_mode

    def optimize(self, data, initial_weights: Any):
        res = run_lbfgs(
            data, self._gradient, self._updater,
            num_corrections=self._num_corrections,
            convergence_tol=self._convergence_tol,
            num_iterations=self._num_iterations,
            reg_param=self._reg_param, initial_weights=initial_weights,
            grad_tol=self._grad_tol, mesh=self._mesh,
            dist_mode=self._dist_mode, device=self._device)
        return res.weights

    def sweep(self, data, reg_params, initial_weights: Any):
        """The regularization path needs the lanes
        (``make_lbfgs_sweep_runner``): not ported yet."""
        raise NotImplementedError(
            f"LBFGS.sweep {_LATER} (the lanes, api.sweep and "
            f"make_lbfgs_sweep_runner, arrive in a later slice)")
