"""Public API, single-device subset: the reference's surface on PyTorch.

Counterpart of ``spark_agd_tpu/api.py``: the ``AcceleratedGradientDescent``
class with its fluent setters (snake_case and camelCase), ``optimize``,
the functional ``run(...) -> (weights, loss_history)``, ``make_runner``
and ``run_minibatch_agd``; the rest of the Optimizer family: the GD
comparator ``run_minibatch_sgd`` and the quasi-Newton member
(``LBFGS``, ``run_lbfgs``, ``make_lbfgs_runner``, which route L1 and
elastic-net updaters to OWL-QN); and the lanes: the regularization paths
(``sweep``, ``make_sweep_runner``, ``sweep_warm_state``; for L-BFGS
``LBFGS.sweep`` and ``make_lbfgs_sweep_runner``) and K-fold
cross-validation (``cross_validate``, ``make_cv_runner``, ``CVResult``),
K fits in lock-step through ``core.host_agd`` and
``core.lbfgs.run_lanes`` where the JAX package ``vmap``s its fused
loops; and the streamed paths over data larger than the card
(``streaming_sweep``, ``streaming_lbfgs_sweep``, over a
``data.streaming.StreamingDataset``).  Data is ``(X, y)`` or ``(X, y,
mask)``, as tensors or numpy arrays, with X dense or an
``ops.sparse.CSRMatrix``; it is placed on the run's device once.

The entry points run on the current CUDA device unless the caller passes
``device=`` (``"cpu"`` for the CPU); with no CUDA device and no explicit
device they raise.  ``dist_mode=`` is validated and, with no mesh,
inert, as in the JAX package.  ``verbose=True`` logs the fit's
per-iteration lines through ``utils.logging.log_result``.
``run(resilience=..., checkpointer=...)`` runs the fit under the
single-device supervisor (``resilience.supervisor``): segments, retries,
rollbacks and an ``AutoCheckpointer``.  Meshes, ``journal=``, telemetry
and the sharded update are not in this slice: asking for them raises
``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ._device import resolve_device
from ._later import reject_later
from .core import agd, gd, host_agd, lbfgs as lbfgs_lib, prng
from .core import smooth as smooth_lib, tvec
from .ops.losses import Gradient
from .ops.prox import IdentityProx, Prox
from .ops.sparse import CSRMatrix

_DIST_MODES = ("shard_map", "auto")


def _check_dist_mode(dist_mode):
    """Raise ``ValueError`` for a mode the JAX package does not know; a
    known mode is inert without a mesh."""
    if dist_mode not in _DIST_MODES:
        raise ValueError(f"unknown dist_mode {dist_mode!r}; expected one "
                         f"of {_DIST_MODES}")


def _check_grid_fit(updater, reg_params, op_name: str):
    """Shared guard of every grid fit: a grid through the identity prox
    would be silently ignored."""
    reg_params = list(reg_params)
    if isinstance(updater, IdentityProx) and any(
            float(r) != 0.0 for r in reg_params):
        raise ValueError(
            f"the updater is IdentityProx (no penalty), so "
            f"reg_params would be ignored; use an explicit updater "
            f"(e.g. L2Prox()) for {op_name}")
    return reg_params


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


def _stage(data, gradient: Gradient, device):
    """``(device, (build, data_args))``: the data placed on the run's
    device once and prepared (``core.smooth.make_smooth_staged``)."""
    dev = resolve_device(device)
    X, y, mask = _normalize_data(data)
    return dev, smooth_lib.make_smooth_staged(
        gradient, _place(X, dev), _place(y, dev), _place(mask, dev))


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
    reject_later(mesh=mesh, telemetry=telemetry,
                 sharded_update=sharded_update)
    dev, (build, dargs) = _stage(data, gradient, device)
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
    also returns the full ``AGDResult``.  ``verbose=True`` logs the
    per-iteration lines and the reference's completion line
    (``utils.logging.log_result``, on the ``spark_agd_tpu`` logger)
    after the fit.

    ``resilience`` (a ``resilience.ResiliencePolicy``, or ``True`` for
    the defaults; off by default): run under the supervisor instead of
    one straight fit: segments, bounded retries with backoff on
    transient failures, rollback to the last good warm state with a step
    cut on non-finite numerics.  ``checkpointer`` (supervised path only,
    a ``resilience.AutoCheckpointer``) adds preemption-safe
    checkpoints and a corruption-tolerant resume.  ``return_result=True``
    then returns the ``SupervisedResult`` third, and ``verbose=True``
    logs one line of its retries and rollbacks.  ``journal=`` comes with
    the observability slice and raises."""
    if initial_weights is None:
        raise ValueError("initial_weights is required")
    reject_later(journal=journal)
    if resilience is not None:
        cfg = agd.AGDConfig(
            convergence_tol=convergence_tol, num_iterations=num_iterations,
            l0=l0, l_exact=l_exact, beta=beta, alpha=alpha,
            may_restart=may_restart, loss_mode=loss_mode)
        return _run_supervised(
            data, gradient, updater, cfg, reg_param, initial_weights,
            mesh, dist_mode, return_result, device, telemetry, verbose,
            resilience, checkpointer, sharded_update)
    if checkpointer is not None:
        raise ValueError(
            "checkpointer=/journal= require the supervised path; pass "
            "resilience=True (or a ResiliencePolicy) as well")
    fit = make_runner(
        data, gradient, updater, convergence_tol=convergence_tol,
        num_iterations=num_iterations, reg_param=reg_param, l0=l0,
        l_exact=l_exact, beta=beta, alpha=alpha, may_restart=may_restart,
        mesh=mesh, dist_mode=dist_mode, loss_mode=loss_mode, device=device,
        telemetry=telemetry, sharded_update=sharded_update)
    result = fit(initial_weights)
    n = int(result.num_iters)
    loss_history = result.loss_history[:n].numpy()
    if verbose:
        from .utils import logging as logging_utils

        logging_utils.log_result(result)
    if return_result:
        return result.weights, loss_history, result
    return result.weights, loss_history


def _run_supervised(data, gradient, updater, cfg, reg_param,
                    initial_weights, mesh, dist_mode, return_result,
                    device, telemetry, verbose, resilience, checkpointer,
                    sharded_update):
    """The ``resilience=`` branch of :func:`run`: the staging of
    :func:`make_runner`, driven by
    ``resilience.supervisor.run_agd_supervised``."""
    from .resilience import supervisor as supervisor_lib

    _check_dist_mode(dist_mode)
    reject_later(mesh=mesh, telemetry=telemetry,
                 sharded_update=sharded_update)
    policy = None if resilience is True else resilience
    dev, staged = _stage(data, gradient, device)
    px, rv = smooth_lib.make_prox(updater, reg_param)
    sres = supervisor_lib.run_agd_supervised(
        prox=px, reg_value=rv, w0=initial_weights, config=cfg,
        policy=policy, checkpointer=checkpointer, staged=staged,
        place_w=lambda w: tvec.tmap(lambda a: _owned(a, dev), w))
    loss_history = np.asarray(sres.loss_history)
    if verbose:
        from .utils import logging as logging_utils

        logging_utils.logger.info(
            "supervised run: %d iterations, %d retries, %d rollbacks, "
            "resumed from %d", sres.num_iters, sres.retries,
            sres.rollbacks, sres.resumed_from)
    if return_result:
        return sres.weights, loss_history, sres
    return sres.weights, loss_history


# ---------------------------------------------------------------------------
# The lanes: regularization paths and cross-validation (api.py:567-957)
# ---------------------------------------------------------------------------


def _regs(reg_params) -> torch.Tensor:
    """The strengths as a 1-D f32 tensor: the JAX sweeps cast them to
    float32 whatever the carry dtype (``api.py:635``, ``:925``), so an
    f64 lane runs at ``float(np.float32(reg))``."""
    regs = torch.as_tensor(np.asarray(reg_params, np.float32))
    if regs.dim() != 1:
        raise ValueError("reg_params must be 1-D")
    return regs


def _stack_lanes(initial_weights, k: int):
    """Broadcast one starting point onto a leading K lane axis."""
    return tvec.tmap(lambda a: torch.stack([a] * k), initial_weights)


def _batched_result(run: host_agd.LaneRun, n: int) -> agd.AGDResult:
    """A lock-step run as the JAX sweep's batched ``AGDResult``: every
    field with a leading K axis, the per-iteration arrays ``(K, n)``,
    NaN (False) past each lane's ``num_iters``."""
    end = run.carry

    def padded(rows, fill):
        t = rows.shape[0]
        out = torch.full((rows.shape[1], n), fill, dtype=rows.dtype)
        out[:, :t] = rows.T
        return out

    return agd.AGDResult(
        weights=end.x, loss_history=padded(run.loss, math.nan),
        num_iters=run.num_iters.to(torch.int32),
        aborted_non_finite=end.aborted, final_l=end.big_l,
        num_backtracks=end.num_backtracks.to(torch.int32),
        num_restarts=end.num_restarts.to(torch.int32), final_z=end.z,
        final_theta=end.theta, final_bts=end.bts,
        converged=end.converged,
        diag_l=padded(run.diag_l, math.nan),
        diag_theta=padded(run.diag_theta, math.nan),
        diag_step=padded(run.diag_step, math.nan),
        diag_restarted=padded(run.diag_restarted, False))


def _warm_carry(warm: agd.AGDWarmState, k: int, dev) -> host_agd.LaneCarry:
    """The lock-step carry of a batched ``AGDWarmState``: every lane
    runs the next segment, a lane that stopped in the last one too (as
    the JAX sweep's warm runs do); counters start at 0."""
    dt = host_agd.carry_dtype(warm.x)

    def t(a, dtype):
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        return a.to(dtype).reshape(k).cpu().clone()

    zeros = torch.zeros(k, dtype=torch.int64)
    no = torch.zeros(k, dtype=torch.bool)
    return host_agd.LaneCarry(
        x=tvec.tmap(lambda a: _place(a, dev), warm.x),
        z=tvec.tmap(lambda a: _place(a, dev), warm.z),
        theta=t(warm.theta, dt), big_l=t(warm.big_l, dt),
        bts=t(warm.bts, torch.bool),
        prior_iters=t(warm.prior_iters, torch.int64),
        active=torch.ones(k, dtype=torch.bool), num_backtracks=zeros,
        num_restarts=zeros, aborted=no, converged=no)


def make_sweep_runner(
    data,
    gradient: Gradient,
    updater: Prox,
    convergence_tol: float = 1e-4,
    num_iterations: int = 100,
    l0: float = 1.0,
    l_exact: float = math.inf,
    beta: float = 0.5,
    alpha: float = 0.9,
    may_restart: bool = True,
    *,
    mesh=False,
    loss_mode: str = "x",
    device=None,
):
    """Build ``fit(initial_weights, reg_params, warm=None) -> batched
    AGDResult`` over data placed and prepared once: the regularization
    path, K strengths fitted in lock-step, every evaluation one
    ``lanes_loss_and_grad`` call for all lanes (one launch of the lanes
    kernel through ``FusedMarginGradient``).  ``warm``: a batched
    ``AGDWarmState`` (``sweep_warm_state``) continues every lane.
    Single device only in this slice (``mesh`` takes ``None`` or
    ``False``)."""
    reject_later(mesh=mesh)
    cfg = agd.AGDConfig(
        convergence_tol=convergence_tol, num_iterations=num_iterations,
        l0=l0, l_exact=l_exact, beta=beta, alpha=alpha,
        may_restart=may_restart, loss_mode=loss_mode)
    dev = resolve_device(device)
    X, y, mask = _normalize_data(data)
    dargs = gradient.prepare(_place(X, dev), _place(y, dev),
                             _place(mask, dev))
    sm, sl = smooth_lib.lanes_smooth(gradient, *dargs)

    def fit(initial_weights, reg_params, warm=None):
        regs = _regs(reg_params)
        k = regs.shape[0]
        if warm is None:
            w0 = tvec.tmap(lambda a: _owned(a, dev), initial_weights)
            carry = host_agd.initial_carry(_stack_lanes(w0, k), cfg)
        else:
            carry = _warm_carry(warm, k, dev)
        px, rv = host_agd.make_prox_multi(updater, regs)
        run_ = host_agd.run_lanes(sm, px, rv, carry, cfg,
                                  smooth_loss_multi=sl)
        return _batched_result(run_, cfg.num_iterations)

    fit.data_args = dargs
    return fit


def sweep_warm_state(res, prior_iters=0) -> agd.AGDWarmState:
    """The batched continuation carry out of a sweep's ``AGDResult``, for
    ``make_sweep_runner``'s ``fit(..., warm=...)``.  ``prior_iters``:
    iterations executed before the segment ``res`` came from (pass the
    previous warm's when chaining), so the ``nIter > 1`` gate sees the
    total."""
    prior = torch.as_tensor(np.asarray(prior_iters)).to(torch.int32)
    return agd.AGDWarmState(
        x=res.weights, z=res.final_z, theta=res.final_theta,
        big_l=res.final_l, bts=res.final_bts,
        prior_iters=prior + res.num_iters)


def sweep(
    data,
    gradient: Gradient,
    updater: Prox,
    reg_params,
    convergence_tol: float = 1e-4,
    num_iterations: int = 100,
    initial_weights: Any = None,
    l0: float = 1.0,
    l_exact: float = math.inf,
    beta: float = 0.5,
    alpha: float = 0.9,
    may_restart: bool = True,
    *,
    mesh=False,
    loss_mode: str = "x",
    device=None,
):
    """Fit one problem at K regularization strengths: each lane equals a
    solo ``run`` at its strength (cast to f32), and X is read once per
    evaluation for all lanes.  Returns a batched ``AGDResult``: every
    field gains a leading K axis, ``loss_history`` is ``(K,
    num_iterations)``, NaN past each lane's ``num_iters``."""
    if initial_weights is None:
        raise ValueError("initial_weights is required")
    fit = make_sweep_runner(
        data, gradient, updater, convergence_tol=convergence_tol,
        num_iterations=num_iterations, l0=l0, l_exact=l_exact, beta=beta,
        alpha=alpha, may_restart=may_restart, mesh=mesh,
        loss_mode=loss_mode, device=device)
    return fit(initial_weights, reg_params)


class CVResult(NamedTuple):
    """``cross_validate`` output, indexed ``[fold, strength]``:
    ``val_loss`` (F, R), the mean smooth loss on each held-out fold (NaN
    for an empty one); ``train_result``, the batched ``AGDResult`` with
    leading axes (F, R); ``mean_val_loss`` (R,), a ``nanmean`` over the
    folds; ``best_index`` (), its argmin as the JAX package takes it,
    NaN counting as the least value (a strength with no valid fold wins;
    the model layer refuses to refit a non-finite winner); ``fold_ids``
    (N,), the fold assignment; ``base_mask`` (N,), the
    validity mask the CV ran under (all ones when the data had none)."""

    val_loss: torch.Tensor
    train_result: Any
    mean_val_loss: torch.Tensor
    best_index: torch.Tensor
    fold_ids: torch.Tensor
    base_mask: torch.Tensor


def make_cv_runner(
    data,
    gradient: Gradient,
    updater: Prox,
    n_folds: int = 5,
    convergence_tol: float = 1e-4,
    num_iterations: int = 100,
    l0: float = 1.0,
    l_exact: float = math.inf,
    beta: float = 0.5,
    alpha: float = 0.9,
    may_restart: bool = True,
    *,
    mesh=False,
    loss_mode: str = "x",
    seed: int = 0,
    device=None,
):
    """Build ``fit(initial_weights, reg_params) -> CVResult`` with the
    data placed and the folds assigned once (see
    :func:`cross_validate`)."""
    return _build_cv(data, gradient, updater, n_folds, convergence_tol,
                     num_iterations, l0, l_exact, beta, alpha,
                     may_restart, mesh, loss_mode, seed, device)


def cross_validate(
    data,
    gradient: Gradient,
    updater: Prox,
    reg_params,
    n_folds: int = 5,
    convergence_tol: float = 1e-4,
    num_iterations: int = 100,
    initial_weights: Any = None,
    l0: float = 1.0,
    l_exact: float = math.inf,
    beta: float = 0.5,
    alpha: float = 0.9,
    may_restart: bool = True,
    *,
    mesh=False,
    loss_mode: str = "x",
    seed: int = 0,
    device=None,
) -> CVResult:
    """K-fold cross-validation over a regularization grid: the
    ``n_folds x len(reg_params)`` fits run as lanes in lock-step, each
    lane training under its fold's complement (an (N, K) mask, a column
    a lane) and scored on its held-out fold.  Folds are JAX's
    assignment for ``seed`` (:func:`fold_assignment`), so both packages
    hold out the same rows.  Rows masked out by an input ``(X, y,
    mask)`` stay out of training and validation everywhere.  The plain
    gradients only: a fused gradient's staged X is refused, as the JAX
    package refuses its Pallas layouts."""
    fit = make_cv_runner(
        data, gradient, updater, n_folds=n_folds,
        convergence_tol=convergence_tol, num_iterations=num_iterations,
        l0=l0, l_exact=l_exact, beta=beta, alpha=alpha,
        may_restart=may_restart, mesh=mesh, loss_mode=loss_mode,
        seed=seed, device=device)
    return fit(initial_weights, reg_params)


def fold_assignment(n: int, n_folds: int, seed: int, device) -> torch.Tensor:
    """The JAX package's balanced fold ids (``api.py:836-843``): fold
    ``i % n_folds`` for the i-th row of ``jax.random.permutation(
    PRNGKey(seed), n)``, as an int32 tensor on ``device``."""
    perm = prng.permutation(seed, n, device)
    fold_ids = torch.zeros(n, dtype=torch.int32, device=device)
    fold_ids[perm] = (torch.arange(n, device=device) % n_folds).to(
        torch.int32)
    return fold_ids


def _nan_first_argmin(v: torch.Tensor) -> torch.Tensor:
    """The argmin of ``v`` with NaN taken as the least value: the first
    NaN entry when there is one, else the argmin (what ``jnp.argmin``
    returns, ``spark_agd_tpu/api.py:946``)."""
    nan = torch.isnan(v)
    if bool(nan.any()):
        return nan.to(torch.int8).argmax()
    return v.argmin()


def _build_cv(data, gradient, updater, n_folds, convergence_tol,
              num_iterations, l0, l_exact, beta, alpha, may_restart,
              mesh, loss_mode, seed, device):
    """Stage the data and assign the folds once; ``fit(initial_weights,
    reg_params)`` runs the lane grid."""
    if n_folds < 2:
        raise ValueError("n_folds must be >= 2")
    reject_later(mesh=mesh)
    cfg = agd.AGDConfig(
        convergence_tol=convergence_tol, num_iterations=num_iterations,
        l0=l0, l_exact=l_exact, beta=beta, alpha=alpha,
        may_restart=may_restart, loss_mode=loss_mode)
    dev = resolve_device(device)
    X, y, base_mask = _normalize_data(data)
    n = X.shape[0]
    base_mask = (torch.ones(n, dtype=torch.float32, device=dev)
                 if base_mask is None
                 else _place(base_mask, dev).to(torch.float32))
    X, y, _ = gradient.prepare(_place(X, dev), _place(y, dev), None)
    if getattr(X, "shape", (None,))[0] != n:
        raise ValueError(
            "cross_validate drives masks through the kernels, so a "
            "gradient whose prepare() re-pads rows (e.g. the fused "
            "Pallas layouts) is not supported here; use the plain "
            "XLA gradients")
    fold_ids = fold_assignment(n, n_folds, seed, dev)

    def fit(initial_weights, reg_params):
        if initial_weights is None:
            raise ValueError("initial_weights is required")
        regs = _regs(reg_params)
        n_regs = regs.shape[0]
        k = n_folds * n_regs
        fold_lane = torch.arange(n_folds, dtype=torch.int32,
                                 device=dev).repeat_interleave(n_regs)
        held = fold_ids[:, None] == fold_lane[None, :]
        train = base_mask[:, None] * ~held
        sm, _ = smooth_lib.lanes_smooth(gradient, X, y, train)
        w0 = tvec.tmap(lambda a: _owned(a, dev), initial_weights)
        px, rv = host_agd.make_prox_multi(updater, regs.repeat(n_folds))
        run_ = host_agd.run_lanes(
            sm, px, rv, host_agd.initial_carry(_stack_lanes(w0, k), cfg),
            cfg, smooth_loss_multi=lambda W: _mean_loss(gradient, W, X, y,
                                                        train))
        del train
        res = _batched_result(run_, cfg.num_iterations)
        val = _mean_loss(gradient, res.weights, X, y,
                         base_mask[:, None] * held)
        val_loss = val.reshape(n_folds, n_regs)
        train_result = agd.AGDResult(*(
            tvec.tmap(lambda a: a.reshape((n_folds, n_regs) + a.shape[1:]),
                      field) for field in res))
        mean_val = torch.nanmean(val_loss, dim=0)
        return CVResult(val_loss=val_loss, train_result=train_result,
                        mean_val_loss=mean_val,
                        best_index=_nan_first_argmin(mean_val),
                        fold_ids=fold_ids, base_mask=base_mask)

    return fit


def _mean_loss(gradient, W, X, y, masks):
    """``(K,)`` mean losses of the lanes of ``W`` under ``masks``; an
    empty selection reads NaN, never a perfect 0.0."""
    ls, _, cnt = gradient.lanes_loss_and_grad(W, X, y, masks)
    cnt = cnt.to(ls.dtype)
    return torch.where(cnt > 0, ls / torch.clamp_min(cnt, 1), math.nan)


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
        reject_later(mesh=mesh)
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

    def _check_grid_fit(self, reg_params, op_name: str):
        return _check_grid_fit(self._updater, reg_params, op_name)

    def sweep(self, data, reg_params, initial_weights: Any):
        """The regularization path with this object's configuration
        (module-level :func:`sweep`); ``set_reg_param`` is ignored, the
        grid supplies the strengths."""
        reg_params = self._check_grid_fit(reg_params, "sweep")
        return sweep(
            data, self._gradient, self._updater, reg_params,
            convergence_tol=self._convergence_tol,
            num_iterations=self._num_iterations,
            initial_weights=initial_weights,
            l0=self._l0, l_exact=self._l_exact, beta=self._beta,
            alpha=self._alpha, may_restart=self._may_restart,
            mesh=self._mesh, loss_mode=self._loss_mode,
            device=self._device)

    def cross_validate(self, data, reg_params, initial_weights: Any,
                       n_folds: int = 5, seed: int = 0) -> CVResult:
        """K-fold CV over a grid with this object's configuration
        (module-level :func:`cross_validate`)."""
        reg_params = self._check_grid_fit(reg_params, "cross_validate")
        return cross_validate(
            data, self._gradient, self._updater, reg_params,
            n_folds=n_folds, convergence_tol=self._convergence_tol,
            num_iterations=self._num_iterations,
            initial_weights=initial_weights,
            l0=self._l0, l_exact=self._l_exact, beta=self._beta,
            alpha=self._alpha, may_restart=self._may_restart,
            mesh=self._mesh, loss_mode=self._loss_mode, seed=seed,
            device=self._device)


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
    reject_later(mesh=mesh)
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
    reject_later(mesh=mesh, telemetry=telemetry)
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
        reject_later(mesh=mesh)
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
        """The L-BFGS regularization path with this object's configuration
        (:func:`make_lbfgs_sweep_runner`; smooth penalties only, and
        ``set_reg_param`` is ignored: the grid supplies the strengths).
        It makes the ``*WithLBFGS`` trainers' ``train_path`` work as the
        AGD seats' does."""
        reg_params = _check_grid_fit(self._updater, reg_params, "sweep")
        fit = make_lbfgs_sweep_runner(
            data, self._gradient, self._updater,
            num_corrections=self._num_corrections,
            convergence_tol=self._convergence_tol,
            num_iterations=self._num_iterations, grad_tol=self._grad_tol,
            mesh=self._mesh, device=self._device)
        return fit(initial_weights, reg_params)


def make_lbfgs_sweep_runner(
    data,
    gradient: Gradient,
    updater: Prox,
    num_corrections: int = 10,
    convergence_tol: float = 1e-4,
    num_iterations: int = 100,
    *,
    grad_tol: float = 0.0,
    mesh=False,
    device=None,
):
    """Build ``fit(initial_weights, reg_params) -> batched LBFGSResult``
    over data placed and prepared once: the regularization path of the
    quasi-Newton member, K fits in lock-step (the JAX package ``vmap``s
    its fused loop).  Each lane runs ``run_lbfgs``'s loop at its
    strength, and each round evaluates every lane that is still running
    in one ``lanes_loss_and_grad`` call (one launch of the lanes kernel
    through ``FusedMarginGradient``; lane by lane for the softmax), plus
    each lane's smooth penalty.  A lane that has stopped is frozen.
    Smooth penalties only (L1 and elastic-net grids raise, as in the JAX
    package, where the OWL-QN dispatch cannot join traced lanes).  The
    result's fields gain a leading K axis; ``eval_rounds`` counts the
    rounds.  Single device only in this slice (``mesh`` takes ``None`` or
    ``False``)."""
    reject_later(mesh=mesh)
    lbfgs_lib.check_smooth_penalty(updater, 1.0)
    cfg = lbfgs_lib.LBFGSConfig(
        num_corrections=num_corrections, convergence_tol=convergence_tol,
        num_iterations=num_iterations, grad_tol=grad_tol)
    dev = resolve_device(device)
    X, y, mask = _normalize_data(data)
    dargs = gradient.prepare(_place(X, dev), _place(y, dev),
                             _place(mask, dev))
    sm, _ = smooth_lib.lanes_smooth(gradient, *dargs)

    def fit(initial_weights, reg_params):
        regs = _lbfgs_regs(_check_grid_fit(updater, reg_params,
                                           "make_lbfgs_sweep_runner"))
        w0 = tvec.tmap(lambda a: _owned(a, dev), initial_weights)
        return lbfgs_lib.run_lbfgs_lanes(
            _penalized_lanes(sm, updater, regs),
            _stack_lanes(w0, len(regs)), cfg)

    fit.data_args = dargs
    return fit


def _lbfgs_regs(reg_params):
    """An L-BFGS path's strengths as Python floats (f64): each lane's
    penalty at the precision a solo fit's reg_param carries (the JAX
    runners take the default float dtype for the same reason)."""
    regs = np.asarray(reg_params, np.float64)
    if regs.ndim != 1:
        raise ValueError("reg_params must be 1-D")
    return [float(r) for r in regs]


def _penalized_lanes(smooth_multi, updater, regs):
    """``objective_multi(W)`` of an L-BFGS path: each lane's smooth value
    and gradient plus its smooth penalty at its strength."""

    def objective_multi(W):
        fs, G = smooth_multi(W)
        pen = [updater.smooth_penalty(tvec.lane(W, i), r)
               for i, r in enumerate(regs)]
        return (fs + torch.stack([torch.as_tensor(p[0]).to(fs)
                                  for p in pen]),
                tvec.stack_lanes([tvec.add(tvec.lane(G, i), p[1])
                                  for i, p in enumerate(pen)]))

    return objective_multi


# ---------------------------------------------------------------------------
# The streamed paths: data larger than the card (api.py:1108, :1579)
# ---------------------------------------------------------------------------


def streaming_sweep(
    dataset,
    gradient: Gradient,
    updater: Prox,
    reg_params,
    convergence_tol: float = 1e-4,
    num_iterations: int = 100,
    initial_weights: Any = None,
    l0: float = 1.0,
    l_exact: float = math.inf,
    beta: float = 0.5,
    alpha: float = 0.9,
    may_restart: bool = True,
    *,
    mesh=None,
    pad_to=None,
    csr_nnz_per_shard=None,
    loss_mode: str = "x",
    device=None,
    pass_stats: list | None = None,
):
    """Train a K-strength regularization path over a streamed dataset
    (a ``data.streaming.StreamingDataset``): one stream read per trial
    for all lanes.  The K lanes run the host driver in lock-step
    (``core.host_agd.run_agd_host_multi``) over a multi-lane streamed
    smooth (``data.streaming.make_streaming_eval_multi``): per
    macro-batch the K lanes are one ``gradient.lanes_loss_and_grad``
    call, one launch of the lanes kernel through ``FusedMarginGradient``.

    Returns a ``core.host_agd.HostAGDMultiResult`` (a leading K axis per
    field; ``loss_history[:, k][:num_iters[k]]`` is lane k's history).
    Port-only keywords: ``device`` (the current CUDA device by default,
    ``"cpu"`` for the CPU) and ``pass_stats`` (a list that receives each
    pass's stats).
    ``mesh=`` and ``csr_nnz_per_shard=`` come with the mesh slice and
    raise."""
    from .data import streaming as streaming_lib

    if initial_weights is None:
        raise ValueError("initial_weights is required")
    reject_later(mesh=mesh, csr_nnz_per_shard=csr_nnz_per_shard)
    regs = list(reg_params)
    dev = resolve_device(device)
    # one placer for both evaluators: one ring of pinned staging buffers
    sm, sl = streaming_lib._eval_multi_pair(gradient, dataset, pad_to, dev,
                                            pass_stats)
    pxm, rvm = host_agd.make_prox_multi(updater, regs)
    w0 = tvec.tmap(lambda a: _owned(a, dev), initial_weights)
    cfg = agd.AGDConfig(
        convergence_tol=convergence_tol, num_iterations=num_iterations,
        l0=l0, l_exact=l_exact, beta=beta, alpha=alpha,
        may_restart=may_restart, loss_mode=loss_mode)
    return host_agd.run_agd_host_multi(sm, pxm, rvm,
                                       _stack_lanes(w0, len(regs)), cfg,
                                       smooth_loss_multi=sl)


def streaming_lbfgs_sweep(
    dataset,
    gradient: Gradient,
    updater: Prox,
    reg_params,
    num_corrections: int = 10,
    convergence_tol: float = 1e-4,
    num_iterations: int = 100,
    initial_weights: Any = None,
    *,
    grad_tol: float = 0.0,
    mesh=None,
    pad_to=None,
    csr_nnz_per_shard=None,
    device=None,
    pass_stats: list | None = None,
):
    """A K-strength L-BFGS regularization path over a streamed dataset:
    one stream read per evaluation round for all lanes.  Each lane runs
    the solo host algorithm (``core.host_lbfgs.run_lbfgs_host``'s), the
    lanes' pending evaluations batched into one
    ``data.streaming.make_streaming_eval_multi`` pass, plus each lane's
    smooth penalty.  Smooth penalties only, as in
    :func:`make_lbfgs_sweep_runner`.

    Returns a ``core.host_lbfgs.HostLBFGSMultiResult`` (a leading K axis;
    ``eval_rounds`` counts the stream passes).  Port-only keywords as in
    :func:`streaming_sweep`."""
    from .core import host_lbfgs
    from .data import streaming as streaming_lib

    if initial_weights is None:
        raise ValueError("initial_weights is required")
    reject_later(mesh=mesh, csr_nnz_per_shard=csr_nnz_per_shard)
    # the guard LBFGS.sweep applies: a no-penalty updater would return K
    # identical lanes
    regs = _lbfgs_regs(_check_grid_fit(updater, reg_params,
                                       "streaming_lbfgs_sweep"))
    lbfgs_lib.check_smooth_penalty(updater, 1.0)
    dev = resolve_device(device)
    sm_multi = streaming_lib.make_streaming_eval_multi(
        gradient, dataset, pad_to=pad_to, device=dev, pass_stats=pass_stats)
    w0 = tvec.tmap(lambda a: _owned(a, dev), initial_weights)
    cfg = lbfgs_lib.LBFGSConfig(
        num_corrections=num_corrections, convergence_tol=convergence_tol,
        num_iterations=num_iterations, grad_tol=grad_tol)
    return host_lbfgs.run_lbfgs_host_multi(
        _penalized_lanes(sm_multi, updater, regs),
        _stack_lanes(w0, len(regs)), cfg)
