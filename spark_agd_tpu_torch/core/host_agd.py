"""Host-orchestrated AGD: the streamed driver and the K-lane lock-step.

Counterpart of ``spark_agd_tpu/core/host_agd.py``.  :func:`run_agd_host`
(``HostAGDResult``) is the solo driver a *streamed* smooth needs
(``data.streaming``): ``core.agd.run_agd``, whose loop already runs on
the host, with the JAX host driver's result type (Python scalars, a
numpy history), so at f64 the two packages take the same steps.  Its
``on_iteration`` callback receives the continuation carry after each
outer iteration (``utils.logging.make_host_logger`` logs from it).

The rest is the multi-lane half (``HostAGDMultiResult``,
``HostMultiWarm``, ``multi_warm_state``, ``make_prox_multi``,
``run_agd_host_multi``), and the engine under ``api.sweep``,
``api.cross_validate`` and ``api.streaming_sweep``, where the JAX
package runs ``jax.vmap`` of the fused loop (``core/agd.py``) over the
lanes.

K fits of one problem run side by side, their weights stacked on a
leading lane axis.  Each backtracking trial evaluates every lane in one
``smooth_multi(W)`` call, so a lanes kernel reads X once for all of them;
a lane that has accepted its trial, or stopped, is frozen by masks while
the others go on, and since evaluations are pure the extra evaluations
change no lane's path.  Each lane decides exactly as the port's solo
``core.agd.run_agd`` does: the same recurrences in the carry dtype, the
exact-zero step gate, the non-finite ``f_y`` accept and abort, the
infinite- and NaN-``localL`` L update, ``max_backtracks`` and the
restart.  The control scalars come to the host as ``(K,)`` tensors,
a few copies a trial.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from . import tvec
from .agd import AGDConfig, _carry, run_agd  # noqa: F401 (_carry)
from ..ops.prox import lane_view


class HostAGDResult(NamedTuple):
    """Same fields as the JAX package's ``HostAGDResult``: the weights
    and ``final_z`` on the weights' device, ``loss_history`` a float64
    numpy array of one entry per executed iteration, the scalars Python
    values."""

    weights: Any
    loss_history: np.ndarray
    num_iters: int
    aborted_non_finite: bool
    final_l: float
    num_backtracks: int
    num_restarts: int
    # continuation carry (mirrors core.agd.AGDResult)
    final_z: Any = None
    final_theta: float = math.inf
    final_bts: bool = True
    # stopped by its own criteria (not the cap, not an abort)
    converged: bool = False


def run_agd_host(
    smooth: Callable,
    prox: Callable,
    reg_value: Callable,
    w0: Any,
    config: AGDConfig,
    *,
    smooth_loss: Callable | None = None,
    warm=None,
    on_iteration: Callable | None = None,
) -> HostAGDResult:
    """``core.agd.run_agd`` with the JAX host driver's result: Python
    scalars and a float64 history of the executed iterations.  ``warm``
    is a ``core.agd.AGDWarmState`` (or any object with its fields) to
    continue a run; ``on_iteration(state_dict)`` is called after every
    outer iteration with the full continuation carry plus that
    iteration's loss."""
    res = run_agd(smooth, prox, reg_value, w0, config,
                  smooth_loss=smooth_loss, warm=warm,
                  on_iteration=on_iteration)
    n = int(res.num_iters)
    return HostAGDResult(
        weights=res.weights,
        loss_history=res.loss_history[:n].to(torch.float64).numpy(),
        num_iters=n, aborted_non_finite=bool(res.aborted_non_finite),
        final_l=float(res.final_l), num_backtracks=int(res.num_backtracks),
        num_restarts=int(res.num_restarts), final_z=res.final_z,
        final_theta=float(res.final_theta), final_bts=bool(res.final_bts),
        converged=bool(res.converged))


class LaneCarry(NamedTuple):
    """Where K lanes start: the stacked iterates, ``(K,)`` CPU tensors
    for the scalars, which lanes run (``active``) and the counters that
    continue."""

    x: Any
    z: Any
    theta: torch.Tensor
    big_l: torch.Tensor
    bts: torch.Tensor
    prior_iters: torch.Tensor
    active: torch.Tensor
    num_backtracks: torch.Tensor
    num_restarts: torch.Tensor
    aborted: torch.Tensor
    converged: torch.Tensor


class LaneRun(NamedTuple):
    """The end of a lock-step run: the final carry, this run's
    ``num_iters`` per lane, and one row per executed iteration, ``(T,
    K)``, of the loss, the diagnostics and ``ran`` (the lanes that ran
    that iteration; elsewhere the rows hold NaN, or False)."""

    carry: LaneCarry
    num_iters: torch.Tensor
    loss: torch.Tensor
    diag_l: torch.Tensor
    diag_theta: torch.Tensor
    diag_step: torch.Tensor
    diag_restarted: torch.Tensor
    ran: torch.Tensor


def carry_dtype(x) -> torch.dtype:
    """The control-scalar dtype of a run over weights ``x``: f32 promoted
    with every leaf's dtype, as ``core.agd.run_agd`` takes it."""
    dt = torch.float32
    for leaf in tvec.leaves(x):
        dt = torch.promote_types(dt, leaf.dtype)
    return dt


def initial_carry(w0_stacked, config: AGDConfig) -> LaneCarry:
    """Every lane at iteration zero from its row of ``w0_stacked``."""
    dt = carry_dtype(w0_stacked)
    k = tvec.leaves(w0_stacked)[0].shape[0]
    zeros = torch.zeros(k, dtype=torch.int64)
    no = torch.zeros(k, dtype=torch.bool)
    return LaneCarry(
        x=w0_stacked, z=w0_stacked,
        theta=torch.full((k,), math.inf, dtype=dt),
        big_l=torch.full((k,), float(config.l0), dtype=dt),
        bts=torch.ones(k, dtype=torch.bool), prior_iters=zeros,
        active=torch.ones(k, dtype=torch.bool), num_backtracks=zeros,
        num_restarts=zeros, aborted=no, converged=no)


def run_lanes(smooth_multi: Callable, prox_multi: Callable,
              reg_value_multi: Callable, carry: LaneCarry,
              config: AGDConfig, *,
              smooth_loss_multi: Callable | None = None) -> LaneRun:
    """Run the active lanes of ``carry`` for up to
    ``config.num_iterations`` iterations in lock-step.

    ``smooth_multi(W) -> ((K,) mean losses, mean gradients stacked like
    W)``; ``prox_multi(Z, G, steps) -> Z_new`` with ``steps`` a ``(K,)``
    CPU tensor; ``reg_value_multi(W) -> (K,)``; ``smooth_loss_multi(W)
    -> (K,)`` serves ``loss_mode='x'`` when backtracking is off."""
    cfg = config
    if cfg.loss_mode not in ("x", "x_strict", "y"):
        raise ValueError(f"unknown loss_mode {cfg.loss_mode!r}")
    x, z = carry.x, carry.z
    dt = carry_dtype(x)
    first = tvec.leaves(x)[0]
    dev, k = first.device, first.shape[0]

    def c(v) -> torch.Tensor:
        """A 0-d CPU tensor of the carry dtype."""
        return torch.tensor(float(v), dtype=dt)

    def host(*vs):
        """``(K,)`` device values as CPU tensors of the carry dtype, in one
        copy."""
        t = torch.stack([torch.as_tensor(v, device=dev).detach().to(dt)
                         .reshape(k) for v in vs]).cpu()
        return t.unbind(0)

    def where(m, A, B):
        md = m.to(dev)
        return tvec.tmap(lambda a, b: torch.where(lane_view(md, a), a, b),
                         A, B)

    def axpby(a, A, b, B):
        return tvec.tmap(lambda u, v: lane_view(a, u).to(u.dtype) * u
                         + lane_view(b, v).to(v.dtype) * v, A, B)

    def pin(t):
        """Pin leaves to their weight leaf's dtype (``norm_smooth``)."""
        return tvec.tmap(lambda ti, wi: ti.to(wi.dtype), t, x)

    def evaluate(W):
        f, g = smooth_multi(W)
        return host(f)[0], pin(g)

    tol, l_exact, beta = c(cfg.convergence_tol), c(cfg.l_exact), c(cfg.beta)
    btol, alpha = c(cfg.backtrack_tol), c(cfg.alpha)
    backtracking = cfg.beta < 1.0

    theta = carry.theta.to(dt).clone()
    big_l = carry.big_l.to(dt).clone()
    bts = carry.bts.clone()
    active = carry.active.clone()
    aborted = carry.aborted.clone()
    converged = carry.converged.clone()
    n_bt = carry.num_backtracks.clone()
    n_restart = carry.num_restarts.clone()
    num_iters = torch.zeros(k, dtype=torch.int64)
    nan_row = torch.full((k,), math.nan, dtype=dt)
    rows = {name: [] for name in ("loss", "diag_l", "diag_theta",
                                  "diag_step", "diag_restarted", "ran")}

    for _ in range(cfg.num_iterations):
        if not bool(active.any()):
            break
        x_old, z_old = x, z
        l_old = big_l
        big_l = torch.where(active, big_l * alpha, big_l)
        theta_old = theta
        pending = active.clone()
        trials = torch.zeros(k, dtype=torch.int64)
        f_y, f_x = nan_row.clone(), nan_row.clone()
        y, g_y = x, None
        while True:  # the do-while of each lane: its first trial always runs
            theta = torch.where(pending, 2.0 / (1.0 + torch.sqrt(
                1.0 + 4.0 * (big_l / l_old) / (theta_old * theta_old))),
                theta)
            y = where(pending, axpby(1.0 - theta, x_old, theta, z_old), y)
            fy, gy = evaluate(y)
            f_y = torch.where(pending, fy, f_y)
            g_y = gy if g_y is None else where(pending, gy, g_y)
            step = 1.0 / (theta * big_l)
            z = where(pending, pin(prox_multi(z_old, g_y, step)), z)
            x = where(pending, axpby(1.0 - theta, x_old, theta, z), x)
            if not backtracking:
                break

            xy = tvec.sub(x, y)
            (xy_sq,) = host(tvec.lane_dot(xy, xy))
            # trivial accepts: an exact-zero step, or a non-finite f_y,
            # which the NaN guard below aborts on
            trivial = pending & ((xy_sq == 0.0) | ~torch.isfinite(f_y))
            f_x = torch.where(trivial, f_y, f_x)
            pending = pending & ~trivial
            if not bool(pending.any()):
                break

            fx, g_x = evaluate(x)
            f_x = torch.where(pending, fx, f_x)
            d_gy, d_curv = host(tvec.lane_dot(xy, g_y),
                                tvec.lane_dot(xy, tvec.sub(g_x, g_y)))
            q_x = f_y + d_gy + 0.5 * big_l * xy_sq
            local_l = torch.where(
                bts, big_l + 2.0 * torch.clamp_min(f_x - q_x, 0.0) / xy_sq,
                2.0 * d_curv / xy_sq)
            bts = torch.where(pending, bts & (
                torch.abs(f_y - f_x)
                >= btol * torch.maximum(torch.abs(f_x), torch.abs(f_y))),
                bts)
            reject = pending & ~((local_l <= big_l) | (big_l >= l_exact))
            # the L-update dance: clamp a finite localL to Lexact, then
            # grow by 1/beta; an infinite localL degrades to L/beta
            inf_l = torch.isinf(local_l)
            l1 = torch.where(inf_l, big_l, torch.minimum(l_exact, local_l))
            local2 = torch.where(inf_l, big_l, local_l)
            big_l = torch.where(reject, torch.minimum(
                l_exact, torch.maximum(local2, l1 / beta)), big_l)
            trials += reject.to(torch.int64)
            pending = reject & (trials < cfg.max_backtracks)
            if not bool(pending.any()):
                break
        n_bt += trials

        if cfg.loss_mode == "y":
            loss = f_y + host(reg_value_multi(y))[0]
        elif cfg.loss_mode == "x_strict":
            f_s, r_s = host(smooth_multi(x)[0], reg_value_multi(x))
            loss = f_s + r_s
        elif backtracking:
            loss = f_x + host(reg_value_multi(x))[0]
        else:
            ls = smooth_loss_multi or (lambda W: smooth_multi(W)[0])
            f_s, r_s = host(ls(x), reg_value_multi(x))
            loss = f_s + r_s

        ran = active.clone()
        num_iters += ran.to(torch.int64)
        rows["loss"].append(torch.where(ran, loss, nan_row))
        rows["diag_l"].append(torch.where(ran, big_l, nan_row))
        rows["diag_theta"].append(torch.where(ran, theta, nan_row))
        rows["diag_step"].append(torch.where(ran, 1.0 / (theta * big_l),
                                             nan_row))
        rows["ran"].append(ran)

        abort_now = ran & ~torch.isfinite(f_y)
        dx = tvec.sub(x, x_old)
        sq_dx, sq_x, d_gdx = host(tvec.lane_dot(dx, dx), tvec.lane_dot(x, x),
                                  tvec.lane_dot(g_y, dx))
        norm_dx, norm_x = torch.sqrt(sq_dx), torch.sqrt(sq_x)
        total = carry.prior_iters + num_iters
        done = ran & (abort_now | ((norm_dx == 0.0) & (total > 1))
                      | (norm_dx < tol * torch.clamp_min(norm_x, 1.0)))
        restart = ran & ~done & (d_gdx > 0.0) if cfg.may_restart \
            else torch.zeros(k, dtype=torch.bool)
        if bool(restart.any()):
            z = where(restart, x, z)
            theta = torch.where(restart, c(math.inf), theta)
            bts = bts | restart
            n_restart += restart.to(torch.int64)
        rows["diag_restarted"].append(restart)
        aborted |= abort_now
        converged |= done & ~abort_now
        active = active & ~done

    def stacked(name, dtype):
        return (torch.stack(rows[name]) if rows[name]
                else torch.zeros((0, k), dtype=dtype))

    end = LaneCarry(x=x, z=z, theta=theta, big_l=big_l, bts=bts,
                    prior_iters=carry.prior_iters + num_iters,
                    active=active, num_backtracks=n_bt,
                    num_restarts=n_restart, aborted=aborted,
                    converged=converged)
    return LaneRun(carry=end, num_iters=num_iters,
                   loss=stacked("loss", dt), diag_l=stacked("diag_l", dt),
                   diag_theta=stacked("diag_theta", dt),
                   diag_step=stacked("diag_step", dt),
                   diag_restarted=stacked("diag_restarted", torch.bool),
                   ran=stacked("ran", torch.bool))


# ---------------------------------------------------------------------------
# The JAX package's multi-lane host surface (core/host_agd.py:210-554)
# ---------------------------------------------------------------------------


class HostAGDMultiResult(NamedTuple):
    """Batched result: every per-lane field carries a leading K axis,
    except ``loss_history``, whose lane axis is second:
    ``loss_history[:, k][:num_iters[k]]`` is lane k's executed history
    (stopped lanes forward-fill their last loss).  The diagnostics rows
    (port only) are ``(T, K)`` too, NaN (False) where a lane did not
    run."""

    weights: Any
    loss_history: np.ndarray
    num_iters: np.ndarray
    aborted_non_finite: np.ndarray
    final_l: np.ndarray
    num_backtracks: np.ndarray
    num_restarts: np.ndarray
    final_z: Any = None
    final_theta: Any = None
    final_bts: Any = None
    converged: Any = None
    diag_l: Any = None
    diag_theta: Any = None
    diag_step: Any = None
    diag_restarted: Any = None


class HostMultiWarm(NamedTuple):
    """Continuation carry for :func:`run_agd_host_multi`: the multi-lane
    twin of ``AGDWarmState`` plus the per-lane stop bookkeeping (a lane
    that stopped stays stopped; counters continue) and ``last_loss``,
    which stopped lanes forward-fill the next segment's history with."""

    x: Any
    z: Any
    theta: np.ndarray
    big_l: np.ndarray
    bts: np.ndarray
    prior_iters: np.ndarray
    converged: np.ndarray
    aborted: np.ndarray
    num_backtracks: np.ndarray
    num_restarts: np.ndarray
    last_loss: np.ndarray

    @classmethod
    def initial(cls, w0_stacked, config) -> "HostMultiWarm":
        """The iteration-zero carry."""
        k = tvec.leaves(w0_stacked)[0].shape[0]
        return cls(
            x=w0_stacked, z=w0_stacked, theta=np.full(k, np.inf),
            big_l=np.full(k, float(config.l0)), bts=np.ones(k, bool),
            prior_iters=np.zeros(k, np.int64),
            converged=np.zeros(k, bool), aborted=np.zeros(k, bool),
            num_backtracks=np.zeros(k, np.int64),
            num_restarts=np.zeros(k, np.int64),
            last_loss=np.full(k, np.nan))


def multi_warm_state(res: HostAGDMultiResult,
                     prior_iters=0) -> HostMultiWarm:
    """The continuation carry out of a multi-lane result, to feed to
    ``run_agd_host_multi(..., warm=...)``.  ``prior_iters``: per-lane
    iterations executed before the segment ``res`` came from (pass the
    previous warm's when chaining), so the ``nIter > 1`` gate sees the
    total."""
    hist = np.asarray(res.loss_history)
    k = len(np.asarray(res.num_iters))
    return HostMultiWarm(
        x=res.weights, z=res.final_z,
        theta=np.asarray(res.final_theta, float),
        big_l=np.asarray(res.final_l, float),
        bts=np.asarray(res.final_bts, bool),
        prior_iters=(np.asarray(prior_iters, np.int64)
                     + np.asarray(res.num_iters, np.int64)),
        converged=np.asarray(res.converged, bool),
        aborted=np.asarray(res.aborted_non_finite, bool),
        num_backtracks=np.asarray(res.num_backtracks, np.int64),
        num_restarts=np.asarray(res.num_restarts, np.int64),
        last_loss=hist[-1] if hist.shape[0] else np.full(k, np.nan))


def make_prox_multi(updater, reg_params):
    """Per-lane ``(prox_multi(Z, G, steps) -> Z_new, reg_value_multi(W)
    -> (K,))`` for a strength grid, the strengths in their native dtype
    (f64 for Python floats, as the JAX twin keeps them; a tensor's
    own)."""
    regs = (reg_params if isinstance(reg_params, torch.Tensor)
            else torch.as_tensor(np.asarray(reg_params)))

    def prox_multi(Z, G, steps):
        return updater.prox_lanes(Z, G, steps, regs)[0]

    def reg_value_multi(W):
        return updater.reg_value_lanes(W, regs)

    return prox_multi, reg_value_multi


def _np(t):
    return t.numpy()


def run_agd_host_multi(
    smooth_multi: Callable,
    prox_multi: Callable,
    reg_value_multi: Callable,
    w0_stacked: Any,
    config: AGDConfig,
    *,
    smooth_loss_multi: Callable | None = None,
    warm: HostMultiWarm | None = None,
) -> HostAGDMultiResult:
    """K-lane lock-step AGD (see :func:`run_lanes`).  ``w0_stacked``
    carries the lane axis.  ``warm`` (:func:`multi_warm_state`)
    continues a prior segment: converged and aborted lanes stay stopped,
    counters continue, and ``loss_history``/``num_iters`` cover this
    segment only."""
    if warm is None:
        warm = HostMultiWarm.initial(w0_stacked, config)
    dt = carry_dtype(warm.x)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(dtype)

    stopped = np.asarray(warm.converged, bool) | np.asarray(warm.aborted,
                                                            bool)
    carry = LaneCarry(
        x=warm.x, z=warm.z, theta=t(warm.theta, dt),
        big_l=t(warm.big_l, dt), bts=t(warm.bts, torch.bool),
        prior_iters=t(warm.prior_iters, torch.int64),
        active=t(~stopped, torch.bool),
        num_backtracks=t(warm.num_backtracks, torch.int64),
        num_restarts=t(warm.num_restarts, torch.int64),
        aborted=t(warm.aborted, torch.bool),
        converged=t(warm.converged, torch.bool))
    run = run_lanes(smooth_multi, prox_multi, reg_value_multi, carry,
                    config, smooth_loss_multi=smooth_loss_multi)
    loss = _np(run.loss).astype(float)
    ran = _np(run.ran)
    prev = np.asarray(warm.last_loss, float)
    for i in range(loss.shape[0]):  # stopped lanes forward-fill
        loss[i] = np.where(ran[i], loss[i], prev)
        prev = loss[i]
    end = run.carry
    return HostAGDMultiResult(
        weights=end.x, loss_history=loss, num_iters=_np(run.num_iters),
        aborted_non_finite=_np(end.aborted), final_l=_np(end.big_l),
        num_backtracks=_np(end.num_backtracks),
        num_restarts=_np(end.num_restarts), final_z=end.z,
        final_theta=_np(end.theta), final_bts=_np(end.bts),
        converged=_np(end.converged), diag_l=_np(run.diag_l),
        diag_theta=_np(run.diag_theta), diag_step=_np(run.diag_step),
        diag_restarted=_np(run.diag_restarted))
