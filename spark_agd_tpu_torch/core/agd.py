"""Accelerated proximal gradient descent (TFOCS Auslender-Teboulle).

Counterpart of ``spark_agd_tpu/core/agd.py``.  The JAX package compiles
the whole optimizer into nested ``lax.while_loop``s; here the outer and
inner loops are Python, shaped like ``spark_agd_tpu/core/host_agd.py``,
and only the vector math runs on the device.  The control scalars come
to the host once per trial (the smooth values, the step's squared norm
and the curvature dots) and the recurrences run on 0-d CPU tensors of
the carry dtype, so an f32 run rounds where the JAX loop rounds.

Parity quirks carried over from the JAX loop (``agd.py:13-40``):

- ``theta = +inf`` on the first iteration, so the first trial evaluates
  at ``w0`` (IEEE ``x/inf == 0``).
- the backtracking estimator switches from ``backtrack_simple`` to the
  curvature estimate once ``|f_y - f_x|`` falls under 1e-10 relative,
  and the infinite-localL L-update dance.
- loss history at x: ``loss_mode`` ``'x'`` reuses the backtracking
  pass's ``f(x)``, ``'x_strict'`` recomputes it, ``'y'`` reads ``f(y)``.
- a non-finite ``f_y`` accepts the trial at once and the NaN guard ends
  the run; ``max_backtracks`` bounds the trials of one iteration.
- the exact-zero step stops the run only when ``nIter > 1``; the
  O'Donoghue-Candes gradient-test restart.
- smooth outputs are pinned to the carry dtype (``norm_smooth``).

Weights may be a tensor or a dict/list/tuple of tensors (``core.tvec``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from . import tvec


@dataclass(frozen=True)
class AGDConfig:
    """The nine reference knobs plus ``backtrack_tol`` and the loop's
    extras (same fields and defaults as the JAX package)."""

    convergence_tol: float = 1e-4
    num_iterations: int = 100
    l0: float = 1.0
    l_exact: float = math.inf
    beta: float = 0.5
    alpha: float = 0.9
    may_restart: bool = True
    backtrack_tol: float = 1e-10
    max_backtracks: int = 100
    loss_mode: str = "x"  # 'x' | 'x_strict' | 'y'


class AGDWarmState(NamedTuple):
    """The inter-iteration carry: enough to continue a run exactly where
    it stopped.  ``prior_iters`` feeds the ``nIter > 1`` gate."""

    x: Any
    z: Any
    theta: Any
    big_l: Any
    bts: Any
    prior_iters: Any

    @classmethod
    def initial(cls, w0: Any, config: AGDConfig) -> "AGDWarmState":
        return cls(x=w0, z=w0, theta=math.inf, big_l=float(config.l0),
                   bts=True, prior_iters=0)


class AGDResult(NamedTuple):
    """Same fields as the JAX package's ``AGDResult``.  ``weights`` and
    ``final_z`` live on the weights' device; the scalars and the
    per-iteration arrays are CPU tensors, the arrays NaN-padded (0/False
    for ``diag_restarted``) to ``num_iterations``."""

    weights: Any
    loss_history: torch.Tensor
    num_iters: torch.Tensor
    aborted_non_finite: torch.Tensor
    final_l: torch.Tensor
    num_backtracks: torch.Tensor
    num_restarts: torch.Tensor
    final_z: Any
    final_theta: torch.Tensor
    final_bts: torch.Tensor
    converged: torch.Tensor
    diag_l: torch.Tensor
    diag_theta: torch.Tensor
    diag_step: torch.Tensor
    diag_restarted: torch.Tensor


def run_agd(
    smooth: Callable,
    prox: Callable,
    reg_value: Callable,
    w0: Any,
    config: AGDConfig,
    *,
    smooth_loss: Callable | None = None,
    warm: AGDWarmState | None = None,
    on_iteration: Callable | None = None,
    telemetry_cb: Callable | None = None,
    shard_dot: Callable | None = None,
) -> AGDResult:
    """Run AGD from ``w0`` (or continue ``warm``, of which ``w0`` is then
    only the structure).

    ``smooth(w) -> (mean_loss, mean_grad)``; ``prox(w, g, step) ->
    (w_new, reg_value)``; ``reg_value(w)``; ``smooth_loss(w) ->
    mean_loss`` is used by ``loss_mode='x'`` when backtracking is off
    (``beta >= 1``).  A warm run executes up to ``num_iterations``
    further iterations.  ``on_iteration(state_dict)`` is called after
    every outer iteration with the continuation carry (:func:`_carry`).
    ``telemetry_cb(**scalars)`` (``obs.Telemetry.iteration_callback``)
    is called once an iteration with the scalars JAX's loop passes its
    callback (``it``, the 1-based iteration of this call, ``loss``,
    ``big_l``, ``theta``, ``step``, ``restarted``), as 0-d CPU tensors
    and a bool: the loop holds them on the host already, so the callback
    adds no device sync, and ``None`` runs the same loop.

    ``shard_dot(a, b) -> 0-d tensor`` (the twin of JAX's ``axis_name=``,
    the sharded weight update): the carry is a sharded tree
    (``parallel.sharded_update``), whose shards the elementwise math
    updates where they lie, and every dot and squared norm of the loop
    (``xy_sq``, the curvature dots, the stop norms, the restart dot) is
    this global inner product, summed across the shards in one fixed
    order, so every slot and rank takes the same branches.  ``smooth``
    then returns the gradient sharded like its argument, and
    ``reg_value`` the global penalty.  ``None`` (default) keeps the plain
    reductions of :mod:`tvec`."""
    cfg = config
    if cfg.loss_mode not in ("x", "x_strict", "y"):
        raise ValueError(f"unknown loss_mode {cfg.loss_mode!r}")
    if warm is None:
        warm = AGDWarmState.initial(w0, cfg)

    dt = torch.float32
    for leaf in tvec.leaves(warm.x):
        dt = torch.promote_types(dt, leaf.dtype)

    def s(v) -> torch.Tensor:
        """A 0-d CPU tensor of the carry dtype (a host sync for a device
        tensor)."""
        if isinstance(v, torch.Tensor):
            return v.detach().to(dtype=dt).reshape(()).cpu()
        return torch.tensor(float(v), dtype=dt)

    def norm_smooth(w_like, out):
        """Pin smooth outputs to the carry dtype: f to ``dt``, each
        gradient leaf to its weight leaf's dtype."""
        f, g = out
        return s(f), tvec.tmap(lambda gi, wi: gi.to(wi.dtype), g, w_like)

    tol = s(cfg.convergence_tol)
    l_exact = s(cfg.l_exact)
    beta = s(cfg.beta)
    btol = s(cfg.backtrack_tol)
    alpha = s(cfg.alpha)
    nan = s(math.nan)
    backtracking = cfg.beta < 1.0
    if shard_dot is None:
        _dot, _sq_norm = tvec.dot, tvec.sq_norm
    else:
        _dot = shard_dot

        def _sq_norm(a):
            return shard_dot(a, a)

    def _norm(a):
        return torch.sqrt(_sq_norm(a))

    x, z = warm.x, warm.z
    theta, big_l = s(warm.theta), s(warm.big_l)
    bts = bool(warm.bts)
    prior_iters = int(warm.prior_iters)

    n = cfg.num_iterations
    loss_hist = torch.full((n,), math.nan, dtype=dt)
    diag_l = torch.full((n,), math.nan, dtype=dt)
    diag_theta = torch.full((n,), math.nan, dtype=dt)
    diag_step = torch.full((n,), math.nan, dtype=dt)
    diag_restarted = torch.zeros((n,), dtype=torch.bool)
    it = n_bt = n_restart = 0
    done = aborted = False

    while it < n and not done:
        x_old, z_old = x, z
        l_old = big_l
        big_l = big_l * alpha
        theta_old = theta

        trial_bt = 0
        while True:  # the reference's do-while: the first trial always runs
            theta = 2.0 / (1.0 + torch.sqrt(
                1.0 + 4.0 * (big_l / l_old) / (theta_old * theta_old)))
            y = tvec.axpby(float(1.0 - theta), x_old, float(theta), z_old)
            f_y, g_y = norm_smooth(x_old, smooth(y))
            step = 1.0 / (theta * big_l)
            z = prox(z_old, g_y, float(step))[0]
            x = tvec.axpby(float(1.0 - theta), x_old, float(theta), z)

            if not backtracking:
                f_x = nan
                break

            xy = tvec.sub(x, y)
            xy_sq = s(_sq_norm(xy))
            # trivial accepts: an exact-zero step (x == y, so f(x) = f(y))
            # or a non-finite f_y, which the NaN guard below aborts on
            if bool(xy_sq == 0.0) or not bool(torch.isfinite(f_y)):
                f_x = f_y
                break

            f_x, g_x = norm_smooth(x_old, smooth(x))
            if bts:
                q_x = f_y + s(_dot(xy, g_y)) + 0.5 * big_l * xy_sq
                local_l = big_l + 2.0 * torch.clamp_min(f_x - q_x, 0.0) \
                    / xy_sq
            else:
                local_l = 2.0 * s(_dot(xy, tvec.sub(g_x, g_y))) / xy_sq
            bts = bts and bool(
                torch.abs(f_y - f_x)
                >= btol * torch.maximum(torch.abs(f_x), torch.abs(f_y)))
            if bool(local_l <= big_l) or bool(big_l >= l_exact):
                break
            # the L-update dance: clamp a finite localL to Lexact, then
            # grow by 1/beta; an infinite localL degrades to L/beta
            if bool(torch.isinf(local_l)):
                l1, local2 = big_l, big_l
            else:
                l1, local2 = torch.minimum(l_exact, local_l), local_l
            big_l = torch.minimum(l_exact, torch.maximum(local2, l1 / beta))
            trial_bt += 1
            if trial_bt >= cfg.max_backtracks:
                break

        if cfg.loss_mode == "y":
            loss = f_y + s(reg_value(y))
        elif cfg.loss_mode == "x_strict":
            loss = s(smooth(x)[0]) + s(reg_value(x))
        elif backtracking:
            loss = f_x + s(reg_value(x))
        else:
            ls = smooth_loss or (lambda w: smooth(w)[0])
            loss = s(ls(x)) + s(reg_value(x))

        loss_hist[it] = loss
        diag_l[it] = big_l
        diag_theta[it] = theta
        diag_step[it] = 1.0 / (theta * big_l)
        it += 1
        n_bt += trial_bt

        aborted = not bool(torch.isfinite(f_y))
        norm_x = s(_norm(x))
        norm_dx = s(_norm(tvec.sub(x, x_old)))
        done = (aborted
                or (bool(norm_dx == 0.0) and it + prior_iters > 1)
                or bool(norm_dx < tol * torch.clamp_min(norm_x, 1.0)))

        restart = (cfg.may_restart and not done
                   and bool(s(_dot(g_y, tvec.sub(x, x_old))) > 0.0))
        if telemetry_cb is not None:
            telemetry_cb(it=it, loss=loss, big_l=big_l, theta=theta,
                         step=diag_step[it - 1], restarted=restart)
        if restart:
            z = x
            theta = s(math.inf)
            bts = True
            n_restart += 1
        diag_restarted[it - 1] = restart
        if on_iteration is not None:
            on_iteration(_carry(x, z, float(theta), float(big_l), bts,
                                prior_iters + it, float(loss),
                                aborted=aborted, stopped=done,
                                last=it == n))

    return AGDResult(
        weights=x, loss_history=loss_hist,
        num_iters=torch.tensor(it, dtype=torch.int32),
        aborted_non_finite=torch.tensor(aborted),
        final_l=big_l,
        num_backtracks=torch.tensor(n_bt, dtype=torch.int32),
        num_restarts=torch.tensor(n_restart, dtype=torch.int32),
        final_z=z, final_theta=theta, final_bts=torch.tensor(bts),
        converged=torch.tensor(done and not aborted),
        diag_l=diag_l, diag_theta=diag_theta, diag_step=diag_step,
        diag_restarted=diag_restarted,
    )


def _carry(x, z, theta, big_l, bts, n_iter, loss, aborted=False,
           stopped=False, last=False) -> dict:
    """The on_iteration payload: the exact continuation carry + metrics.
    ``stopped`` marks the converged final iteration; ``aborted`` the
    non-finite one (which also stops); ``last`` the iteration-cap exit:
    one of the three is always true on a run's final callback."""
    return dict(x=x, z=z, theta=theta, big_l=big_l, bts=bts,
                prior_iters=n_iter, loss=loss, aborted=aborted,
                stopped=stopped or aborted, last=last or aborted)
