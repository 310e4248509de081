"""Host-decided L-BFGS and OWL-QN: the twin of ``core.lbfgs``.

Counterpart of ``spark_agd_tpu/core/host_lbfgs.py``: the same loops as
``core/lbfgs.py`` (one copy of the decision algebra), with every control
scalar compared as a Python float64, as the JAX package's host twin
does.  It serves objectives that run their own host loop (a streamed
smooth, a cross-process one) and carries the warm resume: a
:class:`HostLBFGSWarm` (weights, value, gradient and curvature pairs)
continues a run exactly where it stopped, and ``on_iteration`` hands out
that carry after every accepted step.  :func:`run_lbfgs_host_multi` runs
K lanes in lock-step over one multi-evaluation a round, each lane the
solo loop's own generator (``core.lbfgs._lbfgs_gen``).

Under f64 the two twins take the same branches; with an f32 objective a
decision that sits on a Wolfe or convergence boundary can round
differently (the JAX package's note, ``host_lbfgs.py:17-24``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np

from . import tvec
from .lbfgs import (LBFGSConfig, _Out, _Scalars, _carry_dtype,
                    _lbfgs_loop, _owlqn_loop, run_lanes)


class HostLBFGSResult(NamedTuple):
    """Same fields as the JAX package's ``HostLBFGSResult``:
    ``loss_history`` is ``(num_iters + 1,)`` float64, entry 0 at this
    segment's start; ``final_g``/``final_pairs``/``final_f_smooth`` are
    the continuation carry."""

    weights: Any
    loss_history: np.ndarray
    num_iters: int  # iterations executed in this segment
    converged: bool
    ls_failed: bool
    aborted_non_finite: bool
    grad_norm: float
    num_fn_evals: int
    final_g: Any = None
    final_pairs: tuple = ()
    final_f_smooth: Any = None
    ls_stop_reason: int = 0


class HostLBFGSWarm(NamedTuple):
    """The whole inter-iteration carry: weights, the smooth objective's
    value, its gradient, the curvature pairs ``((s, y, rho), ...)``
    oldest first, and the iterations already run."""

    w: Any
    f: float
    g: Any
    pairs: tuple
    prior_iters: int

    @classmethod
    def from_result(cls, res: "HostLBFGSResult",
                    prior_iters: int = 0) -> "HostLBFGSWarm":
        """The carry out of a finished segment; ``prior_iters`` is the
        iteration total before that segment."""
        f = (res.final_f_smooth if res.final_f_smooth is not None
             else res.loss_history[-1])
        return cls(w=res.weights, f=float(f), g=res.final_g,
                   pairs=tuple(res.final_pairs),
                   prior_iters=prior_iters + res.num_iters)


def _host_result(out: _Out) -> HostLBFGSResult:
    return HostLBFGSResult(
        weights=out.w, loss_history=np.asarray(out.hist, np.float64),
        num_iters=out.seg_iters, converged=out.converged,
        ls_failed=out.ls_failed, aborted_non_finite=out.aborted,
        grad_norm=float(out.grad_norm), num_fn_evals=out.evals,
        final_g=out.g, final_pairs=tuple(out.pairs), final_f_smooth=out.f,
        ls_stop_reason=out.reason)


def run_lbfgs_host(objective: Callable, w0: Any,
                   config: LBFGSConfig = LBFGSConfig(), *,
                   warm: HostLBFGSWarm | None = None,
                   on_iteration: Callable | None = None
                   ) -> HostLBFGSResult:
    """Minimize ``objective(w) -> (f, g)`` with float64 decisions.
    ``warm`` continues a prior segment exactly (no evaluation at the
    start; ``prior_iters`` counts against ``num_iterations``);
    ``on_iteration(state)`` fires after each accepted step with ``{w, f,
    g, pairs, it}``, ``it`` the total including a warm prior."""
    sc = _Scalars(_carry_dtype(w0), host=True)
    return _host_result(_lbfgs_loop(objective, w0, config, sc, warm=warm,
                                    on_iteration=on_iteration))


def run_owlqn_host(objective_smooth: Callable, w0: Any, l1_reg: float,
                   config: LBFGSConfig = LBFGSConfig(), *,
                   warm: HostLBFGSWarm | None = None,
                   on_iteration: Callable | None = None
                   ) -> HostLBFGSResult:
    """OWL-QN with float64 decisions; ``warm.f`` carries the smooth
    part's value (the L1 term is recomputed from the weights) and
    ``loss_history`` holds the full objective."""
    sc = _Scalars(_carry_dtype(w0), host=True)
    return _host_result(_owlqn_loop(objective_smooth, w0, float(l1_reg),
                                    config, sc, warm=warm,
                                    on_iteration=on_iteration))


class HostLBFGSMultiResult(NamedTuple):
    """Same fields as the JAX package's ``HostLBFGSMultiResult``: each
    lane's on a leading K axis; ``loss_history`` is ``(K, max_iters +
    1)`` float64, NaN past each lane's ``num_iters + 1``; ``eval_rounds``
    counts the multi-evaluations the lock-step schedule took."""

    weights: Any
    loss_history: np.ndarray
    num_iters: np.ndarray
    converged: np.ndarray
    ls_failed: np.ndarray
    aborted_non_finite: np.ndarray
    grad_norm: np.ndarray
    num_fn_evals: np.ndarray
    eval_rounds: int
    ls_stop_reason: np.ndarray = None


def run_lbfgs_host_multi(objective_multi: Callable, w0_stacked: Any,
                         config: LBFGSConfig = LBFGSConfig()
                         ) -> HostLBFGSMultiResult:
    """K lock-step L-BFGS lanes with float64 decisions over one
    ``objective_multi(W_stacked) -> ((K,) values, stacked gradients)`` a
    round: K strengths share each pass over the data.  Each lane runs
    the solo algorithm exactly (``run_lbfgs_host``'s), so a lane matches
    its solo run to the multi-evaluation's own rounding; a lane that
    finishes early sends its final weights to later rounds and its
    result is frozen."""
    if not tvec.leaves(w0_stacked):
        raise ValueError("w0_stacked must have at least one leaf")
    sc = _Scalars(_carry_dtype(w0_stacked), host=True)
    outs, rounds = run_lanes(objective_multi, w0_stacked, config, sc)
    results = [_host_result(o) for o in outs]
    hist = np.full((len(results), max(r.num_iters for r in results) + 1),
                   np.nan)
    for k, r in enumerate(results):
        hist[k, :r.num_iters + 1] = r.loss_history
    return HostLBFGSMultiResult(
        weights=tvec.stack_lanes([r.weights for r in results]),
        loss_history=hist,
        num_iters=np.asarray([r.num_iters for r in results]),
        converged=np.asarray([r.converged for r in results]),
        ls_failed=np.asarray([r.ls_failed for r in results]),
        aborted_non_finite=np.asarray(
            [r.aborted_non_finite for r in results]),
        grad_norm=np.asarray([r.grad_norm for r in results]),
        num_fn_evals=np.asarray([r.num_fn_evals for r in results]),
        eval_rounds=rounds,
        ls_stop_reason=np.asarray([r.ls_stop_reason for r in results]))
