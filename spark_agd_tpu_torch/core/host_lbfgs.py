"""Host-decided L-BFGS and OWL-QN: the twin of ``core.lbfgs``.

Counterpart of ``spark_agd_tpu/core/host_lbfgs.py``: the same loops as
``core/lbfgs.py`` (one copy of the decision algebra), with every control
scalar compared as a Python float64, as the JAX package's host twin
does.  It serves objectives that run their own host loop (a streamed
smooth, a cross-process one) and carries the warm resume: a
:class:`HostLBFGSWarm` (weights, value, gradient and curvature pairs)
continues a run exactly where it stopped, and ``on_iteration`` hands out
that carry after every accepted step.

Under f64 the two twins take the same branches; with an f32 objective a
decision that sits on a Wolfe or convergence boundary can round
differently (the JAX package's note, ``host_lbfgs.py:17-24``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np

from .lbfgs import (LBFGSConfig, _Out, _Scalars, _carry_dtype,
                    _lbfgs_loop, _owlqn_loop)


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
