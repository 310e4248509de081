"""L-BFGS and OWL-QN: the Optimizer family's quasi-Newton member.

Counterpart of ``spark_agd_tpu/core/lbfgs.py``.  The JAX package compiles
each minimizer (two-loop recursion, strong-Wolfe bracket and zoom,
curvature pairs, convergence test) into one ``lax.while_loop``; here the
loops are Python, as ``core/agd.py`` is, and only the vector math runs on
the device.  The decisions are the fused loop's, made in the **carry
dtype**: each objective evaluation's control scalars (the value and the
directional derivative) come to the host in one copy as 0-d CPU tensors
of that dtype, so an f32 run rounds where the JAX loop rounds, and the
f32 noise-floor classification (``LS_STOP_NOISE_FLOOR``) agrees.  The
host twin (``core/host_lbfgs.py``) runs the same loops with Python-float
(float64) decisions; :class:`_Scalars` is the one place the two differ.

Semantics pinned to MLlib/Breeze 0.11 as the JAX package pins them:

- ``num_corrections`` pairs (default 10); a pair with ``s·y <= 1e-10 ·
  ‖s‖·‖y‖`` is skipped; ``H0 = gamma·I`` scaled by the newest pair;
- a strong-Wolfe search (c1 = 1e-4, c2 = 0.9, Nocedal-Wright 3.5/3.6 with
  bisection zoom), each phase bounded by ``max_ls_steps``; a failed
  search stops the run with ``ls_failed`` and a ``LS_STOP_*`` reason;
- the relative-improvement stop ``(f_old - f_new) / max(|f_old|,
  |f_new|, 1) <= convergence_tol``, and an optional ``‖g‖ < grad_tol``;
- a non-finite objective aborts; a non-descent direction falls back to
  steepest descent.

:func:`run_owlqn` minimizes ``f + l1·‖w‖₁`` (Andrew & Gao): the
pseudo-gradient, the orthant-aligned direction, and a backtracking
Armijo search whose trials are clipped to the orthant, which gives exact
zeros.  ``loss_history[0]`` is the objective at ``w0`` and entry ``i``
the objective after iteration ``i``, NaN-padded to ``num_iterations +
1``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from . import tvec

LS_STOP_NONE = 0          # the line search did not stop the run
LS_STOP_BRACKET = 1       # Wolfe bracket phase exhausted mid-descent
LS_STOP_ZOOM = 2          # Wolfe zoom phase exhausted mid-descent
LS_STOP_NOISE_FLOOR = 3   # no progress beyond the carry dtype's noise
LS_STOP_ARMIJO = 4        # OWL-QN backtracking-Armijo budget exhausted
LS_STOP_REASONS = ("none", "wolfe_bracket_exhausted",
                   "wolfe_zoom_exhausted", "no_progress_at_noise_floor",
                   "armijo_exhausted")


def ls_stop_reason_name(code) -> str:
    """The name of an ``ls_stop_reason`` code."""
    return LS_STOP_REASONS[int(code)]


@dataclass(frozen=True)
class LBFGSConfig:
    """MLlib ``LBFGS``'s four knobs (their 1.3.0 defaults) plus the
    line-search extras (same fields and defaults as the JAX package)."""

    num_corrections: int = 10
    convergence_tol: float = 1e-4
    num_iterations: int = 100
    grad_tol: float = 0.0  # optional ‖g‖ stop; 0 disables
    c1: float = 1e-4
    c2: float = 0.9
    max_ls_steps: int = 12  # per bracket phase and per zoom phase
    max_step_growth: float = 2.0


def check_smooth_penalty(updater, reg_param: float) -> None:
    """Raise for prox-only updaters; call before any data staging."""
    if updater.smooth_penalty(torch.zeros(()), float(reg_param)) is None:
        raise ValueError(
            f"{type(updater).__name__} has no smooth penalty: L-BFGS "
            "needs a differentiable objective (MLlib 1.3's LBFGS has "
            "the same limitation — no OWLQN); use "
            "AcceleratedGradientDescent for prox-only penalties")


def make_objective(smooth: Callable, updater, reg_param: float):
    """``objective(w) -> (f, g)``: the smooth data term plus the
    updater's smooth penalty folded in (MLlib LBFGS ``CostFun``).  Raises
    for prox-only updaters (:func:`check_smooth_penalty`)."""
    check_smooth_penalty(updater, reg_param)

    def objective(w):
        f, g = smooth(w)
        pv, pg = updater.smooth_penalty(w, reg_param)
        return f + pv, tvec.add(g, pg)

    return objective


def _carry_dtype(w0) -> torch.dtype:
    dt = torch.float32
    for leaf in tvec.leaves(w0):
        dt = torch.promote_types(dt, leaf.dtype)
    return dt


def _pin(g, w_template):
    """Cast each gradient leaf to its weight leaf's dtype (the value is
    cast where it is read, by :meth:`_Scalars.pull`)."""
    return tvec.tmap(lambda gi, wi: gi.to(wi.dtype), g, w_template)


def _pin_objective(objective, w_template):
    """``objective`` with its gradient :func:`_pin`-ned."""
    def obj(w):
        f, g = objective(w)
        return f, _pin(g, w_template)

    return obj


def _drive(gen, objective):
    """Run a generator that yields the points to evaluate and is sent
    ``objective(point)`` back; returns what it returns."""
    try:
        w = next(gen)
        while True:
            w = gen.send(objective(w))
    except StopIteration as e:
        return e.value


class LBFGSResult(NamedTuple):
    """The JAX package's ``LBFGSResult`` fields, then two diagnostics of
    the port's: per accepted iteration, the line search's step
    (``diag_step``, NaN-padded to ``num_iterations``) and its objective
    evaluations (``diag_evals``, 0-padded), which show where two fits'
    searches part; and, for the lanes of a sweep (every field then on a
    leading K axis), ``eval_rounds``, the lock-step evaluation rounds.
    ``weights`` lives on the weights' device; the scalars and the arrays
    are CPU tensors."""

    weights: Any
    loss_history: torch.Tensor
    num_iters: torch.Tensor
    converged: torch.Tensor
    ls_failed: torch.Tensor
    aborted_non_finite: torch.Tensor
    grad_norm: torch.Tensor
    num_fn_evals: torch.Tensor
    ls_stop_reason: Any = LS_STOP_NONE
    diag_step: Any = None
    diag_evals: Any = None
    eval_rounds: Any = None


class _Scalars:
    """Where the loop's control scalars live.  The fused twin
    (``host=False``) reads them to 0-d CPU tensors of the carry dtype
    and keeps the two-loop recursion's coefficients on the device; the
    host twin reads every scalar to a Python float."""

    def __init__(self, dtype: torch.dtype, host: bool):
        self.dtype = dtype
        self.host = host
        self.eps = torch.finfo(dtype).eps
        self.tiny = torch.finfo(torch.float64 if host else dtype).tiny

    def const(self, v):
        return float(v) if self.host else torch.tensor(float(v),
                                                       dtype=self.dtype)

    def pull(self, *vals):
        """The device scalars ``vals`` in one device-to-host copy."""
        dt = torch.float64 if self.host else self.dtype
        dev = vals[0].device
        out = torch.stack([v.detach().reshape(()).to(device=dev, dtype=dt)
                           for v in vals]).cpu()
        return out.tolist() if self.host else out.unbind()

    def keep(self, v):
        """A scalar of the two-loop recursion: a device tensor of the
        carry dtype, or (host) a Python float."""
        return float(v) if self.host else v.to(self.dtype)

    def maximum(self, a, b):
        return max(a, b) if self.host else torch.clamp_min(a, b)


def _finite(v) -> bool:
    return math.isfinite(float(v))


def _two_loop(q, pairs, sc: _Scalars):
    """``H·q`` by the two-loop recursion over ``pairs`` ((s, y, rho),
    oldest first), ``H0 = gamma·I`` scaled by the newest pair."""
    alphas = []
    for s, y, rho in reversed(pairs):  # newest first
        a = sc.keep(rho * tvec.dot(s, q))
        q = tvec.axpby(1.0, q, -a, y)
        alphas.append(a)
    if pairs:
        s_n, y_n, _ = pairs[-1]
        gamma = sc.keep(tvec.dot(s_n, y_n)) / sc.maximum(
            sc.keep(tvec.dot(y_n, y_n)), sc.tiny)
    else:
        gamma = 1.0
    r = tvec.scale(gamma, q)
    for (s, y, rho), a in zip(pairs, reversed(alphas)):
        b = sc.keep(rho * tvec.dot(y, r))
        r = tvec.axpby(1.0, r, a - b, s)
    return r


def _push_pair(pairs, m, s, y, sc: _Scalars):
    """Store (s, y) unless the curvature safeguard rejects it; keep the
    newest ``m``."""
    sy, ns, ny = sc.pull(tvec.dot(s, y), tvec.norm(s), tvec.norm(y))
    if bool(sy > 1e-10 * ns * ny):
        pairs.append((s, y, 1.0 / sy))
        if len(pairs) > m:
            pairs.pop(0)


def _wolfe_gen(w, f0, g0, d, cfg: LBFGSConfig, sc: _Scalars, w_template):
    """Strong-Wolfe step along ``d`` as a generator: each objective
    evaluation is ``f, g = yield w_trial``, the gradient cast to
    ``w_template``'s leaf dtypes.  Returns ``(t, f_t, g_t, evals, ok,
    fail_info)``.  On failure ``f_t``/``g_t`` are the last trial's and
    ``fail_info = (phase, f_lo, t_last, dg0)`` (phase 1 bracket, 2
    zoom) feeds the ``ls_stop_reason`` split."""
    dg0 = sc.pull(tvec.dot(g0, d))[0]
    c1, c2 = sc.const(cfg.c1), sc.const(cfg.c2)

    def at(t):
        f, g = yield tvec.axpby(1.0, w, float(t), d)
        g = _pin(g, w_template)
        f, dg = sc.pull(f, tvec.dot(g, d))
        return f, g, dg

    t = sc.const(1.0)
    f_t, g_t, dg_t = yield from at(t)
    evals = 1
    t_lo, f_lo = sc.const(0.0), f0
    t_hi = sc.const(0.0)
    zoom, it = False, 0
    while True:
        armijo = bool(f_t <= f0 + c1 * t * dg0)
        curv = bool(abs(dg_t) <= -c2 * dg0)
        if armijo and curv:
            return t, f_t, g_t, evals, True, None
        if not zoom:
            if (not armijo) or (it > 0 and bool(f_t >= f_lo)):
                t_hi = t  # a rise brackets [t_lo, t]
                zoom, it = True, 0
            elif bool(dg_t >= 0):  # a sign change brackets [t, t_lo]
                t_lo, f_lo, t_hi = t, f_t, t_lo
                zoom, it = True, 0
            else:
                t_lo, f_lo = t, f_t
                it += 1
                if it >= cfg.max_ls_steps:
                    return t, f_t, g_t, evals, False, (1, f_lo, t, dg0)
                t = t * cfg.max_step_growth
                f_t, g_t, dg_t = yield from at(t)
                evals += 1
                continue
        else:
            if (not armijo) or bool(f_t >= f_lo):
                t_hi = t
            else:
                # a kept trial whose slope points past lo: hi collapses
                # onto the old lo
                if bool(dg_t * (t_hi - t_lo) >= 0):
                    t_hi = t_lo
                t_lo, f_lo = t, f_t
            it += 1
            if it >= cfg.max_ls_steps:
                return t, f_t, g_t, evals, False, (2, f_lo, t, dg0)
        t = 0.5 * (t_lo + t_hi)
        f_t, g_t, dg_t = yield from at(t)
        evals += 1


class _Out(NamedTuple):
    """What a loop hands its result builders."""

    w: Any
    f: Any          # the smooth part's value at exit
    g: Any
    pairs: list
    hist: list      # entry 0 at the start, then one per accepted step
    steps: list     # per accepted step: (step, evaluations it took)
    it: int         # total iterations (warm prior included)
    seg_iters: int  # iterations of this call
    converged: bool
    ls_failed: bool
    aborted: bool
    reason: int
    evals: int
    grad_norm: Any  # ‖g‖ (OWL-QN: of the pseudo-gradient) at exit


def _start(w0, warm, m, sc: _Scalars, extra=None):
    """``(w, f, g, pairs, it, evals, extra_value)`` at the start, as a
    generator: an evaluation at ``w0`` (``f, g = yield w0``), or a warm
    carry (no evaluation).  ``extra(w)`` is read in the same copy as
    ``f``."""
    if warm is not None:
        w, g = warm.w, warm.g
        vals = sc.pull(extra(w)) if extra else ()
        return (w, sc.const(warm.f), g, list(warm.pairs)[-m:],
                int(warm.prior_iters), 0, *vals)
    f, g = yield w0
    g = _pin(g, w0)
    vals = sc.pull(f, *([extra(w0)] if extra else []))
    return (w0, vals[0], g, [], 0, 1, *vals[1:])


def _lbfgs_gen(w0, cfg: LBFGSConfig, sc: _Scalars, *, warm=None,
               on_iteration=None):
    """The L-BFGS loop as a generator (``f, g = yield w`` for each
    objective evaluation; returns an :class:`_Out`): the one body of
    decisions that the solo loops (:func:`_lbfgs_loop`) and the
    lock-step lanes (:func:`run_lanes`) run.  The fused twin
    (``sc.host`` false) also marks an abort when a failed line search
    ended on a non-finite trial, as the JAX loop does; the host twin, as
    ``host_lbfgs.py``, does not."""
    m = int(cfg.num_corrections)
    if m < 1:
        raise ValueError("num_corrections must be >= 1")
    w, f, g, pairs, it, evals = yield from _start(w0, warm, m, sc)
    prior = it
    hist, steps = [f], []
    converged = ls_failed = False
    aborted = not _finite(f)
    reason = LS_STOP_NONE
    tol = sc.const(cfg.convergence_tol)

    while not (converged or ls_failed or aborted) and \
            it < cfg.num_iterations:
        d = tvec.scale(-1.0, _two_loop(g, pairs, sc))
        if not bool(sc.pull(tvec.dot(g, d))[0] < 0):
            d = tvec.scale(-1.0, g)  # stale curvature: steepest descent
        t, f_n, g_n, ev, ok, info = yield from _wolfe_gen(w, f, g, d, cfg,
                                                          sc, w0)
        evals += ev
        if not ok:
            ls_failed = True
            # noise floor: no trial improved f beyond the carry dtype's
            # resolution, and the last trial expected no more either
            phase, f_best, t_last, dg0 = info
            tol_f = 32 * sc.eps * max(abs(f), 1.0)
            at_noise = bool(f - f_best <= tol_f) and \
                bool(abs(dg0) * abs(t_last) <= tol_f)
            reason = LS_STOP_NOISE_FLOOR if at_noise else phase
            aborted = not sc.host and not _finite(f_n)
            break
        if not _finite(f_n):
            aborted = True
            break
        w_n = tvec.axpby(1.0, w, float(t), d)
        _push_pair(pairs, m, tvec.sub(w_n, w), tvec.sub(g_n, g), sc)
        improv = (f - f_n) / max(abs(f), abs(f_n), 1.0)
        converged = bool(improv <= tol)
        if cfg.grad_tol > 0 and bool(sc.pull(tvec.norm(g_n))[0]
                                     < cfg.grad_tol):
            converged = True
        w, f, g = w_n, f_n, g_n
        it += 1
        hist.append(f)
        steps.append((float(t), ev))
        if on_iteration is not None:
            on_iteration({"w": w, "f": f, "g": g, "pairs": tuple(pairs),
                          "it": it})
    return _Out(w, f, g, pairs, hist, steps, it, it - prior, converged,
                ls_failed, aborted, reason, evals, tvec.norm(g))


def _lbfgs_loop(objective, w0, cfg: LBFGSConfig, sc: _Scalars, *,
                warm=None, on_iteration=None) -> _Out:
    """The L-BFGS loop on ``objective(w) -> (f, g)``: :func:`_lbfgs_gen`
    driven one evaluation at a time."""
    return _drive(_lbfgs_gen(w0, cfg, sc, warm=warm,
                             on_iteration=on_iteration), objective)


def run_lanes(objective_multi, w0_stacked, cfg: LBFGSConfig,
              sc: _Scalars):
    """K lock-step L-BFGS lanes over one multi-evaluation a round,
    ``objective_multi(W) -> ((K,) values, gradients stacked like W)``.
    Each lane runs :func:`_lbfgs_gen`, the solo loop's own body, so no
    lane's decisions can drift from a solo run's.  A lane that has
    finished sends its final weights to later rounds (the evaluation
    takes the whole stack) and its result is frozen.  Returns ``(outs,
    rounds)``: each lane's :class:`_Out` and the evaluation rounds."""
    k = tvec.leaves(w0_stacked)[0].shape[0]
    gens = [_lbfgs_gen(tvec.lane(w0_stacked, i), cfg, sc)
            for i in range(k)]
    queries = [next(gen) for gen in gens]  # a fresh loop asks for w0
    outs = [None] * k
    rounds = 0
    while any(o is None for o in outs):
        fs, G = objective_multi(tvec.stack_lanes(
            [queries[i] if outs[i] is None else outs[i].w
             for i in range(k)]))
        rounds += 1
        for i in range(k):
            if outs[i] is not None:
                continue
            try:
                queries[i] = gens[i].send((fs[i], tvec.lane(G, i)))
            except StopIteration as e:
                outs[i] = e.value
    return outs, rounds


def _pseudo_gradient(w, g, l1: float):
    """Leafwise minimal-norm subgradient of ``f + l1·‖·‖₁`` at ``w``."""
    def leaf(wi, gi):
        pos = gi + l1
        neg = gi - l1
        at_zero = torch.where(pos < 0, pos, torch.where(neg > 0, neg, 0.0))
        return torch.where(wi > 0, pos, torch.where(wi < 0, neg, at_zero))

    return tvec.tmap(leaf, w, g)


def _owlqn_loop(objective_smooth, w0, l1_reg: float, cfg: LBFGSConfig,
                sc: _Scalars, *, warm=None, on_iteration=None) -> _Out:
    """The OWL-QN loop (both twins).  ``hist`` holds the full objective
    ``F = f + l1·‖w‖₁``; ``warm.f`` is the smooth part's value."""
    m = int(cfg.num_corrections)
    if m < 1:
        raise ValueError("num_corrections must be >= 1")
    if l1_reg < 0:
        raise ValueError("l1_reg must be >= 0")
    objective_smooth = _pin_objective(objective_smooth, w0)
    l1 = sc.const(l1_reg)
    l1f = float(l1)  # the penalty as the weights see it
    w, f, g, pairs, it, evals, l1n = _drive(
        _start(w0, warm, m, sc, extra=tvec.l1_norm), objective_smooth)
    prior = it
    big_f = f + l1 * l1n
    hist, steps = [big_f], []
    converged = ls_failed = False
    aborted = not _finite(big_f)
    reason = LS_STOP_NONE
    tol = sc.const(cfg.convergence_tol)
    c1 = sc.const(cfg.c1)

    while not (converged or ls_failed or aborted) and \
            it < cfg.num_iterations:
        pg = _pseudo_gradient(w, g, l1f)
        d = tvec.scale(-1.0, _two_loop(pg, pairs, sc))
        # orthant alignment: drop components whose sign disagrees with
        # steepest descent; fall back to -pg if nothing survives
        d = tvec.tmap(lambda di, pgi: torch.where(di * pgi < 0, di, 0.0),
                      d, pg)
        if bool(sc.pull(tvec.dot(d, d))[0] == 0):
            d = tvec.scale(-1.0, pg)
        xi = tvec.tmap(lambda wi, pgi: torch.where(
            wi != 0, torch.sign(wi), torch.sign(-pgi)), w, pg)

        def trial(t, w=w, d=d, xi=xi, pg=pg):
            tf = float(t)
            w_t = tvec.tmap(lambda wi, di, xii: torch.where(
                (wi + tf * di) * xii > 0, wi + tf * di, 0.0), w, d, xi)
            f_t, g_t = objective_smooth(w_t)
            # Armijo through the projected step: the clip can shorten it
            f_t, l1n_t, gain = sc.pull(f_t, tvec.l1_norm(w_t),
                                       tvec.dot(pg, tvec.sub(w_t, w)))
            return w_t, f_t, f_t + l1 * l1n_t, g_t, gain

        t, k = sc.const(1.0), 0
        while True:
            w_n, f_n, big_f_n, g_n, gain = trial(t)
            k += 1
            ok = bool(big_f_n <= big_f + c1 * gain) and _finite(big_f_n)
            if ok or k >= cfg.max_ls_steps:
                break
            t = t * 0.5
        evals += k
        if not ok:
            ls_failed = True
            aborted = not _finite(big_f_n)
            tol_f = 32 * sc.eps * max(abs(big_f), 1.0)
            at_noise = _finite(big_f_n) and \
                bool(abs(big_f_n - big_f) <= tol_f) and \
                bool(abs(gain) <= tol_f)
            reason = LS_STOP_NOISE_FLOOR if at_noise else LS_STOP_ARMIJO
            break
        # the pairs hold the smooth part's gradients (Andrew & Gao)
        _push_pair(pairs, m, tvec.sub(w_n, w), tvec.sub(g_n, g), sc)
        improv = (big_f - big_f_n) / max(abs(big_f), abs(big_f_n), 1.0)
        converged = bool(improv <= tol)
        if cfg.grad_tol > 0 and bool(sc.pull(tvec.norm(
                _pseudo_gradient(w_n, g_n, l1f)))[0] < cfg.grad_tol):
            converged = True
        w, f, g, big_f = w_n, f_n, g_n, big_f_n
        it += 1
        hist.append(big_f)
        steps.append((float(t), k))
        if on_iteration is not None:
            on_iteration({"w": w, "f": f, "g": g, "pairs": tuple(pairs),
                          "it": it})
    return _Out(w, f, g, pairs, hist, steps, it, it - prior, converged,
                ls_failed, aborted, reason, evals,
                tvec.norm(_pseudo_gradient(w, g, l1f)))


def _result(out: _Out, num_iterations: int, dt) -> LBFGSResult:
    hist = torch.full((num_iterations + 1,), math.nan, dtype=dt)
    hist[:len(out.hist)] = torch.stack(out.hist)
    step = torch.full((num_iterations,), math.nan, dtype=dt)
    evals = torch.zeros((num_iterations,), dtype=torch.int32)
    if out.steps:
        step[:len(out.steps)] = torch.tensor([t for t, _ in out.steps],
                                             dtype=dt)
        evals[:len(out.steps)] = torch.tensor([e for _, e in out.steps],
                                              dtype=torch.int32)
    return LBFGSResult(
        weights=out.w, loss_history=hist,
        num_iters=torch.tensor(out.it, dtype=torch.int32),
        converged=torch.tensor(out.converged),
        ls_failed=torch.tensor(out.ls_failed),
        aborted_non_finite=torch.tensor(out.aborted),
        grad_norm=out.grad_norm.detach().to(dt).cpu(),
        num_fn_evals=torch.tensor(out.evals, dtype=torch.int32),
        ls_stop_reason=torch.tensor(out.reason, dtype=torch.int32),
        diag_step=step, diag_evals=evals)


def run_lbfgs(objective: Callable, w0: Any,
              config: LBFGSConfig = LBFGSConfig()) -> LBFGSResult:
    """Minimize ``objective(w) -> (f, g)`` from ``w0`` with decisions in
    the carry dtype (the JAX fused loop's)."""
    dt = _carry_dtype(w0)
    out = _lbfgs_loop(objective, w0, config, _Scalars(dt, host=False))
    return _result(out, config.num_iterations, dt)


def run_lbfgs_lanes(objective_multi: Callable, w0_stacked: Any,
                    config: LBFGSConfig = LBFGSConfig()) -> LBFGSResult:
    """K L-BFGS fits in lock-step (:func:`run_lanes`) with the decisions
    of :func:`run_lbfgs` in the carry dtype, over
    ``objective_multi(W_stacked) -> ((K,) values, stacked gradients)``:
    the lanes of the JAX package's ``jax.vmap`` of its fused loop.
    Returns a batched :class:`LBFGSResult`: each field on a leading K
    axis (``loss_history`` ``(K, num_iterations + 1)``), and
    ``eval_rounds``."""
    dt = _carry_dtype(w0_stacked)
    outs, rounds = run_lanes(objective_multi, w0_stacked, config,
                             _Scalars(dt, host=False))
    res = [_result(o, config.num_iterations, dt) for o in outs]
    return LBFGSResult(
        *(tvec.stack_lanes([getattr(r, f) for r in res])
          for f in LBFGSResult._fields[:-1]), eval_rounds=rounds)


def run_owlqn(objective_smooth: Callable, w0: Any, l1_reg: float,
              config: LBFGSConfig = LBFGSConfig()) -> LBFGSResult:
    """Minimize ``objective_smooth(w) -> (f, g)`` plus ``l1_reg·‖w‖₁``
    from ``w0``; ``objective_smooth`` may fold in an L2 part, so an
    elastic net is ``make_objective``'s smooth part plus ``l1_reg``.
    ``loss_history`` holds the full objective; ``num_fn_evals`` counts
    smooth evaluations."""
    dt = _carry_dtype(w0)
    out = _owlqn_loop(objective_smooth, w0, l1_reg, config,
                      _Scalars(dt, host=False))
    return _result(out, config.num_iterations, dt)
