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
``ops.sparse.CSRMatrix``, or a ``parallel.mesh.ShardedBatch`` already
placed on a mesh; it is placed once.

The entry points run on the current CUDA device unless the caller passes
``device=`` (``"cpu"`` for the CPU); with no CUDA device and no explicit
device they raise.  ``mesh=`` (``run``, ``make_runner``, ``run_lbfgs``,
``make_lbfgs_runner``, ``run_minibatch_sgd``, the optimizers'
``set_mesh``) runs data parallelism over a ``parallel.mesh.Mesh``'s data
axis (``parallel.dist_smooth``), the carry on the mesh's lead device;
``mesh=None`` does what the JAX package does: with no ``device=`` and
more than one visible CUDA device (or a process group of more than one
rank) it shards over all of them, else it runs locally; ``mesh=False``
runs locally.  ``dist_mode=`` is validated and, with no mesh, inert, as
in the JAX package.  ``verbose=True`` logs the fit's per-iteration lines
through ``utils.logging.log_result``.  ``run(resilience=...,
checkpointer=...)`` runs the fit under the supervisor
(``resilience.supervisor``): segments, retries, rollbacks and an
``AutoCheckpointer``.  A mesh may have a ``model`` axis:
``dist_mode="auto"`` then splits a softmax's classes over it
(``parallel.dist_smooth``), and a ``ShardedBatch`` from
``mesh.shard_batch_by_features`` splits the features.
``sharded_update=True`` (``run``, ``make_runner``; a mesh and
``dist_mode="shard_map"``) runs the update on 1/N shards of the weights
(``parallel.sharded_update``).  The grid fits (the sweeps, the L-BFGS
sweep, cross-validation and the streamed sweeps) take ``mesh=`` too
(``parallel.grid``).  ``telemetry=`` (``run``, ``make_runner``,
``run_lbfgs``, ``make_lbfgs_runner``; an ``obs.Telemetry``) streams one
``iteration`` record an iteration, times the fit's phases in spans
(``_make_instrumented_fit``) and, from ``run`` and ``run_lbfgs``, ends
with a ``run`` record; ``run(resilience=..., journal=)`` appends the
run's recovery decisions to a ``resilience.Journal``.
"""

from __future__ import annotations

import math
import os
from typing import Any, NamedTuple

import numpy as np
import torch

from ._device import resolve_device, same_device
from .core import agd, gd, host_agd, lbfgs as lbfgs_lib, prng
from .core import smooth as smooth_lib, tvec
from .ops.losses import Gradient
from .ops.prox import IdentityProx, Prox
from .ops.sparse import CSRMatrix, RowShardedCSR
from .parallel import dist_smooth, mesh as mesh_lib, multihost

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
    """Accept (X, y), (X, y, mask) or a ShardedBatch (returned as it
    is)."""
    if isinstance(data, mesh_lib.ShardedBatch):
        return data
    if isinstance(data, (tuple, list)) and len(data) in (2, 3):
        X, y = data[0], data[1]
        return X, y, data[2] if len(data) == 3 else None
    raise TypeError("data must be (X, y), (X, y, mask) or a ShardedBatch; "
                    f"got {type(data).__name__}")


def _resolve_mesh(mesh, device=None):
    """``False`` -> local; ``None`` -> a data mesh over every visible CUDA
    device when there is more than one (or over the process group's ranks
    when it has more than one) and no ``device=`` was named, else local;
    a ``Mesh`` -> itself, checked (a ``device=`` must be its lead
    device)."""
    if mesh is False:
        return None
    if mesh is None:
        if device is not None:
            return None
        multihost.check_launch()
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if cards <= 1 and multihost.process_count() <= 1:
            return None
        return mesh_lib.make_mesh()
    mesh_lib.check_data_mesh(mesh)
    if device is not None and not same_device(device, mesh.lead):
        raise ValueError(f"device={device} is not the mesh's lead device "
                         f"{mesh.lead}; drop one of the two")
    return mesh


def _batch_mesh(batch: "mesh_lib.ShardedBatch"):
    """The mesh a pre-placed batch lives on (dense or CSR alike)."""
    return batch.X.mesh


def _resolve_fit_mesh(data, mesh, device=None):
    """The one mesh-dispatch decision of the mesh-capable entry points.
    Returns ``(m, batch, csr_raw)``: ``batch`` is the ``ShardedBatch``
    when ``data`` is pre-placed (``m`` is then its mesh, and an explicit
    ``mesh`` must be it or this raises), else None; ``m`` the resolved
    mesh (None: one device); ``csr_raw``: ``data`` is a raw
    ``(CSRMatrix, ...)`` tuple."""
    if isinstance(data, mesh_lib.ShardedBatch):
        m = _batch_mesh(data)
        if mesh not in (None, False) and mesh != m:
            raise ValueError(
                "explicit mesh differs from the ShardedBatch's mesh; "
                "re-shard the batch or drop the mesh argument")
        return m, data, False
    csr_raw = (isinstance(data, (tuple, list))
               and isinstance(data[0], CSRMatrix))
    return _resolve_mesh(mesh, device), None, csr_raw


def _reconcile_runner_mesh(data, mesh, dist_mode: str, device=None):
    """The ``make_*_runner`` preamble on :func:`_resolve_fit_mesh`:
    ``mesh=False`` forces one device even on a pre-placed batch, and raw
    CSR forces the explicit ``shard_map`` mode.  Returns ``(data,
    resolved_mesh, dist_mode)``."""
    data = _normalize_data(data)
    m, batch, csr_raw = _resolve_fit_mesh(data, mesh, device)
    if batch is not None and mesh is False:
        m = None
    if csr_raw:
        dist_mode = "shard_map"
    return data, m, dist_mode


def _grid_mesh_batch(data, mesh, device=None):
    """The mesh and row-sharded batch of a grid fit (the sweeps, the
    L-BFGS sweep): ``(None, None)`` on one device (``mesh=False``, the
    grid fits' default, or ``None`` with one device); a pre-placed batch
    brings its own mesh; raw data is sharded over the resolved mesh."""
    m, batch, _ = _resolve_fit_mesh(data, mesh, device)
    if m is None:
        return None, None
    if batch is None:
        batch = mesh_lib.shard_batch(m, *_normalize_data(data))
    return m, batch


def _gathered(batch: "mesh_lib.ShardedBatch"):
    """A dense pre-placed batch's (X, y, mask) as whole tensors on the
    CPU (``mesh=False`` on a ShardedBatch)."""
    if isinstance(batch.X, RowShardedCSR):
        raise ValueError("mesh=False on a row-sharded CSR batch: pass the "
                         "CSRMatrix itself for a single-device fit")
    return (batch.X.gather(), batch.y.gather(),
            None if batch.mask is None else batch.mask.gather())


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


def _stage(data, gradient: Gradient, device, mesh=False,
           dist_mode: str = "shard_map", sharded_update: bool = False):
    """``(device, (build, data_args))``: the data placed once and
    prepared, on the run's device (``core.smooth.make_smooth_staged``)
    or sharded over the resolved mesh (``parallel.dist_smooth``), whose
    lead device is then the run's.  ``sharded_update=True``: the build is
    a ``parallel.sharded_update.ShardedUpdateBuild``, whose
    ``make_agd_run`` hook runs the whole loop (the JAX package's checks:
    it requires a mesh and ``dist_mode='shard_map'``)."""
    data, m, dist_mode = _reconcile_runner_mesh(data, mesh, dist_mode,
                                                device)
    if sharded_update:
        if m is None:
            raise ValueError(
                "sharded_update=True requires a mesh (the 1/N weight "
                "shard is per-replica); pass mesh= or a ShardedBatch, "
                "or drop sharded_update on a single-device run")
        if dist_mode != "shard_map":
            raise ValueError(
                "sharded_update=True requires dist_mode='shard_map' "
                "(the sharded carry is an explicit-SPMD construction "
                "the GSPMD partitioner cannot express)")
        from .parallel import sharded_update as sharded_lib

        # a ShardedBatch unpacks to its placed (X, y, mask)
        return m.lead, sharded_lib.make_sharded_staged(gradient, *data,
                                                       mesh=m)
    if m is None:
        dev = resolve_device(device)
        X, y, mask = (_gathered(data)
                      if isinstance(data, mesh_lib.ShardedBatch) else data)
        return dev, smooth_lib.make_smooth_staged(
            gradient, _place(X, dev), _place(y, dev), _place(mask, dev))
    batch = (data if isinstance(data, mesh_lib.ShardedBatch)
             else mesh_lib.shard_batch(m, *data))
    return m.lead, dist_smooth.make_dist_smooth_staged(
        gradient, batch, mesh=m, mode=dist_mode)


def _weights_key(w) -> str:
    """A weight tree's structure, shapes and dtypes, as one string."""
    return repr(tvec.tmap(lambda a: (tuple(a.shape), str(a.dtype)), w))


def _make_instrumented_fit(place_w, bind, execute, gradient, dev,
                           telemetry):
    """The telemetry twin of a runner's plain ``fit`` (the JAX package's
    ``api.py:194-240``): the same fit, each phase under a span timer that
    streams a ``span`` record as it closes and under a profiler range of
    the same name (``utils.profiling.annotate``), in the JAX package's
    order:

    - ``h2d_transfer``: ``place_w``, the weights copied onto the run's
      device;
    - on the first call for each weight structure, shape and dtype,
      ``trace`` and then ``compile``.  The port traces and compiles no
      program, so they time what stands in their place: ``trace`` runs
      ``bind()``, which binds the smooth closures to the operands that
      ``gradient.prepare`` staged when the runner was built (the route
      through the kernel wrappers is fixed there), and ``compile`` forces
      the first-use ``nvcc`` build and load of every kernel library the
      gradient launches on ``dev`` (``ops.fused_kernels.load_for``; on
      the CPU, or for a gradient without a kernel, it does nothing), so
      ``execute`` never absorbs it;
    - ``execute``: ``execute(w, bound)``, the fit's loop, ending after
      ``torch.cuda.synchronize(dev)`` on a CUDA device, so the span
      measures the device's work, as the JAX package's
      ``block_until_ready`` does.

    When the telemetry carries a ``profile_dir``, the first ``execute``
    is captured as a profiler trace (``utils.profiling.OneShotTrace``),
    so the span timers and the device timeline line up by name."""
    from .ops import fused_kernels
    from .utils import profiling

    cache = {}
    capture = profiling.OneShotTrace(
        getattr(telemetry, "profile_dir", None))

    def fit(initial_weights):
        with telemetry.span("h2d_transfer"), \
                profiling.annotate("h2d_transfer"):
            w = place_w(initial_weights)
        key = _weights_key(w)
        bound = cache.get(key)
        if bound is None:
            with telemetry.span("trace"), profiling.annotate("trace"):
                bound = bind()
            with telemetry.span("compile"), profiling.annotate("compile"):
                fused_kernels.load_for(gradient, dev)
            cache[key] = bound
        with capture(), telemetry.span("execute"), \
                profiling.annotate("execute"):
            res = execute(w, bound)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return res

    return fit


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
    prepared once (``gradient.prepare`` runs here, not per fit; on a
    mesh once a shard).

    ``telemetry`` (an ``obs.Telemetry``, default off): the loop emits one
    ``iteration`` record an iteration (iter, loss, L, theta, step,
    restarted; ``core.agd.run_agd(telemetry_cb=)``) from the scalars it
    holds on the host already, so it adds no device sync, and each
    ``fit`` runs its phases under the spans of
    :func:`_make_instrumented_fit`.  ``None`` runs the same fit with no
    callback and no span."""
    _check_dist_mode(dist_mode)
    dev, (build, dargs) = _stage(data, gradient, device, mesh, dist_mode,
                                 sharded_update)
    px, rv = smooth_lib.make_prox(updater, reg_param)
    cfg = agd.AGDConfig(
        convergence_tol=convergence_tol, num_iterations=num_iterations,
        l0=l0, l_exact=l_exact, beta=beta, alpha=alpha,
        may_restart=may_restart, loss_mode=loss_mode)
    agd_run = getattr(build, "make_agd_run", None)
    tel_cb = (None if telemetry is None
              else telemetry.iteration_callback("agd"))

    def place_w(initial_weights):
        return tvec.tmap(lambda a: _owned(a, dev), initial_weights)

    if agd_run is not None:
        # the sharded update: the whole loop over 1/N shards, full trees
        # in and out
        def bind():
            return agd_run(px, rv, cfg, telemetry_cb=tel_cb)

        def execute(w0, run_sh):
            return run_sh(w0, dargs)
    else:
        def bind():
            return build(*dargs)

        def execute(w0, closures):
            sm, sl = closures
            return agd.run_agd(sm, px, rv, w0, cfg, smooth_loss=sl,
                               telemetry_cb=tel_cb)

    if telemetry is None:
        def fit(initial_weights):
            return execute(place_w(initial_weights), bind())
    else:
        fit = _make_instrumented_fit(place_w, bind, execute, gradient, dev,
                                     telemetry)
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
    logs one line of its retries and rollbacks.

    ``telemetry`` (an ``obs.Telemetry``, default off): the iteration
    stream and the spans of :func:`make_runner` (on the supervised path,
    the supervisor's records and its iteration stream), then one ``run``
    record at the end.  ``journal`` (supervised path only; a path or an
    open ``resilience.Journal``): every recovery decision of the run is
    also appended to the crash-safe journal, through a ``JournalSink`` on
    the run's bus; a path is opened (its torn tail repaired) and closed
    by this call, an open ``Journal`` flushed and left open."""
    if initial_weights is None:
        raise ValueError("initial_weights is required")
    if resilience is not None:
        cfg = agd.AGDConfig(
            convergence_tol=convergence_tol, num_iterations=num_iterations,
            l0=l0, l_exact=l_exact, beta=beta, alpha=alpha,
            may_restart=may_restart, loss_mode=loss_mode)
        return _run_supervised(
            data, gradient, updater, cfg, reg_param, initial_weights,
            mesh, dist_mode, return_result, device, telemetry, verbose,
            resilience, checkpointer, journal, sharded_update)
    if checkpointer is not None or journal is not None:
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
    if telemetry is not None:
        telemetry.run_summary(
            tool="api.run", algorithm="agd", iters=n,
            final_loss=float(loss_history[-1]) if n else None,
            converged=bool(result.converged),
            restarts=int(result.num_restarts),
            backtracks=int(result.num_backtracks),
            error=("aborted: non-finite loss"
                   if bool(result.aborted_non_finite) else None))
    if verbose:
        from .utils import logging as logging_utils

        logging_utils.log_result(result)
    if return_result:
        return result.weights, loss_history, result
    return result.weights, loss_history


def _run_supervised(data, gradient, updater, cfg, reg_param,
                    initial_weights, mesh, dist_mode, return_result,
                    device, telemetry, verbose, resilience, checkpointer,
                    journal, sharded_update):
    """The ``resilience=`` branch of :func:`run`: the staging of
    :func:`make_runner`, driven by
    ``resilience.supervisor.run_agd_supervised``."""
    from .resilience import supervisor as supervisor_lib

    _check_dist_mode(dist_mode)
    policy = None if resilience is True else resilience
    dev, staged = _stage(data, gradient, device, mesh, dist_mode,
                         sharded_update)
    px, rv = smooth_lib.make_prox(updater, reg_param)

    # journal= wiring: a JournalSink rides the run's event bus for the
    # duration of this call.  A bare journal (telemetry=None) gets a
    # Telemetry of decision records only, with the iteration stream off,
    # so the fit runs as on the plain path.
    jrnl = sink = None
    own_journal = False
    stream_iterations = telemetry is not None
    if journal is not None:
        from .obs import Telemetry
        from .resilience import journal as journal_lib

        if isinstance(journal, journal_lib.Journal):
            jrnl = journal
        else:
            jrnl = journal_lib.Journal(os.fspath(journal))
            own_journal = True
        sink = journal_lib.JournalSink(jrnl)
        if telemetry is None:
            telemetry = Telemetry([sink])
        else:
            telemetry.bus.sinks.append(sink)
        telemetry.journal_replay(**jrnl.replay_summary)

    try:
        sres = supervisor_lib.run_agd_supervised(
            prox=px, reg_value=rv, w0=initial_weights, config=cfg,
            policy=policy, telemetry=telemetry,
            checkpointer=checkpointer, staged=staged,
            place_w=lambda w: tvec.tmap(lambda a: _owned(a, dev), w),
            stream_iterations=stream_iterations)
    finally:
        if sink is not None:
            if sink in telemetry.bus.sinks:
                telemetry.bus.sinks.remove(sink)
            if own_journal:
                jrnl.close()
            else:
                jrnl.flush()
    loss_history = np.asarray(sres.loss_history)
    if telemetry is not None:
        telemetry.run_summary(
            tool="api.run", algorithm="agd", iters=int(sres.num_iters),
            final_loss=(float(loss_history[-1]) if len(loss_history)
                        else None),
            converged=bool(sres.converged),
            error=("aborted: non-finite loss"
                   if sres.aborted_non_finite else None))
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
    ``mesh``: ``False`` (default) runs on one device; a ``Mesh`` (or
    ``None`` for the all-device data mesh, or a ``ShardedBatch``, which
    brings its own) also shards the rows over the mesh's data axis, each
    round one ``lanes_loss_and_grad`` call a slot
    (``parallel.grid.make_mesh_sweep_fit``)."""
    cfg = agd.AGDConfig(
        convergence_tol=convergence_tol, num_iterations=num_iterations,
        l0=l0, l_exact=l_exact, beta=beta, alpha=alpha,
        may_restart=may_restart, loss_mode=loss_mode)
    m, batch = _grid_mesh_batch(data, mesh, device)
    if m is not None:
        from .parallel import grid

        mesh_fit = grid.make_mesh_sweep_fit(gradient, updater, batch, m,
                                            cfg)

        def mesh_path(initial_weights, reg_params, warm=None):
            return mesh_fit(reg_params, initial_weights, warm=warm)

        mesh_path.data_args = mesh_fit.data_args
        return mesh_path
    dev = resolve_device(device)
    X, y, mask = _normalize_data(data)
    dargs = gradient.prepare(_place(X, dev), _place(y, dev),
                             _place(mask, dev))
    sm, sl = smooth_lib.lanes_smooth(gradient, *dargs)
    fit = _lanes_fit(sm, sl, updater, cfg, dev)
    fit.data_args = dargs
    return fit


def _lanes_fit(sm, sl, updater, cfg, dev):
    """``fit(initial_weights, reg_params, warm=None) -> batched
    AGDResult``: the lock-step lanes over ``(smooth_multi,
    smooth_loss_multi)``, one device's or a mesh's."""

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
    cfg = agd.AGDConfig(
        convergence_tol=convergence_tol, num_iterations=num_iterations,
        l0=l0, l_exact=l_exact, beta=beta, alpha=alpha,
        may_restart=may_restart, loss_mode=loss_mode)
    m, batch, _ = _resolve_fit_mesh(data, mesh, device)
    if m is not None:
        return _build_mesh_cv(data, m, batch, gradient, updater, n_folds,
                              cfg, seed)
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
        return _cv_result(val, res, n_folds, n_regs, fold_ids, base_mask)

    return fit


def _cv_result(val, res, n_folds, n_regs, fold_ids, base_mask):
    """The ``CVResult`` of the flat lane grid's validation losses and
    batched result."""
    val_loss = val.reshape(n_folds, n_regs)
    train_result = agd.AGDResult(*(
        tvec.tmap(lambda a: a.reshape((n_folds, n_regs) + a.shape[1:]),
                  field) for field in res))
    mean_val = torch.nanmean(val_loss, dim=0)
    return CVResult(val_loss=val_loss, train_result=train_result,
                    mean_val_loss=mean_val,
                    best_index=_nan_first_argmin(mean_val),
                    fold_ids=fold_ids, base_mask=base_mask)


def _build_mesh_cv(data, m, batch, gradient, updater, n_folds, cfg, seed):
    """The mesh branch of :func:`_build_cv` (``parallel.grid
    .make_mesh_cv_fit``).  Raw data: the folds are JAX's assignment over
    the input rows, placed by ``grid.shard_row_array`` (dense) or through
    the CSR balancer's permutation by ``shard_csr_batch(extras=)``; a
    pre-placed batch: the folds are assigned over its padded layout, as
    the JAX package assigns them."""
    from .parallel import grid

    lead = m.lead
    if batch is not None:
        n = batch.y.shape[0]  # the padded layout; the mask covers padding
        fold_ids = fold_assignment(n, n_folds, seed, lead)
        base_mask = (batch.mask.gather().to(lead)
                     if batch.mask is not None
                     else torch.ones(n, dtype=torch.float32, device=lead))
        fids = grid.shard_row_array(m, fold_ids.cpu().numpy(), n, fill=-1)
    else:
        X, y, base_mask = _normalize_data(data)
        n = X.shape[0]
        fold_ids = fold_assignment(n, n_folds, seed, lead)
        base_mask = (torch.ones(n, dtype=torch.float32, device=lead)
                     if base_mask is None
                     else _place(base_mask, lead).to(torch.float32))
        if isinstance(X, CSRMatrix):
            batch, placed = mesh_lib.shard_csr_batch(
                m, X, y, base_mask.cpu().numpy(),
                extras={"fold_ids": fold_ids.cpu().numpy()})
            fids = placed["fold_ids"]
        else:
            batch = mesh_lib.shard_batch(m, X, y, base_mask.cpu().numpy())
            fids = grid.shard_row_array(m, fold_ids.cpu().numpy(),
                                        batch.y.shape[0], fill=-1)
    mesh_fit = grid.make_mesh_cv_fit(gradient, updater, batch, fids, m, cfg)

    def fit(initial_weights, reg_params):
        if initial_weights is None:
            raise ValueError("initial_weights is required")
        regs = _regs(reg_params)
        n_regs = regs.shape[0]
        fold_lane = torch.arange(n_folds, dtype=torch.int32) \
            .repeat_interleave(n_regs)
        val, res = mesh_fit(fold_lane, regs.repeat(n_folds),
                            initial_weights)
        return _cv_result(val, res, n_folds, n_regs, fold_ids, base_mask)

    return fit


def _mean_loss(gradient, W, X, y, masks):
    """``(K,)`` mean losses of the lanes of ``W`` under ``masks``; an
    empty selection reads NaN, never a perfect 0.0."""
    ls, _, cnt = gradient.lanes_loss_and_grad(W, X, y, masks)
    return smooth_lib.lanes_mean_or_nan(ls, cnt)


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
        """A ``parallel.mesh.Mesh`` (its rows over the data axis; with
        ``dist_mode="auto"`` a softmax's classes over a ``model`` axis),
        ``None`` (the default rule of :func:`run`) or ``False`` (one
        device)."""
        if mesh is not None and mesh is not False:
            mesh_lib.check_data_mesh(mesh)
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
    history entry per iteration (``core.gd``).

    ``mesh=False`` (the default) runs on one device.  A ``Mesh``, ``None``
    (the rule of :func:`run`) or a dense ``ShardedBatch`` shards the rows
    over the mesh's data axis: the samples are the single-device run's
    on the identically padded rows (each slot slices its block of one
    global draw), and each iteration's sums are combined across the
    slots.  Dense only: the nnz-balanced CSR layout permutes rows, which
    would break the global sample."""
    if initial_weights is None:
        raise ValueError("initial_weights is required")
    data = _normalize_data(data)
    m, batch, csr_raw = _resolve_fit_mesh(data, mesh, device)
    if csr_raw:
        if mesh not in (None, False):
            raise ValueError(
                "mesh run_minibatch_sgd supports dense data only (the "
                "nnz-balanced CSR layout permutes rows, breaking the "
                "global Bernoulli sample slicing); drop the mesh "
                "argument for a single-device oracle run")
        m = None
    if m is not None:
        if batch is None:
            batch = mesh_lib.shard_batch(m, *data)
        elif isinstance(batch.X, RowShardedCSR):
            raise ValueError(
                "mesh run_minibatch_sgd supports dense batches only (the "
                "nnz-balanced CSR layout permutes rows, breaking the "
                "global Bernoulli sample slicing)")
        res = gd.run_minibatch_sgd_mesh(
            gradient, updater, batch, m,
            tvec.tmap(lambda a: _owned(a, m.lead), initial_weights),
            step_size=step_size, num_iterations=num_iterations,
            reg_param=reg_param, minibatch_fraction=minibatch_fraction,
            seed=seed)
        return res.weights, res.loss_history.numpy()
    dev = resolve_device(device)
    X, y, mask = (_gathered(data) if isinstance(data, mesh_lib.ShardedBatch)
                  else data)
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
    ``"owlqn"``.  ``mesh`` composes as in :func:`make_runner`.
    ``telemetry``: an ``iteration`` record an accepted iteration from
    the quasi-Newton loop (``algorithm`` the dispatch, ``lbfgs`` or
    ``owlqn``) and the spans of :func:`_make_instrumented_fit`, as in
    :func:`make_runner`."""
    decomp = updater.owlqn_decomposition(float(reg_param))
    if decomp is None:
        raise ValueError(
            f"{type(updater).__name__} offers neither a smooth penalty "
            "nor an L1+smooth split (Prox.owlqn_decomposition); the "
            "quasi-Newton drivers cannot represent it — use "
            "AcceleratedGradientDescent")
    l1_coeff, extra = decomp
    _check_dist_mode(dist_mode)
    dev, (build, dargs) = _stage(data, gradient, device, mesh, dist_mode)
    cfg = lbfgs_lib.LBFGSConfig(
        num_corrections=num_corrections, convergence_tol=convergence_tol,
        num_iterations=num_iterations, grad_tol=grad_tol)
    algorithm = "owlqn" if l1_coeff > 0 else "lbfgs"
    tel_cb = (None if telemetry is None
              else telemetry.iteration_callback(algorithm))

    def place_w(initial_weights):
        return tvec.tmap(lambda a: _owned(a, dev), initial_weights)

    def bind():
        sm = build(*dargs)[0]

        def objective(w):
            f, g = sm(w)
            pv, pg = extra(w)
            return f + pv, tvec.add(g, pg)

        return objective

    def execute(w0, objective):
        if l1_coeff > 0:
            return lbfgs_lib.run_owlqn(objective, w0, l1_coeff, cfg,
                                       telemetry_cb=tel_cb)
        return lbfgs_lib.run_lbfgs(objective, w0, cfg, telemetry_cb=tel_cb)

    if telemetry is None:
        def fit(initial_weights):
            return execute(place_w(initial_weights), bind())
    else:
        fit = _make_instrumented_fit(place_w, bind, execute, gradient, dev,
                                     telemetry)
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
    """MLlib's ``LBFGS.runLBFGS``: returns the full ``LBFGSResult``.
    ``telemetry``: the stream and spans of :func:`make_lbfgs_runner`,
    then one ``run`` record."""
    if initial_weights is None:
        raise ValueError("initial_weights is required")
    fit = make_lbfgs_runner(
        data, gradient, updater, num_corrections=num_corrections,
        convergence_tol=convergence_tol, num_iterations=num_iterations,
        reg_param=reg_param, grad_tol=grad_tol, mesh=mesh,
        dist_mode=dist_mode, device=device, telemetry=telemetry)
    result = fit(initial_weights)
    if telemetry is not None:
        k = int(result.num_iters)
        telemetry.run_summary(
            tool="api.run_lbfgs", algorithm=fit.algorithm, iters=k,
            final_loss=float(result.loss_history[k]),
            converged=bool(result.converged),
            error=("aborted: non-finite objective"
                   if bool(result.aborted_non_finite) else None))
    return result


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
        """A ``parallel.mesh.Mesh`` (its rows over the data axis; with
        ``dist_mode="auto"`` a softmax's classes over a ``model`` axis),
        ``None`` (the default rule of :func:`run`) or ``False`` (one
        device)."""
        if mesh is not None and mesh is not False:
            mesh_lib.check_data_mesh(mesh)
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
    rounds.  ``mesh`` as in :func:`make_sweep_runner`: the rows sharded
    over a mesh's data axis, each round one call a slot
    (``parallel.grid.make_mesh_lbfgs_sweep_fit``)."""
    lbfgs_lib.check_smooth_penalty(updater, 1.0)
    cfg = lbfgs_lib.LBFGSConfig(
        num_corrections=num_corrections, convergence_tol=convergence_tol,
        num_iterations=num_iterations, grad_tol=grad_tol)
    m, batch = _grid_mesh_batch(data, mesh, device)
    if m is not None:
        from .parallel import grid

        mesh_fit = grid.make_mesh_lbfgs_sweep_fit(gradient, updater, batch,
                                                  m, cfg)

        def mesh_path(initial_weights, reg_params):
            return mesh_fit(_check_grid_fit(updater, reg_params,
                                            "make_lbfgs_sweep_runner"),
                            initial_weights)

        mesh_path.data_args = mesh_fit.data_args
        return mesh_path
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
    ``mesh`` (a data-axis ``parallel.mesh.Mesh``) shards each
    macro-batch over the mesh, one lanes launch a slot a batch
    (``data.streaming.make_streaming_eval_multi(mesh=)``); ``device`` is
    then its lead device, and ``csr_nnz_per_shard`` pins a CSR shard's
    entries (inert without a mesh)."""
    from .data import streaming as streaming_lib

    if initial_weights is None:
        raise ValueError("initial_weights is required")
    regs = list(reg_params)
    # one placer for both evaluators: one ring of pinned staging buffers;
    # dev is the device the lanes live on (a mesh's lead device)
    sm, sl, dev = streaming_lib._eval_multi_pair(
        gradient, dataset, pad_to, device, pass_stats, mesh=mesh,
        csr_nnz_per_shard=csr_nnz_per_shard)
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
    :func:`streaming_sweep`, and ``mesh`` too."""
    from .core import host_lbfgs
    from .data import streaming as streaming_lib

    if initial_weights is None:
        raise ValueError("initial_weights is required")
    # the guard LBFGS.sweep applies: a no-penalty updater would return K
    # identical lanes
    regs = _lbfgs_regs(_check_grid_fit(updater, reg_params,
                                       "streaming_lbfgs_sweep"))
    lbfgs_lib.check_smooth_penalty(updater, 1.0)
    sm_multi, _, dev = streaming_lib._eval_multi_pair(
        gradient, dataset, pad_to, device, pass_stats, mesh=mesh,
        csr_nnz_per_shard=csr_nnz_per_shard)
    w0 = tvec.tmap(lambda a: _owned(a, dev), initial_weights)
    cfg = lbfgs_lib.LBFGSConfig(
        num_corrections=num_corrections, convergence_tol=convergence_tol,
        num_iterations=num_iterations, grad_tol=grad_tol)
    return host_lbfgs.run_lbfgs_host_multi(
        _penalized_lanes(sm_multi, updater, regs),
        _stack_lanes(w0, len(regs)), cfg)
