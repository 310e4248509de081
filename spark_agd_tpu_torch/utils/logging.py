"""Structured per-iteration observability.

Counterpart of ``spark_agd_tpu/utils/logging.py``.  The reference's
entire logging surface is two calls: ``logWarning`` on a non-finite loss
(reference ``AcceleratedGradientDescent.scala:309-312``) and ``logInfo``
with the last 10 losses at completion (``:334-335``).  The port's
``AGDResult`` carries the per-iteration diagnostics (L, theta, step,
restarts) as CPU tensors, and this module turns them into records and
log lines, the same lines and records as the JAX package's (the
result's fields are CPU tensors, which numpy reads in place).  The
logger is the JAX package's, ``"spark_agd_tpu"``, so one handler sees
both.
"""

from __future__ import annotations

import json
import logging
from typing import List, Optional

import numpy as np

from ..obs import schema

logger = logging.getLogger("spark_agd_tpu")


def iteration_records(result, *, run_id: Optional[str] = None,
                      algorithm: str = "agd") -> List[dict]:
    """One dict per executed iteration from an ``AGDResult``: iter (1-based,
    like the reference's nIter), loss, L, theta, step, restarted.

    With ``run_id`` set, each dict is a canonical ``obs.schema``
    iteration record (``schema_version``/``kind``/``run_id``/
    ``algorithm`` added), byte-compatible with the JAX package's."""
    n = int(result.num_iters)
    hist = np.asarray(result.loss_history)[:n]
    ls = np.asarray(result.diag_l)[:n]
    thetas = np.asarray(result.diag_theta)[:n]
    steps = np.asarray(result.diag_step)[:n]
    restarted = np.asarray(result.diag_restarted)[:n]
    recs = [
        dict(iter=i + 1, loss=float(hist[i]), L=float(ls[i]),
             theta=float(thetas[i]), step=float(steps[i]),
             restarted=bool(restarted[i]))
        for i in range(n)
    ]
    if run_id is not None:
        recs = [schema.iteration_record(run_id, algorithm,
                                        r.pop("iter"), **r)
                for r in recs]
    return recs


def result_run_record(result, *, tool: str = "api.run",
                      algorithm: str = "agd",
                      run_id: Optional[str] = None, **extra) -> dict:
    """The canonical end-of-run ``run`` record for an ``AGDResult``."""
    n = int(result.num_iters)
    hist = np.asarray(result.loss_history)[:n]
    return schema.run_record(
        tool=tool, run_id=run_id, algorithm=algorithm, iters=n,
        final_loss=float(hist[-1]) if n else None,
        converged=bool(result.converged),
        error=("aborted: non-finite loss"
               if bool(result.aborted_non_finite) else None),
        **extra)


def write_result_jsonl(result, path: str, *, tool: str = "api.run",
                       algorithm: str = "agd",
                       run_id: Optional[str] = None) -> str:
    """Persist one completed run as canonical JSONL (the ``run`` record
    followed by its iteration records).  Returns the ``run_id``."""
    run_id = run_id or schema.new_run_id()
    with open(path, "a") as f:
        f.write(json.dumps(result_run_record(
            result, tool=tool, algorithm=algorithm,
            run_id=run_id)) + "\n")
        for rec in iteration_records(result, run_id=run_id,
                                     algorithm=algorithm):
            f.write(json.dumps(rec) + "\n")
    return run_id


def log_result(result, *, log: Optional[logging.Logger] = None,
               jsonl: bool = False) -> None:
    """Emit per-iteration lines plus the reference's completion/abort lines.

    ``jsonl=True`` formats each iteration as one JSON object per line (the
    machine-readable channel); default is a readable key=value line.
    """
    log = log or logger
    for rec in iteration_records(result):
        if jsonl:
            log.info(json.dumps(rec))
        else:
            log.info(
                "iter=%d loss=%.6g L=%.4g theta=%.4g step=%.4g%s",
                rec["iter"], rec["loss"], rec["L"], rec["theta"],
                rec["step"], " restart" if rec["restarted"] else "")
    if bool(result.aborted_non_finite):
        # the reference's logWarning on numerical failure (:309-312)
        log.warning("AcceleratedGradientDescent: loss is infinite or NaN; "
                    "aborted after %d iterations", int(result.num_iters))
    n = int(result.num_iters)
    hist = np.asarray(result.loss_history)[:n]
    # the reference's completion line: last 10 losses (:334-335)
    log.info("AcceleratedGradientDescent.run finished. Last 10 losses %s",
             ", ".join(f"{v:.6g}" for v in hist[-10:]))


def make_host_logger(*, log: Optional[logging.Logger] = None,
                     every: int = 1):
    """An ``on_iteration`` callback for ``core.host_agd.run_agd_host``:
    logs one structured line per ``every`` iterations as the run executes
    (the streamed regime, where waiting for the end is not an option)."""
    log = log or logger

    def on_iteration(carry: dict):
        it = int(carry["prior_iters"])
        # a run's final callback (converged, aborted, or iteration-cap)
        # always logs: an operator tailing the stream must be able to
        # tell "finished" from "hung" regardless of `every`
        final = carry.get("stopped") or carry.get("last")
        if it % every and not final:
            return
        suffix = ""
        if carry.get("aborted"):
            suffix = " ABORTED-nonfinite"
        elif carry.get("stopped"):
            suffix = " converged"
        elif carry.get("last"):
            suffix = " done(iteration cap)"
        log.info("iter=%d loss=%.6g L=%.4g theta=%.4g%s",
                 it, float(carry["loss"]), float(carry["big_l"]),
                 float(carry["theta"]), suffix)

    return on_iteration
