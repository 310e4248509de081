"""Record parity for the port's telemetry tests: the port's records must be
the JAX package's records, apart from the fields that measure time, name
a run, a span, a file or the device.  This module imports neither
package."""

import math

# fields that measure time, or are ids, paths, the process's pid, or the
# device and versions the port's bus stamps on every record
UNSTABLE = frozenset({
    "timestamp_unix", "seconds", "t_start_unix", "run_id", "trace_id",
    "span_id", "parent_id", "batch_span_id", "latency_ms", "queue_ms",
    "p50_ms", "p99_ms", "baseline_p50_ms", "baseline_p99_ms", "mean_ms",
    "max_ms", "qps", "window_s",
    "backoff_s", "pid", "path", "device_kind", "torch_version",
    "cuda_version", "final_loss", "metrics"})

# the kinds only the JAX package emits here: the compiled-program census
# of its serving engine, which comes with the port's profiling and
# analysis slice
JAX_ONLY_KINDS = frozenset({"program_cost"})


def stable(rec: dict, drop=()) -> dict:
    """``rec`` without its unstable fields (and ``drop``); floats rounded
    to 9 significant digits, so f64 arithmetic that differs in the last
    bits compares equal."""
    out = {}
    for key, value in rec.items():
        if key in UNSTABLE or key in drop:
            continue
        if isinstance(value, float):
            value = float(f"{value:.9g}")
        out[key] = value
    return out


def comparable(records, drop=()) -> list:
    """The stable view of a record stream, in order, without the kinds
    the JAX package alone emits."""
    return [stable(r, drop) for r in records
            if r.get("kind") not in JAX_ONLY_KINDS]


def kinds(records) -> list:
    return [r.get("kind") for r in records
            if r.get("kind") not in JAX_ONLY_KINDS]


def assert_same(mine, theirs, *, approx=None, drop=()) -> None:
    """Assert two record streams are the same records: the same kinds in
    the same order, the same stable fields with equal values, but for
    the fields of ``approx`` (name -> relative tolerance), held to
    their tolerance."""
    approx = dict(approx or {})
    a = [r for r in mine if r.get("kind") not in JAX_ONLY_KINDS]
    b = [r for r in theirs if r.get("kind") not in JAX_ONLY_KINDS]
    assert kinds(a) == kinds(b)
    for i, (x, y) in enumerate(zip(a, b)):
        sx = {k: v for k, v in x.items()
              if k not in UNSTABLE and k not in drop}
        sy = {k: v for k, v in y.items()
              if k not in UNSTABLE and k not in drop}
        assert sorted(sx) == sorted(sy), (i, x, y)
        for key in sx:
            if key in approx and isinstance(sy[key], float):
                if math.isnan(sy[key]):  # a poisoned iteration, in both
                    assert math.isnan(float(sx[key])), (i, key, x, y)
                    continue
                tol = approx[key] * max(abs(sy[key]), 1e-300)
                assert abs(float(sx[key]) - sy[key]) <= tol, (i, key, x, y)
            else:
                assert sx[key] == sy[key], (i, key, x, y)
