"""Perf-regression gate over canonical run-record JSONLs.

A copy of ``spark_agd_tpu/obs/perfgate.py``, which needs only
the standard library and its sibling copies
(``scaling``, ``schema``, ``timeline``);
``tests/test_torch_obs.py`` holds everything after this docstring
to the original, line for line.

The BENCH_* trajectory (``BENCH_r01..r05.json``) accumulated five
rounds of stamped run records with no automated way to say "this PR
made the hot path slower".  This module is that answer: compare a
candidate JSONL against a baseline JSONL, record-by-record, on the
metrics that define "fast as the hardware allows" —

- **wall clock**: ``wall_to_eps_s`` (and its capped twin), ``wall_s``,
  ``iters_per_sec``, ``compile_s``;
- **iterations-to-tolerance**: ``iters`` when both runs stopped under
  their own rule (``converged``);
- **compiled-program facts** (``program_cost`` records, from
  ``obs.introspect``): FLOPs, bytes accessed, peak HBM, and
  per-collective counts — the MLPerf-on-TPU-pod lesson that regression
  tracking must be tied to the compiled program's cost model, not just
  wall clock.

Records pair by a stable identity key (tool / name / config /
algorithm / dtype / pallas for runs; label / algorithm for program
costs).  Relative thresholds are configurable per metric; collective
counts gate on an *absolute* allowed increase (default 0 — a new
collective in the hot program is never noise).  Environments must
match: a gate between records whose provenance fields (platform,
device kind/count, jax/jaxlib version, mesh shape, and the hardened
host identity — cpu count / governor / turbo / cgroup quota) differ is
refused unless explicitly allowed — cross-environment "regressions"
are hardware deltas, not code deltas.

**Curve-shape gating** (:func:`gate_scaling`): ``scaling_curve``
records (the ``benchmarks/run.py --ladder`` weak-scaling ladder) gate
on the SHAPE of the efficiency curve — per-point efficiency floor,
monotonicity, fitted serial-fraction ceiling, per-point deltas vs a
paired baseline curve — and REFUSE (exit 2, with a typed
``scaling_gate`` record) contention-contaminated or cross-environment
comparisons, per the BENCH_r01–r05 post-mortem: a poisoned comparison
is worse than none.

Deliberately dependency-free (stdlib only), like ``obs.schema``: the
CI entry point ``tools/perf_gate.py`` must run anywhere the artifacts
exist, with or without a working jax install.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from . import scaling as scaling_lib
from . import schema
from . import timeline as timeline_lib

# metric -> (direction, default relative threshold).  direction "lower"
# = smaller is better; "higher" = larger is better.  The candidate
# regresses when it is worse by more than the threshold (relative to
# the baseline value).
RUN_METRICS: Dict[str, Tuple[str, float]] = {
    "wall_to_eps_s": ("lower", 0.15),
    "wall_to_eps_capped": ("lower", 0.15),
    "wall_s": ("lower", 0.15),
    "compile_s": ("lower", 0.50),
    "iters_per_sec": ("higher", 0.15),
    "iters_to_tol": ("lower", 0.10),
    # serving-soak summaries (tools/serve_drill.py run records): tail
    # latency is the SLO metric, so its default threshold is tight
    "p50_ms": ("lower", 0.25),
    "p99_ms": ("lower", 0.25),
    "qps": ("higher", 0.15),
    # per-host skew (obs.timeline.straggler_score, stamped onto run
    # records by the drills): lower is better, ~1.0 balanced — a
    # regression that only slows ONE host moves this metric even when
    # aggregate wall clock hides behind the fast hosts
    "straggler_score": ("lower", 0.25),
}

PROGRAM_METRICS: Dict[str, Tuple[str, float]] = {
    "flops": ("lower", 0.01),
    "bytes_accessed": ("lower", 0.05),
    "peak_hbm_bytes": ("lower", 0.05),
    "temp_bytes": ("lower", 0.10),
}

# absolute allowed increase in each collective's op count (default 0)
COLLECTIVES_METRIC = "collectives"
DEFAULT_COLLECTIVE_SLACK = 0.0

# run-record fields that define the measurement environment; a
# mismatch on any present-on-both-sides field refuses the comparison.
# The host-identity tail (cpu count / governor / turbo / cgroup quota,
# from obs.scaling.host_fingerprint) is the BENCH_r01–r05 lesson:
# environment drift nobody stamped is indistinguishable from a code
# regression.
ENV_FIELDS = ("platform", "device_kind", "n_devices", "jax_version",
              "jaxlib_version", "n_processes", "mesh_shape",
              "cpu_count", "cpu_governor", "cpu_turbo",
              "cgroup_cpu_quota")

# scaling-curve env identity: a curve spans mesh shapes, so mesh_shape
# is a per-point fact, not curve identity
CURVE_ENV_FIELDS = tuple(f for f in ENV_FIELDS if f != "mesh_shape")

# curve-vs-baseline per-point metrics: sec_per_iter is the weak-scaling
# quantity itself; efficiency the normalized shape
CURVE_POINT_METRICS: Dict[str, Tuple[str, float]] = {
    "sec_per_iter": ("lower", 0.15),
    "efficiency": ("higher", 0.10),
}
# curve-level: the fitted serial fraction gates on ABSOLUTE increase
# (relative change near s=0 is meaningless noise)
SERIAL_FRACTION_SLACK = 0.05

_RUN_KEY_FIELDS = ("tool", "name", "config", "algorithm", "dtype",
                   "pallas")
_PROGRAM_KEY_FIELDS = ("label", "algorithm", "tool")


@dataclasses.dataclass
class Delta:
    """One compared metric on one paired record."""

    key: str
    metric: str
    baseline: Optional[float]
    candidate: Optional[float]
    rel_change: Optional[float]  # signed; + = candidate worse
    threshold: float
    status: str  # "ok" | "regression" | "improved" | "skipped"


@dataclasses.dataclass
class GateResult:
    deltas: List[Delta]
    env_mismatches: List[str]
    unmatched_baseline: List[str]
    unmatched_candidate: List[str]
    allow_cross_env: bool = False

    @property
    def regressions(self) -> List[Delta]:
        return [d for d in self.deltas if d.status == "regression"]

    @property
    def refused(self) -> bool:
        return bool(self.env_mismatches) and not self.allow_cross_env

    @property
    def ok(self) -> bool:
        return not self.regressions and not self.refused

    def exit_code(self) -> int:
        """0 pass, 1 regression, 2 refused (cross-environment)."""
        if self.refused:
            return 2
        return 1 if self.regressions else 0


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if math.isnan(v):
            return "nan"
        return f"{v:.6g}"
    return str(v)


def _table(headers: Sequence[str], rows: List[Sequence[str]]) -> str:
    widths = [len(h) for h in headers]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(cell))

    def line(cells):
        return "  ".join(c.ljust(w)
                         for c, w in zip(cells, widths)).rstrip()

    out = [line(headers), line(["-" * w for w in widths])]
    out.extend(line(r) for r in rows)
    return "\n".join(out)


def format_deltas(deltas: List[Delta], *,
                  only_compared: bool = False) -> str:
    """Human-readable diff table (the gate's failure output and
    ``tools/agd_report.py --compare``'s body)."""
    headers = ["key", "metric", "baseline", "candidate", "change",
               "threshold", "status"]
    rows = []
    for d in deltas:
        if only_compared and d.status == "skipped":
            continue
        change = ("-" if d.rel_change is None
                  # collective deltas are absolute op counts, the rest
                  # relative
                  else f"{d.rel_change:+g}"
                  if d.metric.startswith("collectives.")
                  else f"{d.rel_change:+.1%}")
        rows.append([d.key, d.metric, _fmt(d.baseline),
                     _fmt(d.candidate), change,
                     f"{d.threshold:g}", d.status])
    if not rows:
        return "(no comparable metrics)"
    return _table(headers, rows)


def _key(rec: dict, fields) -> str:
    parts = [f"{f}={rec[f]}" for f in fields if rec.get(f) is not None]
    return " ".join(parts) if parts else "(unkeyed)"


def _split(records: List[dict]):
    """(run_records, program_cost_records) keyed by identity; multiple
    records per key keep the LAST (the freshest measurement in an
    append-style artifact)."""
    runs: Dict[str, dict] = {}
    progs: Dict[str, dict] = {}
    for rec in records:
        if not isinstance(rec, dict):
            continue
        kind = rec.get("kind")
        if kind == "program_cost":
            progs[_key(rec, _PROGRAM_KEY_FIELDS)] = rec
        elif kind == "run" or (kind is None and (
                "final_loss" in rec or "iters_per_sec" in rec)):
            # pre-schema BENCH rows gate too (legacy best-effort, like
            # tools/agd_report.py)
            runs[_key(rec, _RUN_KEY_FIELDS)] = rec
    return runs, progs


def _num(rec: dict, field: str) -> Optional[float]:
    v = rec.get(field)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    if isinstance(v, float) and math.isnan(v):
        return None
    return float(v)


def _run_metric(rec: dict, metric: str) -> Optional[float]:
    if metric == "iters_to_tol":
        # only a tolerance claim when the run stopped under its own
        # rule — an iteration-capped count is the cap, not convergence
        if rec.get("converged") is not True:
            return None
        return _num(rec, "iters")
    return _num(rec, metric)


def environment_mismatches(base: dict, cand: dict,
                           key: str) -> List[str]:
    """Provenance fields present on BOTH sides that disagree."""
    out = []
    for f in ENV_FIELDS:
        b, c = base.get(f), cand.get(f)
        if b is not None and c is not None and b != c:
            out.append(f"{key}: {f} differs (baseline {b!r} vs "
                       f"candidate {c!r})")
    return out


def _compare_metric(key, metric, direction, b, c, threshold,
                    deltas: List[Delta]):
    if b is None or c is None:
        deltas.append(Delta(key, metric, b, c, None, threshold,
                            "skipped"))
        return
    if b == 0:
        rel = 0.0 if c == 0 else math.inf * (1 if c > 0 else -1)
    else:
        rel = (c - b) / abs(b)
    if direction == "higher":
        rel = -rel  # normalize: positive rel_change = worse
    status = ("regression" if rel > threshold
              else "improved" if rel < -threshold else "ok")
    deltas.append(Delta(key, metric, b, c, rel, threshold, status))


def compare_records(
    baseline: List[dict],
    candidate: List[dict],
    *,
    thresholds: Optional[Dict[str, float]] = None,
    collective_slack: float = DEFAULT_COLLECTIVE_SLACK,
    allow_cross_env: bool = False,
) -> GateResult:
    """The comparison core: pair records by identity key, compare every
    gated metric, and collect environment mismatches.  ``thresholds``
    overrides per-metric defaults (relative); ``collective_slack`` is
    the absolute op-count increase allowed per collective."""
    thresholds = dict(thresholds or {})
    b_runs, b_progs = _split(baseline)
    c_runs, c_progs = _split(candidate)

    deltas: List[Delta] = []
    env_bad: List[str] = []

    for key in sorted(set(b_runs) & set(c_runs)):
        b, c = b_runs[key], c_runs[key]
        env_bad.extend(environment_mismatches(b, c, key))
        for metric, (direction, default_thr) in RUN_METRICS.items():
            thr = thresholds.get(metric, default_thr)
            _compare_metric(key, metric, direction,
                            _run_metric(b, metric),
                            _run_metric(c, metric), thr, deltas)

    for key in sorted(set(b_progs) & set(c_progs)):
        b, c = b_progs[key], c_progs[key]
        for metric, (direction, default_thr) in PROGRAM_METRICS.items():
            thr = thresholds.get(metric, default_thr)
            _compare_metric(key, metric, direction, _num(b, metric),
                            _num(c, metric), thr, deltas)
        slack = thresholds.get(COLLECTIVES_METRIC, collective_slack)
        bc = b.get("collectives") or {}
        cc = c.get("collectives") or {}
        for op in sorted(set(bc) | set(cc)):
            bn = float(bc.get(op, 0) or 0)
            cn = float(cc.get(op, 0) or 0)
            worse = cn - bn
            status = ("regression" if worse > slack
                      else "improved" if worse < -slack else "ok")
            rel = None if bn == 0 and cn == 0 else worse
            deltas.append(Delta(key, f"collectives.{op}", bn, cn, rel,
                                slack, status))

    unmatched_b = sorted((set(b_runs) - set(c_runs))
                         | (set(b_progs) - set(c_progs)))
    unmatched_c = sorted((set(c_runs) - set(b_runs))
                         | (set(c_progs) - set(b_progs)))
    return GateResult(deltas=deltas, env_mismatches=env_bad,
                      unmatched_baseline=unmatched_b,
                      unmatched_candidate=unmatched_c,
                      allow_cross_env=allow_cross_env)


def load_records(path: str) -> List[dict]:
    """Tolerant JSONL load (non-dict lines dropped; malformed JSON
    raises ``ValueError`` naming the line, via ``schema.read_jsonl``)."""
    return [r for r in schema.read_jsonl(path) if isinstance(r, dict)]


def gate_files(baseline_path: str, candidate_path: str,
               **kwargs) -> GateResult:
    """File-level convenience: :func:`compare_records` over two
    JSONLs."""
    return compare_records(load_records(baseline_path),
                           load_records(candidate_path), **kwargs)


# update_mode distinguishes the replicated-psum and sharded-update
# ladders of the same benchmark; absent on pre-sharding records, and
# _key skips None fields, so old histories keep their keys
_CURVE_KEY_FIELDS = ("tool", "name", "algorithm", "update_mode")


def split_curves(records: List[dict]) -> Dict[str, dict]:
    """The ``scaling_curve`` records of a record list, keyed by
    identity; multiple records per key keep the LAST (the freshest
    ladder in an append-style history)."""
    out: Dict[str, dict] = {}
    for rec in records:
        if isinstance(rec, dict) and rec.get("kind") == "scaling_curve":
            out[_key(rec, _CURVE_KEY_FIELDS)] = rec
    return out


@dataclasses.dataclass
class ScalingGateResult:
    """The curve-shape gate's outcome: ``verdicts`` one per candidate
    curve (shape violations = exit 1), ``refusals`` typed reasons the
    gate would not compare at all (contaminated points, cross-
    environment baselines, quarantined records = exit 2), ``deltas``
    the per-point baseline comparison when a baseline was given."""

    verdicts: List[Tuple[str, scaling_lib.CurveVerdict]]
    refusals: List[str]
    deltas: List[Delta]
    unmatched: List[str]
    allow_cross_env: bool = False

    @property
    def shape_failures(self) -> List[str]:
        return [f for _, v in self.verdicts for f in v.failures]

    @property
    def regressions(self) -> List[Delta]:
        return [d for d in self.deltas if d.status == "regression"]

    @property
    def refused(self) -> bool:
        return bool(self.refusals) and not self.allow_cross_env

    @property
    def ok(self) -> bool:
        return not (self.refused or self.shape_failures
                    or self.regressions)

    def exit_code(self) -> int:
        """0 pass, 1 shape/regression failure, 2 refused."""
        if self.refused:
            return 2
        return 0 if not (self.shape_failures or self.regressions) else 1

    def status(self) -> str:
        return ("refused" if self.refused
                else "fail" if self.shape_failures or self.regressions
                else "pass")

    def record(self, run_id: Optional[str] = None,
               tool: str = "agd_bench") -> dict:
        """The gate's outcome as one TYPED, schema-stamped run record —
        what ``tools/agd_bench.py`` emits instead of a bare exit code,
        so a refusal is machine-readable evidence, not silence."""
        return schema.stamp({
            "name": "scaling_gate",
            "gate_status": self.status(),
            "curves": len(self.verdicts),
            "refusals": list(self.refusals),
            "shape_failures": self.shape_failures,
            "regressions": len(self.regressions),
        }, tool=tool, kind="run", run_id=run_id)


def _curve_refusals(key: str, rec: dict,
                    policy: scaling_lib.CurvePolicy,
                    verdict: scaling_lib.CurveVerdict,
                    side: str) -> List[str]:
    out = []
    if policy.contention.refuse_contended:
        out.extend(f"[{side}] {msg}" for msg in verdict.contended)
    gaps = scaling_lib.provenance_gaps(rec)
    if gaps:
        out.append(f"[{side}] {key}: quarantined — " + "; ".join(gaps))
    return out


def gate_scaling(
    candidate: List[dict],
    baseline: Optional[List[dict]] = None,
    *,
    policy: Optional[scaling_lib.CurvePolicy] = None,
    thresholds: Optional[Dict[str, float]] = None,
    allow_cross_env: bool = False,
) -> ScalingGateResult:
    """Gate ``scaling_curve`` records on CURVE SHAPE (efficiency floor
    per point, monotonicity, fitted serial-fraction ceiling) and — when
    ``baseline`` records are given — per-point deltas against the
    paired baseline curve.

    Refuses (exit 2) instead of comparing garbage: candidate or
    baseline curves with contention-contaminated points (under the
    policy's ``refuse_contended``), provenance-quarantined records
    (``obs.scaling.provenance_gaps``), and baseline pairs whose
    :data:`CURVE_ENV_FIELDS` disagree.  ``allow_cross_env`` downgrades
    every refusal to a note, mirroring the run-record gate."""
    policy = policy or scaling_lib.CurvePolicy()
    thresholds = dict(thresholds or {})
    c_curves = split_curves(candidate)
    b_curves = split_curves(baseline or [])

    verdicts: List[Tuple[str, scaling_lib.CurveVerdict]] = []
    refusals: List[str] = []
    deltas: List[Delta] = []

    if not c_curves:
        refusals.append("no scaling_curve records in the candidate — "
                        "nothing to gate")
    for key in sorted(c_curves):
        rec = c_curves[key]
        verdict = scaling_lib.check_curve(rec, policy)
        verdicts.append((key, verdict))
        refusals.extend(_curve_refusals(key, rec, policy, verdict,
                                        "candidate"))

    for key in sorted(set(b_curves) & set(c_curves)):
        b, c = b_curves[key], c_curves[key]
        b_verdict = scaling_lib.check_curve(b, policy)
        refusals.extend(_curve_refusals(key, b, policy, b_verdict,
                                        "baseline"))
        for f in CURVE_ENV_FIELDS:
            bv, cv = b.get(f), c.get(f)
            if bv is not None and cv is not None and bv != cv:
                refusals.append(
                    f"{key}: cross-environment comparison — {f} "
                    f"differs (baseline {bv!r} vs candidate {cv!r})")
        b_pts = {int(p.get("devices", 0)): p
                 for p in scaling_lib.sorted_points(b.get("points") or [])}
        c_sorted = scaling_lib.sorted_points(c.get("points") or [])
        c_eff = dict(zip((int(p.get("devices", 0)) for p in c_sorted),
                         scaling_lib.weak_scaling_efficiency(c_sorted)))
        b_sorted = scaling_lib.sorted_points(b.get("points") or [])
        b_eff = dict(zip((int(p.get("devices", 0)) for p in b_sorted),
                         scaling_lib.weak_scaling_efficiency(b_sorted)))
        for cp in c_sorted:
            k = int(cp.get("devices", 0))
            bp = b_pts.get(k)
            if bp is None:
                continue
            pkey = f"{key} devices={k}"
            for metric, (direction,
                         default_thr) in CURVE_POINT_METRICS.items():
                thr = thresholds.get(metric, default_thr)
                if metric == "efficiency":
                    bv, cv = b_eff.get(k), c_eff.get(k)
                else:
                    bv = scaling_lib.point_time(bp)
                    cv = scaling_lib.point_time(cp)
                _compare_metric(pkey, metric, direction, bv, cv, thr,
                                deltas)
        bs = scaling_lib.fit_serial_fraction(b_sorted)
        cs = scaling_lib.fit_serial_fraction(c_sorted)
        slack = thresholds.get("serial_fraction", SERIAL_FRACTION_SLACK)
        if bs is not None and cs is not None:
            worse = cs - bs
            status = ("regression" if worse > slack
                      else "improved" if worse < -slack else "ok")
            deltas.append(Delta(key, "serial_fraction", bs, cs, worse,
                                slack, status))

    unmatched = sorted(set(b_curves) - set(c_curves)) if b_curves else []
    return ScalingGateResult(verdicts=verdicts, refusals=refusals,
                             deltas=deltas, unmatched=unmatched,
                             allow_cross_env=allow_cross_env)


def format_scaling_report(result: ScalingGateResult) -> str:
    """Human-readable curve-shape gate report (the failure output of
    ``tools/agd_bench.py gate``)."""
    lines: List[str] = []
    if result.refusals:
        head = ("SCALING GATE REFUSED" if result.refused
                else "refusals waived by --allow-cross-env")
        lines.append(head + ":")
        lines.extend("  " + r for r in result.refusals)
        lines.append("")
    for key, v in result.verdicts:
        eff = ", ".join("-" if e is None else f"{e:.3f}"
                        for e in v.efficiency)
        sf = ("-" if v.serial_fraction is None
              else f"{v.serial_fraction:.3f}")
        lines.append(f"{key}: efficiency [{eff}] serial_fraction {sf} "
                     + ("OK" if not v.failures else
                        f"{len(v.failures)} shape failure(s)"))
        lines.extend("  " + f for f in v.failures)
    if result.deltas:
        lines.append("")
        lines.append(format_deltas(result.deltas, only_compared=True))
    if result.unmatched:
        lines.append(f"note: {len(result.unmatched)} baseline-only "
                     "curve(s) not compared: "
                     + "; ".join(result.unmatched[:4]))
    if not result.refused:
        lines.append("SCALING GATE: "
                     + ("pass" if result.exit_code() == 0 else
                        f"FAIL ({len(result.shape_failures)} shape, "
                        f"{len(result.regressions)} regression(s))"))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Update-mode gate (parallel.sharded_update vs replicated all-reduce)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class UpdateModeGateResult:
    """The sharded-vs-replicated gate's outcome: for every benchmark
    that stamped BOTH an ``update_mode="replicated"`` and an
    ``update_mode="sharded"`` scaling curve on the same environment,
    the sharded curve's fitted serial fraction must be STRICTLY below
    the replicated one — the whole point of reduce-scattering the
    gradient is shrinking the non-parallelizable fraction, and a pair
    where it does not is a perf claim the repo must not ship.
    ``refusals`` are typed exit-2 conditions (missing mode curve,
    contention-contaminated points, provenance quarantine, cross-
    environment pair), per the BENCH post-mortem doctrine: a poisoned
    comparison is worse than none."""

    pairs: List[Tuple[str, Optional[float], Optional[float]]]
    refusals: List[str]
    failures: List[str]
    allow_cross_env: bool = False

    @property
    def refused(self) -> bool:
        return bool(self.refusals) and not self.allow_cross_env

    @property
    def ok(self) -> bool:
        return not self.refused and not self.failures

    def exit_code(self) -> int:
        """0 pass, 1 sharded not strictly better, 2 refused."""
        if self.refused:
            return 2
        return 1 if self.failures else 0

    def status(self) -> str:
        return ("refused" if self.refused
                else "fail" if self.failures else "pass")

    def record(self, run_id: Optional[str] = None,
               tool: str = "agd_bench") -> dict:
        """The gate's outcome as one typed, schema-stamped run record
        (mirrors :meth:`ScalingGateResult.record`)."""
        return schema.stamp({
            "name": "update_mode_gate",
            "gate_status": self.status(),
            "pairs": [{"key": k, "replicated_serial_fraction": r,
                       "sharded_serial_fraction": s}
                      for k, r, s in self.pairs],
            "refusals": list(self.refusals),
            "failures": list(self.failures),
        }, tool=tool, kind="run", run_id=run_id)


def _strip_mode(key: str) -> str:
    return " ".join(p for p in key.split(" ")
                    if not p.startswith("update_mode="))


def gate_update_modes(
    records: List[dict],
    *,
    policy: Optional[scaling_lib.CurvePolicy] = None,
    allow_cross_env: bool = False,
) -> UpdateModeGateResult:
    """Pair each benchmark's ``update_mode="sharded"`` scaling curve
    with its ``update_mode="replicated"`` twin (same tool / name /
    algorithm) and require the sharded fitted serial fraction strictly
    below the replicated one.

    Typed refusals (exit 2): a mode missing its twin, contention-
    contaminated points on either curve (under the policy's
    ``refuse_contended``), provenance-quarantined records, disagreeing
    :data:`CURVE_ENV_FIELDS` or stamped ``env_key`` between the pair,
    and serial fractions that cannot be fitted (< 2 points).
    ``allow_cross_env`` downgrades refusals to notes, mirroring
    :func:`gate_scaling`."""
    policy = policy or scaling_lib.CurvePolicy()
    curves = split_curves(records)
    by_mode: Dict[str, Dict[str, dict]] = {}
    for key, rec in curves.items():
        mode = rec.get("update_mode")
        if not isinstance(mode, str):
            continue
        by_mode.setdefault(_strip_mode(key), {})[mode] = rec

    pairs: List[Tuple[str, Optional[float], Optional[float]]] = []
    refusals: List[str] = []
    failures: List[str] = []

    if not by_mode:
        refusals.append("no scaling_curve records carrying update_mode "
                        "— run the ladder with --update-mode both")
    for base_key in sorted(by_mode):
        modes = by_mode[base_key]
        missing = [m for m in ("replicated", "sharded") if m not in modes]
        if missing:
            refusals.append(
                f"{base_key}: no update_mode={'/'.join(missing)} curve "
                "to pair — run both modes on this environment")
            continue
        rep, sh = modes["replicated"], modes["sharded"]
        for side, rec in (("replicated", rep), ("sharded", sh)):
            verdict = scaling_lib.check_curve(rec, policy)
            refusals.extend(
                _curve_refusals(f"{base_key} [{side}]", rec, policy,
                                verdict, side))
        for f in CURVE_ENV_FIELDS + ("env_key",):
            rv, sv = rep.get(f), sh.get(f)
            if rv is not None and sv is not None and rv != sv:
                refusals.append(
                    f"{base_key}: cross-environment pair — {f} differs "
                    f"(replicated {rv!r} vs sharded {sv!r})")
        r_sf = scaling_lib.fit_serial_fraction(
            scaling_lib.sorted_points(rep.get("points") or []))
        s_sf = scaling_lib.fit_serial_fraction(
            scaling_lib.sorted_points(sh.get("points") or []))
        pairs.append((base_key, r_sf, s_sf))
        if r_sf is None or s_sf is None:
            refusals.append(
                f"{base_key}: serial fraction not fittable on both "
                "sides (need >= 2 ladder points per mode)")
            continue
        if not s_sf < r_sf:
            failures.append(
                f"{base_key}: sharded serial fraction {s_sf:.4f} is "
                f"not strictly below replicated {r_sf:.4f} — the "
                "reduce-scatter update is not buying scalability here")
    return UpdateModeGateResult(pairs=pairs, refusals=refusals,
                                failures=failures,
                                allow_cross_env=allow_cross_env)


def format_update_mode_report(result: UpdateModeGateResult) -> str:
    """Human-readable update-mode gate report (the output of
    ``tools/agd_bench.py gate-modes``)."""
    lines: List[str] = []
    if result.refusals:
        head = ("UPDATE-MODE GATE REFUSED" if result.refused
                else "refusals waived by --allow-cross-env")
        lines.append(head + ":")
        lines.extend("  " + r for r in result.refusals)
        lines.append("")
    for key, r_sf, s_sf in result.pairs:
        lines.append(
            f"{key}: serial_fraction replicated {_fmt(r_sf)} vs "
            f"sharded {_fmt(s_sf)}")
    lines.extend("  " + f for f in result.failures)
    if not result.refused:
        lines.append("UPDATE-MODE GATE: "
                     + ("pass (sharded strictly lower)"
                        if result.ok else
                        f"FAIL ({len(result.failures)} pair(s) not "
                        "strictly better)"))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Rebalance-effectiveness gate (resilience.scheduler)
# ---------------------------------------------------------------------------

# the host-local step span the rebalance gate scores (in lockstep SPMD
# the coupled "segment" spans tie; skew lives in the boundary spans —
# the same attribution rule tools/dist_fault_drill.py pins)
REBALANCE_STEP_SPAN = "boundary"

# spans shorter than this floor are host noise, not work: without it
# the straggler score of two idle hosts is a ratio of scheduler jitter
REBALANCE_FLOOR_S = 1e-3


@dataclasses.dataclass
class RebalanceGateResult:
    """The rebalance-effectiveness gate's outcome: a run that carries
    ``rebalance`` recovery actions must show its post-rebalance
    straggler score BELOW the pre-rebalance value.  ``refusals``
    (missing spans, one-sided samples) are typed exit-2 conditions —
    per the repo's gating doctrine, a comparison that cannot be made
    honestly is refused, not passed."""

    rebalances: List[dict]
    rebalance_iter: Optional[int]
    pre_score: Optional[float]
    post_score: Optional[float]
    pre_steps: Dict[int, int]
    post_steps: Dict[int, int]
    refusals: List[str]
    margin: float = 0.0

    @property
    def improved(self) -> bool:
        return (self.pre_score is not None
                and self.post_score is not None
                and self.post_score
                <= self.pre_score * (1.0 - self.margin)
                and self.post_score < self.pre_score)

    @property
    def refused(self) -> bool:
        return bool(self.refusals)

    @property
    def ok(self) -> bool:
        if self.refused:
            return False
        return self.improved if self.rebalances else True

    def exit_code(self) -> int:
        """0 pass, 1 rebalance did not lower the straggler score,
        2 refused (spans missing / nothing comparable)."""
        if self.refused:
            return 2
        return 0 if self.ok else 1


def gate_rebalance(records: List[dict], *,
                   step_span: str = REBALANCE_STEP_SPAN,
                   min_steps: int = 2,
                   margin: float = 0.0,
                   floor_s: float = REBALANCE_FLOOR_S,
                   require_rebalance: bool = False
                   ) -> RebalanceGateResult:
    """Gate rebalance effectiveness over one run's records: split the
    host-local ``step_span`` spans at the FIRST rebalance boundary and
    require the post-rebalance ``obs.timeline.straggler_score`` below
    the pre-rebalance one.  Spans are floored at ``floor_s`` (see
    :data:`REBALANCE_FLOOR_S`).  Without rebalance records the gate
    passes vacuously unless ``require_rebalance`` (then: typed
    refusal).  Missing or one-sided spans refuse (exit 2) — the
    claim "the rebalance helped" cannot be graded without timings on
    both sides."""
    rebalances = [r for r in records if isinstance(r, dict)
                  and ((r.get("kind") == "recovery"
                        and r.get("action") == "rebalance")
                       or r.get("kind") == "rebalance")]
    iters = [v for r in rebalances
             if isinstance(v := r.get("at_iter", r.get("from_iter")),
                           int) and not isinstance(v, bool)]
    refusals: List[str] = []
    if not rebalances:
        if require_rebalance:
            refusals.append("no rebalance records in the stream — "
                            "nothing to gate")
        return RebalanceGateResult(
            rebalances=[], rebalance_iter=None, pre_score=None,
            post_score=None, pre_steps={}, post_steps={},
            refusals=refusals, margin=margin)
    if not iters:
        refusals.append("rebalance records carry no at_iter/from_iter "
                        "— cannot place the boundary")
        return RebalanceGateResult(
            rebalances=rebalances, rebalance_iter=None, pre_score=None,
            post_score=None, pre_steps={}, post_steps={},
            refusals=refusals, margin=margin)
    boundary = min(iters)

    pre: Dict[int, List[float]] = {}
    post: Dict[int, List[float]] = {}
    for s in timeline_lib.collect_spans(records):
        if s.name != step_span or s.truncated:
            continue
        it = s.record.get("start_iter")
        if not isinstance(it, int) or isinstance(it, bool):
            continue
        side = pre if it < boundary else post
        side.setdefault(s.process, []).append(
            max(float(s.seconds), floor_s))
    if not pre and not post:
        refusals.append(
            f"no closed {step_span!r} spans with start_iter in the "
            "stream — run with telemetry/tracing to grade a rebalance")
    else:
        for label, side in (("pre", pre), ("post", post)):
            short = [p for p, ts in sorted(side.items())
                     if len(ts) < min_steps]
            if not side:
                refusals.append(f"no {label}-rebalance {step_span!r} "
                                "spans")
            elif short:
                refusals.append(
                    f"{label}-rebalance side has < {min_steps} "
                    f"samples for host(s) {short}")
    pre_score = timeline_lib.straggler_score(pre) if pre else None
    post_score = timeline_lib.straggler_score(post) if post else None
    if not refusals and (pre_score is None or post_score is None):
        refusals.append("straggler score not computable on both sides "
                        "(degenerate timings)")
    return RebalanceGateResult(
        rebalances=rebalances, rebalance_iter=boundary,
        pre_score=pre_score, post_score=post_score,
        pre_steps={p: len(ts) for p, ts in sorted(pre.items())},
        post_steps={p: len(ts) for p, ts in sorted(post.items())},
        refusals=refusals, margin=margin)


def format_rebalance_report(result: RebalanceGateResult) -> str:
    """Human-readable rebalance-gate report (the failure output of
    ``tools/perf_gate.py --rebalance``)."""
    lines: List[str] = []
    if result.refusals:
        lines.append("REBALANCE GATE REFUSED:")
        lines.extend("  " + r for r in result.refusals)
        return "\n".join(lines)
    if not result.rebalances:
        return ("REBALANCE GATE: pass (no rebalance records — nothing "
                "to gate)")
    lines.append(
        f"rebalance at iteration {result.rebalance_iter} "
        f"({len(result.rebalances)} record(s)); straggler score "
        f"{_fmt(result.pre_score)} -> {_fmt(result.post_score)} "
        f"(pre {result.pre_steps} / post {result.post_steps} steps)")
    lines.append("REBALANCE GATE: "
                 + ("pass (post-rebalance straggler score is lower)"
                    if result.ok else
                    "FAIL (rebalance did not lower the straggler "
                    "score)"))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Promotion gate (pipeline.canary -> pipeline.promote)
# ---------------------------------------------------------------------------

# relative held-out-loss regression allowed before a candidate fails
# the quality leg (models.evaluation.log_loss, lower is better)
DEFAULT_QUALITY_THRESHOLD = 0.05

# a shadow latency summary over fewer requests than this is sampling
# noise, not evidence — the gate refuses rather than judging on it
DEFAULT_MIN_SHADOW_REQUESTS = 16

# the latency leg's metrics: candidate shadow percentiles vs the HEAD
# leg's, on the serving SLO thresholds RUN_METRICS already defines
PROMOTION_LATENCY_METRICS = ("p50_ms", "p99_ms")


@dataclasses.dataclass
class PromotionGateResult:
    """The promotion gate's outcome over ``canary`` records: a
    candidate generation promotes only when BOTH legs hold — held-out
    quality within ``quality_threshold`` of the baseline, and shadow
    p50/p99 within the serving-SLO thresholds of the HEAD leg.
    ``refusals`` are typed exit-2 conditions (too few shadow requests,
    cross-generation spec mismatch, contention-flagged latency, missing
    evidence), per the repo's gating doctrine: a comparison that cannot
    be made honestly is refused, not passed."""

    canaries: List[dict]
    deltas: List[Delta]
    refusals: List[str]
    failures: List[str]

    @property
    def refused(self) -> bool:
        return bool(self.refusals)

    @property
    def ok(self) -> bool:
        return not self.refused and not self.failures

    def exit_code(self) -> int:
        """0 pass, 1 a gate leg regressed, 2 refused."""
        if self.refused:
            return 2
        return 1 if self.failures else 0

    def status(self) -> str:
        return ("refused" if self.refused
                else "fail" if self.failures else "pass")

    def record(self, run_id: Optional[str] = None,
               tool: str = "pipeline") -> dict:
        """The gate's outcome as one typed, schema-stamped run record
        (mirrors :meth:`UpdateModeGateResult.record`)."""
        return schema.stamp({
            "name": "promotion_gate",
            "gate_status": self.status(),
            "canaries": len(self.canaries),
            "refusals": list(self.refusals),
            "failures": list(self.failures),
        }, tool=tool, kind="run", run_id=run_id)


def gate_promotion(records: List[dict], *,
                   quality_threshold: float = DEFAULT_QUALITY_THRESHOLD,
                   thresholds: Optional[Dict[str, float]] = None,
                   min_shadow_requests: int = DEFAULT_MIN_SHADOW_REQUESTS,
                   require_canary: bool = False
                   ) -> PromotionGateResult:
    """Gate promotion over ``canary`` records: for every canary in the
    stream, compare the quality leg (``quality_candidate`` vs
    ``quality_baseline`` held-out loss, relative ``quality_threshold``)
    and the latency leg (shadow ``p50_ms``/``p99_ms`` vs the HEAD
    leg's ``baseline_*``, on :data:`RUN_METRICS` thresholds unless
    overridden by ``thresholds``).  Without canary records the gate
    passes vacuously unless ``require_canary`` (then: typed refusal).

    Typed refusals (exit 2): fewer than ``min_shadow_requests`` shadow
    requests, a ``baseline_spec``/``candidate_spec`` disagreement (the
    engines are not serving the same model family — latency pairs are
    meaningless), a contention-flagged latency window, missing
    quality or latency evidence, and any refusal the canary controller
    itself stamped."""
    thresholds = dict(thresholds or {})
    canaries = [r for r in records if isinstance(r, dict)
                and r.get("kind") == "canary"]
    refusals: List[str] = []
    failures: List[str] = []
    deltas: List[Delta] = []
    if not canaries:
        if require_canary:
            refusals.append("no canary records in the stream — "
                            "nothing to gate")
        return PromotionGateResult(canaries=[], deltas=deltas,
                                   refusals=refusals, failures=failures)
    for rec in canaries:
        gen = rec.get("generation")
        base = rec.get("baseline_generation")
        key = (f"canary g{base}->g{gen}" if base is not None
               else f"canary g{gen}")
        for r in rec.get("refusals") or []:
            refusals.append(f"{key}: {r}")
        shadow = rec.get("shadow_requests")
        if not isinstance(shadow, int) or isinstance(shadow, bool) \
                or shadow < min_shadow_requests:
            refusals.append(
                f"{key}: too few shadow requests "
                f"({shadow!r} < {min_shadow_requests}) — the latency "
                "evidence is sampling noise")
        b_spec, c_spec = rec.get("baseline_spec"), rec.get(
            "candidate_spec")
        if b_spec is not None and c_spec is not None \
                and b_spec != c_spec:
            refusals.append(
                f"{key}: cross-generation spec mismatch — the shadow "
                "engine is not serving the HEAD model family "
                f"(baseline {b_spec!r} vs candidate {c_spec!r})")
        if rec.get("contention_flagged") is True:
            refusals.append(
                f"{key}: contention-flagged latency window — the "
                "shadow percentiles measured a noisy host, not the "
                "candidate")
        qb, qc = _num(rec, "quality_baseline"), _num(
            rec, "quality_candidate")
        if qb is None or qc is None:
            refusals.append(f"{key}: quality evidence missing "
                            "(quality_baseline/quality_candidate)")
        else:
            _compare_metric(key, "holdout_loss", "lower", qb, qc,
                            quality_threshold, deltas)
        lat_pairs = 0
        for metric in PROMOTION_LATENCY_METRICS:
            b = _num(rec, f"baseline_{metric}")
            c = _num(rec, metric)
            if b is None or c is None:
                continue
            lat_pairs += 1
            direction, default = RUN_METRICS[metric]
            _compare_metric(key, metric, direction,
                            b, c, thresholds.get(metric, default),
                            deltas)
        if lat_pairs == 0:
            refusals.append(f"{key}: latency evidence missing "
                            "(no paired baseline_*/candidate "
                            "percentiles)")
    failures.extend(
        f"{d.key}: {d.metric} regressed "
        f"{'' if d.rel_change is None else format(d.rel_change, '+.1%')}"
        f" (baseline {_fmt(d.baseline)} -> candidate "
        f"{_fmt(d.candidate)}, threshold {d.threshold:g})"
        for d in deltas if d.status == "regression")
    return PromotionGateResult(canaries=canaries, deltas=deltas,
                               refusals=refusals, failures=failures)


def format_promotion_report(result: PromotionGateResult) -> str:
    """Human-readable promotion-gate report (the output of
    ``tools/perf_gate.py --promotion``)."""
    lines: List[str] = []
    if result.refusals:
        lines.append("PROMOTION GATE REFUSED:")
        lines.extend("  " + r for r in result.refusals)
        return "\n".join(lines)
    if not result.canaries:
        return ("PROMOTION GATE: pass (no canary records — nothing "
                "to gate)")
    shown = [d for d in result.deltas if d.status != "skipped"]
    if shown:
        lines.append(format_deltas(shown))
    lines.append(
        "PROMOTION GATE: "
        + (f"pass ({len(result.canaries)} canary(s), "
           f"{len(shown)} metric(s) compared)"
           if result.ok else
           f"FAIL ({len(result.failures)} leg(s) regressed)"))
    lines.extend("  " + f for f in result.failures)
    return "\n".join(lines)


def format_report(result: GateResult, *, verbose: bool = False) -> str:
    """The gate's full human-readable report."""
    lines: List[str] = []
    if result.env_mismatches:
        head = ("ENVIRONMENT MISMATCH (comparison "
                + ("allowed by --allow-cross-env"
                   if result.allow_cross_env else "REFUSED") + "):")
        lines.append(head)
        lines.extend("  " + m for m in result.env_mismatches)
        lines.append("")
    reg = result.regressions
    shown = result.deltas if verbose else [
        d for d in result.deltas if d.status != "skipped"]
    if reg:
        lines.append(f"PERF GATE: {len(reg)} regression(s)")
    elif not result.refused:
        n = sum(1 for d in result.deltas if d.status != "skipped")
        lines.append(f"PERF GATE: pass ({n} metric(s) compared)")
    if shown:
        lines.append(format_deltas(shown))
    elif not result.deltas:
        lines.append("no paired records — nothing compared")
    for name, keys in (("baseline", result.unmatched_baseline),
                       ("candidate", result.unmatched_candidate)):
        if keys:
            lines.append(f"note: {len(keys)} {name}-only record "
                         f"key(s) not compared: "
                         + "; ".join(keys[:4])
                         + (" …" if len(keys) > 4 else ""))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Fleet gate (serve.router traffic shift away from a chaos-slowed replica)
# ---------------------------------------------------------------------------

# the slowed replica must lose at least this fraction of its pre-chaos
# traffic share for the router's "routes around slow hosts" claim to
# count as demonstrated
DEFAULT_FLEET_MIN_DROP = 0.25

# a traffic-share comparison over fewer routed requests than this on
# either side of the chaos boundary is sampling noise — refuse
DEFAULT_FLEET_MIN_REQUESTS = 8


@dataclasses.dataclass
class FleetGateResult:
    """The fleet-routing gate's outcome: after a ``slow_replica``
    chaos fault fires, the slowed replica's share of routed traffic
    (``fleet_route`` records, who actually served) must drop by at
    least ``min_drop`` relative to its pre-chaos share.  Typed exit-2
    refusals for comparisons that cannot be made honestly: no routes,
    no chaos boundary, too few requests on a side, or a contaminated
    window (the slowed replica was evicted or killed mid-window — its
    share then drops for a reason that is NOT routing policy)."""

    slow_replica: Optional[int]
    boundary_unix: Optional[float]
    pre_share: Optional[float]
    post_share: Optional[float]
    pre_counts: Dict[int, int]
    post_counts: Dict[int, int]
    refusals: List[str]
    min_drop: float = DEFAULT_FLEET_MIN_DROP

    @property
    def shifted(self) -> bool:
        return (self.pre_share is not None
                and self.post_share is not None
                and self.post_share
                <= self.pre_share * (1.0 - self.min_drop))

    @property
    def refused(self) -> bool:
        return bool(self.refusals)

    @property
    def ok(self) -> bool:
        return not self.refused and self.shifted

    def exit_code(self) -> int:
        """0 pass, 1 the router did not shift traffic, 2 refused."""
        if self.refused:
            return 2
        return 0 if self.ok else 1

    def status(self) -> str:
        return ("refused" if self.refused
                else "pass" if self.ok else "fail")

    def record(self, run_id: Optional[str] = None,
               tool: str = "fleet_drill") -> dict:
        """The gate's outcome as one TYPED, schema-stamped run record
        (the same evidence discipline as the other gates: a refusal is
        machine-readable, not silence)."""
        return schema.stamp({
            "name": "fleet_gate",
            "gate_status": self.status(),
            "slow_replica": self.slow_replica,
            "pre_share": self.pre_share,
            "post_share": self.post_share,
            "refusals": list(self.refusals),
        }, tool=tool, kind="run", run_id=run_id)


def _fleet_routes(records: List[dict]) -> List[dict]:
    return [r for r in records if isinstance(r, dict)
            and r.get("kind") == "fleet_route"
            and r.get("decision") in ("route", "hedge")
            and isinstance(r.get("timestamp_unix"), (int, float))]


def _fleet_served_by(rec: dict) -> Optional[int]:
    # `winner` is who actually answered (hedges); plain routes carry
    # the same value in both fields
    who = rec.get("winner", rec.get("replica"))
    if isinstance(who, bool) or not isinstance(who, int):
        return None
    return who


def gate_fleet(records: List[dict], *,
               min_requests: int = DEFAULT_FLEET_MIN_REQUESTS,
               min_drop: float = DEFAULT_FLEET_MIN_DROP,
               window_s: Optional[float] = None) -> FleetGateResult:
    """Gate the router's traffic shift over one run's records: split
    the served ``fleet_route`` records at the FIRST ``slow_replica``
    chaos record's timestamp and require the slowed replica's served
    share to drop by ``min_drop``.  ``window_s`` bounds the post-chaos
    side (default: everything after the boundary).  Contamination —
    a ``replica_evict`` recovery or ``kill_replica`` chaos against the
    slowed replica inside the comparison window — refuses: an evicted
    replica's share hits zero by EVICTION, which proves nothing about
    latency-aware routing."""
    refusals: List[str] = []
    routes = _fleet_routes(records)
    slow_faults = sorted(
        (r for r in records if isinstance(r, dict)
         and r.get("kind") == "chaos"
         and r.get("fault") == "slow_replica"
         and isinstance(r.get("timestamp_unix"), (int, float))),
        key=lambda r: r["timestamp_unix"])
    if not routes:
        refusals.append("no timestamped fleet_route records in the "
                        "stream — run the fleet with telemetry")
    if not slow_faults:
        refusals.append("no timestamped slow_replica chaos record — "
                        "no boundary to split traffic at")
    if refusals:
        return FleetGateResult(
            slow_replica=None, boundary_unix=None, pre_share=None,
            post_share=None, pre_counts={}, post_counts={},
            refusals=refusals, min_drop=min_drop)
    first = slow_faults[0]
    slow_replica = first.get("process")
    if isinstance(slow_replica, bool) or \
            not isinstance(slow_replica, int):
        return FleetGateResult(
            slow_replica=None, boundary_unix=None, pre_share=None,
            post_share=None, pre_counts={}, post_counts={},
            refusals=["slow_replica chaos record carries no process "
                      "— cannot name the slowed replica"],
            min_drop=min_drop)
    boundary = float(first["timestamp_unix"])
    end = boundary + window_s if window_s is not None else None

    pre_counts: Dict[int, int] = {}
    post_counts: Dict[int, int] = {}
    for rec in routes:
        who = _fleet_served_by(rec)
        if who is None:
            continue
        ts = float(rec["timestamp_unix"])
        if ts < boundary:
            pre_counts[who] = pre_counts.get(who, 0) + 1
        elif end is None or ts <= end:
            post_counts[who] = post_counts.get(who, 0) + 1
    pre_n, post_n = sum(pre_counts.values()), sum(post_counts.values())
    for label, n in (("pre", pre_n), ("post", post_n)):
        if n < min_requests:
            refusals.append(
                f"only {n} routed request(s) on the {label}-chaos "
                f"side (need >= {min_requests}) — not enough signal")
    if pre_counts.get(slow_replica, 0) == 0 and pre_n >= min_requests:
        refusals.append(
            f"slowed replica {slow_replica} served no pre-chaos "
            "traffic — a share of zero cannot drop")

    window_lo = min((float(r["timestamp_unix"]) for r in routes),
                    default=boundary)
    window_hi = (end if end is not None else
                 max((float(r["timestamp_unix"]) for r in routes),
                     default=boundary))
    for rec in records:
        if not isinstance(rec, dict):
            continue
        ts = rec.get("timestamp_unix")
        if not isinstance(ts, (int, float)) or isinstance(ts, bool):
            continue
        if not window_lo <= float(ts) <= window_hi:
            continue
        if (rec.get("kind") == "recovery"
                and rec.get("action") == "replica_evict"
                and rec.get("process") == slow_replica):
            refusals.append(
                f"contaminated: replica {slow_replica} was EVICTED "
                "inside the comparison window — its share drop is "
                "eviction, not routing")
            break
        if (rec.get("kind") == "chaos"
                and rec.get("fault") == "kill_replica"
                and rec.get("process") == slow_replica):
            refusals.append(
                f"contaminated: replica {slow_replica} was KILLED "
                "inside the comparison window — its share drop is "
                "death, not routing")
            break

    pre_share = (pre_counts.get(slow_replica, 0) / pre_n
                 if pre_n else None)
    post_share = (post_counts.get(slow_replica, 0) / post_n
                  if post_n else None)
    return FleetGateResult(
        slow_replica=slow_replica, boundary_unix=boundary,
        pre_share=pre_share, post_share=post_share,
        pre_counts=dict(sorted(pre_counts.items())),
        post_counts=dict(sorted(post_counts.items())),
        refusals=refusals, min_drop=min_drop)


def format_fleet_report(result: FleetGateResult) -> str:
    """Human-readable fleet-gate report (``tools/fleet_drill.py``'s
    slow-replica leg)."""
    lines: List[str] = []
    if result.refusals:
        lines.append("FLEET GATE REFUSED:")
        lines.extend("  " + r for r in result.refusals)
        return "\n".join(lines)
    lines.append(
        f"slow replica {result.slow_replica}: served share "
        f"{_fmt(result.pre_share)} -> {_fmt(result.post_share)} "
        f"(pre {result.pre_counts} / post {result.post_counts}; "
        f"required drop >= {result.min_drop:g})")
    lines.append(
        "FLEET GATE: "
        + ("pass (router shifted traffic away from the slowed "
           "replica)" if result.ok else
           "FAIL (the slowed replica kept its traffic share)"))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Streaming gate (data.streaming / tools/stream_drill.py)
# ---------------------------------------------------------------------------

# a prefetched streamed epoch that spent more than this fraction of its
# wall time BLOCKED on ingest is not overlapping host reads with device
# compute — the double-buffering claim fails (overlap floor =
# 1 - ceiling)
DEFAULT_STREAM_STALL_CEILING = 0.5

# a pass shorter than this is timer noise — such epochs inform the
# report but are not graded
DEFAULT_STREAM_MIN_PASS_S = 0.05


@dataclasses.dataclass
class StreamGateResult:
    """The streamed-ingest gate's outcome: every gradable
    ``stream_epoch`` record with ``prefetch > 0`` must keep its stall
    fraction (time blocked on ingest / pass wall time) at or below the
    ceiling — i.e. prefetch overlap ``1 - stall_fraction`` at or above
    the floor.  Typed exit-2 refusals for measurements that cannot be
    graded honestly: a contention-flagged epoch (the stall timer
    measured the scheduler, not the pipeline), a prefetched epoch
    missing its stall fields, or — under ``require_stream`` — no
    streamed epochs at all."""

    epochs: List[dict]
    graded: int
    worst_stall: Optional[float]
    worst_epoch: Optional[int]
    quarantined: int
    refusals: List[str]
    stall_ceiling: float = DEFAULT_STREAM_STALL_CEILING

    @property
    def worst_overlap(self) -> Optional[float]:
        return None if self.worst_stall is None else 1.0 - self.worst_stall

    @property
    def refused(self) -> bool:
        return bool(self.refusals)

    @property
    def ok(self) -> bool:
        if self.refused:
            return False
        if self.worst_stall is None:
            return True  # nothing prefetched: vacuous pass
        return self.worst_stall <= self.stall_ceiling

    def exit_code(self) -> int:
        """0 pass, 1 a prefetched epoch stalled past the ceiling,
        2 refused (contention-flagged / ungradable)."""
        if self.refused:
            return 2
        return 0 if self.ok else 1


def gate_stream(records: List[dict], *,
                stall_ceiling: float = DEFAULT_STREAM_STALL_CEILING,
                min_pass_s: float = DEFAULT_STREAM_MIN_PASS_S,
                require_stream: bool = False) -> StreamGateResult:
    """Gate streamed-ingest overlap over one run's records: every
    ``stream_epoch`` with ``prefetch > 0`` and a pass long enough to
    time honestly (``min_pass_s``) must hold ``stall_fraction <=
    stall_ceiling``.  Epochs without prefetch inform the report but are
    not graded (serial ingest stalls by construction).  Without any
    ``stream_epoch`` records the gate passes vacuously unless
    ``require_stream`` (then: typed refusal)."""
    epochs = [r for r in records if isinstance(r, dict)
              and r.get("kind") == "stream_epoch"]
    refusals: List[str] = []
    if not epochs and require_stream:
        refusals.append("no stream_epoch records in the stream — run "
                        "the streamed fit with telemetry")
    worst_stall: Optional[float] = None
    worst_epoch: Optional[int] = None
    graded = 0
    for rec in epochs:
        if rec.get("contention_flagged") is True:
            refusals.append(
                f"epoch {rec.get('epoch')}: contention-flagged "
                "streamed epoch — its stall timings measured the "
                "scheduler, not the prefetch pipeline")
            continue
        prefetch = rec.get("prefetch")
        if isinstance(prefetch, bool) or not isinstance(prefetch, int) \
                or prefetch <= 0:
            continue
        stall = rec.get("stall_fraction")
        pass_s = rec.get("pass_s")
        if not isinstance(stall, (int, float)) or isinstance(stall, bool):
            refusals.append(
                f"epoch {rec.get('epoch')}: prefetched stream_epoch "
                "carries no stall_fraction — overlap cannot be graded")
            continue
        if not isinstance(pass_s, (int, float)) or isinstance(
                pass_s, bool) or float(pass_s) < min_pass_s:
            continue  # too short to time honestly; not graded
        graded += 1
        if worst_stall is None or float(stall) > worst_stall:
            worst_stall = float(stall)
            worst_epoch = rec.get("epoch")
    if require_stream and epochs and graded == 0 and not refusals:
        refusals.append(
            f"no gradable prefetched epoch (need prefetch > 0 and "
            f"pass_s >= {min_pass_s:g}) — nothing to hold to the "
            "overlap floor")
    quarantined = max((int(r.get("quarantined") or 0) for r in epochs),
                      default=0)
    return StreamGateResult(
        epochs=epochs, graded=graded, worst_stall=worst_stall,
        worst_epoch=worst_epoch, quarantined=quarantined,
        refusals=refusals, stall_ceiling=stall_ceiling)


def format_stream_report(result: StreamGateResult) -> str:
    """Human-readable stream-gate report (``tools/perf_gate.py
    --stream``)."""
    lines: List[str] = []
    if result.refusals:
        lines.append("STREAM GATE REFUSED:")
        lines.extend("  " + r for r in result.refusals)
        return "\n".join(lines)
    if not result.epochs:
        return ("STREAM GATE: pass (no stream_epoch records — nothing "
                "to gate)")
    if result.worst_stall is None:
        lines.append(
            f"{len(result.epochs)} streamed epoch(s), none prefetched "
            "— overlap not graded")
    else:
        lines.append(
            f"{len(result.epochs)} streamed epoch(s), {result.graded} "
            f"graded; worst stall fraction {_fmt(result.worst_stall)} "
            f"(epoch {result.worst_epoch}, overlap "
            f"{_fmt(result.worst_overlap)}, ceiling "
            f"{result.stall_ceiling:g})")
    if result.quarantined:
        lines.append(f"  {result.quarantined} shard(s) quarantined "
                     "during the run")
    lines.append(
        "STREAM GATE: "
        + ("pass (prefetch overlap held the floor)" if result.ok else
           "FAIL (a prefetched epoch stalled on ingest past the "
           "ceiling)"))
    return "\n".join(lines)
