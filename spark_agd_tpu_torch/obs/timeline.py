"""Per-host timeline analysis over traced span records.

A copy of ``spark_agd_tpu/obs/timeline.py``, which needs only
the standard library;
``tests/test_torch_obs.py`` holds everything after this docstring
to the original, line for line.

The consumption half of ``obs.trace``: given any record stream (a run
JSONL, a flight-recorder dump, or both), reconstruct the causal span
tree and answer the distributed-ML diagnosis questions of PAPERS.md
arXiv 1612.01437 — which host is slow, which chain of work bounds the
wall clock, and where a dead host's timeline stops:

- :func:`collect_spans` pairs each span's open/close records by span
  id (the close record wins; an open with no close is a **truncated**
  span — the on-disk shape of a SIGKILL);
- :func:`build_forest` links children to parents; a well-formed trace
  has ONE root and no orphans (:func:`analyze` reports
  ``connected``);
- :func:`per_host_step_times` / :func:`straggler_score` aggregate the
  ``segment`` spans per process rank — the straggler score is
  ``max over hosts of that host's p95 step time, divided by the median
  step time over all hosts' samples`` (lower is better, ~1.0 means
  balanced; ``obs.perfgate`` gates on it so a regression that only
  slows one host fails);
- :func:`critical_path` walks the tree root→leaf following the child
  whose subtree ends LAST (truncated spans inherit their deepest
  descendant's end) — the chain of work that bounded the run;
- :func:`to_chrome_trace` renders the spans as Chrome trace-event JSON
  (load via ``chrome://tracing`` or Perfetto: one row per host, spans
  nested by time).

Deliberately stdlib-only, like ``obs.schema``: ``tools/agd_trace.py``
must analyze artifacts wherever they ended up, backend or not.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

STEP_SPAN_NAME = "segment"


@dataclasses.dataclass
class Span:
    """One reconstructed span (paired open/close, or truncated)."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    process: int
    seconds: float            # 0.0 when truncated (duration unknown)
    t_start: Optional[float]  # t_start_unix when present
    status: str               # "ok" | "error" | ... | "open"
    truncated: bool
    record: dict              # the raw (closing, or lone open) record
    children: List["Span"] = dataclasses.field(default_factory=list)
    _end: Optional[float] = None

    def end(self) -> Optional[float]:
        """The span's effective end time: close time for a finished
        span, the deepest descendant's end for a truncated one (its
        own duration is unknowable — the process died)."""
        if self._end is not None:
            return self._end
        own = (None if self.t_start is None
               else self.t_start + (0.0 if self.truncated
                                    else self.seconds))
        ends = [own] + [c.end() for c in self.children]
        ends = [e for e in ends if e is not None]
        self._end = max(ends) if ends else None
        return self._end


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted non-empty list
    (same convention as ``serve.queue``)."""
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q * len(sorted_vals) + 0.5)) - 1))
    return sorted_vals[idx]


def collect_spans(records: Sequence[dict],
                  trace_id: Optional[str] = None) -> List[Span]:
    """Pair open/close span records into :class:`Span` objects (file
    order preserved by first sighting).  Only records that carry trace
    ids participate — untraced phase spans (``compile``/``execute``)
    are not part of any tree."""
    by_id: Dict[Tuple[str, str], Span] = {}
    order: List[Tuple[str, str]] = []
    for rec in records:
        if not isinstance(rec, dict) or rec.get("kind") != "span":
            continue
        tid, sid = rec.get("trace_id"), rec.get("span_id")
        if not tid or not sid:
            continue
        if trace_id is not None and tid != trace_id:
            continue
        key = (tid, sid)
        status = rec.get("status", "ok")
        span = Span(
            name=str(rec.get("name", "?")), trace_id=tid, span_id=sid,
            parent_id=rec.get("parent_id"),
            process=int(rec.get("process", 0) or 0),
            seconds=float(rec.get("seconds", 0.0) or 0.0),
            t_start=rec.get("t_start_unix"),
            status=status, truncated=(status == "open"), record=rec)
        if key not in by_id:
            order.append(key)
            by_id[key] = span
        elif status != "open":
            # the close record supersedes the open marker
            by_id[key] = span
    return [by_id[k] for k in order]


def trace_ids(records: Sequence[dict]) -> List[str]:
    """Distinct trace ids present, in first-sighting order."""
    seen: List[str] = []
    for s in collect_spans(records):
        if s.trace_id not in seen:
            seen.append(s.trace_id)
    return seen


def build_forest(spans: Sequence[Span]) -> Tuple[List[Span], int]:
    """Link children to parents; returns ``(roots, orphans)`` where an
    orphan is a span whose ``parent_id`` names a span that is not in
    the stream (it is promoted to a root so nothing is lost, but a
    connected tree has zero of them)."""
    by_id = {s.span_id: s for s in spans}
    roots: List[Span] = []
    orphans = 0
    for s in spans:
        s.children = []
        s._end = None
    for s in spans:
        if s.parent_id is None:
            roots.append(s)
        elif s.parent_id in by_id:
            by_id[s.parent_id].children.append(s)
        else:
            orphans += 1
            roots.append(s)
    for s in spans:
        s.children.sort(key=lambda c: (c.t_start is None,
                                       c.t_start or 0.0))
    return roots, orphans


def hosts_of(spans: Sequence[Span]) -> List[int]:
    return sorted({s.process for s in spans})


def per_host_step_times(records: Sequence[dict], *,
                        name: str = STEP_SPAN_NAME,
                        trace_id: Optional[str] = None,
                        skip_first: int = 0,
                        ) -> Dict[int, List[float]]:
    """Closed step-span durations keyed by process rank — the raw
    material of the skew diagnosis.  Truncated spans are excluded
    (their duration is unknown, not zero).  ``skip_first`` drops that
    many leading steps PER HOST: each host's first segment carries its
    trace+compile cost, which is warmup, not skew — steady-state skew
    diagnosis (the drills) passes 1."""
    out: Dict[int, List[float]] = defaultdict(list)
    for s in collect_spans(records, trace_id):
        if s.name == name and not s.truncated:
            out[s.process].append(s.seconds)
    if skip_first:
        out = {p: ts[int(skip_first):] for p, ts in out.items()}
    return {p: ts for p, ts in out.items() if ts}


def host_step_table(step_times: Dict[int, List[float]]) -> List[dict]:
    """Per-host step-time stats rows (count/total/mean/p50/p95/max),
    sorted by rank — the report table's data."""
    rows = []
    for proc in sorted(step_times):
        times = sorted(step_times[proc])
        if not times:
            continue
        rows.append({
            "process": proc, "steps": len(times),
            "total_s": sum(times),
            "mean_s": sum(times) / len(times),
            "p50_s": _percentile(times, 0.50),
            "p95_s": _percentile(times, 0.95),
            "max_s": times[-1],
        })
    return rows


def _median(vals: Sequence[float]) -> float:
    """Interpolating median (even counts average the middle pair —
    with two hosts, one slow, the nearest-rank median would land
    entirely on one of them and hide the skew)."""
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def straggler_score(step_times: Dict[int, List[float]]
                    ) -> Optional[float]:
    """``max over hosts of p95(host step times), divided by the median
    over hosts of each host's median step time`` — the slowest host's
    tail against the TYPICAL host's typical step.  Lower is better,
    ~1.0 balanced; None without samples or with a zero denominator (a
    degenerate all-instant run has no skew to score)."""
    per_host = [ts for ts in step_times.values() if ts]
    if not per_host:
        return None
    med = _median([_median(ts) for ts in per_host])
    if med <= 0:
        return None
    worst = max(_percentile(sorted(ts), 0.95) for ts in per_host)
    return worst / med


def slowest_host(step_times: Dict[int, List[float]]) -> Optional[int]:
    """The rank with the highest p95 step time (None without
    samples)."""
    best = None
    for proc, ts in step_times.items():
        if not ts:
            continue
        p95 = _percentile(sorted(ts), 0.95)
        if best is None or p95 > best[1]:
            best = (proc, p95)
    return None if best is None else best[0]


def critical_path(root: Span) -> List[Span]:
    """Root→leaf chain following the child whose subtree ends last
    (ties and missing timestamps fall back to the longest child) — the
    chain of work that bounded the wall clock."""
    path = [root]
    node = root
    while node.children:
        def _key(c: Span):
            e = c.end()
            return (e is not None, e if e is not None else c.seconds,
                    c.seconds)
        node = max(node.children, key=_key)
        path.append(node)
    return path


def critical_path_host(path: Sequence[Span]) -> Optional[int]:
    """The host the critical path attributes the time to: the rank
    owning the most closed-span seconds along the path below the root
    (falling back to the deepest span's rank when nothing closed —
    e.g. a path of truncated spans)."""
    if len(path) < 2:
        return path[0].process if path else None
    per: Dict[int, float] = defaultdict(float)
    for s in path[1:]:
        if not s.truncated:
            per[s.process] += s.seconds
    if per:
        return max(per.items(), key=lambda kv: kv[1])[0]
    return path[-1].process


@dataclasses.dataclass
class TraceReport:
    """One trace's analysis — what :func:`analyze` returns and what a
    ``trace_summary`` record serializes."""

    trace_id: str
    spans: int
    hosts: List[int]
    roots: int
    orphans: int
    truncated: int
    connected: bool
    critical_path: List[Span]
    critical_path_s: Optional[float]
    critical_host: Optional[int]
    step_times: Dict[int, List[float]]
    straggler_score: Optional[float]
    slowest_host: Optional[int]

    def summary_fields(self) -> dict:
        """The ``trace_summary`` record's field set (pass to
        ``Telemetry.trace_summary(**report.summary_fields())``)."""
        out = {
            "trace_id": self.trace_id, "spans": int(self.spans),
            "hosts": len(self.hosts), "roots": int(self.roots),
            "truncated": int(self.truncated),
            "connected": bool(self.connected),
            "critical_path": [
                {"name": s.name, "process": int(s.process),
                 "seconds": round(float(s.seconds), 6),
                 "truncated": bool(s.truncated)}
                for s in self.critical_path],
        }
        if self.critical_path_s is not None:
            out["critical_path_s"] = round(float(self.critical_path_s),
                                           6)
        if self.straggler_score is not None:
            out["straggler_score"] = round(float(self.straggler_score),
                                           4)
        return out


def analyze(records: Sequence[dict],
            trace_id: Optional[str] = None, *,
            step_span: str = STEP_SPAN_NAME,
            skip_first: int = 0) -> Optional[TraceReport]:
    """Analyze one trace of ``records`` (the only one present, or the
    one named).  None when no traced spans match.  With several roots
    (a stream missing its cross-process root record) the critical path
    starts from the root whose subtree ends last."""
    if trace_id is None:
        ids = trace_ids(records)
        if not ids:
            return None
        trace_id = ids[0]
    spans = collect_spans(records, trace_id)
    if not spans:
        return None
    roots, orphans = build_forest(spans)
    def _root_key(r: Span):
        e = r.end()
        return (e is not None, e if e is not None else r.seconds)
    start = max(roots, key=_root_key)
    path = critical_path(start)
    closed = [s for s in path if not s.truncated]
    path_s = sum(s.seconds for s in closed[1:]) if len(closed) > 1 \
        else (closed[0].seconds if closed else None)
    steps = per_host_step_times(records, name=step_span,
                                trace_id=trace_id,
                                skip_first=skip_first)
    return TraceReport(
        trace_id=trace_id, spans=len(spans), hosts=hosts_of(spans),
        roots=len(roots), orphans=orphans,
        truncated=sum(1 for s in spans if s.truncated),
        connected=(len(roots) == 1 and orphans == 0),
        critical_path=path, critical_path_s=path_s,
        critical_host=critical_path_host(path),
        step_times=steps, straggler_score=straggler_score(steps),
        slowest_host=slowest_host(steps))


def render_tree(roots: Sequence[Span], *, max_depth: int = 12,
                max_children: int = 16) -> str:
    """Indented text rendering of a span forest (the CLI's -v view)."""
    lines: List[str] = []

    def walk(span: Span, depth: int):
        mark = " TRUNCATED" if span.truncated else ""
        dur = "?" if span.truncated else f"{span.seconds * 1e3:.1f}ms"
        lines.append(f"{'  ' * depth}{span.name} "
                     f"[h{span.process}] {dur}{mark}")
        if depth >= max_depth:
            return
        for i, c in enumerate(span.children):
            if i >= max_children:
                lines.append(f"{'  ' * (depth + 1)}"
                             f"… {len(span.children) - i} more")
                break
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)
    return "\n".join(lines)


def to_chrome_trace(records: Sequence[dict],
                    trace_id: Optional[str] = None) -> dict:
    """Chrome trace-event JSON (the ``chrome://tracing`` / Perfetto
    format): one complete ("ph":"X") event per span, ``pid`` = host
    rank, spans without wall-clock anchors laid out back-to-back.
    Truncated spans get their effective end (deepest descendant) and
    ``args.truncated`` so the kill is visible as a clipped box."""
    spans = collect_spans(records, trace_id)
    build_forest(spans)
    t0 = min((s.t_start for s in spans if s.t_start is not None),
             default=0.0)
    events: List[dict] = []
    fallback_cursor: Dict[int, float] = defaultdict(float)
    for s in spans:
        if s.t_start is not None:
            ts = (s.t_start - t0) * 1e6
        else:
            ts = fallback_cursor[s.process]
            fallback_cursor[s.process] += max(s.seconds, 1e-6) * 1e6
        if s.truncated:
            end = s.end()
            dur = max(((end - t0) * 1e6 - ts)
                      if (end is not None and s.t_start is not None)
                      else 1.0, 1.0)
        else:
            dur = max(s.seconds * 1e6, 1.0)
        args = {"span_id": s.span_id, "parent_id": s.parent_id,
                "status": s.status, "trace_id": s.trace_id}
        if s.truncated:
            args["truncated"] = True
        events.append({"name": s.name, "cat": "span", "ph": "X",
                       "ts": round(ts, 3), "dur": round(dur, 3),
                       "pid": s.process, "tid": 0, "args": args})
    for p in sorted({s.process for s in spans}):
        events.append({"name": "process_name", "ph": "M", "pid": p,
                       "tid": 0, "args": {"name": f"host {p}"}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
