"""The port's copies of the JAX package's stdlib-only ``obs`` modules:
``sinks``, ``flight``, ``timeline``, ``scaling``, ``perfgate``,
``events`` and ``registry`` equal
the originals after their module docstrings, line for line; ``trace``
equals its original but for ``process_index``, which reads the rank of
an initialized ``torch.distributed`` group instead of JAX's process
index.  The copies behave as the originals on the same records."""

import ast
import difflib
from pathlib import Path

import pytest

from spark_agd_tpu.obs import perfgate as jperfgate, timeline as jtimeline
from spark_agd_tpu_torch.obs import (flight, perfgate, scaling, schema,
                                     sinks, timeline, trace)

ROOT = Path(__file__).resolve().parents[1]
COPIES = ("sinks", "flight", "timeline", "scaling", "perfgate", "events",
          "registry", "__main__")


def _after_docstring(path: Path) -> list:
    src = path.read_text()
    first = ast.parse(src).body[0]
    assert isinstance(first, ast.Expr) and isinstance(first.value,
                                                      ast.Constant)
    return src.splitlines(keepends=True)[first.end_lineno:]


def _pair(name):
    return (ROOT / "spark_agd_tpu_torch" / "obs" / f"{name}.py",
            ROOT / "spark_agd_tpu" / "obs" / f"{name}.py")


@pytest.mark.parametrize("name", COPIES)
def test_copied_module_equals_the_original(name):
    mine, theirs = _pair(name)
    assert _after_docstring(mine) == _after_docstring(theirs)
    assert f"A copy of ``spark_agd_tpu/obs/{name}.py``" in \
        ast.get_docstring(ast.parse(mine.read_text()))


def test_trace_differs_from_the_original_only_in_process_index():
    mine, theirs = _pair("trace")
    a, b = _after_docstring(theirs), _after_docstring(mine)
    changed = {i for tag, i1, i2, _, _ in
               difflib.SequenceMatcher(a=a, b=b).get_opcodes()
               if tag != "equal" for i in range(i1, max(i2, i1 + 1))}
    body = next(n for n in ast.parse("".join(a)).body
                if isinstance(n, ast.FunctionDef)
                and n.name == "process_index")
    # every differing line of the original lies inside process_index's
    # body (its docstring and the JAX probe)
    assert changed and all(body.lineno < i + 1 <= body.end_lineno
                           for i in changed), sorted(changed)
    assert "A near-copy of ``spark_agd_tpu/obs/trace.py``" in \
        ast.get_docstring(ast.parse(mine.read_text()))


def test_process_index_reads_torch_distributed(monkeypatch):
    import torch.distributed as dist

    assert trace.process_index() == 0
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    assert trace.process_index() == 3
    assert trace.new_trace_id().startswith("t")


def _canary(gen=5, **over):
    rec = schema.canary_record(
        "r1", gen, "pass", baseline_generation=4, shadow_requests=30,
        quality_baseline=0.5, quality_candidate=0.49, p50_ms=1.0,
        p99_ms=2.0, baseline_p50_ms=1.0, baseline_p99_ms=2.0)
    rec.update(over)
    return rec


@pytest.mark.parametrize("over", [
    {}, {"quality_candidate": 0.9}, {"p99_ms": 40.0},
    {"shadow_requests": 3}, {"contention_flagged": True},
    {"quality_candidate": None}])
def test_gate_promotion_equals_the_original(over):
    recs = [_canary(**{k: v for k, v in over.items() if v is not None})]
    if over.get("quality_candidate", 0) is None:
        del recs[0]["quality_candidate"]
    mine = perfgate.gate_promotion(recs, min_shadow_requests=16)
    theirs = jperfgate.gate_promotion(recs, min_shadow_requests=16)
    assert (mine.refusals, mine.failures, mine.exit_code()) == (
        theirs.refusals, theirs.failures, theirs.exit_code())
    assert perfgate.format_promotion_report(mine) == \
        jperfgate.format_promotion_report(theirs)


def test_timeline_and_flight_on_the_same_records():
    root = trace.SpanContext("t1", "s1", None, 0)
    recs = [
        {"kind": "span", "name": "root", "trace_id": "t1", "span_id": "s1",
         "process": 0, "t_start_unix": 0.0, "seconds": 1.0},
        {"kind": "span", "name": "child", "trace_id": "t1", "span_id": "s2",
         "parent_id": root.span_id, "process": 0, "t_start_unix": 0.1,
         "seconds": 0.5}]
    mine, theirs = timeline.analyze(recs, "t1"), jtimeline.analyze(recs,
                                                                    "t1")
    assert mine.summary_fields() == theirs.summary_fields()
    ring = flight.FlightRecorder(capacity=2)
    for r in recs + [{"kind": "x"}]:
        ring.emit(r)
    assert [r.get("kind") for r in ring.snapshot()] == ["span", "x"]
    mem = sinks.InMemorySink()
    mem.emit({"kind": "x"})
    assert mem.records == [{"kind": "x"}]
    assert scaling.environment_key({"platform": "gpu"}).startswith("env-")


def test_the_obs_module_selfcheck_exits_0():
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "spark_agd_tpu_torch.obs", "--selfcheck"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "selfcheck PASSED" in out.stdout
