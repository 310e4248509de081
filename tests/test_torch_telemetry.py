"""The port's telemetry bus against the JAX package's, on the CPU.

``obs/telemetry.py`` is a near-copy: it differs from the original only
where named (its bus stamps the device and the torch and CUDA versions
on every record, and ``heartbeat`` reads the process index from
``torch.distributed``).  The same runs then go through both packages
with an in-memory sink, and their records are held to each other in
kind, order and every field that does not measure time, name a run, a
span, a file or the device (``tests/torch_records.py``): the AGD loop's
per-iteration stream, supervised fits (f64, ``stream_iterations=True``,
the iteration losses within 1e-9 relative) with a device loss, a NaN
and a preemption, the checkpointer's fallback and resume, a chaos
campaign, heartbeats and a host loss, a serving stack with a hot swap,
and the canary's and promoter's decisions.  A flight dump written by
either package is read by the other's ``load_dump``; ``obs`` and
``resilience`` export the JAX package's names (but ``introspect``'s),
and every former ``telemetry=``/``journal=`` refusal (the fit entry
points, partitioned ingest, the distributed checkpointer and its
loaders, the degraded loader and the straggler scheduler) emits the
JAX package's records."""

import ast
import difflib
import os
import signal
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu.core import agd as jagd, smooth as jsmooth
from spark_agd_tpu.models import glm as jglm
from spark_agd_tpu.models.evaluation import log_loss as jlog_loss
from spark_agd_tpu.obs import Telemetry as JTelemetry
from spark_agd_tpu.obs import flight as jflight, schema as jschema
from spark_agd_tpu.ops.losses import LogisticGradient as JLogistic
from spark_agd_tpu.ops.prox import L2Prox as JL2
from spark_agd_tpu import pipeline as jpipeline
from spark_agd_tpu import resilience as jres
from spark_agd_tpu import serve as jserve
from spark_agd_tpu_torch import pipeline as tpipeline
from spark_agd_tpu_torch import resilience as tres
from spark_agd_tpu_torch import serve as tserve
from spark_agd_tpu_torch.core import agd as tagd, smooth as tsmooth
from spark_agd_tpu_torch.models import glm as tglm
from spark_agd_tpu_torch.models.evaluation import log_loss as tlog_loss
from spark_agd_tpu_torch.obs import Telemetry as TTelemetry
from spark_agd_tpu_torch.obs import flight as tflight, schema as tschema
from spark_agd_tpu_torch.obs import telemetry as ttelemetry
from spark_agd_tpu_torch.ops.losses import LogisticGradient as TLogistic
from spark_agd_tpu_torch.ops.prox import L2Prox as TL2
from torch_records import assert_same

ROOT = Path(__file__).resolve().parents[1]
D = 5
WAIT = 30
# the per-iteration scalars, held at the f64 parity standard
ITER_TOL = {"loss": 1e-9, "L": 1e-9, "theta": 1e-9, "step": 1e-9,
            "big_l": 1e-9}


def _valid(records):
    for rec in records:
        assert tschema.validate_record(rec) == [], rec
        assert jschema.validate_record(rec) == [], rec
        for key in ("device_kind", "torch_version", "cuda_version"):
            assert isinstance(rec[key], str), (key, rec)


# ---------------------------------------------------------------------------
# the near-copy


def _after_docstring(path: Path) -> list:
    src = path.read_text()
    first = ast.parse(src).body[0]
    return src.splitlines(keepends=True)[first.end_lineno:]


def test_telemetry_differs_from_the_original_only_where_named():
    theirs = _after_docstring(ROOT / "spark_agd_tpu" / "obs"
                              / "telemetry.py")
    mine = _after_docstring(ROOT / "spark_agd_tpu_torch" / "obs"
                            / "telemetry.py")
    tree = ast.parse("".join(mine))
    named = []  # (first, last) 1-based lines of the port's named places
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == "environment":
            named.append((node.lineno, node.end_lineno))
        if isinstance(node, ast.ClassDef) and node.name == "_StampedBus":
            named.append((node.lineno, node.end_lineno))
        if isinstance(node, ast.ClassDef) and node.name == "Telemetry":
            for item in node.body:
                if isinstance(item, ast.FunctionDef) \
                        and item.name == "heartbeat":
                    named.append((item.lineno, item.end_lineno))
    bus = next(i + 1 for i, line in enumerate(mine)
               if "self.bus = _StampedBus(" in line)
    named.append((bus, bus))
    changed = [j for tag, _, _, j1, j2 in difflib.SequenceMatcher(
        a=theirs, b=mine, autojunk=False).get_opcodes() if tag != "equal"
        for j in range(j1 + 1, j2 + 1)]
    # every line the port adds or changes lies in a named place (the
    # blank lines around the added definitions too)
    outside = [j for j in changed
               if not any(a - 2 <= j <= b + 2 for a, b in named)
               and mine[j - 1].strip()]
    assert changed and not outside, [mine[j - 1] for j in outside]
    assert "A near-copy of ``spark_agd_tpu/obs/telemetry.py``" in \
        ast.get_docstring(ast.parse(
            (ROOT / "spark_agd_tpu_torch" / "obs" / "telemetry.py")
            .read_text()))


def test_every_record_carries_the_environment(monkeypatch):
    tel = TTelemetry()
    with tel.span("a"):
        pass
    tel.heartbeat(iter=3, phase="segment")
    tel.recovery(action="retry", source="x")
    env = ttelemetry.environment()
    assert env == {"device_kind": "cpu",
                   "torch_version": torch.__version__,
                   "cuda_version": str(torch.version.cuda or "none")}
    assert all(r[k] == v for r in tel.records for k, v in env.items())
    _valid(tel.records)
    # a run record keeps the device_kind its producer names
    rec = tel.run_summary(tool="t", device_kind="H100")
    assert rec["device_kind"] == "H100"
    # heartbeat's process index is the torch.distributed rank
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    assert tel.heartbeat()["process"] == 2


# ---------------------------------------------------------------------------
# the fits


def _data(seed=3, n=160):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, D))
    w = r.normal(size=D)
    y = (r.random(n) < 1.0 / (1.0 + np.exp(-(X @ w)))).astype(np.float64)
    return X, y


def _problem(pkg, seed=3):
    X, y = _data(seed)
    if pkg == "jax":
        staged = jsmooth.make_smooth_staged(JLogistic(), jnp.asarray(X),
                                            jnp.asarray(y))
        px, rv = jsmooth.make_prox(JL2(), 0.01)
        return staged, px, rv, jnp.zeros(D)
    staged = tsmooth.make_smooth_staged(TLogistic(), torch.from_numpy(X),
                                        torch.from_numpy(y))
    px, rv = tsmooth.make_prox(TL2(), 0.01)
    return staged, px, rv, torch.zeros(D, dtype=torch.float64)


def test_agd_telemetry_cb_streams_the_jax_iterations():
    recs = {}
    for pkg, agd_mod, tel_cls in (("jax", jagd, JTelemetry),
                                  ("torch", tagd, TTelemetry)):
        (build, dargs), px, rv, w0 = _problem(pkg)
        sm, sl = build(*dargs)
        tel = tel_cls()
        cfg = agd_mod.AGDConfig(num_iterations=12, convergence_tol=0.0)
        res = agd_mod.run_agd(sm, px, rv, w0, cfg, smooth_loss=sl,
                              telemetry_cb=tel.iteration_callback("agd"))
        recs[pkg] = (tel.iterations("agd"), np.asarray(res.loss_history))
    assert_same(recs["torch"][0], recs["jax"][0], approx=ITER_TOL)
    assert [r["loss"] for r in recs["torch"][0]] == \
        recs["torch"][1].tolist()
    assert any(r["restarted"] for r in recs["torch"][0]) == any(
        r["restarted"] for r in recs["jax"][0])


def _supervised(pkg, tmp_path, faults=None, sigterm=False):
    mods = ((jagd, jres, JTelemetry) if pkg == "jax"
            else (tagd, tres, TTelemetry))
    agd_mod, res_mod, tel_cls = mods
    staged, px, rv, w0 = _problem(pkg)
    tel = tel_cls()
    path = str(tmp_path / pkg / "fit.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)

    def make_faults():
        if faults is None:
            return None
        return res_mod.FaultScript(**faults)

    def fit(fs):
        ck = res_mod.AutoCheckpointer(path, every_iters=5, keep=2,
                                      telemetry=tel)
        return res_mod.run_agd_supervised(
            prox=px, reg_value=rv, w0=w0,
            config=agd_mod.AGDConfig(num_iterations=20,
                                     convergence_tol=0.0),
            policy=res_mod.ResiliencePolicy(
                max_attempts=3, backoff_base=0.0, jitter=0.0, seed=0,
                segment_iters=5),
            telemetry=tel, checkpointer=ck, staged=staged, faults=fs,
            stream_iterations=True)

    fs = make_faults()
    if sigterm:
        with pytest.raises(res_mod.Preempted):
            fit(fs)
        res = fit(None)
    else:
        res = fit(fs)
    return tel.records, res


@pytest.mark.parametrize("case", [
    "clean", "device_loss", "nan", "sigterm"])
def test_supervised_fit_records_equal_jax(case, tmp_path):
    faults = {"clean": None,
              "device_loss": dict(device_loss_at_iter=5),
              "nan": dict(nan_at_iter=10),
              "sigterm": dict(sigterm_at_iter=10,
                              signum=signal.SIGTERM)}[case]
    jrecs, jres_ = _supervised("jax", tmp_path, faults, case == "sigterm")
    trecs, tres_ = _supervised("torch", tmp_path, faults,
                               case == "sigterm")
    _valid(trecs)
    assert tres_.num_iters == jres_.num_iters == 20
    np.testing.assert_allclose(tres_.loss_history, jres_.loss_history,
                               rtol=1e-9)
    assert_same(trecs, jrecs, approx=ITER_TOL)
    kinds = [r["kind"] for r in trecs]
    assert kinds.count("iteration") >= 20
    actions = [r["action"] for r in trecs if r["kind"] == "recovery"]
    want = {"clean": set(), "device_loss": {"retry"},
            "nan": {"rollback"}, "sigterm": {"preemption_flush"}}[case]
    assert want <= set(actions) and "checkpoint" in actions


def test_checkpointer_fallback_and_resume_records_equal_jax(tmp_path):
    recs = {}
    for pkg, agd_mod, res_mod, tel_cls in (
            ("jax", jagd, jres, JTelemetry),
            ("torch", tagd, tres, TTelemetry)):
        staged, px, rv, w0 = _problem(pkg)
        path = str(tmp_path / pkg / "c.npz")
        os.makedirs(os.path.dirname(path))
        kw = dict(prox=px, reg_value=rv, w0=w0, staged=staged,
                  policy=res_mod.ResiliencePolicy(segment_iters=4),
                  stream_iterations=False)
        res_mod.run_agd_supervised(
            config=agd_mod.AGDConfig(num_iterations=8,
                                     convergence_tol=0.0),
            checkpointer=res_mod.AutoCheckpointer(path, every_iters=4,
                                                  keep=3), **kw)
        with open(path, "r+b") as f:  # the newest generation, torn
            f.truncate(100)
        tel = tel_cls()
        res_mod.run_agd_supervised(
            config=agd_mod.AGDConfig(num_iterations=12,
                                     convergence_tol=0.0),
            checkpointer=res_mod.AutoCheckpointer(path, every_iters=4,
                                                  keep=3, telemetry=tel),
            telemetry=tel, **kw)
        recs[pkg] = tel.records
    # the fallback's reason is each package's own exception text
    assert_same(recs["torch"], recs["jax"], drop=("reason",))
    actions = [r["action"] for r in recs["torch"]
               if r["kind"] == "recovery"]
    assert actions[:2] == ["checkpoint_fallback", "resume"]


def test_chaos_campaign_records_equal_jax(tmp_path):
    from spark_agd_tpu.resilience import chaos as jchaos
    from spark_agd_tpu_torch.resilience import chaos as tchaos

    faults = (("device_loss", 3, 0.0), ("sigterm", 6, 0.0),
              ("truncate_ckpt", 7, 0.4))
    recs = {}
    for pkg, agd_mod, res_mod, ch, tel_cls in (
            ("jax", jagd, jres, jchaos, JTelemetry),
            ("torch", tagd, tres, tchaos, TTelemetry)):
        staged, px, rv, w0 = _problem(pkg)
        campaign = ch.ChaosCampaign(seed=31, iters=12, faults=tuple(
            ch.ScheduledFault(k, at, payload=p) for k, at, p in faults))
        cfg = agd_mod.AGDConfig(num_iterations=12, convergence_tol=0.0)
        policy = res_mod.ResiliencePolicy(max_attempts=3, backoff_base=0.0,
                                          jitter=0.0, seed=0,
                                          segment_iters=3)
        base = res_mod.run_agd_supervised(prox=px, reg_value=rv, w0=w0,
                                          config=cfg, policy=policy,
                                          staged=staged,
                                          stream_iterations=False)
        workdir = tmp_path / pkg
        os.makedirs(workdir)
        tel = tel_cls()
        out = ch.run_campaign(
            campaign, staged=staged, prox=px, reg_value=rv, w0=w0,
            config=cfg, policy=policy, workdir=str(workdir),
            baseline_loss=float(base.loss_history[-1]), telemetry=tel)
        assert out.outcome == "converged", out
        recs[pkg] = tel.records
    # the chaos record of the truncation names the bytes it kept, which
    # follow each package's npz layout
    assert_same(recs["torch"], recs["jax"], drop=("outcome", "reason"))
    fired = [r["fault"] for r in recs["torch"] if r["kind"] == "chaos"]
    assert fired == ["device_loss", "sigterm", "truncate_ckpt"]


def test_heartbeat_and_monitor_records_equal_jax(tmp_path):
    from spark_agd_tpu.resilience import distributed as jdist
    from spark_agd_tpu_torch.resilience import distributed as tdist

    recs = {}
    for pkg, dist, tel_cls in (("jax", jdist, JTelemetry),
                               ("torch", tdist, TTelemetry)):
        tel = tel_cls()
        d = str(tmp_path / pkg)
        now = [1000.0]
        for p in range(3):
            dist.HeartbeatWriter(d, process_index=p, process_count=3,
                                 telemetry=tel,
                                 clock=lambda: now[0]).beat(
                iter=4, phase="slow" if p == 1 else "segment")
        mon = dist.HostMonitor(d, stale_after_s=5.0, slow_after_s=2.0,
                               telemetry=tel, clock=lambda: now[0])
        v0 = mon.verdicts()
        now[0] += 10.0
        for _ in range(2):
            with pytest.raises(Exception, match="heartbeat|stale|lost"):
                mon.check()
        recs[pkg] = (tel.records, v0, mon.verdicts())
    assert recs["torch"][1:] == recs["jax"][1:]
    assert recs["torch"][1] == {0: "ok", 1: "slow", 2: "ok"}
    assert_same(recs["torch"][0], recs["jax"][0])
    _valid(recs["torch"][0])


# ---------------------------------------------------------------------------
# serving and the pipeline


def _model(pkg, seed=1, scale=1.0):
    w = (np.random.default_rng(seed).normal(size=D) * scale).astype(
        np.float32)
    if pkg == "jax":
        return jglm.LogisticRegressionModel(w, 0.0)
    return tglm.LogisticRegressionModel(torch.from_numpy(w), 0.0)


def _X(i, n=3):
    return np.random.default_rng(100 + i).normal(size=(n, D)).astype(
        np.float32)


def test_serving_stack_records_equal_jax(tmp_path):
    recs = {}
    for pkg, serve, tel_cls in (("jax", jserve, JTelemetry),
                                ("torch", tserve, TTelemetry)):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        tel = tel_cls()
        reg = serve.ModelRegistry(str(tmp_path / pkg), telemetry=tel, **kw)
        reg.publish(_model(pkg, seed=1))
        eng = serve.ServeEngine(reg.load_newest().model, generation=1,
                                max_batch=8, min_bucket=4, telemetry=tel,
                                **kw)
        reg.refresh(eng)
        q = serve.MicroBatchQueue(eng, telemetry=tel, replica=2,
                                  max_wait_us=0).start()
        values = []
        for i in range(3):
            values.append(q.submit(_X(i), "predict_proba",
                                   tenant="acme").result(WAIT).value)
        reg.publish(_model(pkg, seed=2))
        assert reg.refresh(eng) == 2
        for i in range(3, 5):
            values.append(q.submit(_X(i), "predict").result(WAIT).value)
        q.emit_latency()
        q.stop()
        recs[pkg] = (tel.records, values)
    trecs, jrecs = recs["torch"][0], recs["jax"][0]
    _valid(trecs)
    assert_same(trecs, jrecs)
    for a, b in zip(recs["torch"][1], recs["jax"][1]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    served = [r for r in trecs if r["kind"] == "serve_request"]
    assert [r["generation"] for r in served] == [1, 1, 1, 2, 2]
    assert all(r["replica"] == 2 for r in served)
    assert [r.get("tenant") for r in served] == ["acme"] * 3 + [None] * 2


class _Stack:
    """One package's pipeline stack: a registry with a serving
    generation, its engine and queue, a canary and a promoter, each with
    the telemetry (the HEAD queue without, so every record comes from
    the calling thread or the shadow leg's one worker)."""

    def __init__(self, pkg, path):
        self.pkg = pkg
        serve = jserve if pkg == "jax" else tserve
        self.pipe = jpipeline if pkg == "jax" else tpipeline
        kw = {} if pkg == "jax" else {"device": "cpu"}
        self.tel = JTelemetry() if pkg == "jax" else TTelemetry()
        r = np.random.default_rng(5)
        self.Xv = r.normal(size=(96, D)).astype(np.float32)
        self.yv = (r.random(96) < 0.5).astype(np.float32)
        self.reg = serve.ModelRegistry(str(path), telemetry=self.tel, **kw)
        self.reg.publish(_model(pkg, seed=99))
        self.engine = serve.ServeEngine(
            self.reg.load_newest().model, generation=1, max_batch=8,
            min_bucket=4, **kw)
        self.reg.refresh(self.engine)
        self.queue = serve.MicroBatchQueue(self.engine).start()
        self.ctl = self.pipe.CanaryController(
            self.reg, self.engine, self.queue, telemetry=self.tel,
            holdout=(self.Xv, self.yv), slice_fraction=1.0,
            min_shadow_requests=2,
            thresholds={"p50_ms": 1e6, "p99_ms": 1e6},
            contention_check=lambda: False)
        self.log_loss = jlog_loss if pkg == "jax" else tlog_loss

    def holdout_loss(self, model):
        return float(self.log_loss(model.predict_proba(self.Xv), self.yv))

    def run(self, scenario):
        post_check = None
        override = None
        if scenario == "promoted":
            gen = self.reg.publish(_model(self.pkg, seed=99))
        elif scenario == "rejected":
            gen = self.reg.publish(_model(self.pkg, seed=3, scale=40.0))
        else:  # rolled_back: the canary is lied to, post_check sees it
            good = self.holdout_loss(self.reg.current.model)
            gen = self.reg.publish(_model(self.pkg, seed=3, scale=40.0))
            override = good

            def post_check(loaded):
                live = self.holdout_loss(loaded.model)
                ok = live <= good * 1.5
                return ok, "" if ok else "live loss regressed"
        try:
            self.ctl.start_canary(gen, epoch=1, quality_override=override)
            for i in range(4):
                self.ctl.submit(_X(i)).result(timeout=WAIT)
                # one shadow batch at a time: the records' order is fixed
                self.ctl._shadow_futures[-1].result(timeout=WAIT)
            report = self.ctl.finish_canary()
            decision = self.pipe.Promoter(
                self.reg, self.engine, telemetry=self.tel,
                post_check=post_check).decide(report)
        finally:
            self.queue.stop()
        return report, decision


@pytest.mark.parametrize("scenario", ["promoted", "rejected",
                                      "rolled_back"])
def test_canary_and_promotion_records_equal_jax(scenario, tmp_path):
    j = _Stack("jax", tmp_path / "jax")
    jrep, jdec = j.run(scenario)
    t = _Stack("torch", tmp_path / "torch")
    trep, tdec = t.run(scenario)
    assert tdec.decision == jdec.decision == scenario
    _valid(t.tel.records)
    # the held-out losses are each package's f32 log loss
    quality = {"quality_baseline": 1e-5, "quality_candidate": 1e-5,
               "quality_delta": 1e-4}
    assert_same(t.tel.records, j.tel.records, approx=quality,
                drop=("evidence",))
    assert tdec.record["evidence"]["verdict"] == \
        jdec.record["evidence"]["verdict"]
    kinds = [r["kind"] for r in t.tel.records]
    assert "canary" in kinds and "promotion" in kinds
    assert t.tel.records[kinds.index("canary")]["contention_flagged"] is \
        False
    if scenario == "rolled_back":
        assert [r for r in t.tel.records if r.get("action")
                == "rollback_generation"]


# ---------------------------------------------------------------------------
# flight dumps, either way


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_flight_dumps_are_read_by_the_other_package(writer, tmp_path):
    tel = TTelemetry() if writer == "torch" else JTelemetry()
    for i in range(5):
        tel.recovery(action="retry", attempt=i, source="drill")
    path = str(tmp_path / "flight.bin")
    assert tel.flight.dump(path, reason="drill") == path
    reader = jflight if writer == "torch" else tflight
    replay = reader.load_dump(path)
    assert [r["attempt"] for r in replay.records] == list(range(5))
    assert replay.torn_bytes == 0


def test_supervisor_giving_up_dumps_the_flight_ring(tmp_path):
    staged, px, rv, w0 = _problem("torch")
    tel = TTelemetry(flight_dir=str(tmp_path / "flight"))
    with pytest.raises(tres.SupervisorGivingUp):
        tres.run_agd_supervised(
            prox=px, reg_value=rv, w0=w0,
            config=tagd.AGDConfig(num_iterations=8), staged=staged,
            policy=tres.ResiliencePolicy(max_attempts=1, backoff_base=0.0,
                                         jitter=0.0, segment_iters=4),
            telemetry=tel,
            faults=tres.FaultScript(device_loss_at_iter=0))
    dumps = [r for r in tel.records if r.get("action") == "flight_dump"]
    assert len(dumps) == 1 and dumps[0]["reason"] == "supervisor_giving_up"
    replay = jflight.load_dump(dumps[0]["path"])
    assert [r["kind"] for r in replay.records].count("attempt") == 1


# the JAX ``obs`` package's names that wait for the profiling and analysis
# slice: the compiled-program introspection
OBS_NAMES_TO_PORT = {"introspect", "ProgramCost", "analyze",
                     "analyze_compiled", "analyze_runner",
                     "collective_census", "count_ops",
                     "environment_fingerprint"}


def test_obs_and_resilience_export_the_jax_names():
    import spark_agd_tpu.obs as jobs
    import spark_agd_tpu_torch.obs as tobs

    for jmod, tmod, waiting in ((jobs, tobs, OBS_NAMES_TO_PORT),
                                (jres, tres, set())):
        jnames = {n for n in dir(jmod) if not n.startswith("_")}
        missing = {n for n in jnames if not hasattr(tmod, n)}
        assert missing == waiting, missing
    assert tobs.Telemetry is ttelemetry.Telemetry


def _site_run(pkg, X, y, tel, **kw):
    """``api.run`` of ``pkg`` at f64 on the CPU."""
    from spark_agd_tpu import api as japi
    from spark_agd_tpu_torch import api as tapi

    if pkg == "jax":
        return japi.run((X, y), JLogistic(), JL2(), mesh=False,
                        initial_weights=np.zeros(D), telemetry=tel, **kw)
    return tapi.run((X, y), TLogistic(), TL2(), device="cpu",
                    initial_weights=np.zeros(D), telemetry=tel, **kw)


def _site_fit_kw():
    return dict(reg_param=0.01, num_iterations=8, convergence_tol=0.0)


def _site_records(site, pkg, tmp_path):
    """Run ``site``, one of the former ``telemetry=``/``journal=``
    refusals, through ``pkg`` with a fresh ``Telemetry``; its records,
    the registry, and what else the site's check reads."""
    from spark_agd_tpu import api as japi
    from spark_agd_tpu.data import ingest as jingest
    from spark_agd_tpu.parallel import mesh as jmesh
    from spark_agd_tpu.resilience import (degrade as jdegrade,
                                          distributed as jdist,
                                          journal as jjournal,
                                          scheduler as jsched)
    from spark_agd_tpu_torch import api as tapi
    from spark_agd_tpu_torch.data import ingest as tingest, libsvm
    from spark_agd_tpu_torch.parallel import mesh as tmesh
    from spark_agd_tpu_torch.resilience import (degrade as tdegrade,
                                                distributed as tdist,
                                                journal as tjournal,
                                                scheduler as tsched)

    jx = pkg == "jax"
    tel = JTelemetry() if jx else TTelemetry()
    X, y = _data(seed=5, n=120)
    work = tmp_path / pkg
    os.makedirs(work)
    extra = None
    if site == "run":
        extra = np.asarray(_site_run(pkg, X, y, tel, **_site_fit_kw())[1])
    elif site == "run_journal":
        path = str(work / "run.wal")
        res_mod = jres if jx else tres
        _site_run(pkg, X, y, tel, journal=path,
                  resilience=res_mod.ResiliencePolicy(segment_iters=4),
                  checkpointer=res_mod.AutoCheckpointer(
                      str(work / "c.npz"), every_iters=4, telemetry=tel),
                  **_site_fit_kw())
        extra = path
    elif site == "make_runner":
        mod = japi if jx else tapi
        kw = dict(mesh=False) if jx else dict(device="cpu")
        gradient, updater = ((JLogistic(), JL2()) if jx
                             else (TLogistic(), TL2()))
        fit = mod.make_runner((X, y), gradient, updater, telemetry=tel,
                              **_site_fit_kw(), **kw)
        fit(np.zeros(D))
        fit(np.full(D, 0.1))  # the same shape: no trace, no compile
    elif site == "run_lbfgs":
        for reg_prox in ((JL2(), TL2()), (jres_l1(), tres_l1())):
            if jx:
                japi.run_lbfgs((X, y), JLogistic(), reg_prox[0],
                               reg_param=0.01, num_iterations=10,
                               initial_weights=np.zeros(D), mesh=False,
                               telemetry=tel)
            else:
                tapi.run_lbfgs((X, y), TLogistic(), reg_prox[1],
                               reg_param=0.01, num_iterations=10,
                               initial_weights=np.zeros(D), device="cpu",
                               telemetry=tel)
    elif site == "from_partitioned_files":
        paths = []
        for k in range(3):
            p = str(work / f"part-{k}")
            libsvm.save_libsvm(p, X[40 * k:40 * (k + 1)].astype(np.float32),
                               y[40 * k:40 * (k + 1)])
            paths.append(p)
        with open(paths[2], "a") as f:
            f.write("1 1:nan\n")
        lib = jingest.libsvm if jx else tingest.libsvm
        failures = []

        def flaky(path, n_features=None):
            if path == paths[1] and not failures:
                failures.append(path)
                raise OSError("transient read error")
            return lib.load_libsvm(path, n_features=n_features)

        retries = (jres if jx else tres).RetryPolicy(
            max_attempts=3, backoff_base=0.0, jitter=0.0, seed=0)
        if jx:
            import jax

            m = jmesh.make_mesh({"data": 2}, devices=jax.devices()[:2])
            b = jingest.from_partitioned_files(
                paths, m, n_features=D, loader=flaky, retries=retries,
                validate="drop", telemetry=tel)
            extra = np.asarray(b.X).shape[0]
        else:
            m = tmesh.make_mesh({"data": 2}, devices=["cpu"] * 2)
            b = tingest.from_partitioned_files(
                paths, m, n_features=D, loader=flaky, retries=retries,
                validate="drop", telemetry=tel)
            extra = b.X.gather().shape[0]
    elif site in ("load_for_topology", "DistributedCheckpointer",
                  "load_degraded"):
        dist = jdist if jx else tdist
        staged, px, rv, w0 = _problem(pkg, seed=5)
        agd_mod = jagd if jx else tagd
        res_mod = jres if jx else tres

        def fit(iters, ck_tel):
            ck = dist.DistributedCheckpointer(
                str(work / "gens"), every_iters=4, keep=3,
                partitions=["p0", "p1"], telemetry=ck_tel)
            return res_mod.run_agd_supervised(
                prox=px, reg_value=rv, w0=w0,
                config=agd_mod.AGDConfig(num_iterations=iters,
                                         convergence_tol=0.0),
                policy=res_mod.ResiliencePolicy(segment_iters=4),
                checkpointer=ck, staged=staged, telemetry=ck_tel,
                stream_iterations=False)

        if site == "DistributedCheckpointer":
            fit(8, tel)  # two generations, each a commit span
            fit(12, tel)  # resumes from the newest: a resume record
        else:
            fit(8, None)
            m = (jres if jx else tres).manifest.load_manifest(
                str(work / "gens"))
            with open(m.shard_path(str(work / "gens"), 0), "r+b") as f:
                f.truncate(64)  # the newest generation, torn
            if site == "load_for_topology":
                extra = dist.load_for_topology(
                    str(work / "gens"), w0, process_index=1,
                    process_count=2, telemetry=tel).partitions
            else:
                deg = jdegrade if jx else tdegrade
                extra = deg.load_degraded(
                    str(work / "gens"), w0, surviving=[0],
                    telemetry=tel).dropped_partitions
    elif site == "StragglerScheduler":
        sched = jsched if jx else tsched

        def exchange(row):
            other = row.copy()
            other[1] = 400_000
            return np.stack([row, other])

        sc = sched.StragglerScheduler(
            [f"p{i:02d}" for i in range(8)],
            policy=sched.ReschedulePolicy(trigger_segments=2),
            process_index=0, process_count=2, exchange=exchange,
            telemetry=tel)
        for i in range(4):
            d = sc.after_segment(start_iter=4 * i, iters=4,
                                 boundary_s=0.0002)
            if d is not None:
                sc.apply(d)
        spec = sched.SpeculationResult(result=None, warm=_warm_of(pkg),
                                       seconds=0.5, from_iter=4, iters=4)
        sched.resolve_speculation(spec, _warm_of(pkg), fleet_seconds=1.0,
                                  straggler=1, telemetry=tel)
    return tel, extra


def jres_l1():
    from spark_agd_tpu.ops.prox import L1Prox

    return L1Prox()


def tres_l1():
    from spark_agd_tpu_torch.ops.prox import L1Prox

    return L1Prox()


def _warm_of(pkg):
    w = (jnp.arange(3.0) if pkg == "jax"
         else torch.arange(3.0, dtype=torch.float64))
    mod = jagd if pkg == "jax" else tagd
    return mod.AGDWarmState(x=w, z=w, theta=0.5, big_l=2.0, bts=True,
                            prior_iters=8)


# each former refusal, with the kinds its records must hold (in order,
# once the iterations are left out)
SITES = {
    "run": ["span", "span", "span", "span", "run"],
    "run_journal": None,
    "make_runner": ["span", "span", "span", "span", "span", "span"],
    "run_lbfgs": ["span", "span", "span", "span", "run"] * 2,
    "from_partitioned_files": ["recovery"],
    "load_for_topology": ["recovery", "recovery"],
    "DistributedCheckpointer": None,
    "load_degraded": ["recovery", "degraded", "recovery"],
    "StragglerScheduler": ["skew_estimate", "skew_estimate", "rebalance",
                           "recovery", "skew_estimate", "skew_estimate",
                           "recovery"],
}


@pytest.mark.parametrize("site", list(SITES))
def test_later_sites_still_raise_naming_their_slice(site, tmp_path):
    # the thirteen telemetry=/journal= refusals are gone: each site emits
    # the JAX package's records, in kind, order and non-timing fields
    mine, got = _site_records(site, "torch", tmp_path)
    theirs, want = _site_records(site, "jax", tmp_path)
    _valid(mine.records)
    # paths and exception texts name each package's own files
    assert_same(mine.records, theirs.records, approx=ITER_TOL,
                drop=("reason", "error", "shard"))
    kinds = [r["kind"] for r in mine.records if r["kind"] != "iteration"]
    if SITES[site] is not None:
        assert kinds == SITES[site], kinds
    if site == "run":
        assert [r["loss"] for r in mine.records
                if r["kind"] == "iteration"] == got.tolist()
    elif site == "run_journal":
        # each package's journal file is read by the other's replay
        for path in (got, want):
            a = [(r["kind"], r.get("action"))
                 for r in tjournal_replay(path)]
            b = [(r["kind"], r.get("action"))
                 for r in jjournal_replay(path)]
            assert a == b and ("recovery", "checkpoint") in a
    elif site == "make_runner":
        names = [r["name"] for r in mine.records if r["kind"] == "span"]
        assert names == ["h2d_transfer", "trace", "compile", "execute",
                         "h2d_transfer", "execute"]
    elif site == "from_partitioned_files":
        assert got == want == 120
        assert mine.registry.counter("data.invalid_records").value == 1
    elif site == "DistributedCheckpointer":
        # a closed commit span a generation, each holding its save's
        # recovery record; the second fit resumes from the first's last
        commits = [r for r in mine.records if r.get("name") == "ckpt_commit"
                   and r["kind"] == "span" and r["status"] != "open"]
        saves = [r for r in mine.records if r["kind"] == "recovery"
                 and r["source"] == "dist_ckpt" and r["action"] != "resume"]
        assert [r["generation"] for r in commits] == \
            [r["generation"] for r in saves] == list(range(len(saves)))
        resumes = [r for r in mine.records if r.get("action") == "resume"]
        assert len(resumes) == 1 and resumes[0]["to_iter"] == 8
    elif site == "load_for_topology":
        assert got == want == ("p1",)
    elif site == "load_degraded":
        assert got == want == ()


def tjournal_replay(path):
    from spark_agd_tpu_torch.resilience import journal

    return journal.replay(path).records


def jjournal_replay(path):
    from spark_agd_tpu.resilience import journal

    return journal.replay(path).records
