"""The port's replica fleet on the CPU, against numpy and the JAX package.

Real replica processes (``tests/torch_fleet_child.py``, each its own
interpreter) serve a small logistic model from a registry: three of the
port's and one of the JAX package's (``JAX_PLATFORMS=cpu``).
``discover_replicas`` finds the port's from their membership files; their
answers through the f32 JSON wire, directly and through a
``FleetRouter``, equal a numpy sigmoid at 1e-4; the port's
``ReplicaHandle`` gets the same answers from the JAX server as from the
port's, and the JAX package's handle from the port's server; a 4-row
request against ``max_queue_rows=2`` raises ``ServeOverloaded`` with its
counts intact across the wire; a publish hot-swaps every replica; and a
replica's ``kill_replica`` fault (a SIGKILL mid-request) costs no
admitted request.  Without processes: the fleet chaos draws equal JAX's
for three seeds, and ``before_request`` keeps a slowed replica's
heartbeat SLOW, never LOST.  Every wait has a timeout, and a ``finally``
kills and reaps every child."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_agd_tpu.resilience import chaos as jchaos
from spark_agd_tpu.resilience.errors import ServeOverloaded as JOverloaded
from spark_agd_tpu.serve import fleet as jfleet
from spark_agd_tpu_torch.models import glm as tglm
from spark_agd_tpu_torch.obs import Telemetry, schema
from spark_agd_tpu_torch.resilience import chaos
from spark_agd_tpu_torch.resilience.distributed import (HeartbeatWriter,
                                                        HostMonitor)
from spark_agd_tpu_torch.resilience.errors import ServeOverloaded
from spark_agd_tpu_torch.serve import (FleetRouter, ModelRegistry,
                                       ReplicaHandle, ReplicaServer,
                                       ServeEngine, discover_replicas)

pytestmark = pytest.mark.fleet

ROOT = Path(__file__).resolve().parents[1]
CHILD = str(ROOT / "tests" / "torch_fleet_child.py")
D = 8
START_S = 120.0   # a child's start, imports included
KILLED = 2        # the port replica with a kill_replica fault
KILL_AT = 5
JAX_REPLICA = 7


def _weights(seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=D) * 0.8).astype(np.float32), \
        float(r.normal()) * 0.3


def _model(seed):
    w, b = _weights(seed)
    return tglm.LogisticRegressionModel(torch.from_numpy(w), b)


def _ref(rows, seed):
    """The f64 sigmoid of the f32 rows the wire carries."""
    w, b = _weights(seed)
    z = np.asarray(rows, np.float32).astype(np.float64) @ \
        w.astype(np.float64) + b
    return 1.0 / (1.0 + np.exp(-z))


def _rows(i, n=5):
    return np.random.default_rng(1000 + i).normal(size=(n, D)).astype(
        np.float32)


def _start(tmp, package, fleet_dir, replica, *extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    log = open(tmp / f"child-{package}-{replica}.log", "w")
    proc = subprocess.Popen(
        [sys.executable, CHILD, "--package", package, "--fleet-dir",
         str(fleet_dir), "--registry", str(tmp / "registry"),
         "--replica", str(replica), *extra],
        stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))
    proc.log_path = log.name
    log.close()
    return proc


def _await(procs, fleet_dir, want):
    deadline = time.monotonic() + START_S
    while time.monotonic() < deadline:
        found = discover_replicas(str(fleet_dir))
        if set(want) <= set(found):
            return found
        for p in procs:
            if p.poll() is not None:
                raise AssertionError(
                    f"a replica exited early ({p.returncode}):\n"
                    + Path(p.log_path).read_text()[-3000:])
        time.sleep(0.1)
    raise AssertionError(f"replicas {sorted(want)} did not announce")


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    registry = ModelRegistry(str(tmp / "registry"), device="cpu")
    assert registry.publish(_model(1)) == 1
    port_dir, jax_dir = tmp / "port", tmp / "jax"
    procs = {}
    try:
        for r in (0, 1):
            procs[r] = _start(tmp, "torch", port_dir, r)
        procs[KILLED] = _start(tmp, "torch", port_dir, KILLED,
                               "--kill-at", str(KILL_AT))
        procs[JAX_REPLICA] = _start(tmp, "jax", jax_dir, JAX_REPLICA)
        _await(list(procs.values()), port_dir, (0, 1, KILLED))
        _await(list(procs.values()), jax_dir, (JAX_REPLICA,))
        yield dict(tmp=tmp, registry=registry, port_dir=port_dir,
                   jax_dir=jax_dir, procs=procs)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)


def test_discover_replicas_finds_the_port_replicas(fleet):
    found = discover_replicas(str(fleet["port_dir"]))
    assert sorted(found) == [0, 1, KILLED]
    for r, handle in found.items():
        assert isinstance(handle, ReplicaHandle)
        assert handle.pid == fleet["procs"][r].pid and handle.port > 0
    # a torn membership file is skipped, not fatal
    torn = fleet["port_dir"] / "replica.h099.json"
    torn.write_text("{\"port\": ")
    try:
        assert sorted(discover_replicas(str(fleet["port_dir"]))) == [
            0, 1, KILLED]
    finally:
        torn.unlink()


def test_answers_equal_a_numpy_sigmoid_through_the_wire(fleet):
    handles = discover_replicas(str(fleet["port_dir"]))
    for r in (0, 1):
        for i, n in enumerate((1, 3, 16)):
            rows = _rows(i, n)
            resp = handles[r].predict(rows, op="predict_proba")
            assert (resp["replica"], resp["generation"]) == (r, 1)
            np.testing.assert_allclose(resp["values"], _ref(rows, 1),
                                       rtol=1e-4)
    with FleetRouter({r: handles[r] for r in (0, 1)},
                     telemetry=Telemetry()) as router:
        for i in range(12):
            rows = _rows(10 + i, 1 + i % 4)
            res = router.request(rows, op="predict_proba", tenant="t")
            np.testing.assert_allclose(res.values, _ref(rows, 1),
                                       rtol=1e-4)
        assert sorted(router.stats.per_replica) == [0, 1]
        for rec in router.telemetry.records:
            assert schema.validate_record(rec) == []


def test_either_package_handle_talks_to_the_other_server(fleet):
    port_server = discover_replicas(str(fleet["port_dir"]))[0]
    jax_server = discover_replicas(str(fleet["jax_dir"]))[JAX_REPLICA]
    jax_handle = jfleet.ReplicaHandle(port_server.replica, port_server.port)
    rows = _rows(40, 6)
    answers = [h.predict(rows, op="predict_proba")
               for h in (port_server, jax_server, jax_handle)]
    assert [a["replica"] for a in answers] == [0, JAX_REPLICA, 0]
    for a in answers:
        np.testing.assert_allclose(a["values"], _ref(rows, 1), rtol=1e-4)
    np.testing.assert_allclose(answers[1]["values"], answers[0]["values"],
                               rtol=1e-6)
    labels = jax_server.predict(rows, op="predict")["values"]
    assert labels == [float(p >= 0.5) for p in _ref(rows, 1)]


def test_overload_is_typed_with_its_counts_across_the_wire(tmp_path):
    engine = ServeEngine(_model(1), generation=1, max_batch=16,
                         min_bucket=4, device="cpu")
    with ReplicaServer(str(tmp_path), 4, engine, max_queue_rows=2) as srv:
        for handle in (discover_replicas(str(tmp_path))[4],
                       jfleet.ReplicaHandle(4, srv.port)):
            # each package's handle raises its own package's type
            with pytest.raises((ServeOverloaded, JOverloaded)) as ei:
                handle.predict(_rows(0, 4), timeout=10.0)
            assert (ei.value.queued_rows, ei.value.limit_rows) == (4, 2)
        ok = discover_replicas(str(tmp_path))[4].predict(_rows(1, 2))
        assert ok["generation"] == 1 and len(ok["values"]) == 2
    # a clean stop is a leave: membership and heartbeat files are gone
    assert discover_replicas(str(tmp_path)) == {}
    assert not [f for f in os.listdir(tmp_path) if f.startswith("heart")]


def test_a_publish_hot_swaps_every_replica(fleet):
    assert fleet["registry"].publish(_model(2)) == 2
    handles = {**discover_replicas(str(fleet["port_dir"])),
               **discover_replicas(str(fleet["jax_dir"]))}
    rows = _rows(50, 4)
    deadline = time.monotonic() + 30.0
    pending = {0, 1, JAX_REPLICA}
    while pending and time.monotonic() < deadline:
        for r in sorted(pending):
            resp = handles[r].predict(rows, op="predict_proba")
            if resp["generation"] == 2:
                np.testing.assert_allclose(resp["values"], _ref(rows, 2),
                                           rtol=1e-4)
                pending.discard(r)
        time.sleep(0.05)
    assert not pending, pending


def test_a_killed_replica_costs_no_admitted_request(fleet):
    """The last test of the module: replica KILLED SIGKILLs itself at its
    KILL_AT-th request; the router evicts it and retries on a survivor."""
    handles = discover_replicas(str(fleet["port_dir"]))
    tel = Telemetry()
    monitor = HostMonitor(str(fleet["port_dir"]), stale_after_s=4.0,
                          slow_after_s=1.5)
    answered, errors = [], []
    lock = threading.Lock()
    with FleetRouter(handles, monitor=monitor, telemetry=tel,
                     request_timeout_s=20.0) as router:
        def client(c):
            for i in range(15):
                rows = _rows(100 + 15 * c + i, 1 + i % 5)
                try:
                    res = router.request(rows, op="predict_proba")
                except Exception as e:  # noqa: BLE001 — a check below
                    with lock:
                        errors.append(repr(e))
                    continue
                good = np.allclose(res.values, _ref(rows, res.generation),
                                   rtol=1e-4)
                with lock:
                    answered.append((res.replica, good))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        stats = router.stats
    assert fleet["procs"][KILLED].wait(timeout=30) == -signal.SIGKILL
    assert not errors, errors[:3]
    assert len(answered) == 45 and all(good for _, good in answered)
    assert stats.evictions == 1 and stats.retries >= 1
    assert KILLED not in router.members
    actions = [r["action"] for r in tel.records if r["kind"] == "recovery"]
    assert actions.count("replica_evict") == 1
    assert "request_retry" in actions
    # the kill is on the replica's own record, flushed before the SIGKILL
    recs = schema.read_jsonl(str(fleet["port_dir"]
                                 / f"records.h{KILLED:03d}.jsonl"))
    kills = [r for r in recs if r.get("kind") == "chaos"]
    assert [(r["fault"], r["fired_iter"]) for r in kills] == [
        ("kill_replica", KILL_AT)]
    assert all(r.get("replica") == KILLED for r in recs
               if r.get("kind") == "serve_request")
    for rec in recs + tel.records:
        assert schema.validate_record(rec) == []


# ---------------------------------------------------------------------------
# the replica chaos kinds, in process


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_fleet_campaigns_draw_the_jax_faults(seed):
    for kw in (dict(), dict(requests=200, replica_count=4, max_faults=3,
                            p_kill=0.2)):
        mine = chaos.ChaosCampaign.generate_fleet(seed, **kw)
        theirs = jchaos.ChaosCampaign.generate_fleet(seed, **kw)
        assert mine.describe() == theirs.describe()
        assert [dataclasses.astuple(f) for f in mine.faults] == [
            dataclasses.astuple(f) for f in theirs.faults]
        for replica in range(mine.process_count):
            fired = []
            for camp, out in ((mine, []), (theirs, [])):
                sched = camp.schedule_for_replica(
                    replica, sleep=lambda s, o=out: o.append(round(s, 12)))
                for i in range(1, 40):
                    if [f for f in sched._replica_pending
                            if f.kind == "kill_replica"
                            and f.at_iter <= i]:
                        break  # the kill would end this process
                    sched.before_request(i)
                fired.append((sched.fired, out))
            assert fired[0] == fired[1]
    with pytest.raises(ValueError, match="survivor"):
        chaos.ChaosCampaign.generate_fleet(seed, replica_count=1)


def test_a_slowed_replica_reads_slow_never_lost(tmp_path):
    hb = HeartbeatWriter(str(tmp_path), process_index=1, process_count=2)
    hb.beat(phase="serve")
    monitor = HostMonitor(str(tmp_path), stale_after_s=0.3,
                          slow_after_s=0.1)
    seen = []
    sched = chaos.ChaosSchedule(
        [chaos.ScheduledFault("slow_replica", at_iter=2, payload=0.6,
                              persist=True)],
        sleep=lambda s: (time.sleep(s), seen.append(
            monitor.verdicts()[1])), beat_interval_s=0.05)
    sched.bind_heartbeat(hb)
    sched.before_request(1)
    assert seen == []
    sched.before_request(2)   # 0.6 s of sleep, past the stale window
    assert seen and set(seen) == {"slow"}
    assert [k for k, _ in sched.fired] == ["slow_replica"]
    assert json.loads(Path(hb.path).read_text())["phase"] == "slow"
