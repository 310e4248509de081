"""The port's multi-host resilience (``resilience/distributed.py``,
``degrade.py``, the supervisor's ``heartbeat=``/``monitor=``) against the
JAX package's, on the CPU.

Two simulated processes commit through a thread barrier in one process
(the ``ThreadExchange`` of ``tests/test_dist_resilience.py``): the port
refuses mixed-generation and diverged commits as JAX does, and refuses
the same torn, mixed and CRC-failed sets.  A generation set written by
either package resumes in the other, bit-equal at the same topology and
elastically on one process; the warm-state CRC is one number in both.
Heartbeat verdicts, the quorum matrix and the degraded loader agree on
the same files; a supervised f64 fit with a heartbeat, a monitor and a
scheduler follows JAX's step for step.  The ``dist_fault`` drill runs
two gloo processes (``tests/torch_multihost_child.py --drill``): one
SIGKILLs itself, the parent detects the loss from heartbeats, a torn
generation is refused, the elastic 1-process resume ends within 1e-6 of
the uninterrupted fit, and a degraded continuation on the survivor's
partitions is held to the same fit without a checkpointer."""

import dataclasses
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import unittest.mock as mock
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu.core import agd as jagd, smooth as jsmooth
from spark_agd_tpu.ops import losses as jlosses, prox as jprox
from spark_agd_tpu import resilience as jres
from spark_agd_tpu.resilience import (
    degrade as jdegrade,
    distributed as jdist,
    manifest as jmanifest,
)
from spark_agd_tpu.utils import checkpoint as jckpt
from spark_agd_tpu_torch import resilience as tres
from spark_agd_tpu_torch.core import agd, smooth as tsmooth
from spark_agd_tpu_torch.data import libsvm
from spark_agd_tpu_torch.ops import losses, prox
from spark_agd_tpu_torch.resilience import (
    DegradePolicy,
    DegradedCheckpointer,
    DistributedCheckpointer,
    HeartbeatWriter,
    HostLost,
    HostMonitor,
    QuorumLost,
    ResiliencePolicy,
    distributed,
    faults,
    load_degraded,
    load_for_topology,
    manifest,
    run_agd_supervised,
)
from spark_agd_tpu_torch.utils import checkpoint as ckpt
from torch_multihost_child import DRILL_ITERS, DRILL_SEGMENT, DRILL_WIDTH

ROOT = Path(__file__).resolve().parents[1]
CHILD = ROOT / "tests" / "torch_multihost_child.py"

# each package's multi-host pieces, to run one scenario through both
PORT = dict(Ckpt=DistributedCheckpointer, load=load_for_topology,
            manifest=manifest, faults=faults, AGDWarmState=agd.AGDWarmState,
            AGDConfig=agd.AGDConfig)
JAX = dict(Ckpt=jres.DistributedCheckpointer, load=jres.load_for_topology,
           manifest=jmanifest, faults=jres.faults,
           AGDWarmState=jagd.AGDWarmState, AGDConfig=jagd.AGDConfig)
PACKAGES = {"port": PORT, "jax": JAX}


def _carry(seed=0, d=4, prior_iters=3):
    """One f64 carry as host arrays: x, z, theta, L, bts, iterations."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(d), rng.standard_normal(d),
            float(rng.uniform(0.1, 1.0)), float(rng.uniform(1.0, 9.0)),
            True, prior_iters)


def _warm(pkg, carry):
    x, z, theta, big_l, bts, it = carry
    if pkg is PORT:
        x, z = torch.from_numpy(x.copy()), torch.from_numpy(z.copy())
    else:
        x, z = jnp.asarray(x), jnp.asarray(z)
    return pkg["AGDWarmState"](x=x, z=z, theta=theta, big_l=big_l, bts=bts,
                               prior_iters=it)


def _template(pkg, d=4):
    return (torch.zeros(d, dtype=torch.float64) if pkg is PORT
            else jnp.zeros(d))


class ThreadExchange:
    """A threading.Barrier stand-in for the all-gather barrier: N
    simulated processes block until all have given their row."""

    def __init__(self, n):
        self.n = n
        self._barrier = threading.Barrier(n, timeout=30)
        self._rows = {}

    def for_process(self, p):
        def exchange(row):
            self._rows[p] = np.asarray(row)
            self._barrier.wait()
            out = np.stack([self._rows[i] for i in range(self.n)])
            self._barrier.wait()  # hold the rows until everyone copied
            return out

        return exchange


def _concurrently(fns):
    """Run one callable a simulated process on threads; the exception
    each raised (None where it returned)."""
    errs = [None] * len(fns)

    def run(i):
        try:
            fns[i]()
        except Exception as e:  # noqa: BLE001 (handed to the test)
            errs[i] = e

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return errs


def _host(pkg, warm):
    """What each package's checkpointer hands ``_save``: the port's
    ``update`` copies the carry to the host first."""
    return ckpt.host_warm(warm) if pkg is PORT else warm


def _two_host_save(pkg, directory, carry, *, generations=1, keep=3,
                   fingerprint=None, warms=None, next_gen=None):
    """A concurrent 2-process barrier commit of ``generations`` saves in
    ``pkg``; the checkpointers and each process's exception."""
    ex = ThreadExchange(2)
    cks = [pkg["Ckpt"](
        str(directory), every_iters=1, keep=keep, fingerprint=fingerprint,
        mesh_shape={"data": 2}, partitions=[f"part-{p}", f"part-{p + 2}"],
        row_state={"rows": np.arange(p * 4, (p + 1) * 4)},
        process_index=p, process_count=2, exchange=ex.for_process(p))
        for p in (0, 1)]
    if next_gen is not None:
        cks[1]._next_generation = next_gen
    warms = warms or [_warm(pkg, carry)] * 2

    def saves(p):
        def run():
            for g in range(generations):
                w = warms[p]
                cks[p]._save(_host(pkg, w._replace(
                    prior_iters=int(w.prior_iters) + g)), [0.5, 0.4],
                    False, False)
        return run

    return cks, _concurrently([saves(0), saves(1)])


def _state(loaded):
    """A loaded generation as plain values, to compare across packages."""
    if loaded is None:
        return None
    w = loaded.warm
    return dict(x=np.asarray(w.x).tolist(), z=np.asarray(w.z).tolist(),
                scalars=(float(w.theta), float(w.big_l), bool(w.bts),
                         int(w.prior_iters)),
                dtype=str(np.asarray(w.x).dtype),
                hist=np.asarray(loaded.loss_history).tolist(),
                generation=loaded.generation,
                saved=loaded.saved_process_count, elastic=loaded.elastic,
                partitions=loaded.partitions,
                rows={k: v.tolist() for k, v in loaded.row_state.items()})


def _load_state(pkg, directory, p, n, fingerprint=None):
    return _state(pkg["load"](str(directory), _template(pkg),
                              process_index=p, process_count=n,
                              fingerprint=fingerprint))


# ---------------------------------------------------------------------------
# two processes committing through a thread barrier


@pytest.mark.parametrize("fault", ["mixed_generation", "divergence"])
def test_refused_commits_match_jax(tmp_path, fault):
    carry = _carry()
    out = {}
    for name, pkg in PACKAGES.items():
        directory = tmp_path / name
        kw = ({"next_gen": 5} if fault == "mixed_generation" else
              {"warms": [_warm(pkg, carry),
                         _warm(pkg, carry)._replace(big_l=999.0)]})
        _, errs = _two_host_save(pkg, directory, carry, **kw)
        out[name] = ([type(e).__name__ for e in errs],
                     pkg["manifest"].committed_generations(str(directory)))
        want = "mixed-generation" if fault == "mixed_generation" \
            else "divergence"
        assert all(want in str(e) for e in errs), errs
    assert out["port"] == out["jax"] == (["RuntimeError"] * 2, [])


@pytest.mark.parametrize("damage", ["torn", "crc", "missing", "mixed",
                                    "orphan", "all_torn"])
def test_damaged_sets_are_refused_as_jax_refuses_them(tmp_path, damage):
    """The same damage to the same generation set in both packages: each
    loader falls back to the same generation (or to nothing)."""
    carry = _carry(seed=1, prior_iters=2)
    got = {}
    for name, pkg in PACKAGES.items():
        directory = tmp_path / name
        _, errs = _two_host_save(pkg, directory, carry, generations=3)
        assert errs == [None, None]
        m = pkg["manifest"].load_manifest(str(directory))
        assert m.generation == 2
        newest = m.shard_path(str(directory), 1)
        if damage == "torn":
            pkg["faults"].truncate_file(newest, keep_fraction=0.4)
        elif damage == "crc":
            size = os.path.getsize(newest)
            pkg["faults"].scramble_file(newest, seed=3)
            os.truncate(newest, size)
        elif damage == "missing":
            os.unlink(newest)
        elif damage == "mixed":
            # generation 1's shard of process 1 under generation 2's name,
            # with the manifest's size and CRC rewritten to match it
            older = pkg["manifest"].load_manifest(str(directory), 1)
            shutil.copyfile(older.shard_path(str(directory), 1), newest)
            shards = list(m.shards)
            shards[1] = dataclasses.replace(
                shards[1], crc32=pkg["manifest"].crc32_file(newest),
                size=os.path.getsize(newest))
            pkg["manifest"].write_manifest(
                str(directory), dataclasses.replace(m, shards=shards))
        elif damage == "orphan":
            # a shard with no manifest: a process died before the barrier
            orphan = os.path.join(str(directory),
                                  pkg["manifest"].shard_name(3, 0))
            jckpt.atomic_savez(orphan, {"generation": np.asarray(3)})
        else:
            for g in (0, 1, 2):
                mg = pkg["manifest"].load_manifest(str(directory), g)
                pkg["faults"].truncate_file(mg.shard_path(str(directory), 0),
                                            keep_fraction=0.3)
        got[name] = [_load_state(pkg, directory, p, 2) for p in (0, 1)]
    # a mixed shard passes the manifest's checks: only the process that
    # reads it (process 1, at the same topology) meets its generation id
    want = {"orphan": [2, 2], "all_torn": [None, None],
            "mixed": [2, 1]}.get(damage, [1, 1])
    assert [None if st is None else st["generation"]
            for st in got["port"]] == want
    assert got["port"] == got["jax"]


def test_fingerprint_mismatch_raises_in_both(tmp_path):
    carry = _carry()
    for name, pkg in PACKAGES.items():
        _two_host_save(pkg, tmp_path / name, carry, fingerprint="problem-A")
        with pytest.raises(ValueError, match="different problem"):
            pkg["load"](str(tmp_path / name), _template(pkg),
                        process_index=0, process_count=2,
                        fingerprint="problem-B")


def test_gc_and_uncommitted_shards_match_jax(tmp_path):
    carry = _carry()
    for name, pkg in PACKAGES.items():
        _two_host_save(pkg, tmp_path / name, carry, generations=4, keep=2)
    names = [sorted(os.listdir(tmp_path / n)) for n in PACKAGES]
    assert names[0] == names[1]
    assert manifest.committed_generations(str(tmp_path / "port")) == [3, 2]


# ---------------------------------------------------------------------------
# interop: a set written by either package resumes in the other


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_a_generation_set_resumes_in_the_other_package(tmp_path, writer,
                                                       reader):
    carry = _carry(seed=2, prior_iters=7)
    wpkg, rpkg = PACKAGES[writer], PACKAGES[reader]
    fp = "logistic|f64|d=4"
    _, errs = _two_host_save(wpkg, tmp_path, carry, generations=2,
                             fingerprint=fp)
    assert errs == [None, None]
    for p in (0, 1):
        mine = _load_state(rpkg, tmp_path, p, 2, fp)
        theirs = _load_state(wpkg, tmp_path, p, 2, fp)
        assert mine == theirs  # bit-equal at the same topology
        assert mine["x"] == np.asarray(carry[0]).tolist()
        assert mine["dtype"] == "float64" and not mine["elastic"]
        assert mine["partitions"] == (f"part-{p}", f"part-{p + 2}")
    # elastically on one process, and re-split onto three
    for n in (1, 3):
        for p in range(n):
            mine = _load_state(rpkg, tmp_path, p, n, fp)
            assert mine == _load_state(wpkg, tmp_path, p, n, fp)
            assert mine["elastic"] and mine["saved"] == 2
    one = _load_state(rpkg, tmp_path, 0, 1, fp)
    assert one["partitions"] == ("part-0", "part-1", "part-2", "part-3")
    assert one["rows"]["rows"] == list(range(8))
    assert one["scalars"][3] == 8  # the newest generation: 7 + 1


def test_the_port_resumes_a_jax_set_into_its_supervisor(tmp_path):
    """A JAX 2-process set at generation g resumes through the port's
    DistributedCheckpointer on 2 processes (bit-equal carry, the cadence
    and generation counter seeded) and on 1 (elastic, the re-split
    partitions adopted for the next generation)."""
    carry = _carry(seed=4, prior_iters=5)
    _two_host_save(JAX, tmp_path, carry, generations=2)
    for n in (2, 1):
        ck = DistributedCheckpointer(str(tmp_path), every_iters=2,
                                     process_index=0, process_count=n)
        loaded = ck.load(_template(PORT))
        assert loaded.generation == 1 and ck._next_generation == 2
        assert torch.equal(loaded.warm.x, torch.from_numpy(carry[0]))
        assert ck._last_saved_iters == 6
        assert loaded.elastic == (n == 1)
        assert tuple(ck.partitions or ()) == (
            ("part-0", "part-1", "part-2", "part-3") if n == 1 else ())


def test_warm_crc_is_one_number_in_both_packages():
    for seed in range(4):
        carry = _carry(seed=seed, d=5, prior_iters=seed)
        mine = distributed._warm_crc(ckpt.host_warm(_warm(PORT, carry)))
        assert mine == jdist._warm_crc(_warm(JAX, carry))
        assert mine == distributed._warm_crc(_warm(PORT, carry))
    # and it sees a one-ulp change
    x, *rest = _carry()
    bumped = (np.nextafter(x, np.inf), *rest)
    assert distributed._warm_crc(ckpt.host_warm(_warm(PORT, bumped))) \
        != distributed._warm_crc(ckpt.host_warm(_warm(PORT, _carry())))


def test_save_timings_and_single_process_default_exchange(tmp_path):
    ck = DistributedCheckpointer(str(tmp_path), every_iters=1)
    assert (ck.process_index, ck.process_count) == (0, 1)
    warm = _warm(PORT, _carry())
    assert ck.update(warm, [0.3]) and ck.update(
        warm._replace(prior_iters=4), [0.3, 0.2])
    # one process: the second generation may still be in flight
    assert len(ck.save_seconds) == ck.saves == 2
    ck.wait()
    assert len(ck.write_seconds) == len(ck.commit_seconds) == 2
    assert manifest.committed_generations(str(tmp_path)) == [1, 0]
    assert load_for_topology(str(tmp_path), _template(PORT)).generation == 1


@pytest.mark.parametrize("drain", ["wait", "force", "flush", "load"])
def test_one_process_commits_on_a_writer_thread(tmp_path, drain):
    """On one process a save on cadence returns while its shard is still
    being written; a forced update, a flush, a load and ``wait`` return
    only once the generation is committed."""
    ck = DistributedCheckpointer(str(tmp_path), every_iters=1)
    warm = _warm(PORT, _carry())
    gate, real = threading.Event(), ckpt.atomic_savez

    def held_savez(path, payload):
        assert gate.wait(10.0)
        real(path, payload)

    with mock.patch.object(ckpt, "atomic_savez", held_savez):
        assert ck.update(warm, [0.3])
        assert manifest.committed_generations(str(tmp_path)) == []
        threading.Timer(0.2, gate.set).start()
        if drain == "wait":
            ck.wait()
        elif drain == "force":
            ck.update(warm._replace(prior_iters=4), [0.3, 0.2], force=True)
        elif drain == "flush":
            ck.flush()
        else:
            assert ck.load(_template(PORT)).generation == 0
    gens = manifest.committed_generations(str(tmp_path))
    assert gens == ([0] if drain in ("wait", "load") else [1, 0])
    assert len(ck.write_seconds) == len(ck.commit_seconds) == len(gens)


def test_a_failed_background_write_raises_at_the_next_save(tmp_path):
    ck = DistributedCheckpointer(str(tmp_path), every_iters=1)
    warm = _warm(PORT, _carry())

    def full_disk(path, payload):
        raise OSError(28, "No space left on device")

    with mock.patch.object(ckpt, "atomic_savez", full_disk):
        assert ck.update(warm, [0.3])  # the failure is in flight
        with pytest.raises(OSError, match="No space"):
            ck.update(warm._replace(prior_iters=4), [0.3, 0.2])
    assert manifest.committed_generations(str(tmp_path)) == []


def test_several_processes_save_on_the_callers_thread(tmp_path):
    """Over several processes the barrier is a collective on the fit's
    group, so the shard write and the commit stay on the caller's
    thread."""
    ex = ThreadExchange(2)
    cks = [DistributedCheckpointer(str(tmp_path), every_iters=1,
                                   process_index=p, process_count=2,
                                   exchange=ex.for_process(p))
           for p in range(2)]
    assert all(ck._writer is None for ck in cks)
    warm = _warm(PORT, _carry())
    assert _concurrently([lambda ck=ck: ck.update(warm, [0.3])
                          for ck in cks]) == [None, None]
    assert manifest.committed_generations(str(tmp_path)) == [0]
    assert [len(ck.commit_seconds) for ck in cks] == [1, 1]


# ---------------------------------------------------------------------------
# heartbeats


def test_heartbeat_verdicts_and_losses_match_jax(tmp_path):
    t = [100.0]
    writers = [HeartbeatWriter(str(tmp_path), process_index=p,
                               process_count=3, clock=lambda: t[0])
               for p in range(3)]
    writers[0].beat(iter=4, phase="segment")
    t[0] += 3.0
    writers[1].beat(iter=4, phase="slow")
    t[0] += 1.0
    writers[2].beat(iter=4)
    for p, w in enumerate(writers):
        rec = json.loads(Path(w.path).read_text())
        assert (rec["process"], rec["process_count"], rec["iter"]) \
            == (p, 3, 4)
    for kw in (dict(stale_after_s=5.0), dict(stale_after_s=5.0,
                                             slow_after_s=2.0),
               dict(stale_after_s=2.5, expected=[0, 2])):
        for dt in (0.0, 1.5, 2.0, 4.5, 8.0):
            now = t[0] + dt
            mine = HostMonitor(str(tmp_path), clock=lambda: now, **kw)
            theirs = jres.HostMonitor(str(tmp_path), clock=lambda: now,
                                      **kw)
            assert mine.verdicts() == theirs.verdicts()
            assert mine.lost_hosts() == theirs.lost_hosts()
            assert mine.slow_hosts() == theirs.slow_hosts()
            assert {p: r["age_s"] for p, r in mine.poll().items()} == {
                p: r["age_s"] for p, r in theirs.poll().items()}
            lost = mine.lost_hosts()
            if lost:
                with pytest.raises(HostLost) as ei:
                    mine.check()
                assert ei.value.process_index == lost[0]
            else:
                mine.check()
    assert HostMonitor(str(tmp_path / "none"), expected=[0]).poll() == {}
    with pytest.raises(ValueError, match="slow_after_s"):
        HostMonitor(str(tmp_path), stale_after_s=1.0, slow_after_s=2.0)
    # telemetry= is ported: a beat is a heartbeat record, and the first
    # loss of a process a host_lost record, once
    from spark_agd_tpu_torch.obs import Telemetry

    tel = Telemetry()
    HeartbeatWriter(str(tmp_path / "t"), process_index=2, process_count=3,
                    telemetry=tel).beat(iter=4, phase="segment")
    mon = HostMonitor(str(tmp_path / "t"), stale_after_s=1.0,
                      telemetry=tel, clock=lambda: time.time() + 60.0)
    for _ in range(2):
        with pytest.raises(HostLost):
            mon.check()
    assert [(r["kind"], r.get("process"), r.get("action"))
            for r in tel.records] == [("heartbeat", 2, None),
                                      ("recovery", 2, "host_lost")]


# ---------------------------------------------------------------------------
# quorum degradation


def test_quorum_matrix_matches_jax():
    for q, floor in ((0.5, 1), (0.75, 1), (0.5, 2), (1.0, 1)):
        for saved in (1, 2, 3, 4, 8):
            for alive in range(saved + 1):
                mine = DegradePolicy(q, floor).decide(saved, alive)
                assert mine == jdegrade.DegradePolicy(q, floor).decide(
                    saved, alive)
    assert [DegradePolicy().decide(s, a).allowed
            for s, a in ((2, 1), (4, 2), (4, 1), (8, 3))] \
        == [True, True, False, False]
    with pytest.raises(ValueError, match="min_quorum"):
        DegradePolicy(min_quorum=0.0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_load_degraded_matches_jax(tmp_path, writer):
    carry = _carry(seed=6, prior_iters=4)
    ex = ThreadExchange(4)
    pkg = PACKAGES[writer]
    cks = [pkg["Ckpt"](
        str(tmp_path), every_iters=1, partitions=[f"p{p}", f"p{p + 4}"],
        row_state={"rows": np.arange(3 * p, 3 * p + 3)},
        process_index=p, process_count=4, exchange=ex.for_process(p))
        for p in range(4)]
    warm = _warm(pkg, carry)
    assert _concurrently([
        lambda c=c: c._save(_host(pkg, warm), [0.9], False, False)
        for c in cks]) == [None] * 4
    # the dead process 3's shard is torn: a degraded resume must not care
    m = manifest.load_manifest(str(tmp_path))
    faults.truncate_file(m.shard_path(str(tmp_path), 3), keep_fraction=0.5)
    for survivors in ([0, 2], [1, 2], [0, 1, 2]):
        for p in survivors:
            mine = load_degraded(str(tmp_path), _template(PORT),
                                 surviving=survivors, process_index=p)
            theirs = jdegrade.load_degraded(
                str(tmp_path), _template(JAX), surviving=survivors,
                process_index=p)
            assert _state(mine.loaded) == _state(theirs.loaded)
            assert mine.decision == theirs.decision
            assert mine.dropped_partitions == theirs.dropped_partitions
    assert load_degraded(str(tmp_path), _template(PORT), surviving=[0, 2],
                         process_index=2).loaded.partitions == ("p2", "p6")
    with pytest.raises(QuorumLost):
        load_degraded(str(tmp_path), _template(PORT), surviving=[1])
    with pytest.raises(ValueError, match="not in"):
        load_degraded(str(tmp_path), _template(PORT), surviving=[0],
                      process_index=1)


def test_degraded_checkpointer_chains_its_own_generations(tmp_path):
    carry = _carry(seed=7, prior_iters=3)
    _two_host_save(JAX, tmp_path, carry)
    ck = DegradedCheckpointer(str(tmp_path), surviving=[1],
                              original_process_index=1, every_iters=1)
    assert (ck.process_index, ck.process_count) == (0, 1)
    loaded = ck.load(_template(PORT))
    assert ck.load(_template(PORT)) is loaded  # decided once
    assert ck.partitions == ["part-1", "part-3"]
    assert ck.dropped_partitions == ("part-0", "part-2")
    assert ck.last_decision.allowed
    ck._save(ckpt.host_warm(loaded.warm._replace(prior_iters=4)), [0.1],
             False, False)
    ck.wait()
    m = manifest.load_manifest(str(tmp_path))
    assert (m.generation, m.process_count, m.prior_iters) == (1, 1, 4)
    again = load_for_topology(str(tmp_path), _template(PORT))
    assert again.partitions == ("part-1", "part-3") and not again.elastic


# ---------------------------------------------------------------------------
# the supervisor with heartbeat=, monitor= and scheduler=


def _fit_data(n=240, d=3, seed=9):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ np.linspace(-1, 1, d))))
    return X, y.astype(np.float64)


def test_supervised_fit_with_heartbeat_monitor_scheduler_matches_jax(
        tmp_path):
    X, y = _fit_data()
    cfg_kw = dict(convergence_tol=0.0, num_iterations=14)
    pol_kw = dict(max_attempts=3, backoff_base=0.0, jitter=0.0, seed=0,
                  segment_iters=4)

    class LostOnce:
        """A monitor that loses a peer once, at the second boundary."""

        def __init__(self, exc):
            self.exc, self.calls = exc, 0

        def check(self):
            self.calls += 1
            if self.calls == 2:
                raise self.exc(1, "peer gone")

    def run(res_mod, build_staged, w0, cfg, pol, d):
        hb_dir = str(d / "hb")
        hb = res_mod.HeartbeatWriter(hb_dir, process_index=0,
                                     process_count=1)
        kw = {} if res_mod is tres else {"stream_iterations": False}
        out = res_mod.run_agd_supervised(
            prox=build_staged[1][0], reg_value=build_staged[1][1], w0=w0,
            config=cfg, policy=pol, staged=build_staged[0], heartbeat=hb,
            monitor=LostOnce(res_mod.HostLost),
            scheduler=res_mod.StragglerScheduler(
                ["a", "b"], process_index=0, process_count=1),
            checkpointer=res_mod.DistributedCheckpointer(
                str(d / "ck"), every_iters=4, process_index=0,
                process_count=1), **kw)
        last = json.loads(Path(hb.path).read_text())
        return out, hb.beats, last

    mine, beats, last = run(
        tres, (tsmooth.make_smooth_staged(losses.LogisticGradient(),
                                          torch.from_numpy(X),
                                          torch.from_numpy(y)),
               tsmooth.make_prox(prox.L2Prox(), 0.1)),
        torch.zeros(3, dtype=torch.float64), agd.AGDConfig(**cfg_kw),
        ResiliencePolicy(**pol_kw), tmp_path / "port")
    theirs, jbeats, jlast = run(
        jres, (jsmooth.make_smooth_staged(jlosses.LogisticGradient(),
                                          jnp.asarray(X), jnp.asarray(y)),
               jsmooth.make_prox(jprox.L2Prox(), 0.1)),
        jnp.zeros(3), jagd.AGDConfig(**cfg_kw),
        jres.ResiliencePolicy(**pol_kw), tmp_path / "jax")
    assert mine.num_iters == theirs.num_iters == 14
    assert mine.retries == theirs.retries == 1
    np.testing.assert_allclose(mine.loss_history, theirs.loss_history,
                               rtol=1e-9)
    np.testing.assert_allclose(mine.weights.numpy(),
                               np.asarray(theirs.weights), rtol=3e-7,
                               atol=1e-12)
    assert [(e["outcome"], e["failure_kind"], e["start_iter"])
            for e in mine.attempts] == [
        (e["outcome"], e["failure_kind"], e["start_iter"])
        for e in theirs.attempts]
    assert beats == jbeats and last["phase"] == jlast["phase"] == "exit"
    assert last["iter"] == 14
    assert sorted(os.listdir(tmp_path / "port" / "ck")) == sorted(
        os.listdir(tmp_path / "jax" / "ck"))


def test_a_distributed_checkpoint_resumes_a_supervised_fit_exactly(
        tmp_path):
    X, y = _fit_data(seed=10)
    staged = tsmooth.make_smooth_staged(
        losses.LogisticGradient(), torch.from_numpy(X), torch.from_numpy(y))
    px, rv = tsmooth.make_prox(prox.L2Prox(), 0.1)
    w0 = torch.zeros(3, dtype=torch.float64)
    cfg = agd.AGDConfig(convergence_tol=0.0, num_iterations=12)
    pol = ResiliencePolicy(backoff_base=0.0, jitter=0.0, seed=0,
                           segment_iters=4)
    plain = run_agd_supervised(prox=px, reg_value=rv, w0=w0, config=cfg,
                               policy=pol, staged=staged)
    fp = ckpt.problem_fingerprint(w0, cfg)

    def ck():
        return DistributedCheckpointer(str(tmp_path), every_iters=4,
                                       fingerprint=fp)

    run_agd_supervised(prox=px, reg_value=rv, w0=w0,
                       config=agd.AGDConfig(convergence_tol=0.0,
                                            num_iterations=8),
                       policy=pol, staged=staged, checkpointer=ck())
    res = run_agd_supervised(prox=px, reg_value=rv, w0=w0, config=cfg,
                             policy=pol, staged=staged, checkpointer=ck())
    assert res.resumed_from == 8 and res.num_iters == plain.num_iters
    assert torch.equal(res.weights, plain.weights)
    assert np.array_equal(res.loss_history, plain.loss_history)


# ---------------------------------------------------------------------------
# two gloo processes: a SIGKILL, heartbeats, a torn generation, elastic and
# degraded resumes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _drill_parts(part_dir, n_per=(40, 35, 45, 30), d=DRILL_WIDTH, seed=12):
    rng = np.random.default_rng(seed)
    w_true = np.linspace(-1.0, 1.0, d)
    paths = []
    for k, n in enumerate(n_per):
        X = rng.standard_normal((n, d))
        y = np.where(X @ w_true + 0.3 * rng.standard_normal(n) > 0, 1.0,
                     -1.0)
        paths.append(str(part_dir / f"part-{k}.libsvm"))
        libsvm.save_libsvm(paths[-1], X, y)
    return paths


def _spawn_drill(part_dir, work, tag, kill_at=None):
    port_no = _free_port()
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return [subprocess.Popen(
        [sys.executable, str(CHILD), f"localhost:{port_no}", "2", str(r),
         str(part_dir), "--drill", str(work / tag)]
        + ([f"--kill-at={kill_at}"] if kill_at is not None and r == 1
           else []),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(2)]


def _drill_problem(paths, n_iters):
    from spark_agd_tpu_torch.data import ingest
    from spark_agd_tpu_torch.parallel import dist_smooth, mesh as tmesh

    def staged_for(assignment=None):
        mesh = tmesh.make_mesh({"data": 2}, devices=["cpu"] * 2)
        batch = ingest.from_partitioned_files(
            paths, mesh, n_features=DRILL_WIDTH, dtype=np.float64,
            assignment=assignment)
        return dist_smooth.make_dist_smooth_staged(
            losses.LogisticGradient(), batch, mesh=mesh)

    px, rv = tsmooth.make_prox(prox.L2Prox(), 0.1)
    cfg = agd.AGDConfig(convergence_tol=0.0, num_iterations=n_iters)
    w0 = torch.zeros(DRILL_WIDTH, dtype=torch.float64)
    return staged_for, px, rv, w0, cfg


DRILL_KILL_AT = 12


@pytest.mark.dist_fault
def test_two_process_kill_detect_elastic_and_degraded_resume(tmp_path):
    part_dir = tmp_path / "parts"
    part_dir.mkdir()
    paths = _drill_parts(part_dir)
    base = _spawn_drill(part_dir, tmp_path, "base")
    killed = _spawn_drill(part_dir, tmp_path, "killed",
                          kill_at=DRILL_KILL_AT)
    try:
        rc = killed[1].wait(timeout=120)
        assert rc == -signal.SIGKILL, killed[1].stderr.read()[-3000:]
        # the parent tells the loss from the dead rank's heartbeat alone
        monitor = HostMonitor(str(tmp_path / "killed" / "hb"),
                              expected=[1], stale_after_s=1.0)
        lost, deadline = None, time.monotonic() + 30
        while lost is None and time.monotonic() < deadline:
            try:
                monitor.check()
                time.sleep(0.1)
            except HostLost as e:
                lost = e
        assert lost is not None and lost.process_index == 1
        assert json.loads((tmp_path / "killed" / "hb" /
                           "heartbeat.h001.json").read_text())["iter"] \
            == DRILL_KILL_AT
        # the survivor cannot finish: its next collective against the
        # dead peer fails (gloo sees the closed socket) or waits until
        # the parent reaps it
        if killed[0].poll() is None:
            killed[0].kill()
        out0, _ = killed[0].communicate(timeout=60)
        assert killed[0].returncode != 0 and "RESULT " not in out0
        outs = [p.communicate(timeout=120) for p in base]
        for p, (out, err) in zip(base, outs):
            assert p.returncode == 0, err[-3000:]
        results = [json.loads(next(
            ln for ln in out.splitlines() if ln.startswith("RESULT "))[7:])
            for out, _ in outs]
    finally:
        for p in base + killed:
            if p.poll() is None:
                p.kill()
            p.communicate()
    assert results[0]["hist"] == results[1]["hist"]  # ranks bit-equal
    base_hist = np.array([float.fromhex(v) for v in results[0]["hist"]])

    ck_dir = tmp_path / "killed" / "ck"
    gens = manifest.committed_generations(str(ck_dir))
    newest = manifest.load_manifest(str(ck_dir), gens[0])
    assert len(gens) >= 2 and newest.prior_iters == DRILL_KILL_AT
    shutil.copytree(ck_dir, tmp_path / "degraded_ck")
    faults.truncate_file(newest.shard_path(str(ck_dir), 0),
                         keep_fraction=0.4)
    older = manifest.load_manifest(str(ck_dir), gens[1])

    # elastic: one process resumes on all four parts
    staged_for, px, rv, w0, cfg = _drill_problem(paths, DRILL_ITERS)
    pol = ResiliencePolicy(backoff_base=0.0, jitter=0.0, seed=0,
                           segment_iters=DRILL_SEGMENT)
    fp = ckpt.problem_fingerprint(w0, cfg)
    ck = DistributedCheckpointer(str(ck_dir), every_iters=DRILL_SEGMENT,
                                 keep=4, fingerprint=fp)
    loaded = ck.load(w0)
    assert loaded.generation == older.generation and loaded.elastic
    assert loaded.partitions == tuple(sorted(paths))
    res = run_agd_supervised(prox=px, reg_value=rv, w0=w0, config=cfg,
                             policy=pol,
                             staged=staged_for(list(loaded.partitions)),
                             checkpointer=ck)
    assert res.resumed_from == older.prior_iters > 0
    assert res.num_iters == DRILL_ITERS == len(base_hist)
    np.testing.assert_allclose(res.loss_history, base_hist, rtol=1e-6)
    assert abs(res.loss_history[-1] - base_hist[-1]) <= 1e-6

    # degraded: rank 0 alone, on its own two parts, from generation g
    dck = DegradedCheckpointer(str(tmp_path / "degraded_ck"), surviving=[0],
                               every_iters=DRILL_SEGMENT, keep=4,
                               fingerprint=fp)
    dl = dck.load(w0)
    assert dl.generation == newest.generation
    assert dl.partitions == tuple(sorted(paths)[0::2])
    assert dck.dropped_partitions == tuple(sorted(paths)[1::2])
    staged = staged_for(list(dl.partitions))
    dres = run_agd_supervised(prox=px, reg_value=rv, w0=w0, config=cfg,
                              policy=pol, staged=staged, checkpointer=dck)
    sm, sl = staged[0](*staged[1])
    ref = agd.run_agd(sm, px, rv, w0, agd.AGDConfig(
        convergence_tol=0.0,
        num_iterations=DRILL_ITERS - dl.warm.prior_iters),
        smooth_loss=sl, warm=dl.warm)
    assert dres.resumed_from == DRILL_KILL_AT
    assert torch.equal(dres.weights, ref.weights)
    np.testing.assert_array_equal(
        dres.loss_history[DRILL_KILL_AT:],
        ref.loss_history[:int(ref.num_iters)].numpy())
