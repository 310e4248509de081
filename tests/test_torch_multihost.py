"""Meshes across processes in the port (``parallel/multihost.py``, the
partitioned ingest) on the CPU.

The launcher-marker and ``initialize`` cases of ``tests/test_multihost.py``
in torch's terms (torchrun's variables are markers too; a bare call in one
process is a no-op; a group that cannot form raises), and a real
2-process gloo run: each rank reads its round-robin half of the partition
files (``from_partitioned_files`` and ``from_partitioned_files_csr``) onto
a 4-slot mesh across the two processes and fits AGD; the ranks' histories
and weights must be bit-equal, and held to the JAX package's one-process
fit on all files at f64 (the same iteration, backtrack and restart
counts, histories within 1e-9, weights within 3e-7)."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from spark_agd_tpu import api as japi
from spark_agd_tpu.data import ingest as jingest, libsvm as jlibsvm
from spark_agd_tpu.ops import losses as jlosses, prox as jprox
from spark_agd_tpu.parallel import mesh as jmesh
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.data import ingest as tingest
from spark_agd_tpu_torch.parallel import mesh as tmesh
from spark_agd_tpu_torch.parallel import multihost as mh

ROOT = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).with_name("torch_multihost_child.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write_parts(tmp_path, rng, sizes=(13, 7, 10, 5, 9, 6, 11, 8)):
    d = 9
    for k, n in enumerate(sizes):
        X = (rng.random((n, d)) * (rng.random((n, d)) < 0.5)).astype(
            np.float32)
        X[0, -1] = 0.3  # width evidence in every part
        y = np.where(rng.random(n) < 0.5, 1.0, -1.0)
        jlibsvm.save_libsvm(str(tmp_path / f"part-{k}.libsvm"), X, y)
    return sorted(str(p) for p in tmp_path.glob("part-*.libsvm"))


class TestLauncherMarkers:
    @pytest.mark.parametrize("env_patch", [
        {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234"},
        {"SLURM_NTASKS": "4"},
        {"OMPI_COMM_WORLD_SIZE": "2"},
        {"TPU_WORKER_HOSTNAMES": "host0,host1"},
        {"WORLD_SIZE": "2", "RANK": "1"},
        {"TORCHELASTIC_RUN_ID": "job7"},
    ], ids=lambda e: next(iter(e)))
    def test_markers_and_a_bare_call_under_a_launcher(self, monkeypatch,
                                                      env_patch):
        for k in ("MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env_patch.items():
            monkeypatch.setenv(k, v)
        assert mh.launcher_markers() == [next(iter(env_patch))]
        # no group can form from this environment: it raises, naming it
        with pytest.raises(RuntimeError, match="launcher environment"):
            mh.initialize()
        assert not mh.is_initialized()
        # a mesh built without initialize() would hold one process alone
        with pytest.raises(RuntimeError, match="initialize"):
            tmesh.make_mesh(devices=["cpu"] * 2)

    def test_what_is_not_a_marker(self, monkeypatch):
        assert mh.launcher_markers() == []
        monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "localhost")
        monkeypatch.setenv("WORLD_SIZE", "1")
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("TORCHELASTIC_RUN_ID", "none")  # one process
        monkeypatch.setenv("NPROC", "8")
        assert mh.launcher_markers() == []

    def test_single_process_helpers(self):
        mh.initialize()  # nothing to join: a no-op
        assert not mh.is_initialized()
        assert (mh.process_count(), mh.process_index()) == (1, 0)
        assert mh.is_primary_host() and mh.process_tag() == ""
        assert mh.host_suffixed("run.jsonl") == "run.jsonl"
        assert mh.process_local_rows(1000) == slice(0, 1000)
        assert mh.local_rows_slice(10, 2, 3) == slice(8, 10)
        assert mh.rank_among([5, 2, 9], 9) == 2
        with pytest.raises(ValueError, match="not among"):
            mh.rank_among([1, 2], 3)
        np.testing.assert_array_equal(mh.process_allgather_int64([3, 4]),
                                      [[3, 4]])
        with pytest.raises(ValueError, match="non-negative"):
            mh.process_allgather_int64([-1])
        m = mh.make_hybrid_mesh({"data": 2}, {"data": 2},
                                devices=["cpu"] * 4)
        assert m.shape == {"data": 4} and m.process_count == 1

    def test_explicit_arguments_are_checked(self):
        with pytest.raises(ValueError, match="rank 2 of 2"):
            mh.initialize("localhost:9", 2, 2)
        with pytest.raises(ValueError, match="coordinator_address"):
            mh.initialize(None, 2, 0)

    def test_a_group_that_cannot_form_raises(self):
        # rank 1 of 2 waiting for a coordinator nobody runs, with a short
        # timeout: the call raises instead of degrading to one process
        code = (
            "import datetime, sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from spark_agd_tpu_torch.parallel import multihost as mh\n"
            "try:\n"
            f"    mh.initialize('localhost:{_free_port()}', 2, 1,\n"
            "                  backend='gloo', device='cpu',\n"
            "                  timeout=datetime.timedelta(seconds=3))\n"
            "except RuntimeError as e:\n"
            "    print('RAISED', 'init_process_group' in str(e),\n"
            "          mh.is_initialized())\n")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=60)
        assert "RAISED True False" in out.stdout, out.stderr[-2000:]


def test_single_process_ingest_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    paths = _write_parts(tmp_path, rng)
    jm = jmesh.make_mesh({"data": 3}, devices=jax.devices()[:3])
    tm = tmesh.make_mesh({"data": 3}, devices=["cpu"] * 3)
    jb = jingest.from_partitioned_files(paths, jm)
    tb = tingest.from_partitioned_files(paths, tm)
    np.testing.assert_array_equal(tb.X.gather().numpy(), np.asarray(jb.X))
    np.testing.assert_array_equal(tb.y.gather().numpy(), np.asarray(jb.y))
    jc = jingest.from_partitioned_files_csr(paths, jm)
    tc = tingest.from_partitioned_files_csr(paths, tm)
    for name in ("row_ids", "col_ids", "values", "csc_row_ids",
                 "csc_col_ids", "csc_values"):
        np.testing.assert_array_equal(getattr(tc.X, name).numpy(),
                                      np.asarray(getattr(jc.X, name)))
    np.testing.assert_array_equal(tc.mask.gather().numpy(),
                                  np.asarray(jc.mask))
    assert tingest.local_partitions(paths[::-1]) == paths
    with pytest.raises(ValueError, match="no partition files"):
        tingest.from_partitioned_files([], tm)
    # telemetry= is ported: a read that needs no retry records nothing
    from spark_agd_tpu_torch.obs import Telemetry

    tel = Telemetry()
    again = tingest.from_partitioned_files(paths, tm, telemetry=tel)
    assert torch.equal(again.X.gather(), tb.X.gather())
    assert tel.records == []
    bad = tmp_path / "part-bad.libsvm"
    bad.write_text("1 1:nan\n")
    with pytest.raises(tingest.libsvm.DataValidationError):
        tingest.from_partitioned_files([str(bad)], tm, n_features=9,
                                       validate="raise")
    kept = tingest.from_partitioned_files(
        [str(bad), paths[0]], tm, n_features=9, validate="drop")
    assert kept.X.shape[0] >= 13


def _jax_fit(batch):
    return japi.run(batch, jlosses.LogisticGradient(), jprox.L2Prox(),
                    reg_param=0.05, num_iterations=10, convergence_tol=1e-12,
                    initial_weights=np.zeros(9), return_result=True)


def _run_ranks(part_dir, *extra):
    """Both ranks of the child, each under a timeout; their RESULT
    objects in rank order."""
    port_no = _free_port()
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen(
        [sys.executable, str(CHILD), f"localhost:{port_no}", "2", str(r),
         str(part_dir), *extra], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            p.kill()
    results = []
    for rc, out, err in outs:
        assert rc == 0, f"child failed (rc={rc}):\n{err[-3000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        results.append(json.loads(line[0][len("RESULT "):]))
    return results


def test_two_process_gloo_fit_matches_jax_and_ranks_agree(tmp_path):
    rng = np.random.default_rng(11)
    paths = _write_parts(tmp_path, rng)
    results = _run_ranks(tmp_path)
    r0, r1 = results
    assert (r0["rank"], r1["rank"]) == (0, 1)
    for kind in ("dense", "csr"):
        assert r0[kind] == r1[kind], kind  # bit-equal on both ranks

    # the JAX package's one-process fit on all eight files
    jm = jmesh.make_mesh({"data": 4}, devices=jax.devices()[:4])
    for kind, batch in (
            ("dense", jingest.from_partitioned_files(paths, jm,
                                                     n_features=9)),
            ("csr", jingest.from_partitioned_files_csr(paths, jm,
                                                       n_features=9))):
        jw, jh, jr = _jax_fit(batch)
        got = r0[kind]
        assert got["iters"] == int(jr.num_iters)
        assert got["backtracks"] == int(jr.num_backtracks)
        assert got["restarts"] == int(jr.num_restarts)
        hist = np.array([float.fromhex(v) for v in got["hist"]])
        w = np.array([float.fromhex(v) for v in got["w"]])
        np.testing.assert_allclose(hist, jh, rtol=1e-9)
        np.testing.assert_allclose(w, np.asarray(jw), rtol=3e-7, atol=1e-12)
    # the same fit in one process of the port, on all files
    tm = tmesh.make_mesh({"data": 4}, devices=["cpu"] * 4)
    tw, th = port.run(tingest.from_partitioned_files(paths, tm,
                                                     n_features=9),
                      port.LogisticGradient(), port.L2Prox(),
                      reg_param=0.05, num_iterations=10,
                      convergence_tol=1e-12, initial_weights=np.zeros(9))
    np.testing.assert_allclose(
        np.array([float.fromhex(v) for v in r0["dense"]["hist"]]), th,
        rtol=1e-12)


def test_a_rank_past_the_last_row_joins_with_zero_sums(tmp_path):
    """3 rows over 2 ranks x 4 slots: rank 1's slots all lie past the last
    row.  It joins each collective with zero sums instead of leaving rank
    0 waiting, in memory and for a streamed tail batch of 3 rows; both
    fits held to the JAX package's on 8 virtual devices, the ranks
    bit-equal.  So does a class-sharded softmax evaluation of 2 rows over
    {data: 4, model: 2}, held to the same evaluation on one process; with
    no rows on any rank it raises on every rank."""
    from spark_agd_tpu.core import agd as jagd, host_agd as jhost
    from spark_agd_tpu.core import smooth as jsmooth
    from spark_agd_tpu.data import streaming as jstream

    from spark_agd_tpu_torch.parallel import dist_smooth as tdist

    rng = np.random.default_rng(5)
    X = rng.standard_normal((11, 5))
    y = (rng.random(11) < 1 / (1 + np.exp(-X[:, 0]))).astype(np.float64)
    labels = rng.integers(0, 3, 11)
    W = rng.standard_normal((5, 3)) / 3
    np.savez(tmp_path / "tail.npz", X=X, y=y, labels=labels, W=W)
    r0, r1 = _run_ranks(tmp_path, "cpu", "--tail")
    assert (r0["rank"], r1["rank"]) == (0, 1)
    for kind in ("memory", "stream", "class_sharded"):
        assert r0[kind] == r1[kind], kind
    # the class-sharded evaluation on one process with the same mesh shape
    f, g = tdist.make_dist_smooth(
        port.SoftmaxGradient(3), X[:2], labels[:2],
        mesh=tmesh.make_mesh({"data": 4, "model": 2}, devices=["cpu"] * 8),
        mode="auto")[0](torch.from_numpy(W))
    for r in (r0, r1):
        assert "empty, on every rank" in r["class_sharded_empty"]
    got = r0["class_sharded"]
    np.testing.assert_allclose(float.fromhex(got["f"][0]), float(f),
                               rtol=1e-12)
    np.testing.assert_allclose([float.fromhex(v) for v in got["g"]],
                               g.numpy().reshape(-1), rtol=1e-11,
                               atol=1e-15)

    jm = jmesh.make_mesh({"data": 8}, devices=jax.devices()[:8])
    jw, jh, jr = japi.run(jmesh.shard_batch(jm, X[:3], y[:3]),
                          jlosses.LogisticGradient(), jprox.L2Prox(),
                          reg_param=0.05, num_iterations=10,
                          convergence_tol=1e-12, initial_weights=np.zeros(5),
                          return_result=True)
    ds = jstream.StreamingDataset.from_arrays(X, y, 8)
    sm, sl = jstream.make_streaming_smooth(jlosses.LogisticGradient(), ds,
                                           mesh=jm)
    px, rv = jsmooth.make_prox(jprox.L2Prox(), 0.05)
    js = jhost.run_agd_host(sm, px, rv, np.zeros(5),
                            jagd.AGDConfig(num_iterations=10,
                                           convergence_tol=1e-12),
                            smooth_loss=sl)
    for kind, (w, h, r) in (("memory", (jw, jh, jr)),
                            ("stream", (js.weights, js.loss_history, js))):
        got = r0[kind]
        assert (got["iters"], got["backtracks"], got["restarts"]) == (
            int(r.num_iters), int(r.num_backtracks), int(r.num_restarts))
        np.testing.assert_allclose([float.fromhex(v) for v in got["hist"]],
                                   np.asarray(h), rtol=1e-9)
        np.testing.assert_allclose([float.fromhex(v) for v in got["w"]],
                                   np.asarray(w), rtol=3e-7, atol=1e-12)
