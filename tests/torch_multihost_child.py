"""Child program of the port's 2-process test
(tests/test_torch_multihost.py): one rank of a gloo group on the CPU.

It joins the group, builds a 4-slot mesh across the two processes (two
CPU slots each), reads its round-robin half of the partition files
(dense and sparse), fits AGD over each batch and prints one JSON line
with its histories and weights as hex floats, so the parent can hold the
ranks bit-equal and the fit to the JAX package's one-process run.

With ``--tail`` it fits ``PART_DIR/tail.npz`` instead, over an 8-slot
mesh (four slots a rank) where the batch is too short to reach the last
rank's slots: its 3 rows in memory (``shard_batch``), and its 11 rows
streamed in batches of 8 (``make_streaming_smooth(mesh=)``, a tail batch
of 3), and one class-sharded softmax evaluation of its first 2 rows
over a {data: 4, model: 2} mesh.  The rank that holds no rows joins every
collective with zero sums.

With ``--drill WORK`` it runs one rank of the multi-host resilience drill
(``tests/test_torch_dist_resilience.py``): an f64 supervised fit over
its round-robin half of ``PART_DIR/part-*.libsvm`` (a 4-slot mesh), a
``DistributedCheckpointer`` committing every segment into ``WORK/ck`` and
a ``HeartbeatWriter`` beating into ``WORK/hb``; with ``--kill-at=N`` the
rank SIGKILLs itself at the boundary of iteration N.

With ``--sharded`` it fits the dense partitioned batch with the sharded
weight update (``run(sharded_update=True)``) and prints the rank's census
of collectives (``multihost.census``) beside the fit.

Usage: python torch_multihost_child.py ADDR NPROC RANK PART_DIR [DEVICE]
       [--tail | --sharded | --drill WORK [--kill-at=N]]
"""

import datetime
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _hex(a):
    return [float(v).hex() for v in np.asarray(a, np.float64).reshape(-1)]


def _tail_fits(port, mesh_lib, part_dir, device, nproc):
    """The ``--tail`` fits: 3 rows in memory and 11 rows streamed in
    batches of 8, over four slots a rank."""
    from spark_agd_tpu_torch.core import agd, host_agd, smooth
    from spark_agd_tpu_torch.data import streaming

    data = np.load(os.path.join(part_dir, "tail.npz"))
    X, y = data["X"], data["y"]
    mesh = mesh_lib.make_mesh({"data": 4 * nproc}, devices=[device] * 4)
    d = X.shape[1]
    w, h, r = port.run(mesh_lib.shard_batch(mesh, X[:3], y[:3]),
                       port.LogisticGradient(), port.L2Prox(),
                       reg_param=0.05, num_iterations=10,
                       convergence_tol=1e-12, initial_weights=np.zeros(d),
                       return_result=True)
    out = {"memory": dict(hist=_hex(h), w=_hex(w.cpu()),
                          iters=int(r.num_iters),
                          backtracks=int(r.num_backtracks),
                          restarts=int(r.num_restarts))}
    ds = streaming.StreamingDataset.from_arrays(X, y, 8)
    sm, sl = streaming.make_streaming_smooth(port.LogisticGradient(), ds,
                                             mesh=mesh)
    px, rv = smooth.make_prox(port.L2Prox(), 0.05)
    r = host_agd.run_agd_host(
        sm, px, rv, torch.zeros(d, dtype=torch.float64, device=device),
        agd.AGDConfig(num_iterations=10, convergence_tol=1e-12),
        smooth_loss=sl)
    out["stream"] = dict(hist=_hex(r.loss_history), w=_hex(r.weights.cpu()),
                         iters=int(r.num_iters),
                         backtracks=int(r.num_backtracks),
                         restarts=int(r.num_restarts))
    # the class-sharded softmax (mode="auto" on a model axis): 2 rows over
    # {data: 2 a rank, model: 2}, so rank 1's data slots hold none
    from spark_agd_tpu_torch.parallel import dist_smooth

    tp = mesh_lib.make_mesh({"data": 2 * nproc, "model": 2},
                            devices=[device] * 4)
    f, g = dist_smooth.make_dist_smooth(
        port.SoftmaxGradient(3), X[:2], data["labels"][:2], mesh=tp,
        mode="auto")[0](torch.from_numpy(data["W"]).to(device))
    out["class_sharded"] = dict(f=_hex(f), g=_hex(g.cpu()))
    try:  # no rows on any rank: every rank raises, none returns NaN
        dist_smooth.make_dist_smooth(
            port.SoftmaxGradient(3), X[:0], data["labels"][:0], mesh=tp,
            mode="auto")[0](torch.from_numpy(data["W"]).to(device))
        out["class_sharded_empty"] = "returned"
    except ValueError as e:
        out["class_sharded_empty"] = str(e)
    return out


# the drill's fit: iterations, segment (= checkpoint cadence) and width
DRILL_ITERS, DRILL_SEGMENT, DRILL_WIDTH = 24, 3, 5


def _drill(part_dir, work, kill_at):
    """One rank of the resilience drill (module docstring)."""
    from spark_agd_tpu_torch.core import agd, smooth
    from spark_agd_tpu_torch.data import ingest
    from spark_agd_tpu_torch.ops import losses, prox
    from spark_agd_tpu_torch.parallel import dist_smooth, mesh as mesh_lib
    from spark_agd_tpu_torch import resilience
    from spark_agd_tpu_torch.utils import checkpoint as ckpt

    paths = sorted(glob.glob(os.path.join(part_dir, "part-*.libsvm")))
    mesh = mesh_lib.make_mesh({"data": 4}, devices=["cpu"] * 2)
    batch = ingest.from_partitioned_files(paths, mesh,
                                          n_features=DRILL_WIDTH,
                                          dtype=np.float64)
    staged = dist_smooth.make_dist_smooth_staged(
        losses.LogisticGradient(), batch, mesh=mesh)
    px, rv = smooth.make_prox(prox.L2Prox(), 0.1)
    w0 = torch.zeros(DRILL_WIDTH, dtype=torch.float64)
    cfg = agd.AGDConfig(convergence_tol=0.0, num_iterations=DRILL_ITERS)
    res = resilience.run_agd_supervised(
        prox=px, reg_value=rv, w0=w0, config=cfg, staged=staged,
        policy=resilience.ResiliencePolicy(
            backoff_base=0.0, jitter=0.0, seed=0,
            segment_iters=DRILL_SEGMENT),
        checkpointer=resilience.DistributedCheckpointer(
            os.path.join(work, "ck"), every_iters=DRILL_SEGMENT, keep=4,
            fingerprint=ckpt.problem_fingerprint(w0, cfg),
            mesh_shape=dict(mesh.shape),
            partitions=ingest.local_partitions(paths)),
        heartbeat=resilience.HeartbeatWriter(os.path.join(work, "hb")),
        faults=(None if kill_at is None else
                resilience.FaultScript(sigkill_at_iter=kill_at)))
    return {"hist": _hex(res.loss_history), "w": _hex(res.weights),
            "iters": int(res.num_iters)}


def main():
    argv = sys.argv[1:]
    work = None
    if "--drill" in argv:
        i = argv.index("--drill")
        work = argv.pop(i + 1)
    flags = [a for a in argv if a.startswith("--")]
    args = [a for a in argv if not a.startswith("--")]
    addr, nproc, rank, part_dir = args[:4]
    device = args[4] if len(args) > 4 else "cpu"
    nproc, rank = int(nproc), int(rank)

    import spark_agd_tpu_torch as port
    from spark_agd_tpu_torch.data import ingest
    from spark_agd_tpu_torch.parallel import mesh as mesh_lib
    from spark_agd_tpu_torch.parallel import multihost as mh

    mh.initialize(addr, nproc, rank, backend="gloo", device=device,
                  timeout=datetime.timedelta(seconds=60))
    mh.initialize(addr, nproc, rank)  # idempotent second call
    assert mh.process_count() == nproc and mh.process_index() == rank
    got = mh.process_allgather_int64([rank, 7, 2 ** 40 + rank])
    assert got.tolist() == [[p, 7, 2 ** 40 + p] for p in range(nproc)], got

    mesh = mesh_lib.make_mesh({"data": 2 * nproc}, devices=[device] * 2)
    assert mesh.process_count == nproc and len(mesh.slots()) == 2
    hyb = mh.make_hybrid_mesh({"data": 2}, {"data": nproc},
                              devices=[device] * 2)
    assert hyb.shape == {"data": 2 * nproc}

    out = {"rank": rank}
    if work is not None:
        kill = [int(f.split("=", 1)[1]) for f in flags
                if f.startswith("--kill-at=")]
        out.update(_drill(part_dir, work, kill[0] if kill else None))
        print("RESULT " + json.dumps(out), flush=True)
        mh.shutdown()
        return
    if "--tail" in flags:
        out.update(_tail_fits(port, mesh_lib, part_dir, device, nproc))
        print("RESULT " + json.dumps(out), flush=True)
        mh.shutdown()
        return

    paths = sorted(glob.glob(os.path.join(part_dir, "part-*.libsvm")))
    w0 = np.zeros(9)
    kw = dict(reg_param=0.05, num_iterations=10, convergence_tol=1e-12,
              initial_weights=w0, return_result=True)
    dense = ingest.from_partitioned_files(paths, mesh, n_features=9)
    if "--sharded" in flags:
        mh.reset_census()
        w, h, r = port.run(dense, port.LogisticGradient(), port.L2Prox(),
                           sharded_update=True, **kw)
        out["sharded"] = dict(hist=_hex(h), w=_hex(w.cpu()),
                              iters=int(r.num_iters),
                              census=dict(mh.census))
        print("RESULT " + json.dumps(out), flush=True)
        mh.shutdown()
        return
    w, h, r = port.run(dense, port.LogisticGradient(), port.L2Prox(), **kw)
    out["dense"] = dict(hist=_hex(h), w=_hex(w.cpu()),
                        iters=int(r.num_iters),
                        backtracks=int(r.num_backtracks),
                        restarts=int(r.num_restarts),
                        rows=int(dense.X.shape[0]))
    sparse = ingest.from_partitioned_files_csr(paths, mesh, n_features=9)
    w, h, r = port.run(sparse, port.LogisticGradient(), port.L2Prox(), **kw)
    out["csr"] = dict(hist=_hex(h), w=_hex(w.cpu()),
                      iters=int(r.num_iters),
                      backtracks=int(r.num_backtracks),
                      restarts=int(r.num_restarts))
    if device != "cpu":
        torch.cuda.synchronize()
    print("RESULT " + json.dumps(out), flush=True)
    mh.shutdown()


if __name__ == "__main__":
    main()
