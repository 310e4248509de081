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
of 3).  The rank that holds no rows joins every collective with zero
sums.

Usage: python torch_multihost_child.py ADDR NPROC RANK PART_DIR [DEVICE]
       [--tail]
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
    return out


def main():
    flags = [a for a in sys.argv[1:] if a.startswith("--")]
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
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
