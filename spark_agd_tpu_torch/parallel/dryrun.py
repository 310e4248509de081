"""The multi-device dry run: the full training loop over an N-slot mesh,
each path held to the same problem's single-device run.

Counterpart of ``__graft_entry__.dryrun_multichip`` (its paths 1, 4, 5, 6
and 8): data parallelism over dense rows, over CSR rows
(``48 * n + 5`` rows, not divisible), the fused kernel in every shard,
the mesh-streamed CSR fit and L-BFGS over the mesh, each asserting its
loss history (and weights) against the single-device run at the JAX
package's tolerances (reduction order is all that may differ).  Its
paths 2, 3 and 7 (the model axis, feature sharding, the mesh sweep) come
with a later slice.

Run it on N slots of one device: ``dryrun_multichip(4, "cuda")`` on the
card, ``dryrun_multichip(8, "cpu")`` on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

# reduction-order noise bound: the slots' sums reassociate f32 sums,
# nothing else may differ (__graft_entry__.py:28-29)
_RTOL = 1e-5
_ATOL = 1e-7


def _assert_parity(name, hist, ref_hist, w=None, ref_w=None):
    hist = np.asarray(hist)
    ref_hist = np.asarray(ref_hist)
    assert len(hist) == len(ref_hist), (
        f"{name}: executed {len(hist)} iterations, single-device "
        f"executed {len(ref_hist)}: the sharded control flow diverged")
    np.testing.assert_allclose(
        hist, ref_hist, rtol=_RTOL, atol=_ATOL,
        err_msg=f"{name}: sharded loss history diverged from the "
                f"single-device run")
    if w is not None:
        np.testing.assert_allclose(
            _np(w), _np(ref_w), rtol=_RTOL, atol=_ATOL,
            err_msg=f"{name}: sharded weights diverged")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def dryrun_multichip(n_slots: int, device="cuda") -> dict:
    """Run the full training loop over a mesh of ``n_slots`` slots of
    ``device``, asserting parity with the single-device run on every
    path; returns the paths' launch counts (slot evaluations, and the
    margin kernel's launches of path 5)."""
    from .. import api
    from ..core import agd, host_agd, smooth as smooth_lib
    from ..data import streaming
    from ..ops import fused_kernels as fk
    from ..ops.fused_kernels import FusedLogisticGradient
    from ..ops.losses import LogisticGradient
    from ..ops.prox import L2Prox, MLlibSquaredL2Updater
    from ..ops.sparse import CSRMatrix
    from . import dist_smooth, mesh as mesh_lib

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device()
                           if dev.index is None else dev.index)
    mesh = mesh_lib.make_mesh({mesh_lib.DATA_AXIS: n_slots},
                              devices=[dev] * n_slots)
    counts = {}
    rng = np.random.default_rng(42)
    n_rows, d = 64 * n_slots, 16
    X = rng.standard_normal((n_rows, d)).astype(np.float32)
    y = (rng.random(n_rows) < 0.5).astype(np.float32)
    w0 = np.zeros(d, np.float32)

    # path 1: dense DP over the data axis
    run_kw = dict(num_iterations=3, reg_param=0.1, initial_weights=w0,
                  convergence_tol=0.0)
    dist_smooth.reset_counts()
    weights, hist = api.run((X, y), LogisticGradient(), L2Prox(),
                            mesh=mesh, dist_mode="shard_map", **run_kw)
    counts["dense_dp"] = dist_smooth.slot_evaluations
    w_ref, hist_ref = api.run((X, y), LogisticGradient(), L2Prox(),
                              mesh=False, device=dev, **run_kw)
    _assert_parity("DP shard_map", hist, hist_ref, weights, w_ref)

    # path 4: sparse DP, CSR rows over the data axis
    n_csr = 48 * n_slots + 5  # not divisible
    row_counts = rng.integers(1, 7, n_csr)
    cindptr = np.concatenate([[0], np.cumsum(row_counts)])
    nnz = int(cindptr[-1])
    cidx = rng.integers(0, d, nnz).astype(np.int32)
    cval = rng.standard_normal(nnz).astype(np.float32)
    Xcsr = CSRMatrix.from_csr_arrays(cindptr, cidx, cval, d,
                                     device="cpu").with_csc(lazy=True)
    y_csr = (rng.random(n_csr) < 0.5).astype(np.float32)
    csr_kw = dict(num_iterations=3, reg_param=0.1, convergence_tol=0.0,
                  initial_weights=np.zeros(d, np.float32))
    dist_smooth.reset_counts()
    cw, chist = api.run((Xcsr, y_csr), LogisticGradient(), L2Prox(),
                        mesh=mesh, **csr_kw)
    counts["csr_dp"] = dist_smooth.slot_evaluations
    cw1, chist1 = api.run((Xcsr.to(dev), y_csr), LogisticGradient(),
                          L2Prox(), mesh=False, device=dev, **csr_kw)
    _assert_parity("CSR DP", chist, chist1, cw, cw1)

    # path 5: the fused kernel in every shard, against the plain
    # single-device fit
    fk.reset_launch_counts()
    dist_smooth.reset_counts()
    pw, phist = api.run(
        (X, y), FusedLogisticGradient(), L2Prox(), num_iterations=2,
        reg_param=0.1, convergence_tol=0.0, initial_weights=w0, mesh=mesh)
    counts["fused_dp"] = dist_smooth.slot_evaluations
    counts["fused_dp_kernel_launches"] = fk.launch_count
    if dev.type == "cuda" and fk.launch_count != counts["fused_dp"]:
        raise AssertionError(
            f"fused DP: {fk.launch_count} kernel launches for "
            f"{counts['fused_dp']} slot evaluations")
    pw1, phist1 = api.run((X, y), LogisticGradient(), L2Prox(),
                          num_iterations=2, reg_param=0.1,
                          convergence_tol=0.0, initial_weights=w0,
                          mesh=False, device=dev)
    _assert_parity("fused DP", phist, phist1, pw, pw1)

    # path 6: mesh-streamed CSR, the host driver on top
    ds = streaming.StreamingDataset.from_csr(
        cindptr, cidx, cval, d, y_csr, batch_rows=max(16, n_csr // 3),
        with_csc="lazy")
    dist_smooth.reset_counts()
    ssm, ssl = streaming.make_streaming_smooth(LogisticGradient(), ds,
                                               mesh=mesh)
    spx, srv = smooth_lib.make_prox(MLlibSquaredL2Updater(), 0.1)
    scfg = agd.AGDConfig(num_iterations=2, convergence_tol=0.0)
    sres = host_agd.run_agd_host(ssm, spx, srv,
                                 torch.zeros(d, device=mesh.lead), scfg,
                                 smooth_loss=ssl)
    counts["mesh_streamed_csr"] = dist_smooth.slot_evaluations
    sw1, shist1 = api.run((Xcsr.to(dev), y_csr), LogisticGradient(),
                          MLlibSquaredL2Updater(), num_iterations=2,
                          reg_param=0.1, convergence_tol=0.0,
                          initial_weights=np.zeros(d, np.float32),
                          mesh=False, device=dev)
    _assert_parity("mesh-streamed CSR",
                   np.asarray(sres.loss_history)[:sres.num_iters],
                   shist1, sres.weights, sw1)

    # path 8: L-BFGS over the same mesh smooth
    lres = api.run_lbfgs((X, y), LogisticGradient(), L2Prox(), mesh=mesh,
                         **run_kw)
    lres1 = api.run_lbfgs((X, y), LogisticGradient(), L2Prox(),
                          mesh=False, device=dev, **run_kw)
    nl, nl1 = int(lres.num_iters), int(lres1.num_iters)
    assert nl == nl1 == run_kw["num_iterations"], (
        f"mesh L-BFGS: iteration counts diverged ({nl} vs {nl1})")
    _assert_parity("mesh L-BFGS",
                   np.asarray(lres.loss_history)[:nl + 1],
                   np.asarray(lres1.loss_history)[:nl1 + 1],
                   lres.weights, lres1.weights)
    return counts
