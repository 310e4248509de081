"""The multi-device dry run: the full training loop over an N-slot mesh,
each path held to the same problem's single-device run.

Counterpart of ``__graft_entry__.dryrun_multichip`` (its eight paths):
data parallelism over dense rows; DP x TP, a softmax's classes over a
``model`` axis of 2 (an even slot count); feature sharding of CSR columns
over every slot; data parallelism over CSR rows (``48 * n + 5`` rows, not
divisible); the fused kernel in every shard; the mesh-streamed CSR fit;
the mesh sweep (its lanes through ``lanes_loss_and_grad`` a slot, the
lanes kernel with ``FusedLogisticGradient``); L-BFGS over the mesh.  Each
asserts its loss history (and weights) against the single-device run at
the JAX package's tolerances (reduction order is all that may differ).

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
    path; returns the paths' launch counts (slot evaluations, the margin
    kernel's launches of path 5 and the lanes kernel's of path 7)."""
    from .. import api
    from ..core import agd, host_agd, smooth as smooth_lib
    from ..data import streaming
    from ..ops import fused_kernels as fk
    from ..ops.fused_kernels import FusedLogisticGradient
    from ..ops.losses import LogisticGradient, SoftmaxGradient
    from ..ops.prox import L2Prox, MLlibSquaredL2Updater
    from ..ops.sparse import CSRMatrix
    from . import dist_smooth, feature_sharded, mesh as mesh_lib

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
    px, rv = smooth_lib.make_prox(L2Prox(), 0.1)
    cfg2 = agd.AGDConfig(num_iterations=2, convergence_tol=0.0)

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

    # path 2: DP x TP, the softmax's (D, K) classes over the model axis
    if n_slots % 2 == 0:
        k, tp = 8, 2
        mesh2 = mesh_lib.make_mesh(
            {mesh_lib.DATA_AXIS: n_slots // tp, mesh_lib.MODEL_AXIS: tp},
            devices=[dev] * n_slots)
        y_cls = rng.integers(0, k, n_rows).astype(np.int32)
        dist_smooth.reset_counts()
        sm, sl = dist_smooth.make_dist_smooth(
            SoftmaxGradient(k), mesh_lib.shard_batch(mesh2, X, y_cls),
            mesh=mesh2, mode="auto")
        res = agd.run_agd(sm, px, rv, torch.zeros((d, k), device=dev),
                          cfg2, smooth_loss=sl)
        counts["dp_tp_softmax"] = dist_smooth.slot_evaluations
        Xd = torch.as_tensor(X, device=dev)
        yd = torch.as_tensor(y_cls, device=dev)
        res1 = agd.run_agd(
            smooth_lib.make_smooth(SoftmaxGradient(k), Xd, yd), px, rv,
            torch.zeros((d, k), device=dev), cfg2,
            smooth_loss=smooth_lib.make_smooth_loss(SoftmaxGradient(k), Xd,
                                                    yd))
        _assert_parity("DPxTP softmax",
                       res.loss_history[:int(res.num_iters)],
                       res1.loss_history[:int(res1.num_iters)],
                       res.weights, res1.weights)

    # path 3: feature (D-axis) sharding of CSR columns over every slot
    mesh3 = mesh_lib.make_mesh({mesh_lib.MODEL_AXIS: n_slots},
                               devices=[dev] * n_slots)
    n_sp, d_sp, nnz_row = 64, 8 * n_slots + 3, 4
    indptr = np.arange(n_sp + 1) * nnz_row
    indices = rng.integers(0, d_sp, n_sp * nnz_row).astype(np.int32)
    vals = rng.standard_normal(n_sp * nnz_row).astype(np.float32)
    y_sp = (rng.random(n_sp) < 0.5).astype(np.float32)
    fbatch = feature_sharded.shard_csr_by_columns(indptr, indices, vals,
                                                  d_sp, y_sp, mesh3)
    fsm, fsl = feature_sharded.make_feature_sharded_smooth(
        LogisticGradient(), fbatch, mesh=mesh3)
    fres = agd.run_agd(
        fsm, px, rv,
        feature_sharded.shard_weights(np.zeros(d_sp), fbatch, mesh3), cfg2,
        smooth_loss=fsl)
    Xsp = CSRMatrix.from_csr_arrays(indptr, indices, vals, d_sp,
                                    device=dev)
    fw1, fhist1 = api.run((Xsp, y_sp), LogisticGradient(), L2Prox(),
                          num_iterations=2, reg_param=0.1,
                          convergence_tol=0.0,
                          initial_weights=np.zeros(d_sp, np.float32),
                          mesh=False, device=dev)
    _assert_parity("feature-sharded",
                   fres.loss_history[:int(fres.num_iters)], fhist1,
                   feature_sharded.unshard_weights(fres.weights, fbatch),
                   fw1)

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

    # path 7: the mesh sweep, one lanes launch a slot a round
    regs = [0.01, 0.5]
    lanes_before = fk.lanes_launch_count
    dist_smooth.reset_counts()
    gres = api.sweep((X, y), FusedLogisticGradient(), L2Prox(), regs,
                     num_iterations=3, convergence_tol=0.0,
                     initial_weights=w0, mesh=mesh)
    counts["mesh_sweep"] = dist_smooth.slot_evaluations
    counts["mesh_sweep_lanes_launches"] = (fk.lanes_launch_count
                                           - lanes_before)
    if dev.type == "cuda" and counts["mesh_sweep_lanes_launches"] \
            != counts["mesh_sweep"]:
        raise AssertionError(
            f"mesh sweep: {fk.lanes_launch_count} lanes launches for "
            f"{counts['mesh_sweep']} slot evaluations")
    gres1 = api.sweep((X, y), LogisticGradient(), L2Prox(), regs,
                      num_iterations=3, convergence_tol=0.0,
                      initial_weights=w0, mesh=False, device=dev)
    for i in range(len(regs)):
        ni = int(gres.num_iters[i])
        assert ni == int(gres1.num_iters[i]), (
            f"mesh sweep lane {i}: iteration counts diverged")
        _assert_parity(f"mesh sweep lane {i}", gres.loss_history[i][:ni],
                       gres1.loss_history[i][:ni], gres.weights[i],
                       gres1.weights[i])

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
