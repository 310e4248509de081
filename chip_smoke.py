#!/usr/bin/env python3
"""Drive the PyTorch port (``spark_agd_tpu_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
NVIDIA card with 80 GB, ``nvcc`` (PATH, ``$CUDA_HOME`` or
``/usr/local/cuda``) and no network; it builds the port's CUDA kernels
from the checkout's sources.

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build: both kernels' ``nvcc`` builds, started together; the margin
   kernel's width limits and the softmax kernel's class limits at
   D = 785;
3. kernel: the CUDA margin kernel against its plain PyTorch version on
   the card (3 losses x f32/bf16 x masked/unmasked x w = 0/random, on
   ragged shapes and at the kernel's width limit), each call repeated
   to check that it is bit-identical; one column past the limit raises;
4. softmax_kernel: the CUDA softmax kernel against its plain version
   (N = 100,003, D in {784, 785, 777}, K in {1, 2, 3, 8, 9, 10, 16, 17,
   32} and the class limit, f32/bf16 x masked/unmasked x W = 0/random),
   each call repeated; at D = 785, K = 10 also against f64 sums; one
   class past the limit raises;
5. main path: a 10,000,000 x 1,000 f32 class-logistic dataset made on the
   card, fit with ``AcceleratedGradientDescent(FusedLogisticGradient(),
   SquaredL2Updater()).setRegParam(0.1).setNumIterations(40)
   .setConvergenceTol(0.0).optimize`` and ``run(..., return_result=True)``
   (bench.py's flagship fit), held to the same ``run`` through
   the plain ``LogisticGradient`` (two cuBLAS products);
6. times at the main-path shape (CUDA events, median of 20 after a
   warm-up): the kernel, its bound, its plain version, the two
   ``torch.matmul`` products alone, with the card's clocks, power and
   temperature read before and after (``card_before``/``card_after``);
7. softmax_path: BASELINE config 4 at its published scale, 8,100,000 x
   784 with 10 classes made on the card, fit with
   ``SoftmaxRegressionWithAGD(10, reg_param=1e-4,
   updater=SquaredL2Updater())`` through ``FusedSoftmaxGradient``
   (``train``, then ``run`` on the intercept-augmented X), held to
   ``run`` through the plain ``SoftmaxGradient`` (two cuBLAS products);
   X and its intercept copy take 51 GB;
8. softmax_times at the softmax shape (8,100,000 x 785, K = 10), read
   as phase 6 is, the kernel held to f64 sums there (the plain version's
   f32 products drift further from them over 8.1M rows; both errors are
   printed);
9. sparse_ops: the CSR products (``ops/sparse.py``) on a 200,003 x
   50,021 CSR made on the card with varied counts (empty rows, empty
   columns, zero-value padding): matvec, rmatvec, matmat and rmatmat at
   f32 within 1e-4 of the largest f64 result, each call repeated
   bit-identical; ``FusedLogisticGradient`` and ``FusedSoftmaxGradient``
   given a CSR launch no dense kernel;
10. rcv1_path: BASELINE config 1 at its published scale, rcv1-like
    697,641 x 47,236 with 74 nonzeros a row made on the card (seed 0),
    fit with ``LogisticRegressionWithAGD(reg_param=1e-4)`` (40
    iterations, convergence_tol 0) through ``train``, then ``run`` on the
    intercept CSR, held to the same ``run`` at f64 (loss histories rtol
    1e-4 until the two fits' step sizes part at a backtrack:
    ``common_path``) and the f32 gradient at the final weights to f64
    sums (1e-4 of its largest entry); ms per smooth evaluation and per
    product against the bytes bound (nnz x 16 B), the cuSPARSE products
    and a 1-D ``segment_reduce`` beside them;
11. libsvm: phase 10's data written to a LIBSVM file in a temporary
    directory, read back with the port's ``load_libsvm`` (the native
    parser, or the phase fails), the parsed arrays equal to the card-made
    ones bit for bit, and the same trainer fit from
    ``CSRMatrix.from_csr_arrays(..., device="cuda")``: weights equal to
    phase 10's bit for bit (the first 69,764 rows only, and then against
    a fit of those rows, when writing all of them would take over 60 s);
12. url_path: BASELINE config 3 at its published scale, url-like
    2,396,130 x 3,231,961 with 116 nonzeros a row (seed 1), fit with
    ``SVMWithAGD(reg_param=1e-5)`` (hinge + L1), read as phase 10, with
    the count of exact-zero weights;
13. the ``kernels`` line; then the card's name and power limit, and last
    ``{"ok": true, "device": {...}}``.

Launch counts are set to 0 just before each path (phases 5, 7, 10-12)
and read just after it; the sparse paths launch neither kernel.  Any
failed check raises, and the script exits non-zero without the last
line.  It also exits non-zero when CUDA is not available.

``python3 chip_smoke.py --ab NAME=SOURCE [...] [--seeds 3,4]`` runs none
of the phases.  It times versions of the softmax kernel side by side
instead: each SOURCE is a copy of ``csrc/softmax_loss_grad.cu`` with its
C interface (the shipped file, a parent commit's, an edited variant),
with ``tile_common.cuh`` beside it.  All are built at once, then for
each seed phase 8's data and weights are made (planted-softmax data,
the intercept column, W from 40 iterations of the plain fit), and the
builds are timed in turns, A, B, ..., then back, each held to the f64
sums; one ``ab`` line per seed.
"""

import argparse
import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_MAIN, D_MAIN = 10_000_000, 1_000
# bench.py's flagship fit: logistic + L2, reg 0.1, 40 iterations with
# convergence_tol 0 (bench.py:323), so both fits run all 40: at the
# default tol 1e-4 the stop test is a knife edge that f32 summation order
# decides (15 vs 16 iterations between the kernel and cuBLAS here)
ITERS, REG, TOL = 40, 0.1, 0.0
# BASELINE config 4: MNIST-8M's shape (benchmarks/datasets.py:136-145),
# SquaredL2Updater at reg 1e-4 (benchmarks/run.py:96-100)
N_SM, D_SM, K_SM, REG_SM = 8_100_000, 784, 10, 1e-4
# H100 SXM data sheet: 3.35 TB/s of HBM3, 67 TFLOP/s f32 (no tensor core)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_REL = 1e-5, 1e-4, 1e-4  # test_pallas.py
# BASELINE configs 1 and 3 (benchmarks/run.py:75-93): rcv1-like and
# url-like shapes of benchmarks/datasets.py:112-122, with their seeds
RCV1 = dict(n=697_641, d=47_236, k=74, seed=0, reg=1e-4, min_accuracy=0.6)
# 40 iterations of hinge + L1 at 1e-5 leave url-like near chance (the
# gradient of most of its 3.2M weights stays under the L1 threshold)
URL = dict(n=2_396_130, d=3_231_961, k=116, seed=1, reg=1e-5,
           min_accuracy=0.0)
# the CSR values (4 B) and ids (4 B) read once by each of the two products
SPARSE_BYTES_PER_NNZ = 16
LIBSVM_WRITE_LIMIT_S, LIBSVM_REDUCED_ROWS = 60.0, 69_764


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


CARD_STATE = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu",
              "clocks_throttle_reasons.active")


def card_state():
    """The card's clocks, power draw, temperature and active throttle
    reasons (``nvidia-smi``), read beside a timing window: the times of
    one call can differ from the next call's by a third when the card is
    held below its clocks."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=" + ",".join(CARD_STATE),
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        return {"nvidia_smi_error": out.stderr.strip()}
    values = out.stdout.strip().splitlines()[0].split(",")
    return dict(zip(CARD_STATE, (v.strip() for v in values)))


def time_ms(fn, repeats=20):
    """Median CUDA-event time of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(repeats):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(bytes_moved, flops):
    """The least time the card could take: bytes over the memory rate
    against f32 flops over the CUDA-core rate; returns (ms, bound_by)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_flops = flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_flops) * 1e3,
            "bytes" if t_bytes >= t_flops else "operations")


def compare(kernel, plain, where):
    """``kernel()`` twice (bit-identical) against ``plain()``, each
    returning ``(loss, grad)``; returns ``(loss relative error, grad max
    abs error)``."""
    loss, grad = kernel()
    loss2, grad2 = kernel()
    torch.cuda.synchronize()
    if not (torch.equal(loss, loss2) and torch.equal(grad, grad2)):
        raise AssertionError(f"{where}: repeated kernel calls differ")
    ref_loss, ref_grad = plain()
    loss_err = abs(float(loss) - float(ref_loss)) \
        / max(abs(float(ref_loss)), 1e-30)
    abs_err = (grad - ref_grad).abs()
    gmax = float(ref_grad.abs().max())
    ok_grad = bool((abs_err <= GRAD_RTOL * ref_grad.abs()
                    + GRAD_ATOL_REL * gmax).all())
    if loss_err > LOSS_RTOL or not ok_grad or not torch.isfinite(grad).all():
        raise AssertionError(
            f"{where}: kernel disagrees with its plain version: loss rel "
            f"{loss_err:.3e} (tol {LOSS_RTOL}), grad max abs "
            f"{float(abs_err.max()):.3e} (|g|max {gmax:.3e})")
    return loss_err, float(abs_err.max())


def softmax_f64(k, W, staged, chunk=1 << 20):
    """The softmax loss and gradient in f64, over row chunks: the
    yardstick at the full shape, where two f32 sums over millions of rows
    differ by their summation order."""
    n, d = staged.X.shape
    loss = torch.zeros((), dtype=torch.float64, device=staged.X.device)
    grad = torch.zeros((d, k), dtype=torch.float64, device=staged.X.device)
    W64 = W.to(torch.float64)
    classes = torch.arange(k, dtype=torch.float64, device=staged.X.device)
    for r0 in range(0, n, chunk):
        Xb = staged.X[r0:r0 + chunk].to(torch.float64)
        yb = staged.y[r0:r0 + chunk].to(torch.float64)
        mb = staged.m[r0:r0 + chunk].to(torch.float64)
        z = Xb @ W64
        lse = torch.logsumexp(z, dim=1)
        onehot = (classes == yb[:, None]).to(torch.float64)
        loss += ((lse - (z * onehot).sum(dim=1)) * mb).sum()
        grad += Xb.T @ ((torch.exp(z - lse[:, None]) - onehot) * mb[:, None])
    return loss, grad


def compare_margin(fk, gradient, w, staged, where):
    return compare(lambda: fk.fused_margin_loss_grad(gradient, w, staged),
                   lambda: fk.fused_margin_loss_grad_reference(gradient, w,
                                                               staged),
                   where)


def compare_softmax(fk, k, W, staged, where, plain=None):
    """The softmax kernel against ``plain()`` (default: its plain
    version)."""
    return compare(lambda: fk.fused_softmax_loss_grad(k, W, staged),
                   plain or (lambda: fk.fused_softmax_loss_grad_reference(
                       k, W, staged)),
                   where)


def same_stop(res, res_plain, hist, hist_plain):
    """Both fits stopped together, or the one that stopped first stopped
    by its own criterion with every later loss of the other at its final
    loss within rtol 1e-4.  Fits at the f32 loss floor stop where
    summation-order rounding makes a step exactly zero."""
    n_iters, n_plain = int(res.num_iters), int(res_plain.num_iters)
    n_common = min(n_iters, n_plain)
    shorter, longer = ((res, hist_plain) if n_iters <= n_plain
                       else (res_plain, hist))
    return n_iters == n_plain or (
        bool(shorter.converged) and not bool(shorter.aborted_non_finite)
        and bool(np.allclose(longer[n_common:],
                             float(shorter.loss_history[n_common - 1]),
                             rtol=1e-4, atol=0.0)))


def build_report(b):
    """A build's time, file and ``ptxas`` report (registers, spills)."""
    lines = b.log.splitlines()
    return {"nvcc_seconds": b.seconds, "library": b.path.name,
            "ptxas": sorted({ln.split(":", 1)[1].strip() for ln in lines
                             if "Used" in ln and "registers" in ln}),
            "spills": sorted({ln.strip() for ln in lines if "spill" in ln
                              and " 0 bytes spill" not in ln})}


def phase_build(fk):
    """Both libraries, one ``nvcc`` each, started together."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        built = dict(zip(("margin_loss_grad", "softmax_loss_grad"),
                         pool.map(lambda lib: lib()[1],
                                  (fk.library, fk.softmax_library))))
    out = {"phase": "build", "seconds": time.perf_counter() - t0}
    for name, b in built.items():
        out[name] = build_report(b)
    out["max_width"] = {"f32": fk.max_width(torch.float32),
                        "bf16": fk.max_width(torch.bfloat16)}
    out["softmax_max_classes_d785"] = {
        "f32": fk.max_classes(785, torch.float32),
        "bf16": fk.max_classes(785, torch.bfloat16)}
    emit(out)


def phase_kernel(fk, losses):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    shapes = [(100_003, 1_000, (torch.float32, torch.bfloat16)),
              (100_003, 777, (torch.float32, torch.bfloat16)),
              (20_000, fk.max_width(torch.float32), (torch.float32,)),
              (8_192, fk.max_width(torch.bfloat16), (torch.bfloat16,))]
    for n, d, xtypes in shapes:
        X32 = torch.randn((n, d), generator=gen, device=dev)
        y = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
        mask = (torch.rand(n, generator=gen, device=dev) < 0.7).float()
        w_rand = torch.randn(d, generator=gen, device=dev) / d ** 0.5
        for xt in xtypes:
            X = X32 if xt == torch.float32 else X32.to(xt)
            worst_loss = worst_grad = 0.0
            cases = 0
            for name in ("logistic", "least_squares", "hinge"):
                for m in (None, mask):
                    staged = fk.stage_dense(X, y, m)
                    for w in (torch.zeros(d, device=dev), w_rand):
                        le, ge = compare_margin(
                            fk, losses.GRADIENTS[name](), w, staged,
                            f"{n}x{d} {xt} {name} masked={m is not None}")
                        worst_loss = max(worst_loss, le)
                        worst_grad = max(worst_grad, ge)
                        cases += 1
            rows, grid = fk.launch_shape(X)
            emit({"phase": "kernel", "shape": [n, d],
                  "x_dtype": str(xt).replace("torch.", ""),
                  "tile_rows": rows, "grid": grid,
                  "cases": cases, "bit_identical": True,
                  "max_loss_rel_err": worst_loss,
                  "max_grad_abs_err": worst_grad})
            del X
        del X32, y, mask
        torch.cuda.empty_cache()
    # one column past the limit: refused before any launch
    for xt in (torch.float32, torch.bfloat16):
        d = fk.max_width(xt) + 1
        before = fk.launch_count
        try:
            fk.stage_dense(torch.zeros((2, d), dtype=xt, device=dev),
                           torch.zeros(2, device=dev))
        except ValueError:
            pass
        else:
            raise AssertionError(f"{xt} X of width {d} was not refused")
        if fk.launch_count != before:
            raise AssertionError("a refused X launched the kernel")
    emit({"phase": "kernel", "past_width_limit_raises": True})


def phase_softmax_kernel(fk):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    n = 100_003
    for d in (784, 785, 777):
        X32 = torch.randn((n, d), generator=gen, device=dev)
        mask = (torch.rand(n, generator=gen, device=dev) < 0.7).float()
        # 8, 9 and 16: the edges of the one- and two-n8-tile buckets
        ks = [1, 2, 3, 8, 9, 10, 16, 17, 32]
        if d == 785:
            ks = sorted(set(ks) | {fk.max_classes(d, torch.float32),
                                   fk.max_classes(d, torch.bfloat16)})
        for k in ks:
            y = torch.randint(0, k, (n,), generator=gen, device=dev)
            W_rand = torch.randn((d, k), generator=gen, device=dev) / d ** 0.5
            for xt in (torch.float32, torch.bfloat16):
                if k > fk.max_classes(d, xt):
                    continue
                X = X32 if xt == torch.float32 else X32.to(xt)
                worst_loss = worst_grad = 0.0
                cases = 0
                for m in (None, mask):
                    staged = fk.stage_softmax(X, y, k, m)
                    for W in (torch.zeros_like(W_rand), W_rand):
                        le, ge = compare_softmax(
                            fk, k, W, staged,
                            f"softmax {n}x{d} K={k} {xt} "
                            f"masked={m is not None}")
                        worst_loss = max(worst_loss, le)
                        worst_grad = max(worst_grad, ge)
                        cases += 1
                rows, grid = fk.softmax_launch_shape(X, k)
                out = {"phase": "softmax_kernel", "shape": [n, d],
                       "classes": k, "x_dtype": str(xt).replace("torch.", ""),
                       "tile_rows": rows, "grid": grid, "cases": cases,
                       "bit_identical": True, "max_loss_rel_err": worst_loss,
                       "max_grad_abs_err": worst_grad}
                if d == 785 and k == 10:
                    # held to f64 sums too: the tensor-core products keep
                    # f32 accuracy only with their correction passes
                    staged = fk.stage_softmax(X, y, k, mask)
                    exact = softmax_f64(k, W_rand, staged)
                    out["f64_loss_rel_err"], out["f64_grad_max_abs_err"] = \
                        compare_softmax(
                            fk, k, W_rand, staged,
                            f"softmax {n}x{d} K={k} {xt} vs f64",
                            plain=lambda: (exact[0].float(),
                                           exact[1].float()))
                emit(out)
                del X
        del X32, mask
        torch.cuda.empty_cache()
    # one class past the limit: refused before any launch
    for xt in (torch.float32, torch.bfloat16):
        k = fk.max_classes(785, xt) + 1
        before = fk.softmax_launch_count
        X = torch.zeros((2, 785), dtype=xt, device=dev)
        for call in (
                lambda: fk.stage_softmax(X, torch.zeros(2, device=dev), k),
                lambda: fk.fused_softmax_loss_grad(
                    k, torch.zeros((785, k), device=dev),
                    fk.stage_softmax(X, torch.zeros(2, device=dev), 1))):
            try:
                call()
            except ValueError:
                pass
            else:
                raise AssertionError(f"{xt} X with {k} classes was not "
                                     f"refused")
        if fk.softmax_launch_count != before:
            raise AssertionError("a refused softmax input launched")
    emit({"phase": "softmax_kernel", "past_class_limit_raises": True})


def counting(cls):
    """``cls`` with a count of smooth evaluations, to hold launches
    against them."""

    class Counting(cls):
        evaluations = 0

        def batch_loss_and_grad(self, weights, X, y, mask=None):
            self.evaluations += 1
            return super().batch_loss_and_grad(weights, X, y, mask)

    return Counting


def margin_path(port, fk, losses, device_synth):
    """Phases 5 and 6; returns the margin kernel's numbers.  Its tensors
    (X, the staged operands, the multipliers) are freed on return."""
    t0 = time.perf_counter()
    X, y = device_synth.class_logistic(N_MAIN, D_MAIN, seed=0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    w0 = torch.zeros(D_MAIN, dtype=torch.float32, device="cuda")

    fused = counting(port.FusedLogisticGradient)()
    torch.cuda.reset_peak_memory_stats()
    fk.launch_count = fk.softmax_launch_count = 0
    t0 = time.perf_counter()
    w_opt = (port.AcceleratedGradientDescent(fused, port.SquaredL2Updater())
             .setRegParam(REG).setNumIterations(ITERS)
             .setConvergenceTol(TOL).optimize((X, y), w0))
    torch.cuda.synchronize()
    optimize_s = time.perf_counter() - t0
    launches_optimize = fk.launch_count
    evaluations_optimize = fused.evaluations
    t0 = time.perf_counter()
    w_run, hist, res = port.run(
        (X, y), fused, port.SquaredL2Updater(), reg_param=REG,
        num_iterations=ITERS, convergence_tol=TOL, initial_weights=w0,
        return_result=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fk.launch_count
    if fk.softmax_launch_count != 0:
        raise AssertionError("the margin path launched the softmax kernel")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    t0 = time.perf_counter()
    w_plain, hist_plain, res_plain = port.run(
        (X, y), port.LogisticGradient(), port.SquaredL2Updater(),
        reg_param=REG, num_iterations=ITERS, convergence_tol=TOL,
        initial_weights=w0, return_result=True)
    torch.cuda.synchronize()
    plain_run_s = time.perf_counter() - t0

    n_iters, n_plain = int(res.num_iters), int(res_plain.num_iters)
    n_common = min(n_iters, n_plain)
    checks = {
        # one launch per smooth evaluation, in each fit
        "launches_equal_evaluations": launches == fused.evaluations > 0,
        "run_launches_equal_run_evaluations":
            launches - launches_optimize
            == fused.evaluations - evaluations_optimize > 0,
        "same_stop_or_both_at_floor": same_stop(res, res_plain, hist,
                                                hist_plain),
        "loss_decreases": bool(hist[-1] < hist[0]),
        "finite": bool(np.isfinite(hist).all()
                       and torch.isfinite(w_run).all()),
        "weights_shape": tuple(w_run.shape) == (D_MAIN,),
        "history_rtol_1e-4": bool(np.allclose(hist[:n_common],
                                              hist_plain[:n_common],
                                              rtol=1e-4, atol=0.0)),
        "optimize_equals_run": bool(torch.allclose(w_opt, w_run, rtol=1e-6,
                                                   atol=0.0)),
        "no_second_copy_of_x": peak_gb < 1.25 * X.numel() * 4 / 1e9,
    }
    with torch.no_grad():
        acc = float(((X[:1_000_000] @ w_run > 0).float()
                     == y[:1_000_000]).float().mean())
    checks["accuracy_above_0.8"] = acc > 0.8
    emit({"phase": "main_path", "shape": [N_MAIN, D_MAIN],
          "x_gb": X.numel() * 4 / 1e9, "generate_s": gen_s,
          "optimize_s": optimize_s, "run_s": run_s,
          "plain_run_s": plain_run_s, "num_iters": n_iters,
          "num_iters_plain": n_plain, "converged": bool(res.converged),
          "converged_plain": bool(res_plain.converged),
          "num_backtracks": int(res.num_backtracks),
          "num_restarts": int(res.num_restarts),
          "smooth_evaluations": fused.evaluations, "launches": launches,
          "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
          "loss_last_plain": float(hist_plain[-1]),
          "max_hist_rel_diff": float(np.max(
              np.abs(hist[:n_common] - hist_plain[:n_common])
              / np.abs(hist_plain[:n_common]))),
          "loss_history": hist.tolist(),
          "loss_history_plain": hist_plain.tolist(),
          "optimize_bit_identical_to_run": bool(torch.equal(w_opt, w_run)),
          "peak_gb": peak_gb, "train_accuracy_1M": acc, "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}")

    # 6. times at the main-path shape, at the fitted weights
    gradient = losses.LogisticGradient()
    staged = fk.stage_dense(X, y)
    loss_err, max_abs_err = compare_margin(fk, gradient, w_run, staged,
                                           "main-path shape")
    state_before = card_state()
    kernel_ms = time_ms(lambda: fk.fused_margin_loss_grad(gradient, w_run,
                                                          staged))
    plain_ms = time_ms(lambda: fk.fused_margin_loss_grad_reference(
        gradient, w_run, staged))
    mult = torch.randn(N_MAIN, device="cuda")
    two_mm_ms = time_ms(lambda: (X @ w_run, mult @ X))
    state_after = card_state()
    n, d = X.shape
    b_ms, bound_by = bound_ms(n * d * 4 + 2 * n * 4 + d * 4 + 4 + d * 4,
                              4 * n * d)
    per_fit = launches - launches_optimize  # the run's own launches
    emit({"phase": "times", "shape": [n, d], "kernel_ms": kernel_ms,
          "bound_ms": b_ms, "bound_by": bound_by,
          "bound_source": "H100 SXM data sheet 3.35 TB/s, 67 TFLOP/s f32",
          "kernel_bw_frac": b_ms / kernel_ms,
          "plain_ms": plain_ms, "two_matmuls_ms": two_mm_ms,
          "launches_per_fit": per_fit,
          "kernel_share_of_run_wall": per_fit * kernel_ms / (run_s * 1e3),
          "main_shape_loss_rel_err": loss_err,
          "main_shape_grad_max_abs_err": max_abs_err,
          "card_before": state_before, "card_after": state_after})
    del X, y, staged, mult
    return {"name": "margin_loss_grad", "route": "cuda",
            "source": "spark_agd_tpu_torch/csrc/margin_loss_grad.cu",
            "replaces": "spark_agd_tpu/ops/pallas_kernels.py:182",
            "counterpart": "spark_agd_tpu/ops/pallas_kernels.py:"
                           "fused_margin_loss_grad",
            "launches": launches, "max_abs_err": max_abs_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": bound_by, "library_ms": None,
            "two_matmuls_ms": two_mm_ms}


def softmax_path(port, fk, device_synth):
    """Phases 7 and 8: BASELINE config 4 through the GLM trainer; returns
    the softmax kernel's numbers."""
    from spark_agd_tpu_torch.models import evaluation, glm

    t0 = time.perf_counter()
    X, y = device_synth.planted_softmax(N_SM, D_SM, K_SM, seed=3)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    x_bytes = X.numel() * X.element_size()
    d = D_SM + 1  # the trainer's intercept column
    w0 = torch.zeros((d, K_SM), dtype=torch.float32, device="cuda")

    fused = counting(port.FusedSoftmaxGradient)(port.SoftmaxGradient(K_SM))
    trainer = glm.SoftmaxRegressionWithAGD(
        K_SM, reg_param=REG_SM, updater=port.SquaredL2Updater())
    trainer.optimizer.set_gradient(fused).setNumIterations(ITERS) \
        .setConvergenceTol(TOL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.launch_count = fk.softmax_launch_count = 0
    t0 = time.perf_counter()
    model = trainer.train(X, y)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches_train = fk.softmax_launch_count
    evaluations_train = fused.evaluations

    Xa = glm._add_intercept(X)
    X_1m = Xa[:1_000_000, 1:]  # a view, for the accuracy check
    del X
    t0 = time.perf_counter()
    w_run, hist, res = port.run(
        (Xa, y), fused, port.SquaredL2Updater(), reg_param=REG_SM,
        num_iterations=ITERS, convergence_tol=TOL, initial_weights=w0,
        return_result=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fk.softmax_launch_count
    if fk.launch_count != 0:
        raise AssertionError("the softmax path launched the margin kernel")

    t0 = time.perf_counter()
    w_plain, hist_plain, res_plain = port.run(
        (Xa, y), port.SoftmaxGradient(K_SM), port.SquaredL2Updater(),
        reg_param=REG_SM, num_iterations=ITERS, convergence_tol=TOL,
        initial_weights=w0, return_result=True)
    torch.cuda.synchronize()
    plain_run_s = time.perf_counter() - t0

    n_iters, n_plain = int(res.num_iters), int(res_plain.num_iters)
    n_common = min(n_iters, n_plain)
    with torch.no_grad():
        y_1m = y[:1_000_000]
        acc = float(evaluation.multiclass_metrics(
            model.predict(X_1m), y_1m, K_SM)["accuracy"])
        acc_plain = float(evaluation.multiclass_metrics(
            glm.SoftmaxRegressionModel(w_plain[1:], w_plain[0])
            .predict(X_1m), y_1m, K_SM)["accuracy"])
    checks = {
        "train_launches_equal_evaluations":
            launches_train == evaluations_train > 0,
        "run_launches_equal_run_evaluations":
            launches - launches_train
            == fused.evaluations - evaluations_train > 0,
        "train_equals_run": bool(
            torch.allclose(model.weights, w_run[1:], rtol=1e-6, atol=0.0)
            and torch.allclose(model.intercept, w_run[0], rtol=1e-6,
                               atol=0.0)),
        "same_stop_or_both_at_floor": same_stop(res, res_plain, hist,
                                                hist_plain),
        "history_rtol_1e-4": bool(np.allclose(hist[:n_common],
                                              hist_plain[:n_common],
                                              rtol=1e-4, atol=0.0)),
        "loss_decreases": bool(hist[-1] < hist[0]),
        "finite": bool(np.isfinite(hist).all()
                       and torch.isfinite(w_run).all()),
        "weights_shape": tuple(w_run.shape) == (d, K_SM),
        "no_copy_of_xa_in_prepare": train_peak_gb * 1e9 < 2.1 * x_bytes,
        "accuracy_above_2/K": acc > 2.0 / K_SM,
        "accuracy_within_0.002_of_plain": abs(acc - acc_plain) < 0.002,
    }
    emit({"phase": "softmax_path", "shape": [N_SM, D_SM], "classes": K_SM,
          "x_gb": x_bytes / 1e9, "generate_s": gen_s, "train_s": train_s,
          "run_s": run_s, "plain_run_s": plain_run_s,
          "num_iters": n_iters, "num_iters_plain": n_plain,
          "converged": bool(res.converged),
          "converged_plain": bool(res_plain.converged),
          "num_backtracks": int(res.num_backtracks),
          "num_restarts": int(res.num_restarts),
          "smooth_evaluations": fused.evaluations,
          "smooth_evaluations_train": evaluations_train,
          "launches": launches, "launches_train": launches_train,
          "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
          "loss_last_plain": float(hist_plain[-1]),
          "max_hist_rel_diff": float(np.max(
              np.abs(hist[:n_common] - hist_plain[:n_common])
              / np.abs(hist_plain[:n_common]))),
          "loss_history": hist.tolist(),
          "loss_history_plain": hist_plain.tolist(),
          "train_bit_identical_to_run": bool(
              torch.equal(model.weights, w_run[1:])
              and torch.equal(model.intercept, w_run[0])),
          "train_peak_gb": train_peak_gb, "accuracy_1M": acc,
          "accuracy_1M_plain": acc_plain, "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"softmax path checks failed: {failed}")

    # 8. times at the softmax shape, at the fitted weights.  Here the
    # kernel is held to the f64 sums at the stated tolerance: over 8.1M
    # rows the plain version's f32 products drift further from them
    # (both errors are printed)
    staged = fk.stage_softmax(Xa, y, K_SM)
    exact_loss, exact_grad = softmax_f64(K_SM, w_run, staged)
    loss_err, err_f64 = compare_softmax(
        fk, K_SM, w_run, staged, "softmax-path shape vs f64",
        plain=lambda: (exact_loss.float(), exact_grad.float()))
    loss, grad = fk.fused_softmax_loss_grad(K_SM, w_run, staged)
    ref_loss, ref_grad = fk.fused_softmax_loss_grad_reference(K_SM, w_run,
                                                              staged)
    err_vs_plain = float((grad - ref_grad).abs().max())
    plain_err_f64 = float((ref_grad.double() - exact_grad).abs().max())
    plain_loss_err = abs(float(ref_loss) - float(exact_loss)) \
        / abs(float(exact_loss))
    state_before = card_state()
    kernel_ms = time_ms(lambda: fk.fused_softmax_loss_grad(K_SM, w_run,
                                                           staged))
    plain_ms = time_ms(lambda: fk.fused_softmax_loss_grad_reference(
        K_SM, w_run, staged))
    resid = torch.randn((N_SM, K_SM), device="cuda")
    two_mm_ms = time_ms(lambda: (Xa @ w_run, Xa.T @ resid))
    state_after = card_state()
    n = Xa.shape[0]
    b_ms, bound_by = bound_ms(n * d * 4 + 2 * n * 4 + 2 * d * K_SM * 4,
                              4 * n * d * K_SM)
    per_fit = launches - launches_train  # the run's own launches
    emit({"phase": "softmax_times", "shape": [n, d], "classes": K_SM,
          "kernel_ms": kernel_ms, "bound_ms": b_ms, "bound_by": bound_by,
          "bound_source": "H100 SXM data sheet 3.35 TB/s, 67 TFLOP/s f32",
          "kernel_bound_frac": b_ms / kernel_ms,
          "tile_rows_grid": list(fk.softmax_launch_shape(Xa, K_SM)),
          "plain_ms": plain_ms, "two_matmuls_ms": two_mm_ms,
          "two_matmuls_note": "Xa @ W and Xa.T @ resid: two calls, no "
                              "single PyTorch call computes this function",
          "launches_per_fit": per_fit,
          "kernel_share_of_run_wall": per_fit * kernel_ms / (run_s * 1e3),
          "loss_rel_err_vs_f64": loss_err,
          "grad_max_abs_err_vs_f64": err_f64,
          "plain_loss_rel_err_vs_f64": plain_loss_err,
          "plain_grad_max_abs_err_vs_f64": plain_err_f64,
          "grad_max_abs_err_vs_plain_f32": err_vs_plain,
          "grad_abs_max": float(exact_grad.abs().max()),
          "card_before": state_before, "card_after": state_after})
    return {"name": "softmax_loss_grad", "route": "cuda",
            "source": "spark_agd_tpu_torch/csrc/softmax_loss_grad.cu",
            "replaces": "spark_agd_tpu/ops/pallas_kernels.py:406",
            "counterpart": "spark_agd_tpu/ops/pallas_kernels.py:"
                           "fused_softmax_loss_grad",
            "launches": launches,
            # the error the run asserts: against the f64 sums
            "max_abs_err": err_f64,
            "max_abs_err_vs_plain_f32": err_vs_plain,
            "plain_max_abs_err_vs_f64": plain_err_f64,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": bound_by, "library_ms": None,
            "two_matmuls_ms": two_mm_ms}


def csr_f64(sparse, X):
    """``X`` with f64 values (and twin values), sharing its ids and
    offsets."""
    twin = {}
    if X.has_csc:
        twin = dict(csc_row_ids=X.csc_row_ids, csc_col_ids=X.csc_col_ids,
                    csc_values=X.csc_values.double())
    return sparse.CSRMatrix(X.row_ids, X.col_ids, X.values.double(), X.shape,
                            rows_sorted=True, **twin)


def check_products(X, X64, cases, where):
    """Each ``(name, fn, arg)``: ``fn(X, arg)`` twice (bit-identical), held
    to ``fn(X64, arg in f64)`` within 1e-4 of its largest entry; returns
    ``{name: {...}}`` with the error and the median time."""
    out = {}
    for name, fn, arg in cases:
        a, b = fn(X, arg), fn(X, arg)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"{where} {name}: repeated calls differ")
        ref = fn(X64, arg.double())
        err = float((a.double() - ref).abs().max())
        scale = float(ref.abs().max())
        if not (torch.isfinite(a).all() and err <= 1e-4 * scale):
            raise AssertionError(
                f"{where} {name}: f32 is {err:.3e} from f64 (limit "
                f"{1e-4 * scale:.3e})")
        out[name] = {"max_abs_err_vs_f64": err, "abs_max_f64": scale,
                     "ms": time_ms(lambda: fn(X, arg))}
    return out


def phase_sparse_ops(port, fk, sparse, device_synth, glm):
    """Phase 9: the four CSR products at f32 against f64 on the card,
    repeat bit-identical; no dense kernel launched for a CSR."""
    t0 = time.perf_counter()
    n, d_drawn, d, k = 200_003, 50_000, 50_021, 10
    rid, cid, val, y = device_synth.planted_sparse_parts_varied(
        n, d_drawn, 12, seed=9)
    keep = rid % 97 != 0  # every 97th row loses its entries: empty rows
    # the intercept column: one column holding every row, summed in chunks
    X = glm._add_intercept(sparse.CSRMatrix(
        rid[keep] + 0, cid[keep], val[keep], (n, d - 1),
        rows_sorted=True)).with_csc()
    del rid, cid, val, keep
    X64 = csr_f64(sparse, X)
    row_lengths = X.indptr[1:] - X.indptr[:-1]
    empty_rows = int((row_lengths == 1).sum())  # the intercept entry only
    empty_cols = int((X.colptr[1:] == X.colptr[:-1]).sum())
    padding = int((X.values == 0).sum())
    if not (empty_rows and empty_cols >= d - 1 - d_drawn and padding):
        raise AssertionError("sparse_ops: the CSR lacks empty rows, empty "
                             "columns or padding")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    w = torch.randn(d, generator=gen, device="cuda")
    v = torch.randn(n, generator=gen, device="cuda")
    W = torch.randn((d, k), generator=gen, device="cuda")
    V = torch.randn((n, k), generator=gen, device="cuda")
    products = check_products(X, X64, [
        ("matvec", sparse.CSRMatrix.matvec, w),
        ("rmatvec", sparse.CSRMatrix.rmatvec, v),
        ("matmat", sparse.CSRMatrix.matmat, W),
        ("rmatmat", sparse.CSRMatrix.rmatmat, V)], "sparse_ops")
    # the fused gradients route a CSR to the sparse products
    fk.launch_count = fk.softmax_launch_count = 0
    labels = torch.randint(0, k, (n,), generator=gen, device="cuda")
    for g, wt, yt in ((port.FusedLogisticGradient(), w, y),
                      (port.FusedSoftmaxGradient(port.SoftmaxGradient(k)),
                       W * 0.01, labels)):
        Xp, yp, mp = g.prepare(X, yt)
        loss, grad, _ = g.batch_loss_and_grad(wt, Xp, yp, mp)
        if not (torch.isfinite(loss) and torch.isfinite(grad).all()):
            raise AssertionError("sparse_ops: a fused gradient on CSR is "
                                 "not finite")
    torch.cuda.synchronize()
    if fk.launch_count or fk.softmax_launch_count:
        raise AssertionError("a CSR input launched a dense kernel")
    emit({"phase": "sparse_ops", "shape": [n, d], "nnz": X.nnz,
          "intercept_column": True,
          "empty_rows_but_the_intercept": empty_rows,
          "empty_columns": empty_cols,
          "padding_entries": padding, "bit_identical": True,
          "dense_kernel_launches": 0, "products": products,
          "seconds": time.perf_counter() - t0})


def common_path(res, res64, n_common):
    """The iterations over which an f32 and an f64 fit are held to each
    other: all of them while both took the same step sizes (``diag_l``
    within 1e-4), else those before the step that preceded the first
    parting.  A backtrack fires when a step overshot (the step size had
    fallen below the loss's curvature), and that step amplifies rounding
    (on the card, 1e-6 to 4e-5 of the loss in the step before the first
    backtrack of the rcv1-like fits); the backtrack then estimates the
    new step from a difference of two nearly equal losses, which f32
    rounds (0.414 in f32, 0.359 in f64 there), so the fits part."""
    l32 = res.diag_l[:n_common].double().cpu().numpy()
    l64 = res64.diag_l[:n_common].double().cpu().numpy()
    parted = ~np.isclose(l32, l64, rtol=1e-4, atol=0.0)
    return int(np.argmax(parted)) - 1 if parted.any() else n_common


def cusparse_ms(X, w, v):
    """The library yardstick (timed here, used nowhere in the port): the
    same two products as cuSPARSE CSR products through ``torch.sparse``,
    with whether three repeats gave the same bits."""
    try:
        A = torch.sparse_csr_tensor(X.indptr.to(torch.int32), X.col_ids,
                                    X.values, X.shape)
        At = torch.sparse_csr_tensor(X.colptr.to(torch.int32),
                                     X.csc_row_ids, X.csc_values,
                                     X.shape[::-1])
        mv = [A @ w for _ in range(3)]
        rmv = [At @ v for _ in range(3)]
        torch.cuda.synchronize()
        return {"matvec_ms": time_ms(lambda: A @ w),
                "rmatvec_ms": time_ms(lambda: At @ v),
                "matvec_bit_identical": all(torch.equal(mv[0], r)
                                            for r in mv),
                "rmatvec_bit_identical": all(torch.equal(rmv[0], r)
                                             for r in rmv)}
    except RuntimeError as e:  # a yardstick only: record why it failed
        return {"error": repr(e)[:300]}


def sparse_path(port, fk, sparse, device_synth, glm, phase, cfg,
                trainer_cls, loss_cls, updater_cls):
    """Phases 10 and 12: a BASELINE sparse config at its published scale
    through its trainer and ``run``, held to ``run`` at f64; returns the
    data, the model and the product timings."""
    t_phase = time.perf_counter()
    n, d = cfg["n"], cfg["d"]
    t0 = time.perf_counter()
    rid, cid, val, y = device_synth.planted_sparse_parts(
        n, d, cfg["k"], seed=cfg["seed"])
    X = sparse.CSRMatrix(rid, cid, val, (n, d),
                         rows_sorted=True).with_csc(lazy=True)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0

    gradient = counting(loss_cls)()
    trainer = trainer_cls(reg_param=cfg["reg"])
    trainer.optimizer.set_gradient(gradient).setNumIterations(ITERS) \
        .setConvergenceTol(TOL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.launch_count = fk.softmax_launch_count = 0
    state_before = card_state()
    t0 = time.perf_counter()
    model = trainer.train(X, y)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    evaluations_train = gradient.evaluations

    Xa = glm._add_intercept(X).with_csc()
    w0 = torch.zeros(d + 1, dtype=torch.float32, device="cuda")
    updater = updater_cls()
    t0 = time.perf_counter()
    w_run, hist, res = port.run(
        (Xa, y), gradient, updater, reg_param=cfg["reg"],
        num_iterations=ITERS, convergence_tol=TOL, initial_weights=w0,
        return_result=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    dense_launches = fk.launch_count + fk.softmax_launch_count
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    Xa64, y64 = csr_f64(sparse, Xa), y.double()
    t0 = time.perf_counter()
    w64, hist64, res64 = port.run(
        (Xa64, y64), loss_cls(), updater, reg_param=cfg["reg"],
        num_iterations=ITERS, convergence_tol=TOL,
        initial_weights=w0.double(), return_result=True)
    torch.cuda.synchronize()
    run64_s = time.perf_counter() - t0

    plain = loss_cls()
    loss32, g32, _ = plain.batch_loss_and_grad(w_run, Xa, y)
    loss64, g64, _ = plain.batch_loss_and_grad(w_run.double(), Xa64, y64)
    grad_err = float((g32.double() - g64).abs().max())
    grad_max = float(g64.abs().max())
    loss_err = abs(float(loss32) - float(loss64)) / abs(float(loss64))

    n_iters, n64 = int(res.num_iters), int(res64.num_iters)
    n_common = min(n_iters, n64)
    n_path = common_path(res, res64, n_common)
    with torch.no_grad():
        acc = float((model.predict(X) == y).float().mean())
        acc64 = float(((Xa64.matvec(w64) > 0).to(y.dtype) == y)
                      .float().mean())
    checks = {
        "train_evaluations_counted": evaluations_train > 0,
        "no_dense_kernel_launch": dense_launches == 0,
        "train_equals_run": bool(
            torch.allclose(model.weights, w_run[1:], rtol=1e-6, atol=0.0)
            and abs(model.intercept - float(w_run[0]))
            <= 1e-6 * abs(float(w_run[0]))),
        "same_stop_as_f64": same_stop(res, res64, hist, hist64),
        "common_path_of_10_iterations_or_more": n_path >= 10,
        "history_rtol_1e-4_vs_f64_on_the_common_path": bool(np.allclose(
            hist[:n_path], hist64[:n_path], rtol=1e-4, atol=0.0)),
        "grad_within_1e-4_of_f64": grad_err <= 1e-4 * grad_max,
        "loss_decreases": bool(hist[-1] < hist[0]),
        "finite": bool(np.isfinite(hist).all()
                       and torch.isfinite(w_run).all()),
        "weights_shape": tuple(w_run.shape) == (d + 1,),
        "train_accuracy_within_0.002_of_f64": abs(acc - acc64) < 0.002,
        f"train_accuracy_above_{cfg['min_accuracy']}":
            acc > cfg["min_accuracy"],
    }

    # times at the fitted weights: one smooth evaluation, each product,
    # and the cuSPARSE products beside them
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    v = torch.randn(n, generator=gen, device="cuda")
    eval_ms = time_ms(lambda: plain.batch_loss_and_grad(w_run, Xa, y))
    matvec_ms = time_ms(lambda: Xa.matvec(w_run))
    rmatvec_ms = time_ms(lambda: Xa.rmatvec(v))
    library = cusparse_ms(Xa, w_run, v)
    # the same products reduced as 1-D arrays: segment_reduce then takes
    # CUB's segmented reduction, the variant ops/sparse.py passes over
    twin = (Xa.csc_values, Xa.csc_row_ids, v, Xa.colptr)
    cub_1d = {name: time_ms(lambda a=args: torch.segment_reduce(
                  a[0] * torch.index_select(a[2], 0, a[1]), "sum",
                  offsets=a[3]))
              for name, args in (
                  ("matvec_ms", (Xa.values, Xa.col_ids, w_run, Xa.indptr)),
                  ("rmatvec_ms", twin))}
    state_after = card_state()
    b_ms, bound_by = bound_ms(Xa.nnz * SPARSE_BYTES_PER_NNZ, 4 * Xa.nnz)
    out = {
        "phase": phase, "shape": [n, d], "nnz": X.nnz,
        "nnz_with_intercept": Xa.nnz,
        "x_gb": X.nnz * 12 / 1e9, "generate_s": gen_s, "train_s": train_s,
        "run_s": run_s, "run_f64_s": run64_s, "num_iters": n_iters,
        "num_iters_f64": n64, "converged": bool(res.converged),
        "num_backtracks": int(res.num_backtracks),
        "num_restarts": int(res.num_restarts),
        "smooth_evaluations": gradient.evaluations,
        "smooth_evaluations_train": evaluations_train,
        "dense_kernel_launches": dense_launches,
        "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
        "loss_last_f64": float(hist64[-1]),
        "common_path_iterations": n_path,
        "max_hist_rel_diff_vs_f64_on_the_common_path": float(np.max(
            np.abs(hist[:n_path] - hist64[:n_path])
            / np.abs(hist64[:n_path]))),
        "max_hist_rel_diff_vs_f64": float(np.max(
            np.abs(hist[:n_common] - hist64[:n_common])
            / np.abs(hist64[:n_common]))),
        "loss_history": hist.tolist(), "loss_history_f64": hist64.tolist(),
        "step_l": res.diag_l[:n_iters].tolist(),
        "step_l_f64": res64.diag_l[:n64].tolist(),
        "grad_max_abs_err_vs_f64": grad_err, "grad_abs_max": grad_max,
        "loss_rel_err_vs_f64": loss_err,
        "train_bit_identical_to_run": bool(
            torch.equal(model.weights, w_run[1:])
            and model.intercept == float(w_run[0])),
        "train_peak_gb": train_peak_gb, "peak_gb": peak_gb,
        "train_accuracy": acc, "train_accuracy_f64": acc64,
        "eval_ms": eval_ms, "matvec_ms": matvec_ms,
        "rmatvec_ms": rmatvec_ms, "bound_ms": b_ms, "bound_by": bound_by,
        "bound_source": "nnz x 16 B at 3.35 TB/s (H100 SXM data sheet)",
        "eval_bound_frac": b_ms / eval_ms,
        "evaluations_share_of_run_wall":
            (gradient.evaluations - evaluations_train) * eval_ms
            / (run_s * 1e3),
        "cusparse": library, "segment_reduce_1d": cub_1d,
        "card_before": state_before, "card_after": state_after}
    if updater_cls is port.L1Prox:
        out["exact_zero_weights"] = int((w_run == 0).sum())
    out["checks"] = checks
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"{phase} checks failed: {failed}")
    return {"X": X, "y": y, "model": model, "trainer_cls": trainer_cls,
            "cfg": cfg,
            "row": {"shape": [n, d + 1], "nnz": Xa.nnz, "eval_ms": eval_ms,
                    "matvec_ms": matvec_ms, "rmatvec_ms": rmatvec_ms,
                    "bound_ms": b_ms,
                    "products_per_fit": 2 * (gradient.evaluations
                                             - evaluations_train),
                    "cusparse": library, "segment_reduce_1d": cub_1d}}


def write_libsvm(path, cid, val, y, k, rows):
    """The first ``rows`` rows (``k`` entries each) as LIBSVM text,
    ``%.9g`` values (f32 round-trips exactly), a block of rows per
    ``write``; returns the seconds it took."""
    t0 = time.perf_counter()
    block = 20_000
    with open(path, "w", encoding="ascii") as f:
        for r0 in range(0, rows, block):
            r1 = min(rows, r0 + block)
            a = np.empty((r1 - r0, 1 + 2 * k))
            a[:, 0] = y[r0:r1]
            a[:, 1::2] = cid[r0 * k:r1 * k].reshape(-1, k) + 1
            a[:, 2::2] = val[r0 * k:r1 * k].reshape(-1, k)
            line = "%.9g" + " %d:%.9g" * k + "\n"
            f.write((line * (r1 - r0)) % tuple(a.ravel().tolist()))
    return time.perf_counter() - t0


def phase_libsvm(port, sparse, native, rcv1):
    """Phase 11: phase 10's data through a LIBSVM file, the native parser
    and the same trainer."""
    t_phase = time.perf_counter()
    cfg, X = rcv1["cfg"], rcv1["X"]
    n, d, k = cfg["n"], cfg["d"], cfg["k"]
    cid = X.col_ids.cpu().numpy()
    val = X.values.cpu().numpy()
    y = rcv1["y"].cpu().numpy()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_libsvm_")
    try:
        path = os.path.join(tmp, "rcv1_like.libsvm")
        # time the reduced size first; the rest only if all of it fits
        write_s = write_libsvm(path, cid, val, y, k, LIBSVM_REDUCED_ROWS)
        rows = LIBSVM_REDUCED_ROWS
        if write_s * n / LIBSVM_REDUCED_ROWS <= LIBSVM_WRITE_LIMIT_S:
            write_s = write_libsvm(path, cid, val, y, k, n)
            rows = n
        file_mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        data = port.load_libsvm(path, n_features=d)
        parse_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fallback = native.pop_fallback_event("libsvm_parser.so")
    if fallback is not None or native.load_parser() is None:
        raise AssertionError(f"libsvm: the native parser did not run "
                             f"({fallback})")
    m = rows * k
    same = {"labels": np.array_equal(data.labels, y[:rows]),
            "indptr": np.array_equal(data.indptr,
                                     np.arange(rows + 1) * k),
            "indices": np.array_equal(data.indices, cid[:m]),
            "values": np.array_equal(data.values, val[:m])}
    if not all(same.values()):
        raise AssertionError(f"libsvm: parsed arrays differ from the "
                             f"card-made ones: {same}")

    def trainer():
        t = rcv1["trainer_cls"](reg_param=cfg["reg"])
        t.optimizer.setNumIterations(ITERS).setConvergenceTol(TOL)
        return t

    Xf = sparse.CSRMatrix.from_csr_arrays(data.indptr, data.indices,
                                          data.values, d, device="cuda")
    t0 = time.perf_counter()
    model = trainer().train(Xf, data.binarized_labels())
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    ref = rcv1["model"]
    if rows < n:  # the same rows, held in memory
        ref = trainer().train(
            sparse.CSRMatrix(X.row_ids[:m], X.col_ids[:m], X.values[:m],
                             (rows, d), rows_sorted=True),
            rcv1["y"][:rows])
    equal = bool(torch.equal(model.weights, ref.weights)
                 and model.intercept == ref.intercept)
    emit({"phase": "libsvm", "rows": rows, "features": d, "nnz": m,
          "reduced": None if rows == n else
          f"first {rows} of {n} rows: writing all would take "
          f"{write_s * n / rows:.1f} s, over {LIBSVM_WRITE_LIMIT_S} s",
          "file_mb": file_mb, "write_s": write_s, "parse_s": parse_s,
          "parse_mb_per_s": file_mb / parse_s, "native_parser": True,
          "arrays_bit_identical": True, "train_s": train_s,
          "weights_bit_identical": equal,
          "seconds": time.perf_counter() - t_phase})
    if not equal:
        raise AssertionError("libsvm: the fit from the file differs from "
                             "the in-memory fit")


def softmax_ab(port, fk, device_synth, specs, seeds):
    """``--ab``: the builds ``specs`` (NAME=SOURCE) of the softmax kernel
    timed in turns at phase 8's shape, each held to the f64 sums."""
    import ctypes

    from spark_agd_tpu_torch.models import glm

    names = [s.split("=", 1)[0] for s in specs]
    sources = [os.path.abspath(s.split("=", 1)[1]) for s in specs]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(specs)) as pool:
        libs = list(pool.map(fk.softmax_library, sources))
    emit({"phase": "ab_build", "seconds": time.perf_counter() - t0,
          "builds": {name: dict(build_report(b), source=src)
                     for name, src, (_, b) in zip(names, sources, libs)}})
    d = D_SM + 1
    for seed in seeds:
        X, y = device_synth.planted_softmax(N_SM, D_SM, K_SM, seed=seed)
        X = glm._add_intercept(X)
        W, _ = port.run((X, y), port.SoftmaxGradient(K_SM),
                        port.SquaredL2Updater(), reg_param=REG_SM,
                        num_iterations=ITERS, convergence_tol=TOL,
                        initial_weights=torch.zeros((d, K_SM),
                                                    device="cuda"))
        staged = fk.stage_softmax(X, y, K_SM)
        exact_loss, exact_grad = softmax_f64(K_SM, W, staged)
        out = {"phase": "ab", "seed": seed, "shape": [N_SM, d],
               "classes": K_SM, "grad_abs_max": float(exact_grad.abs().max()),
               "card_before": card_state()}
        for name, (lib, _) in zip(names + names[::-1], libs + libs[::-1]):
            rows, grid = ctypes.c_int(), ctypes.c_int()
            if lib.softmax_plan(N_SM, d, K_SM, 4,
                                fk._device_sms(X.device.index),
                                ctypes.byref(rows), ctypes.byref(grid)):
                raise AssertionError(f"{name}: softmax_plan refused the shape")
            plan = rows.value, grid.value

            def call(lib=lib, plan=plan):
                return fk._launch(lib, "softmax_loss_grad", "softmax", K_SM,
                                  W, staged, plan)

            loss, grad = call()
            r = out.setdefault(name, {"tile_rows_grid": list(plan), "ms": []})
            r["ms"].append(time_ms(call))
            r["grad_max_abs_err_vs_f64"] = float(
                (grad.double() - exact_grad).abs().max())
            r["loss_rel_err_vs_f64"] = abs(
                float(loss) - float(exact_loss)) / abs(float(exact_loss))
        out["card_after"] = card_state()
        emit(out)
        del X, y, staged, exact_grad
        torch.cuda.empty_cache()


def main(argv):
    parser = argparse.ArgumentParser(
        description="Drive the PyTorch port on one CUDA card.")
    parser.add_argument("--ab", nargs="+", metavar="NAME=SOURCE",
                        help="time these builds of the softmax kernel "
                             "instead of running the phases")
    parser.add_argument("--seeds", default="3",
                        help="data seeds of --ab, comma-separated")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import spark_agd_tpu_torch as port
    from spark_agd_tpu_torch import native
    from spark_agd_tpu_torch.data import device_synth
    from spark_agd_tpu_torch.models import glm
    from spark_agd_tpu_torch.ops import fused_kernels as fk, losses, sparse

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = gpu_name_and_power()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    if args.ab:
        softmax_ab(port, fk, device_synth, args.ab,
                   [int(s) for s in args.seeds.split(",")])
        return 0

    # 2-4. build, and each kernel against its plain version
    phase_build(fk)
    phase_kernel(fk, losses)
    phase_softmax_kernel(fk)

    # 5-8. the two paths at full width, one after the other
    margin = margin_path(port, fk, losses, device_synth)
    torch.cuda.empty_cache()
    softmax = softmax_path(port, fk, device_synth)
    torch.cuda.empty_cache()

    # 9-12. the sparse data plane: the products, BASELINE configs 1 and 3
    t0 = time.perf_counter()
    phase_sparse_ops(port, fk, sparse, device_synth, glm)
    torch.cuda.empty_cache()
    rcv1 = sparse_path(port, fk, sparse, device_synth, glm, "rcv1_path",
                       RCV1, glm.LogisticRegressionWithAGD,
                       port.LogisticGradient, port.L2Prox)
    phase_libsvm(port, sparse, native, rcv1)
    rows = {"rcv1_like": rcv1["row"]}
    del rcv1
    torch.cuda.empty_cache()
    url = sparse_path(port, fk, sparse, device_synth, glm, "url_path", URL,
                      glm.SVMWithAGD, port.HingeGradient, port.L1Prox)
    rows["url_like"] = url["row"]
    del url
    torch.cuda.empty_cache()
    emit({"phase": "sparse_products", **rows,
          "seconds": time.perf_counter() - t0})

    # 13. the kernels line, the card, the result
    emit({"kernels": [margin, softmax]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
