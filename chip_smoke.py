#!/usr/bin/env python3
"""Drive the PyTorch port (``spark_agd_tpu_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
NVIDIA card, ``nvcc`` (PATH, ``$CUDA_HOME`` or ``/usr/local/cuda``) and
no network; it builds the port's CUDA kernel from the checkout's sources.

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build: the margin kernel's ``nvcc`` build;
3. kernel: the CUDA margin kernel against its plain PyTorch version on
   the card (3 losses x f32/bf16 x masked/unmasked x w = 0/random, on
   ragged shapes and at the kernel's width limit), each call repeated
   to check that it is bit-identical; one column past the limit raises;
4. main path: a 10,000,000 x 1,000 f32 class-logistic dataset made on the
   card, fit with ``AcceleratedGradientDescent(FusedLogisticGradient(),
   SquaredL2Updater()).setRegParam(0.1).setNumIterations(40)
   .setConvergenceTol(0.0).optimize`` and ``run(..., return_result=True)``
   (bench.py's flagship fit), held to the same ``run`` through
   the plain ``LogisticGradient`` (two cuBLAS products);
5. times at the main-path shape (CUDA events, median of 20 after a
   warm-up): the kernel, its bound, its plain version, the two
   ``torch.matmul`` products alone;
6. the ``kernels`` line; then the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the last
line.  It also exits non-zero when CUDA is not available.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_MAIN, D_MAIN = 10_000_000, 1_000
# bench.py's flagship fit: logistic + L2, reg 0.1, 40 iterations with
# convergence_tol 0 (bench.py:323), so both fits run all 40: at the
# default tol 1e-4 the stop test is a knife edge that f32 summation order
# decides (15 vs 16 iterations between the kernel and cuBLAS here)
ITERS, REG, TOL = 40, 0.1, 0.0
# H100 SXM data sheet: 3.35 TB/s of HBM3, 67 TFLOP/s f32 (no tensor core)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_REL = 1e-5, 1e-4, 1e-4  # test_pallas.py


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


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


def compare(fk, gradient, w, staged, where):
    """Kernel twice (bit-identical) against the plain version; returns
    ``(loss relative error, grad max abs error)``."""
    loss, grad = fk.fused_margin_loss_grad(gradient, w, staged)
    loss2, grad2 = fk.fused_margin_loss_grad(gradient, w, staged)
    torch.cuda.synchronize()
    if not (torch.equal(loss, loss2) and torch.equal(grad, grad2)):
        raise AssertionError(f"{where}: repeated kernel calls differ")
    ref_loss, ref_grad = fk.fused_margin_loss_grad_reference(gradient, w,
                                                             staged)
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
                        le, ge = compare(
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import spark_agd_tpu_torch as port
    from spark_agd_tpu_torch.data import device_synth
    from spark_agd_tpu_torch.ops import fused_kernels as fk, losses

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = gpu_name_and_power()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 2. build
    t0 = time.perf_counter()
    _, built = fk.library()
    regs = [ln.split(":", 1)[1].strip() for ln in built.log.splitlines()
            if "Used" in ln and "registers" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built.seconds, "library": built.path.name,
          "ptxas": sorted(set(regs)),
          "max_width": {"f32": fk.max_width(torch.float32),
                        "bf16": fk.max_width(torch.bfloat16)}})

    # 3. the kernel against its plain version
    phase_kernel(fk, losses)

    # 4. the main path at full width
    t0 = time.perf_counter()
    X, y = device_synth.class_logistic(N_MAIN, D_MAIN, seed=0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    w0 = torch.zeros(D_MAIN, dtype=torch.float32, device="cuda")

    class CountingFused(port.FusedLogisticGradient):
        """Counts smooth evaluations, to hold launches against them."""
        evaluations = 0

        def batch_loss_and_grad(self, weights, X, y, mask=None):
            self.evaluations += 1
            return super().batch_loss_and_grad(weights, X, y, mask)

    fused = CountingFused()
    torch.cuda.reset_peak_memory_stats()
    fk.launch_count = 0
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
    # Both fits reach the f32 loss floor (7 digits) after about a dozen
    # iterations; from there the exact-zero-step stop is decided by
    # summation-order rounding, so the two fits may stop at different
    # iterations.  Where they do, the one that stopped must have stopped
    # by its own criterion, and every later loss of the other must sit
    # at its final loss within the same rtol.
    shorter, longer = ((res, hist_plain) if n_iters <= n_plain
                       else (res_plain, hist))
    same_stop = n_iters == n_plain or (
        bool(shorter.converged) and not bool(shorter.aborted_non_finite)
        and bool(np.allclose(longer[n_common:],
                             float(shorter.loss_history[n_common - 1]),
                             rtol=1e-4, atol=0.0)))
    checks = {
        # one launch per smooth evaluation, in each fit
        "launches_equal_evaluations": launches == fused.evaluations > 0,
        "run_launches_equal_run_evaluations":
            launches - launches_optimize
            == fused.evaluations - evaluations_optimize > 0,
        "same_stop_or_both_at_floor": same_stop,
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

    # 5. times at the main-path shape, at the fitted weights
    gradient = losses.LogisticGradient()
    staged = fk.stage_dense(X, y)
    loss_err, max_abs_err = compare(fk, gradient, w_run, staged,
                                    "main-path shape")
    kernel_ms = time_ms(lambda: fk.fused_margin_loss_grad(gradient, w_run,
                                                          staged))
    plain_ms = time_ms(lambda: fk.fused_margin_loss_grad_reference(
        gradient, w_run, staged))
    mult = torch.randn(N_MAIN, device="cuda")
    two_mm_ms = time_ms(lambda: (X @ w_run, mult @ X))
    n, d = X.shape
    bytes_moved = n * d * 4 + 2 * n * 4 + d * 4 + 4 + d * 4
    flops = 4 * n * d
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S,
                   flops / F32_FLOPS_PER_S) * 1e3
    per_fit = launches - launches_optimize  # the run's own launches
    emit({"phase": "times", "shape": [n, d], "kernel_ms": kernel_ms,
          "bound_ms": bound_ms, "bound_by": "bytes",
          "bound_source": "H100 SXM data sheet 3.35 TB/s, 67 TFLOP/s f32",
          "kernel_bw_frac": bound_ms / kernel_ms,
          "plain_ms": plain_ms, "two_matmuls_ms": two_mm_ms,
          "launches_per_fit": per_fit,
          "kernel_share_of_run_wall": per_fit * kernel_ms / (run_s * 1e3),
          "main_shape_loss_rel_err": loss_err,
          "main_shape_grad_max_abs_err": max_abs_err})

    # 6. the kernels line, the card, the result
    emit({"kernels": [{
        "name": "margin_loss_grad", "route": "cuda",
        "source": "spark_agd_tpu_torch/csrc/margin_loss_grad.cu",
        "replaces": "spark_agd_tpu/ops/pallas_kernels.py:182",
        "counterpart": "spark_agd_tpu/ops/pallas_kernels.py:"
                       "fused_margin_loss_grad",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None,
        "two_matmuls_ms": two_mm_ms}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
