#!/usr/bin/env python3
"""Phase 43 of ``chip_smoke.py`` run several times on one card, each time
after a fresh run of phase 5's fit (the bits it holds the phase to): the
spread of the checkpointed fits' median wall time against the plain
fit's (each timed in turns within the phase), and the seconds its saves,
beats and monitor checks held the fit.  Not part of the package.

Usage, from the root of a checkout on a machine with one CUDA card:
``python3 probes/dist_ckpt_repeat.py [RUNS]`` (4 by default).  Prints
each run's ``dist_ckpt_fit`` line, then one ``dist_ckpt_repeat`` line
with the ratios of every run and the checks that failed in any.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def main(argv):
    runs = int(argv[0]) if argv else 4
    if not torch.cuda.is_available():
        print("dist_ckpt_repeat: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import spark_agd_tpu_torch as port
    from spark_agd_tpu_torch.data import device_synth
    from spark_agd_tpu_torch.ops import fused_kernels as fk

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.gpu_name_and_power()
    print(smi, flush=True)
    cs.phase_build(fk)
    X, y = device_synth.class_logistic(cs.N_MAIN, cs.D_MAIN, seed=0)
    w0 = torch.zeros(cs.D_MAIN, dtype=torch.float32, device="cuda")
    kw = dict(reg_param=cs.REG, num_iterations=cs.ITERS,
              convergence_tol=cs.TOL, initial_weights=w0, return_result=True)

    def phase5():
        return port.run((X, y), port.FusedLogisticGradient(),
                        port.SquaredL2Updater(), **kw)

    phase5()  # warm
    lines, failed, emitted = [], [], []
    emit = cs.emit

    def keep(obj):  # the phase's line, as chip_smoke prints it
        emitted.append(obj)
        emit(obj)

    cs.emit = keep
    for _ in range(runs):
        (w, h, r), s = cs.timed(phase5)
        try:
            cs.dist_ckpt_fit(port, fk, smi, X, y, (r, h, s), {"modes": {}})
        except AssertionError as e:
            failed.append(str(e))
        lines.append(emitted[-1])
    keys = ("a_over_plain_median_wall", "hooks_over_plain_median_wall",
            "a_held_s", "hooks_held_s", "phase5_run_s")
    emit({"phase": "dist_ckpt_repeat", "runs": runs, "card": smi,
          **{k: [line[k] for line in lines] for k in keys},
          "failed": failed, "at": time.strftime("%Y-%m-%dT%H:%M:%S")})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
