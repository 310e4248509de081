#!/usr/bin/env python3
"""Drive the PyTorch port (``spark_agd_tpu_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
NVIDIA card with 80 GB, ``nvcc`` (PATH, ``$CUDA_HOME`` or
``/usr/local/cuda``) and no network; it builds the port's CUDA kernels
from the checkout's sources.

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build: the three libraries' ``nvcc`` builds, started together; the
   margin kernel's hand-overs (its cluster mode's widest X and its grid
   mode's, the widest read once) and the softmax kernel's (the widest X
   its one-read kernel takes at K = 10, 20 and 32);
3. kernel: the CUDA margin kernel against its plain PyTorch version on
   the card (3 losses x f32/bf16 x masked/unmasked x w = 0/random) at
   D in {1, 2, 3, 7, 8, 31, 32} (its narrow mode, at 2,000,003 rows, so
   that each thread walks several groups of rows and a ragged last
   group), at D in {33, 54, 64, 65, 90} and the warp-rows hand-over and
   one column either side of it, and bf16 at 127 and 129 (its warp-rows
   mode, and the tile past it, at 100,003 rows, not a multiple of a
   warp's rows), at ``tile_max_width`` and one column past it (the tile's
   hand-over to the stream mode), at D in {777, 1000} (the stream mode;
   bf16 777 the tile), at ``max_width`` and one column past it (the
   cluster mode), each call repeated to
   check that it is bit-identical, each line with the plan and its
   launches, each plan's mode held to the width rule (narrow, warp-rows,
   tile, stream, cluster to ``cluster_max_width`` but f32 rows not
   16-byte aligned from ``grid_unaligned_from_width``, grid to
   ``grid_max_width``, two-pass past it); a ``widths_by_mode`` and a
   ``past_width_cluster`` line;
4. softmax_kernel: the CUDA softmax kernel against its plain version
   (N = 100,003, D in {784, 785, 777}, K in {1, 2, 3, 8, 9, 10, 16, 17,
   32}, and 33 and 100 at D = 785, f32/bf16 x masked/unmasked x W =
   0/random), each call repeated, each plan's mode ("one_read" up to 32
   classes while a row tile fits, else "two_pass") held to that rule; at
   D = 785, K = 10 and 33 also against f64 sums; then, against f64 sums,
   1,000 classes at D = 785 and 10 classes at the one-read kernel's
   widest X and one column past it;
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
   also the kernel's device time by kernel name (``torch.profiler``,
   without the wrapper's host time that the event times include) and
   the two products' device time; so too in phases 16 and 19 and for
   ``--ab margin:``;
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
   bit-identical; the same matrix with bf16 values: matvec and rmatvec,
   and the logistic loss and gradient (f32), against f64 sums over the
   same values; ``FusedLogisticGradient`` and ``FusedSoftmaxGradient``
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
13. lbfgs_path, on phase 5's data (run after phase 6, before it is
    freed): ``LBFGS(FusedLogisticGradient(), SquaredL2Updater())
    .setRegParam(0.1).setNumIterations(40).optimize``, ``run_lbfgs``
    with the same, and OWL-QN (``make_lbfgs_runner`` with ``L1Prox``, reg
    1e-3, which must route to ``"owlqn"``), each held to the same fit
    through the plain ``LogisticGradient``: loss histories at rtol 1e-4
    over the iterations before the two fits' line searches first part
    (``diag_step``/``diag_evals``), printed with where they part, the
    evaluations, stop reasons and exact zeros;
14. softmax_lbfgs_path, on phase 7's data (after phase 8):
    ``SoftmaxRegressionWithLBFGS(10, reg_param=1e-4)`` with
    ``FusedSoftmaxGradient`` in the seat (``train``, then ``run_lbfgs``),
    held to ``run_lbfgs`` through the plain ``SoftmaxGradient`` as 13;
15. rcv1_lbfgs, on phase 10's CSR (after phase 11):
    ``LogisticRegressionWithLBFGS(reg_param=1e-4)`` at f32, held to the
    same fit at f64 as 13, and the f32 gradient at the final weights to
    f64 sums within 1e-4 of its largest entry;
16. gd_gate: the reference's correctness spec (AGD at 10 iterations
    within 2% of MLlib GD at 50, ``tests/test_reference_suite.py:38-50``)
    at 10,000,000 rows of its own problem family
    (``generate_gd_input(2, -1.5, seed 42)`` and the intercept column),
    both through ``FusedLogisticGradient``; the kernel GD held to the
    plain GD at rtol 1e-4; a GD at fraction 0.1 (seed 42) whose masks,
    drawn on the card, equal the CPU draw bit for bit; the kernel
    against its plain version at this narrow shape (at the start and at
    GD's weights: each thread walks about 74 rows), and its time there
    (every launch in its narrow mode) beside its plain version's, the
    two ``torch.matmul`` products' (which it must beat) and its bound;
17. linreg_path: BASELINE config 2 as published, 10,000,000 x 1,000
    ``planted_dense_linreg`` (seed 2) through
    ``LinearRegressionWithAGD(add_intercept=False)`` with
    ``FusedMarginGradient(LeastSquaresGradient())`` in the seat (40
    iterations, convergence_tol 0), held to the plain fit as phase 5 is;
    GD at config 2's step 0.1 (50 iterations) through the kernel, held to
    plain GD at rtol 1e-4;
18. mlp_path: BASELINE config 5 as published, ``planted_mlp`` 1,000,000
    x 1,024 (hidden 32, 2 classes, seed 4) through
    ``MLPClassifierWithAGD(32, 2, reg_param=1e-5)`` (tanh, 40 iterations,
    convergence_tol 0), held to the same fit at f64 over their common
    path and the final gradient to f64 sums; the training accuracy;
19. wide_path: X past one row in shared memory.  The margin kernel
    against its plain version at D = 40,000 and 200,000 (3,000 rows),
    one column past ``cluster_max_width`` and one past
    ``grid_max_width`` (300 rows), f32 and bf16, as phase 3, each plan's
    mode held to the width rule (the cluster mode up to
    ``cluster_max_width``, 40,000 columns in it, the grid mode up to
    ``grid_max_width``, the two-pass mode past it); an AGD fit at
    100,000 x 40,000 f32 made on the card (16 GB, a gene-expression-like
    shape) through ``FusedLogisticGradient`` and ``SquaredL2Updater``
    (reg 0.1, 20 iterations, tol 0), every launch in the cluster mode,
    held to the plain fit as phase 5 is; the kernel there held to f64
    sums and its ms per evaluation beside the bound (X read once), the
    two-pass floor (X twice) and the two ``torch.matmul`` products;
    then the grid mode held to f64 sums and timed (device ms by kernel
    name) at 10,000 x 262,145 and 262,148 f32 and 262,145 bf16
    (``margin_times``), and the two-pass mode at 300 rows one column past
    ``grid_max_width`` (f32);
    then phase 30 on its data; then the lanes kernel's two-pass mode at
    100,003 rows one column past ``lanes_max_width`` for 8 and for 16
    lanes (``lanes_two_pass_times``: held to f64 sums, the plan held to
    the two-pass mode, device ms by kernel name, so by pass, beside the
    bound, the two-pass floor of X read twice, the plain version and the
    two products);
20. the ``kernels`` line (with each kernel's launches by path, the
    streamed paths of phases 32-34 among them, the margin and softmax
    kernels' modes by path and their numbers by mode (the margin grid
    mode's at phase 31's shape and at phase 19's GRID_TIMES, the stream
    mode's a batch at a time in phase 32), the lanes kernel's modes by
    path and its numbers by
    mode: ``lanes_mma`` at phase 22's shape, ``lanes_cluster`` at phase
    29's, the two-pass mode at phase 30's and phase 19's, and
    each library's registers and spills by kernel, the margin cluster
    and grid modes' instantiations among them); then the card's name and
    power limit, and last ``{"ok": true, "device": {...}}``;
21. lanes_kernel, right after phase 4: the K-lane margin kernel
    (``csrc/margin_lanes_loss_grad.cu``) against its plain version, and
    each lane against the solo kernel, at K in {1, 2, 3, 8, 16, 17, 20}
    (every lane bucket, one past the largest, two chunks) and D in {1,
    2, 33, 1000, 1001, 1024, 40,000} plus each bucket's ``lanes_mma``
    reach, the column before its cluster mode's first
    (``lanes_cluster_min_width``), its widest one-read width
    (``lanes_max_width``, the cluster mode's reach) and one column past
    each, f32/bf16 x masked/unmasked,
    all three losses at D = 1000, K = 8, each call repeated
    bit-identical, each plan's mode held to the width rule (one block a
    row below ``lanes_cluster_min_width``, the cluster mode from there to
    ``lanes_max_width``, the two-pass mode past it: ``lanes_max_width``
    ends where the plan hands over to the two-pass mode, so the edges
    follow the hand-over);
22. sweep_path, on phase 5's data after phase 13: ``AcceleratedGradient
    Descent(FusedLogisticGradient(), SquaredL2Updater()).sweep`` over
    the 8 strengths 10^-1 ... 10^-8 (40 iterations, tol 0), every launch
    the lanes kernel, one per evaluation round; each lane held to the
    same sweep through the plain ``LogisticGradient`` and the 0.1 lane
    to phase 5's solo fit (rtol 1e-4 over common iterations,
    ``same_stop``); the kernel held to f64 sums at 8 random weight rows,
    its distance from them at the sweep's weights beside the solo
    kernel's and the plain version's, and its ms per round beside its
    bound, the plain version, the two ``torch.matmul`` products on (D,
    8) and 8 solo launches; the sweep's wall time beside 8 x phase 5's
    solo ``run``;
23. cv_path, on the same data: ``LogisticRegressionWithAGD(add_intercept=
    False).cross_validate`` over 4 strengths and 5 folds (20 lanes,
    the plain gradient, no kernel launch) with its refit; the fold ids
    drawn on the card equal to the CPU draw bit for bit, ``val_loss``
    equal to each lane's held-out mean loss, two lanes held to solo
    ``run``s under their train masks;
24. softmax_sweep, on phase 7's data after phase 14:
    ``SoftmaxRegressionWithAGD(10, add_intercept=False).train_path`` on
    the intercept-augmented X with ``FusedSoftmaxGradient`` in the seat
    (3 strengths, 10 iterations; one softmax launch a lane a round),
    each lane held to the plain sweep;
25. mid_path, after phase 16: 10,000,000 x 54 f32 class-logistic data
    made on the card (covtype.binary's width), the flagship's AGD fit
    through ``run`` with ``FusedLogisticGradient``, every launch in the
    margin kernel's warp-rows mode, held to the plain fit as phase 5 is;
    the kernel at the fitted weights held to f64 sums (phase 3's
    tolerance) and timed beside its bound, its plain version and the two
    ``torch.matmul`` products, which it must beat;
26. softmax_wide, after phase 19: the softmax kernel's two-pass mode at
    CIFAR-100's shape (50,000 x 3,072 f32, 100 classes), LIBSVM's aloi
    (108,000 x 128, 1,000 classes) and CIFAR-10's (50,000 x 3,072, 10
    classes), data made on the card: held to f64 sums (repeat
    bit-identical), timed by events and by the profiler (by pass)
    beside its bound (``softmax_bound``: X once, or the products in
    TF32; the two-pass design's floor and the f32-FMA figure beside
    it), its plain version and the two ``torch.matmul`` products; and
    a ``SoftmaxRegressionWithAGD`` fit (``run`` and ``train``) at
    CIFAR-100's shape, every launch in the two-pass mode, held to the
    plain fit over their common iterations;
27. lbfgs_sweep_path, on phase 5's data after phase 22: ``LBFGS(
    FusedLogisticGradient(), SquaredL2Updater()).sweep`` over the 8
    strengths 10^-1 ... 10^-8 (40 iterations at MLlib's tol 1e-4), one
    launch of the lanes kernel a round, each lane held to its solo
    ``run_lbfgs`` through the margin kernel over their common path
    (``hold_lbfgs``); the path's wall time beside the 8 solo fits'.
28. epsilon_path, after phase 25: 400,000 x 2,000 f32 class-logistic
    data made on the card (LIBSVM's epsilon, the PASCAL Large Scale
    Learning Challenge's dense set), read as phase 25 is, every launch
    in the margin kernel's stream mode (the plan's for 2,000 columns);
29. epsilon_sweep, on phase 28's data: the path of phase 22 (8
    strengths, 40 iterations, tol 0) read as phase 22 is, every launch
    in the lanes kernel's cluster mode, the 0.1 lane held to phase 28's
    solo ``run``;
30. wide_sweep, on phase 19's data (100,000 x 40,000 f32) after its
    fit: the path of phase 22 (8 strengths, phase 19's 20 iterations,
    tol 0) read as phase 22 is, every launch in the mode the lanes
    kernel's plan gives there (its two-pass mode: 40,000 columns lie
    past ``lanes_max_width`` for 8 lanes), the 0.1 lane held to phase
    19's solo fit; the kernel held to f64 sums at 8 random weight rows
    and timed by events and by the profiler, by pass, beside its bound,
    the two-pass floor, the plain version, the two products and 8 solo
    launches; the path's wall time beside 8 solo ``run``s;
31. snp_path, after phase 19 (whose X is freed first): 10,000 x 500,000
    f32 class-logistic data made on the card (20 GB; a genotype matrix's
    width: SNP arrays measure 500,000-800,000 markers), read as phase 25
    is, every launch in the margin kernel's grid mode;
32. stream_path, after phase 5 (whose data was copied once into pinned
    host memory at the end of phase 23, after ``MemAvailable`` was read
    and found to hold it; the card's copy is freed): the data streamed
    through ``StreamingDataset.from_arrays`` in batches of 1,048,576
    rows (the last a ragged 562,816), 2 batches prepared ahead,
    ``make_streaming_smooth(FusedLogisticGradient())`` and
    ``run_agd_host`` at phase 5's settings capped at 10 iterations:
    every launch in the margin kernel's stream mode, one a batch a pass;
    the first evaluation and one at phase 5's weights held to f64 sums
    over the same stream, the loss history to phase 5's over their
    common iterations (rtol 1e-4); the pass seconds, the stall share,
    the host-to-device GB/s beside plain pinned ``copy_``s of one batch
    and of the whole pass back to back (``pass_copy_s_best``), the
    kernel's device ms a batch, the card's peak allocation (under 2 + 2
    batches + 1 GB) and ``MemAvailable``;
33. stream_sweep, on phase 32's stream: ``streaming_sweep`` over the 8
    strengths of phase 22 capped at 10 iterations, every launch in the
    lanes kernel's ``lanes_mma`` mode, one a batch a round, each lane
    held to phase 22's; then ``streaming_lbfgs_sweep`` over the same
    strengths, each lane held to phase 27's;
34. stream_libsvm, inside phase 11: its file cut into 8 LIBSVM part
    files, streamed through ``from_libsvm_parts`` (65,536 rows a batch, 2
    ahead) for a 3-iteration logistic AGD fit through ``run_agd_host``,
    held to the same fit of the parsed arrays in memory over common
    iterations (rtol 1e-4); the parse MB/s, the passes' MB/s and the
    stall share; CSR launches no kernel;
35. supervised_fit, on phase 5's data after phase 27: the flagship fit
    under the supervisor (``ResiliencePolicy(segment_iters=5)``, an
    ``AutoCheckpointer`` every 5 iterations keeping 2 generations): (a)
    ``run(..., resilience=, checkpointer=)`` gives phase 5's bits
    (weights and history); (b) ``run_agd_supervised`` under
    ``FaultScript(device_loss_at_iter=10, nan_at_iter=20)``: one retry,
    one rollback, the ledger as scripted, the fit ends at phase 5's loss
    (rtol 1e-4); (c) ``FaultScript(sigterm_at_iter=15)`` raises
    ``Preempted``, the newest generation is truncated, and the rerun
    resumes from the generation that survives to (a)'s bits; the wall
    seconds beside phase 5's, the checkpointer's device-to-host copy and
    npz write ms per save and their share of the wall time; every launch
    the margin kernel's stream mode;
36. supervised_path, after phase 35: ``run_agd_multi_checkpointed`` over
    phase 22's 8 strengths, stopped after 20 iterations and resumed,
    gives lane by lane the bits of the same call run straight (every
    launch ``lanes_mma``), with its largest difference from phase 22's
    ``sweep``; ``run_lbfgs_checkpointed`` on the flagship split 2 + 3
    gives the bits of the same call run straight for 5, held to phase
    13's ``run_lbfgs`` at rtol 1e-4;
37. supervised_stream, after phase 33 on its stream (the pinned source
    still held): a 3-iteration ``run_agd_supervised(driver="host")``
    over the streamed smooth, a segment an iteration, a
    ``StreamCheckpoint`` every 4 batches, a SIGTERM from a
    ``threading.Timer`` about half a pass into iteration 2; resumed from
    the newest generation (iteration 2 replayed) and from the cursor's
    (its committed batches skipped), each to the bits of phase 32's fit
    after 3 iterations; where the signal landed and what was replayed;
38. chaos_soak, on phase 28's data after phase 29: five seeded
    ``ChaosCampaign``s (their faults: nan, device_loss, sigterm, fatal,
    truncate_ckpt, scramble_ckpt and slow_host) through ``run_campaign``
    in segments of 4, the clean supervised run first (phase 28's bits):
    every outcome ``converged`` (the clean run's final loss; its bits
    where no NaN rolled a segment back) or ``gave_up`` where a fatal
    fault fired, never ``mismatch`` or ``stalled``.

Launch counts are set to 0 just before each path (phases 5, 7, 10-19,
22-38) and read just after it; the sparse paths launch neither kernel,
nor do the MLP and the cross-validation.  Each phase from 13 on prints its fit wall times with the card's
name and power limit.  Any failed check raises, and the script exits
non-zero without the last line.  It also exits non-zero when CUDA is not
available.

``python3 chip_smoke.py --ab NAME=SOURCE [...] [--seeds 3,4]`` runs none
of the phases.  It times versions of the softmax kernel side by side
instead: each SOURCE is a copy of ``csrc/softmax_loss_grad.cu`` (the
shipped file, a parent commit's with the one-read kernel's older C
interface, an edited variant), with ``tile_common.cuh`` beside it.  All
are built at once, then for each seed phase 8's data and weights are
made (planted-softmax data, the intercept column, W from 40 iterations
of the plain fit), and the builds are timed in turns, A, B, ..., then
back, each held to the f64 sums: each build's one-read kernel (with a
same-bits flag against the first build's) and, as ``NAME:two_pass``,
its two-pass mode forced at this shape (with a same-bits-on-repeat
flag), beside both modes' bounds; one ``ab`` line per seed.

``python3 chip_smoke.py --ab margin:NAME=SOURCE [...] [--shapes
sweep,grid]`` does the same for copies of ``csrc/margin_loss_grad.cu``
with its C interface (this one, or an earlier commit's with the four-int
plan of the sources from before the cluster mode).  "sweep": at
10,000,000 rows of f32 X of width 1, 2, 3, 8, 16,
32, 33, 40, 48, 54, 64, 90, 96, 127, 128, 129, 192, 255, 256, 257, 264,
265, 272, 273, 288, 289, 320, 384, 448, 512 and 1000, of bf16 X of width
33, 64, 65, 127, 128, 129, 192, 255, 256, 257, 384, 512, 768, 793, 794,
800, 896 and 897 (the warp-rows mode's widths and its hand-overs, the
tile's hand-over, at odd and even widths), the single-block range (f32 1,001
and 1,024 at 10,000,000 rows and 2,000, 2,001, 3,072, 4,096, 5,000,
8,191, 8,192, 12,288 and 16,384 at the rows that make f32 X about 8 GB;
bf16 1,000 and 1,001 at 10,000,000 rows and 2,000, 2,001, 3,072, 4,096,
8,192, 16,383 and 16,384 likewise), the cluster
mode's two ends (the tile's widest before the stream mode, 19,364 f32
and 23,238 bf16, this tree's ``max_width``, one column past each, at
100,000 rows, and ``cluster_max_width``) and 100,000 x 40,000 f32 and
bf16: one
``ab_margin`` line a shape, with each build's plan, ms by CUDA events
and by the profiler, error from f64 sums and whether its bits equal the
first build's, the bound and the two ``torch.matmul`` products' time.
Past the warp-rows mode the tile, the stream mode and the cluster mode
at 2 and 4 blocks are each forced, wherever they take the width, through
the first build that can force them (``margin_mode_plan``;
``NAME:tile``, ``NAME:cluster2``, ...).  Last, each build runs the
flagship fit (10,000,000 x 1,000 f32, logistic AGD) at AB_FIT_ITERS
iterations, in turns: one ``ab_margin_fit`` line with each build's wall
seconds, iterations, evaluations and final loss.  "grid": the grid
mode's shapes at AB_GRID_ROWS rows (AB_GRID_SHAPES: the hand-over from
the cluster mode at 131,072, 196,608 and 262,144 columns and one column
under each, f32 and bf16; 262,145 f32 and bf16 and 262,148 f32, past
the cluster mode's reach; the 500,000 of phase 31; this tree's
``grid_max_width`` and one column past it at fewer rows), where the
cluster mode at 8 and 16 blocks, the grid mode and the two-pass mode are
each forced through the first build that can force them, every line
with each build's device ms by kernel name (so the two-pass mode's by
pass).
It fails if a build's result is further from the f64 sums than phase
3's tolerance (loss rtol 1e-5, gradient 1e-4 of each entry plus 1e-4 of
the largest).

``python3 chip_smoke.py --ab lanes:NAME=SOURCE [...] [--shapes
sweep,edges,handover,two_pass]`` does the same for copies of
``csrc/margin_lanes_loss_grad.cu``: "sweep", 10,000,000 rows of f32 X at
D in {64, 256, 512, 1000} and K in {1, 2, 4, 8, 16}; "edges", for each
K the widths of the first build that knows them, at 100,003 rows:
``lanes_mma``'s reach, the widest one-read width, and one past each, and
the first width of the cluster mode (f32 and bf16) and one before it;
"handover", the widths that decide the plan's hand-overs
(LANES_AB_HANDOVER: f32 1,024-12,000 and 40,000 columns, LIBSVM
epsilon's 400,000 x 2,000, bf16 1,280-12,000, at the lane counts that
run there); "two_pass", the two-pass mode's shapes
(LANES_AB_TWO_PASS: each K's reach of the cluster mode and one column
past it, 40,000 columns, 100,000 x 40,000, 10,000 x 262,145, bf16 past
the reach, the hand-over region under the f32 reach), where every build
that can force it also runs its two-pass mode (``NAME:lanes_two_pass``)
and each line carries the two-pass floor (X read twice); one
``ab_lanes`` line a shape and K, with each
build's plan, ms by CUDA events and by the profiler, error from f64 sums
(held lane by lane) and same-bits flag, and the two ``torch.matmul``
products on (D, K), ``X @ W.T`` and ``M.T @ X``, each alone and as a
pair, by CUDA events (and the pair by the profiler).  At the edges and
handover shapes the first build that can force a mode
(``lanes_mode_plan``) also times ``lanes_mma``, ``lanes_tile``,
``lanes_cluster`` at 2, 4, 8 and 16 blocks and ``lanes_two_pass``
wherever they take the width (``NAME:lanes_tile``,
``NAME:lanes_cluster2``, ...).
"""

import argparse
import concurrent.futures
import dataclasses
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
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
# H100 SXM data sheet: 3.35 TB/s of HBM3, 67 TFLOP/s f32 (no tensor core),
# 495 TFLOP/s dense TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
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
# OWL-QN on the flagship data (phase 13)
L1_MAIN = 1e-3
# the reference's GD gate (tests/test_reference_suite.py:38-50) at 10M
# rows; the card's masks of a sampled GD are held to the CPU draw over
# all rows at three iterations and over the first MASK_ROWS at the rest
N_GATE, MASK_ROWS = 10_000_000, 250_000
# BASELINE config 5 (benchmarks/run.py:102-106, datasets.py:148-154)
MLP = dict(n=1_000_000, d=1_024, hidden=32, classes=2, seed=4, reg=1e-5)
# phase 19: dense X past one row in shared memory, the shape of a
# gene-expression matrix (about 20k-40k features, 1e4-1e5 samples), and
# the kernel checks at a few thousand rows
WIDE = dict(n=100_000, d=40_000, seed=5, reg=0.1, iters=20)
# phase 25: covtype.binary's width (581,012 x 54 in the LIBSVM
# collection) at the flagship's 10M rows, where the margin kernel runs its
# warp-rows mode
MID = dict(n=10_000_000, d=54, seed=7)
# phase 28: LIBSVM's epsilon (PASCAL Large Scale Learning Challenge,
# 400,000 x 2,000 dense), where the margin kernel runs its stream mode
EPSILON = dict(n=400_000, d=2_000, seed=8)
WIDE_CHECK = dict(rows=3_000, widths=(40_000, 200_000), past_rows=300)
# phase 31: a genotype matrix's width (SNP arrays: 500,000-800,000
# markers) at 10,000 samples, where the margin kernel runs its grid mode
SNP = dict(n=10_000, d=500_000, seed=9)
# the margin kernel's grid mode timed one column past the cluster mode's
# reach (rows not 16-byte aligned), at 262,148 f32 columns (aligned) and
# in bf16; and the lanes kernel's two-pass mode one column past
# lanes_max_width at 8 and 16 lanes (the widest X it reads once for each)
GRID_TIMES_ROWS = 10_000
GRID_TIMES = ((262_145, torch.float32), (262_148, torch.float32),
              (262_145, torch.bfloat16))
LANES_TWO_PASS_ROWS, LANES_TWO_PASS_K = 100_003, (8, 16)


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


def device_ms(fn, calls=10):
    """The mean device time of each kernel that ``fn`` launches (once a
    call), in ms by kernel name (``torch.profiler``'s CUDA activity over
    ``calls`` calls after a warm-up): without the host time between
    launches that ``time_ms`` includes.  Each kernel's time is averaged
    over the launches the profiler recorded, which can be fewer than the
    calls.  Empty where it recorded none (callers report None then)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if us and e.count:
            out[e.key[:80]] = us / 1e3 / e.count
    return out


def two_matmuls_device_ms(X, w, mult):
    """The device time of the two ``torch.matmul`` products ``X @ w``
    and ``mult @ X``, each profiled alone (``device_ms``) and summed;
    None where the profiler recorded none."""
    times = [device_ms(lambda: X @ w), device_ms(lambda: mult @ X)]
    return sum(sum(t.values()) for t in times) if all(times) else None


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
    return hold(loss, grad, ref_loss, ref_grad,
                f"{where}: kernel disagrees with its plain version")


def hold(loss, grad, ref_loss, ref_grad, what):
    """Raise ``AssertionError(what ...)`` unless ``(loss, grad)`` is
    within loss rtol LOSS_RTOL of ``ref_loss`` and ``grad`` within
    GRAD_RTOL of each entry of ``ref_grad`` plus GRAD_ATOL_REL of its
    largest; returns ``(loss relative error, grad max abs error)``."""
    loss_err = abs(float(loss) - float(ref_loss)) \
        / max(abs(float(ref_loss)), 1e-30)
    abs_err = (grad.to(ref_grad.dtype) - ref_grad).abs()
    gmax = float(ref_grad.abs().max())
    ok_grad = bool((abs_err <= GRAD_RTOL * ref_grad.abs()
                    + GRAD_ATOL_REL * gmax).all())
    if loss_err > LOSS_RTOL or not ok_grad or not torch.isfinite(grad).all():
        raise AssertionError(
            f"{what}: loss rel {loss_err:.3e} (tol {LOSS_RTOL}), grad max "
            f"abs {float(abs_err.max()):.3e} (|g|max {gmax:.3e})")
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


def kernel_registers(log):
    """``{kernel<template args>: [registers, spilled bytes stored and
    loaded, stack frame bytes]}`` of every kernel in a ``ptxas -v`` log
    (a stack frame without spills is an array that did not stay in
    registers)."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?_ZN(\w+)", ln)
        if m:  # the nested names <length><name>..., the kernel's last
            rest, name = m.group(1), ""
            while (n := re.match(r"\d+", rest)):
                size = int(n.group())
                name, rest = rest[n.end():n.end() + size], \
                    rest[n.end() + size:]
            t = re.match(r"I(\w+?)EEv", rest)
            if t:  # the mangled template arguments: X's type, then values
                args = re.sub(r"^f", "f32,", t.group(1).replace(
                    "13__nv_bfloat16", "bf16,"))
                args = re.sub(r"Li(\d+)E", r"\1,", args)
                args = re.sub(r"Lb([01])E", lambda v: ("false", "true")[
                    int(v.group(1))] + ",", args)
                name += f"<{args.rstrip(',')}>"
            cur = out.setdefault(name, [None, 0, 0])
            continue
        if re.search(r"(?:Compiling entry function|Function properties)",
                     ln):
            cur = None
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            if m:
                cur[1] = int(m.group(2)) + int(m.group(3))
                cur[2] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur[0] = int(m.group(1))
    return out


def build_report(b):
    """A build's time, file and ``ptxas`` report (registers, spills; each
    kernel's on its own)."""
    lines = b.log.splitlines()
    return {"nvcc_seconds": b.seconds, "library": b.path.name,
            "ptxas": sorted({ln.split(":", 1)[1].strip() for ln in lines
                             if "Used" in ln and "registers" in ln}),
            "spills": sorted({ln.strip() for ln in lines if "spill" in ln
                              and " 0 bytes spill" not in ln}),
            "registers_spills_by_kernel": kernel_registers(b.log)}


def phase_build(fk):
    """The three libraries, one ``nvcc`` each, started together."""
    t0 = time.perf_counter()
    libs = {"margin_loss_grad": fk.library,
            "margin_lanes_loss_grad": fk.lanes_library,
            "softmax_loss_grad": fk.softmax_library}
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        built = dict(zip(libs, pool.map(lambda lib: lib()[1],
                                        libs.values())))
    out = {"phase": "build", "seconds": time.perf_counter() - t0}
    for name, b in built.items():
        out[name] = build_report(b)
    out["tile_max_width"] = {"f32": fk.tile_max_width(torch.float32),
                             "bf16": fk.tile_max_width(torch.bfloat16)}
    for name in ("max_width", "cluster_max_width", "grid_max_width",
                 "grid_unaligned_from_width"):
        out[name] = {"f32": getattr(fk, name)(torch.float32),
                     "bf16": getattr(fk, name)(torch.bfloat16)}
    out["lanes_max_width_k8"] = {"f32": fk.lanes_max_width(8, torch.float32),
                                 "bf16": fk.lanes_max_width(8,
                                                            torch.bfloat16)}
    out["softmax_one_read_max_width"] = {
        f"k{k}": {"f32": fk.softmax_one_read_max_width(k, torch.float32),
                  "bf16": fk.softmax_one_read_max_width(k, torch.bfloat16)}
        for k in (10, 20, 32)}
    emit(out)
    return {name: out[name]["registers_spills_by_kernel"] for name in built}


# phase 3's widths: the narrow mode's bucket edges at KERNEL_NARROW_ROWS
# rows, so that each thread walks several groups of rows (at 132 SMs a
# thread's rows are 135,168 apart, 67,584 at D > 16, taken up to 4 at a
# time) and a ragged last group; the warp-rows mode's column buckets and
# unaligned rows (33, 54, 64, 65, 90), ragged and flagship widths at
# KERNEL_ROWS (not a multiple of any warp's rows); the warp-rows hand-over
# and one column either side there, and bf16's odd-width edge; then, per
# dtype, the widest X read once and one column past it (two-pass) at
# fewer rows
KERNEL_NARROW_ROWS = 2_000_003
KERNEL_NARROW_WIDTHS = (1, 2, 3, 7, 8, 31, 32)
KERNEL_ROWS = 100_003
KERNEL_WIDTHS = (33, 54, 64, 65, 90, 777, 1_000)
# bf16 X of odd width: the warp-rows mode's last (127) and the tile's
# first (129) past 128 columns
KERNEL_BF16_ODD = (127, 129)
KERNEL_WIDE_ROWS = {torch.float32: 20_000, torch.bfloat16: 8_192}


def check_margin_kernel(fk, losses, X32, xt, gen, where):
    """The margin kernel against its plain version on ``X32`` cast to
    ``xt``: 3 losses x masked/unmasked x w = 0/random, each call repeated
    bit-identical; returns the line's fields (the plan, the launches by
    mode, the worst errors)."""
    n, d = X32.shape
    dev = X32.device
    y = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
    mask = (torch.rand(n, generator=gen, device=dev) < 0.7).float()
    w_rand = torch.randn(d, generator=gen, device=dev) / d ** 0.5
    X = X32 if xt == torch.float32 else X32.to(xt)
    worst_loss = worst_grad = 0.0
    cases = 0
    plan = fk.launch_shape(X)
    before = fk.margin_mode_launches[plan.mode]
    for name in ("logistic", "least_squares", "hinge"):
        for m in (None, mask):
            staged = fk.stage_dense(X, y, m)
            for w in (torch.zeros(d, device=dev), w_rand):
                le, ge = compare_margin(
                    fk, losses.GRADIENTS[name](), w, staged,
                    f"{where} {n}x{d} {xt} {name} masked={m is not None}")
                worst_loss = max(worst_loss, le)
                worst_grad = max(worst_grad, ge)
                cases += 1
    launched = fk.margin_mode_launches[plan.mode] - before
    if launched != 2 * cases:
        raise AssertionError(f"{where} {n}x{d} {xt}: {launched} launches "
                             f"in {plan.mode} mode for {cases} cases")
    return {"shape": [n, d], "x_dtype": str(xt).replace("torch.", ""),
            "plan": plan._asdict(), "cases": cases,
            "launches": launched, "bit_identical": True,
            "max_loss_rel_err": worst_loss, "max_grad_abs_err": worst_grad}


def wide_mode(fk, d, dtype):
    """The margin kernel's mode past one block a row for X of width d:
    the width rule of its hand-overs (f32 rows that are not 16-byte
    aligned take the grid mode from ``grid_unaligned_from_width``)."""
    unaligned_from = fk.grid_unaligned_from_width(dtype)
    unaligned = d * torch.tensor([], dtype=dtype).element_size() % 16 != 0
    if d <= fk.cluster_max_width(dtype) and not (
            unaligned and unaligned_from and d >= unaligned_from):
        return "cluster"
    return "grid" if d <= fk.grid_max_width(dtype) else "two_pass"


def phase_kernel(fk, losses):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    both = (torch.float32, torch.bfloat16)
    shapes = [(KERNEL_NARROW_ROWS, d, both) for d in KERNEL_NARROW_WIDTHS]
    shapes += [(KERNEL_ROWS, d, both) for d in KERNEL_WIDTHS]
    hand = fk.warp_rows_max_width()
    shapes += [(KERNEL_ROWS, hand + e, both) for e in (-1, 0, 1)]
    shapes += [(KERNEL_ROWS, d, (torch.bfloat16,)) for d in KERNEL_BF16_ODD]
    # the tile's hand-over to the stream mode and one column past it
    for xt in both:
        shapes += [(KERNEL_ROWS, fk.tile_max_width(xt) + e, (xt,))
                   for e in (0, 1)]
    for xt, n in KERNEL_WIDE_ROWS.items():
        limit = fk.max_width(xt)
        shapes += [(n, limit, (xt,)), (n, limit + 1, (xt,))]
    past, modes = {}, {}
    for n, d, xtypes in shapes:
        X32 = torch.randn((n, d), generator=gen, device=dev)
        for xt in xtypes:
            row = check_margin_kernel(fk, losses, X32, xt, gen, "kernel")
            emit({"phase": "kernel", **row})
            limit = fk.max_width(xt)
            want = ("narrow" if d <= 32 else "warp_rows"
                    if d <= hand and (xt == torch.float32 or d % 2 == 0
                                      or d <= 128)
                    else "tile" if d <= fk.tile_max_width(xt)
                    else "stream" if d <= limit
                    else wide_mode(fk, d, xt))
            if (want == "warp_rows") != fk.warp_rows_takes(d, xt):
                raise AssertionError(f"warp_rows_takes({d}, {xt}) disagrees "
                                     f"with the width rule")
            if row["plan"]["mode"] != want:
                raise AssertionError(f"kernel {n}x{d} {xt}: plan "
                                     f"{row['plan']['mode']}, not {want}")
            modes.setdefault(want, set()).add(d)
            if d == limit + 1:
                past[row["x_dtype"]] = row
        del X32
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "widths_by_mode": {
        m: sorted(ws) for m, ws in modes.items()},
        "warp_rows_max_width": hand})
    # one column past the widest X one block takes: read once across a
    # cluster
    if sorted(past) != ["bfloat16", "float32"] or any(
            r["plan"]["mode"] != "cluster" for r in past.values()):
        raise AssertionError(f"one column past max_width did not run "
                             f"the cluster mode: {past}")
    emit({"phase": "kernel", "past_width_cluster": {
        k: {f: r[f] for f in ("shape", "plan", "launches",
                              "max_loss_rel_err", "max_grad_abs_err")}
        for k, r in past.items()}})


# phase 4's class counts: the one-read kernel's n8-tile bucket edges up
# to its 32, then past them (the two-pass mode's 16- and 64-class chunks)
SOFTMAX_KERNEL_K = (1, 2, 3, 8, 9, 10, 16, 17, 32)
SOFTMAX_PAST_K = (33, 100, 1_000)


def softmax_mode_want(fk, d, k, dtype):
    """The mode the plan must give k classes over X of width d."""
    return ("one_read" if d <= fk.softmax_one_read_max_width(k, dtype)
            else "two_pass")


def phase_softmax_kernel(fk):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    n = 100_003
    for d in (784, 785, 777):
        X32 = torch.randn((n, d), generator=gen, device=dev)
        mask = (torch.rand(n, generator=gen, device=dev) < 0.7).float()
        ks = SOFTMAX_KERNEL_K + (SOFTMAX_PAST_K[:2] if d == 785 else ())
        for k in ks:
            y = torch.randint(0, k, (n,), generator=gen, device=dev)
            W_rand = torch.randn((d, k), generator=gen, device=dev) / d ** 0.5
            for xt in (torch.float32, torch.bfloat16):
                X = X32 if xt == torch.float32 else X32.to(xt)
                worst_loss = worst_grad = 0.0
                cases = 0
                plan = fk.softmax_launch_shape(X, k)
                if plan.mode != softmax_mode_want(fk, d, k, xt):
                    raise AssertionError(f"softmax {n}x{d} K={k} {xt}: "
                                         f"plan {plan.mode}")
                before = fk.softmax_mode_launches[plan.mode]
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
                out = {"phase": "softmax_kernel", "shape": [n, d],
                       "classes": k, "x_dtype": str(xt).replace("torch.", ""),
                       "plan": plan._asdict(), "cases": cases,
                       "launches": fk.softmax_mode_launches[plan.mode]
                       - before, "bit_identical": True,
                       "max_loss_rel_err": worst_loss,
                       "max_grad_abs_err": worst_grad}
                if d == 785 and k in (10, 33):
                    # held to f64 sums too: the one-read kernel's tensor-core
                    # products keep f32 accuracy only with their correction
                    # passes; one class past its limit, the two-pass mode
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
    # no class limit: 1,000 classes at D = 785 and 10 classes one column
    # past the one-read kernel's widest X, each held to f64 sums
    past = {}
    for xt in (torch.float32, torch.bfloat16):
        kind = "bf16" if xt == torch.bfloat16 else "f32"
        edge = fk.softmax_one_read_max_width(10, xt)
        for rows, d, k in ((20_011, 785, SOFTMAX_PAST_K[-1]),
                           (n, edge, 10), (n, edge + 1, 10)):
            X = torch.randn((rows, d), generator=gen, device=dev).to(xt)
            y = torch.randint(0, k, (rows,), generator=gen, device=dev)
            m = (torch.rand(rows, generator=gen, device=dev) < 0.7).float()
            W = torch.randn((d, k), generator=gen, device=dev) / d ** 0.5
            staged = fk.stage_softmax(X, y, k, m)
            plan = fk.softmax_launch_shape(X, k)
            if plan.mode != softmax_mode_want(fk, d, k, xt):
                raise AssertionError(f"softmax {rows}x{d} K={k} {xt}: plan "
                                     f"{plan.mode}")
            exact = softmax_f64(k, W, staged)
            le, ge = compare_softmax(
                fk, k, W, staged, f"softmax {rows}x{d} K={k} {xt} vs f64",
                plain=lambda: (exact[0].float(), exact[1].float()))
            past[f"{kind} {rows}x{d} K={k}"] = {
                "mode": plan.mode, "f64_loss_rel_err": le,
                "f64_grad_max_abs_err": ge}
            del X, staged, exact
        torch.cuda.empty_cache()
    emit({"phase": "softmax_kernel", "no_class_limit_vs_f64": past,
          "one_read_max_width_k10": {
              "f32": fk.softmax_one_read_max_width(10, torch.float32),
              "bf16": fk.softmax_one_read_max_width(10, torch.bfloat16)}})


def margin_modes(fk):
    """The margin kernel's launches by mode since the counts were last
    set to 0 (modes that ran only)."""
    return {m: c for m, c in fk.margin_mode_launches.items() if c}


def record_margin_path(fk, launches, path):
    """The margin kernel's launches on ``path`` since the counts were
    last set to 0: in all, and by mode under ``launches["modes"]``."""
    launches[path] = fk.launch_count
    launches.setdefault("modes", {})[path] = margin_modes(fk)


def softmax_modes(fk, launches, path):
    """Record the softmax kernel's launches by mode since the counts were
    last set to 0 under ``launches["softmax_modes"][path]``."""
    launches.setdefault("softmax_modes", {})[path] = {
        m: c for m, c in fk.softmax_mode_launches.items() if c}


def counting(cls):
    """``cls`` with a count of smooth evaluations, to hold launches
    against them."""

    class Counting(cls):
        evaluations = 0

        def batch_loss_and_grad(self, weights, X, y, mask=None):
            self.evaluations += 1
            return super().batch_loss_and_grad(weights, X, y, mask)

    return Counting


def margin_path(port, fk, losses, device_synth, after):
    """Phases 5 and 6, then ``after(X, y, solo)`` on the same data, with
    ``solo`` the run's ``(AGDResult, loss history, wall seconds)``;
    returns the margin kernel's numbers.  Its tensors (X, the staged
    operands, the multipliers) are freed on return."""
    t0 = time.perf_counter()
    X, y = device_synth.class_logistic(N_MAIN, D_MAIN, seed=0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    w0 = torch.zeros(D_MAIN, dtype=torch.float32, device="cuda")

    fused = counting(port.FusedLogisticGradient)()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launch_counts()
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
    modes = margin_modes(fk)
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
    kernel_device_ms = device_ms(lambda: fk.fused_margin_loss_grad(
        gradient, w_run, staged))
    plain_ms = time_ms(lambda: fk.fused_margin_loss_grad_reference(
        gradient, w_run, staged))
    mult = torch.randn(N_MAIN, device="cuda")
    two_mm_ms = time_ms(lambda: (X @ w_run, mult @ X))
    two_mm_device_ms = two_matmuls_device_ms(X, w_run, mult)
    state_after = card_state()
    n, d = X.shape
    b_ms, bound_by = bound_ms(n * d * 4 + 2 * n * 4 + d * 4 + 4 + d * 4,
                              4 * n * d)
    per_fit = launches - launches_optimize  # the run's own launches
    emit({"phase": "times", "shape": [n, d], "kernel_ms": kernel_ms,
          "kernel_device_ms": kernel_device_ms,
          "bound_ms": b_ms, "bound_by": bound_by,
          "bound_source": "H100 SXM data sheet 3.35 TB/s, 67 TFLOP/s f32",
          "kernel_bw_frac": b_ms / kernel_ms,
          "plain_ms": plain_ms, "two_matmuls_ms": two_mm_ms,
          "two_matmuls_device_ms": two_mm_device_ms,
          "launches_per_fit": per_fit,
          "kernel_share_of_run_wall": per_fit * kernel_ms / (run_s * 1e3),
          "main_shape_loss_rel_err": loss_err,
          "main_shape_grad_max_abs_err": max_abs_err,
          "card_before": state_before, "card_after": state_after})
    del staged, mult
    after(X, y, (res, hist, run_s))
    del X, y
    return {"name": "margin_loss_grad", "route": "cuda",
            "source": "spark_agd_tpu_torch/csrc/margin_loss_grad.cu",
            "replaces": "spark_agd_tpu/ops/pallas_kernels.py:184",
            "counterpart": "spark_agd_tpu/ops/pallas_kernels.py:"
                           "fused_margin_loss_grad",
            "launches": launches, "max_abs_err": max_abs_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": bound_by, "library_ms": None,
            "two_matmuls_ms": two_mm_ms,
            "device_ms": sum(kernel_device_ms.values()) or None,
            "two_matmuls_device_ms": two_mm_device_ms,
            "main_path_modes": modes}


def softmax_path(port, fk, device_synth, after):
    """Phases 7 and 8: BASELINE config 4 through the GLM trainer, then
    ``after(Xa, y)`` on the same data (with its intercept column);
    returns the softmax kernel's numbers."""
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
    fk.reset_launch_counts()
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
    path_modes = {m: c for m, c in fk.softmax_mode_launches.items() if c}
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
          "plan": fk.softmax_launch_shape(Xa, K_SM)._asdict(),
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
    del staged, resid
    after(Xa, y)
    return {"name": "softmax_loss_grad", "route": "cuda",
            "source": "spark_agd_tpu_torch/csrc/softmax_loss_grad.cu",
            "replaces": "spark_agd_tpu/ops/pallas_kernels.py:409",
            "counterpart": "spark_agd_tpu/ops/pallas_kernels.py:"
                           "fused_softmax_loss_grad",
            "launches": launches, "softmax_path_modes": path_modes,
            # the error the run asserts: against the f64 sums
            "max_abs_err": err_f64,
            "max_abs_err_vs_plain_f32": err_vs_plain,
            "plain_max_abs_err_vs_f64": plain_err_f64,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": bound_by, "library_ms": None,
            "two_matmuls_ms": two_mm_ms}


# phase 26: published shapes past the one-read softmax kernel: CIFAR-100
# (50,000 x 3,072 pixels, 100 classes; past shared memory and past 32
# classes), LIBSVM's aloi (108,000 x 128, 1,000 classes) and CIFAR-10
# (50,000 x 3,072, 10 classes: past the one-read kernel's 2,600 f32
# columns, the two-pass mode's 16-class tile)
SOFTMAX_WIDE = {"cifar100": dict(n=50_000, d=3_072, k=100, seed=21),
                "aloi": dict(n=108_000, d=128, k=1_000, seed=22),
                "cifar10": dict(n=50_000, d=3_072, k=10, seed=23)}


def softmax_bound(n, d, k, itemsize):
    """The softmax kernel's bound at X (n, d) and k classes, counting
    each input byte read once and each output byte written once: X, y,
    the mask and W read once and the gradient written once at
    HBM_BYTES_PER_S, against the 3 x 4 N D K flops of the two products
    in three TF32 passes at TF32_FLOPS_PER_S;
    beside it, under their own names, the two-pass design's floor (X
    read twice, the (N, K) residuals written and read) and the f32-FMA
    figure (4 N D K flops on the CUDA cores).  Returns a dict."""
    t_bytes = (n * d * itemsize + 8 * n + 8 * d * k + 4) / HBM_BYTES_PER_S
    t_ops = 3 * 4 * n * d * k / TF32_FLOPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "x_once_ms": t_bytes * 1e3, "tf32_ops_ms": t_ops * 1e3,
            "two_pass_floor_ms": (2 * n * d * itemsize + 2 * n * k * 4)
            / HBM_BYTES_PER_S * 1e3,
            "f32_fma_ms": 4 * n * d * k / F32_FLOPS_PER_S * 1e3}


# the two-pass mode's kernels by pass, as the profiler names them
SOFTMAX_PASSES = {"pass1": "softmax_tp_logits", "pass2": "softmax_tp_grad",
                  "final_sum": "reduce_partials_dk"}


def softmax_device_by_pass(per_launch, chunks):
    """The device ms of one two-pass call by pass: each kernel's mean
    launch time (``device_ms``'s names) times its launches in a call,
    the two passes once a chunk of rows, the final sum once."""
    return {p: sum(t for name, t in per_launch.items() if kernel in name)
            * (1 if p == "final_sum" else chunks)
            for p, kernel in SOFTMAX_PASSES.items()}


def softmax_timings(fk, k, W, staged):
    """The kernel's event and device ms at ``(k, W, staged)`` (device ms
    by kernel name for one launch, by pass, and summed over one call's
    launches), its plain version's and the two ``torch.matmul``
    products' (``X @ W``, ``X.T @ resid``), with the card's state around
    them."""
    X = staged.X
    resid = torch.randn((X.shape[0], k), device=X.device)
    Xf = X.float()
    state_before = card_state()

    def kernel():
        return fk.fused_softmax_loss_grad(k, W, staged)

    per_launch = device_ms(kernel)
    plan = fk.softmax_launch_shape(X, k)
    chunks = -(-X.shape[0] // plan.chunk) if plan.chunk else 1
    by_pass = softmax_device_by_pass(per_launch, chunks)
    out = {"kernel_ms": time_ms(kernel), "kernel_device_ms": per_launch,
           "kernel_device_ms_by_pass": by_pass,
           "kernel_device_ms_per_call": sum(by_pass.values()) or None,
           "plain_ms": time_ms(lambda: fk.fused_softmax_loss_grad_reference(
               k, W, staged)),
           "two_matmuls_ms": time_ms(lambda: (Xf @ W, Xf.T @ resid))}
    times = [device_ms(lambda: Xf @ W), device_ms(lambda: Xf.T @ resid)]
    out["two_matmuls_device_ms"] = (sum(sum(t.values()) for t in times)
                                    if all(times) else None)
    out["card_before"], out["card_after"] = state_before, card_state()
    return out


def softmax_wide(port, fk, device_synth, glm, smi, launches):
    """Phase 26: the softmax kernel's two-pass mode at SOFTMAX_WIDE's
    published shapes, data made on the card: the kernel held to f64 sums
    (repeat bit-identical) and timed beside its bound, its plain version
    and the two products; and a ``SoftmaxRegressionWithAGD`` fit at
    CIFAR-100's shape, every launch in the two-pass mode, held to the
    plain fit over their common iterations.  Returns the mode's numbers
    for the kernels line."""
    t_phase = time.perf_counter()
    checks, out, by_shape = {}, {}, {}
    fk.reset_launch_counts()
    for name, cfg in SOFTMAX_WIDE.items():
        n, d, k = cfg["n"], cfg["d"], cfg["k"]
        X, y = device_synth.planted_softmax(n, d, k, seed=cfg["seed"])
        staged = fk.stage_softmax(X, y, k)
        plan = fk.softmax_launch_shape(X, k)
        checks[f"{name}_two_pass"] = plan.mode == "two_pass"
        if name == "cifar100":
            trainer = glm.SoftmaxRegressionWithAGD(
                k, reg_param=REG_SM, updater=port.SquaredL2Updater(),
                add_intercept=False)
            fused = counting(port.FusedSoftmaxGradient)(
                port.SoftmaxGradient(k))
            trainer.optimizer.set_gradient(fused).setNumIterations(ITERS) \
                .setConvergenceTol(TOL)
            w0 = torch.zeros((d, k), dtype=torch.float32, device="cuda")
            before = dict(fk.softmax_mode_launches)
            (w_fit, hist, res), run_s = timed(lambda: port.run(
                (X, y), fused, port.SquaredL2Updater(), reg_param=REG_SM,
                num_iterations=ITERS, convergence_tol=TOL,
                initial_weights=w0, return_result=True))
            fit_launches = {m: c - before.get(m, 0)
                            for m, c in fk.softmax_mode_launches.items()
                            if c - before.get(m, 0)}
            evals_run = fused.evaluations
            (w_plain, hist_plain, res_plain), plain_s = timed(
                lambda: port.run((X, y), port.SoftmaxGradient(k),
                                 port.SquaredL2Updater(), reg_param=REG_SM,
                                 num_iterations=ITERS, convergence_tol=TOL,
                                 initial_weights=w0, return_result=True))
            model, train_s = timed(lambda: trainer.train(X, y))
            # the path's launches: the fit's run and train, before the
            # kernel is compared and timed below
            launches["softmax_wide"] = fk.softmax_launch_count
            softmax_modes(fk, launches, "softmax_wide")
            n_common = min(int(res.num_iters), int(res_plain.num_iters))
            checks.update({
                "fit_every_launch_two_pass":
                    evals_run > 0
                    and fit_launches == {"two_pass": evals_run},
                "fit_history_rtol_1e-4": bool(np.allclose(
                    hist[:n_common], hist_plain[:n_common], rtol=1e-4,
                    atol=0.0)),
                "fit_same_stop_or_both_at_floor": same_stop(
                    res, res_plain, hist, hist_plain),
                "fit_loss_decreases": bool(hist[-1] < hist[0]),
                "fit_finite": bool(np.isfinite(hist).all()
                                   and torch.isfinite(w_fit).all()),
                "train_equals_run": bool(torch.allclose(
                    model.weights, w_fit, rtol=1e-6, atol=0.0)),
            })
            out["cifar100_fit"] = {
                "iterations": int(res.num_iters),
                "iterations_plain": int(res_plain.num_iters),
                "run_s": run_s, "plain_run_s": plain_s,
                "run_s_over_plain": run_s / plain_s, "train_s": train_s,
                "run_launches_by_mode": fit_launches,
                "smooth_evaluations": evals_run,
                "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
                "loss_last_plain": float(hist_plain[-1]),
                "max_hist_rel_diff": float(np.max(
                    np.abs(hist[:n_common] - hist_plain[:n_common])
                    / np.abs(hist_plain[:n_common])))}
            W = w_fit
        else:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(cfg["seed"])
            W = torch.randn((d, k), generator=gen, device="cuda") / d ** 0.5
        exact_loss, exact_grad = softmax_f64(k, W, staged)
        loss_err, grad_err = compare_softmax(
            fk, k, W, staged, f"{name} {n}x{d} K={k} vs f64",
            plain=lambda: (exact_loss.float(), exact_grad.float()))
        plain_loss, plain_grad = fk.fused_softmax_loss_grad_reference(
            k, W, staged)
        bound = softmax_bound(n, d, k, 4)
        row = {"shape": [n, d], "classes": k, "plan": plan._asdict(),
               "loss_rel_err_vs_f64": loss_err,
               "grad_max_abs_err_vs_f64": grad_err,
               "plain_grad_max_abs_err_vs_f64": float(
                   (plain_grad.double() - exact_grad).abs().max()),
               "grad_abs_max": float(exact_grad.abs().max()),
               "bit_identical": True, **bound,
               "scratch_mb": (plan.chunk * k + plan.partials * d * k
                              + plan.loss_partials) * 4 / 1e6,
               **softmax_timings(fk, k, W, staged)}
        row["kernel_bound_frac"] = bound["bound_ms"] / row["kernel_ms"]
        if row["kernel_device_ms_per_call"]:
            row["kernel_device_bound_frac"] = (
                bound["bound_ms"] / row["kernel_device_ms_per_call"])
        by_shape[name] = row
        del X, y, staged, exact_grad, plain_grad
        torch.cuda.empty_cache()
    out.update(by_shape)
    finish("softmax_wide", out, checks, t_phase, smi)
    return by_shape


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
    # bf16 values: the products widen them and sum in f32; held to f64
    # sums over the same (bf16-rounded) values, as is the logistic loss
    # and gradient, which come back in f32
    X16 = sparse.CSRMatrix(
        X.row_ids, X.col_ids, X.values.to(torch.bfloat16), X.shape,
        rows_sorted=True, csc_row_ids=X.csc_row_ids,
        csc_col_ids=X.csc_col_ids, csc_values=X.csc_values.to(torch.bfloat16))
    X16_64 = csr_f64(sparse, X16)
    bf16 = check_products(X16, X16_64, [
        ("matvec", sparse.CSRMatrix.matvec, w),
        ("rmatvec", sparse.CSRMatrix.rmatvec, v)], "sparse_ops bf16")
    logistic = port.LogisticGradient()
    loss16, grad16, _ = logistic.batch_loss_and_grad(w, X16, y)
    loss64, grad64, _ = logistic.batch_loss_and_grad(w.double(), X16_64,
                                                     y.double())
    if not (loss16.dtype == grad16.dtype == torch.float32):
        raise AssertionError("sparse_ops bf16: the loss or gradient is not "
                             "f32")
    bf16["logistic_loss_rel_err_vs_f64"], \
        bf16["logistic_grad_max_abs_err_vs_f64"] = hold(
            loss16, grad16, loss64, grad64,
            "sparse_ops bf16: logistic loss and gradient vs f64")
    del X16, X16_64
    # the fused gradients route a CSR to the sparse products
    fk.reset_launch_counts()
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
          "bf16_values": bf16,
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
    fk.reset_launch_counts()
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


def phase_libsvm(port, sparse, native, rcv1, after=None):
    """Phase 11: phase 10's data through a LIBSVM file, the native parser
    and the same trainer; then ``after(path, data, Xf)`` on the file, the
    parsed arrays and their CSR on the card (phase 34) before the file is
    removed."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_libsvm_")
    try:
        _phase_libsvm(port, sparse, native, rcv1, tmp, after)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_libsvm(port, sparse, native, rcv1, tmp, after):
    t_phase = time.perf_counter()
    cfg, X = rcv1["cfg"], rcv1["X"]
    n, d, k = cfg["n"], cfg["d"], cfg["k"]
    cid = X.col_ids.cpu().numpy()
    val = X.values.cpu().numpy()
    y = rcv1["y"].cpu().numpy()
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
    if after is not None:
        after(path, data, Xf)


def lbfgs_common_path(res, ref):
    """The iterations over which two L-BFGS fits are held to each other:
    those before the first whose line search took another step or another
    number of evaluations (``diag_step``, ``diag_evals``); the loss
    history entries ``[:n + 1]`` precede that search."""
    k = min(int(res.num_iters), int(ref.num_iters))
    same = ((res.diag_evals[:k] == ref.diag_evals[:k])
            & (res.diag_step[:k].double() == ref.diag_step[:k].double()))
    return k if bool(same.all()) else int(torch.argmin(same.int()))


def lbfgs_report(res, prefix=""):
    """A fit's diagnostics for the phase line."""
    from spark_agd_tpu_torch.core import lbfgs

    k = int(res.num_iters)
    hist = res.loss_history[:k + 1].double().numpy()
    return {f"{prefix}num_iters": k,
            f"{prefix}num_fn_evals": int(res.num_fn_evals),
            f"{prefix}ls_stop_reason": lbfgs.ls_stop_reason_name(
                res.ls_stop_reason),
            f"{prefix}converged": bool(res.converged),
            f"{prefix}ls_failed": bool(res.ls_failed),
            f"{prefix}aborted_non_finite": bool(res.aborted_non_finite),
            f"{prefix}loss_history": hist.tolist(),
            f"{prefix}steps": res.diag_step[:k].tolist(),
            f"{prefix}evals_per_iteration": res.diag_evals[:k].tolist()}


def hold_lbfgs(res, ref, checks, label):
    """Hold ``res`` to ``ref`` over their common path (histories rtol
    1e-4) and add the checks every L-BFGS fit passes; returns the phase
    line's fields for the pair."""
    n_path = lbfgs_common_path(res, ref)
    h = res.loss_history[:n_path + 1].double().numpy()
    h_ref = ref.loss_history[:n_path + 1].double().numpy()
    k = int(res.num_iters)
    full = res.loss_history[:k + 1].double().numpy()
    checks[f"{label}_history_rtol_1e-4_on_the_common_path"] = bool(
        np.allclose(h, h_ref, rtol=1e-4, atol=0.0))
    checks[f"{label}_loss_decreases"] = k > 0 and bool(full[-1] < full[0])
    checks[f"{label}_finite"] = bool(
        np.isfinite(full).all() and not bool(res.aborted_non_finite)
        and torch.isfinite(res.weights).all())
    return {f"{label}_common_path_iterations": n_path,
            f"{label}_parts_at_iteration":
                None if n_path == min(k, int(ref.num_iters)) else n_path,
            f"{label}_max_hist_rel_diff_on_the_common_path": float(np.max(
                np.abs(h - h_ref) / np.abs(h_ref)))}


def timed(fn):
    """``fn()`` and its wall time to ``torch.cuda.synchronize()``."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def finish(phase, out, checks, t_phase, smi):
    """Emit the phase line (with the card, the checks and the seconds)
    and raise if a check failed."""
    out = {"phase": phase, **out, "card": smi, "checks": checks,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"{phase} checks failed: {failed}")


def lbfgs_path(port, fk, smi, X, y, launches, keep=None):
    """Phase 13, on phase 5's data: the quasi-Newton member through the
    margin kernel, ``LBFGS.optimize`` and ``run_lbfgs`` (L2), and OWL-QN
    (``run_lbfgs`` with ``L1Prox``), each held to the same fit through
    the plain ``LogisticGradient``; ``keep["res"]`` (a dict, optional)
    receives the ``run_lbfgs`` result (phase 36 holds to it)."""
    t_phase = time.perf_counter()
    w0 = torch.zeros(D_MAIN, dtype=torch.float32, device="cuda")
    fused = counting(port.FusedLogisticGradient)()
    kw = dict(reg_param=REG, num_iterations=ITERS, initial_weights=w0)
    fk.reset_launch_counts()
    w_opt, optimize_s = timed(lambda: port.LBFGS(
        fused, port.SquaredL2Updater()).setRegParam(REG)
        .setNumIterations(ITERS).optimize((X, y), w0))
    launches_optimize, evals_optimize = fk.launch_count, fused.evaluations
    res, run_s = timed(lambda: port.run_lbfgs(
        (X, y), fused, port.SquaredL2Updater(), **kw))
    launches_run = fk.launch_count - launches_optimize
    fit = port.make_lbfgs_runner((X, y), fused, port.L1Prox(),
                                 reg_param=L1_MAIN, num_iterations=ITERS)
    res_l1, owlqn_s = timed(lambda: fit(w0))
    launches_l1 = fk.launch_count - launches_optimize - launches_run
    record_margin_path(fk, launches, "lbfgs_path")
    softmax_launches = fk.softmax_launch_count
    plain, plain_s = timed(lambda: port.run_lbfgs(
        (X, y), port.LogisticGradient(), port.SquaredL2Updater(), **kw))
    plain_l1, plain_l1_s = timed(lambda: port.run_lbfgs(
        (X, y), port.LogisticGradient(), port.L1Prox(), reg_param=L1_MAIN,
        num_iterations=ITERS, initial_weights=w0))
    checks = {
        "launches_equal_evaluations":
            fk.launch_count == fused.evaluations > 0,
        "run_launches_equal_num_fn_evals":
            launches_run == int(res.num_fn_evals) > 0,
        "owlqn_launches_equal_num_fn_evals":
            launches_l1 == int(res_l1.num_fn_evals) > 0,
        "optimize_launches_equal_its_evaluations":
            launches_optimize == evals_optimize > 0,
        "no_softmax_launch": softmax_launches == 0,
        "optimize_equals_run": bool(torch.allclose(
            w_opt, res.weights, rtol=1e-6, atol=0.0)),
        "l1_routes_to_owlqn": fit.algorithm == "owlqn",
        "weights_shape": tuple(res.weights.shape) == (D_MAIN,),
    }
    out = {"shape": [N_MAIN, D_MAIN], "reg": REG, "l1_reg": L1_MAIN,
           "optimize_s": optimize_s, "run_s": run_s,
           "plain_run_s": plain_s, "owlqn_run_s": owlqn_s,
           "owlqn_plain_run_s": plain_l1_s,
           "launches": fk.launch_count, "launches_run": launches_run,
           "launches_owlqn": launches_l1,
           "smooth_evaluations": fused.evaluations,
           "algorithm_l1": fit.algorithm,
           "optimize_bit_identical_to_run": bool(torch.equal(w_opt,
                                                             res.weights)),
           **lbfgs_report(res), **lbfgs_report(plain, "plain_"),
           **lbfgs_report(res_l1, "owlqn_"),
           **lbfgs_report(plain_l1, "owlqn_plain_"),
           "owlqn_exact_zero_weights": int((res_l1.weights == 0).sum()),
           "owlqn_plain_exact_zero_weights":
               int((plain_l1.weights == 0).sum())}
    out.update(hold_lbfgs(res, plain, checks, "lbfgs"))
    out.update(hold_lbfgs(res_l1, plain_l1, checks, "owlqn"))
    with torch.no_grad():
        acc = float(((X[:1_000_000] @ res.weights > 0).float()
                     == y[:1_000_000]).float().mean())
    out["train_accuracy_1M"] = acc
    checks["accuracy_above_0.8"] = acc > 0.8
    if keep is not None:
        keep["res"] = res
    finish("lbfgs_path", out, checks, t_phase, smi)


def softmax_lbfgs_path(port, fk, glm, smi, Xa, y, launches):
    """Phase 14, on phase 7's data: ``SoftmaxRegressionWithLBFGS`` with
    ``FusedSoftmaxGradient`` in the seat (``train`` on X, whose
    intercept copy it makes, then ``run_lbfgs`` on Xa), held to
    ``run_lbfgs`` through the plain ``SoftmaxGradient``."""
    t_phase = time.perf_counter()
    d = D_SM + 1
    w0 = torch.zeros((d, K_SM), dtype=torch.float32, device="cuda")
    fused = counting(port.FusedSoftmaxGradient)(port.SoftmaxGradient(K_SM))
    trainer = glm.SoftmaxRegressionWithLBFGS(K_SM, reg_param=REG_SM)
    trainer.optimizer.set_gradient(fused).setNumIterations(ITERS)
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launch_counts()
    model, train_s = timed(lambda: trainer.train(Xa[:, 1:], y))
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches_train, evals_train = fk.softmax_launch_count, fused.evaluations
    res, run_s = timed(lambda: port.run_lbfgs(
        (Xa, y), fused, port.L2Prox(), reg_param=REG_SM,
        num_iterations=ITERS, initial_weights=w0))
    launches["softmax_lbfgs_path"] = fk.softmax_launch_count
    softmax_modes(fk, launches, "softmax_lbfgs_path")
    margin_launches = fk.launch_count
    plain, plain_s = timed(lambda: port.run_lbfgs(
        (Xa, y), port.SoftmaxGradient(K_SM), port.L2Prox(),
        reg_param=REG_SM, num_iterations=ITERS, initial_weights=w0))
    checks = {
        "train_launches_equal_evaluations":
            launches_train == evals_train > 0,
        "run_launches_equal_num_fn_evals":
            fk.softmax_launch_count - launches_train
            == int(res.num_fn_evals) > 0,
        "no_margin_launch": margin_launches == 0,
        "train_equals_run": bool(
            torch.allclose(model.weights, res.weights[1:], rtol=1e-6,
                           atol=0.0)
            and torch.allclose(model.intercept, res.weights[0], rtol=1e-6,
                               atol=0.0)),
        "weights_shape": tuple(res.weights.shape) == (d, K_SM),
    }
    out = {"shape": [N_SM, D_SM], "classes": K_SM, "reg": REG_SM,
           "train_s": train_s, "run_s": run_s, "plain_run_s": plain_s,
           "train_peak_gb": train_peak_gb,
           "launches": fk.softmax_launch_count,
           "launches_train": launches_train,
           "smooth_evaluations": fused.evaluations,
           **lbfgs_report(res), **lbfgs_report(plain, "plain_")}
    out.update(hold_lbfgs(res, plain, checks, "lbfgs"))
    finish("softmax_lbfgs_path", out, checks, t_phase, smi)


def rcv1_lbfgs(port, fk, sparse, glm, smi, rcv1):
    """Phase 15, on phase 10's CSR: ``LogisticRegressionWithLBFGS`` at
    f32 (``train``, then ``run_lbfgs`` on the intercept CSR), held to the
    same ``run_lbfgs`` at f64 over their common path, and the f32
    gradient at the final weights to f64 sums."""
    t_phase = time.perf_counter()
    cfg, X, y = rcv1["cfg"], rcv1["X"], rcv1["y"]
    n, d = cfg["n"], cfg["d"]
    gradient = counting(port.LogisticGradient)()
    trainer = glm.LogisticRegressionWithLBFGS(reg_param=cfg["reg"])
    trainer.optimizer.set_gradient(gradient).setNumIterations(ITERS)
    fk.reset_launch_counts()
    model, train_s = timed(lambda: trainer.train(X, y))
    evaluations_train = gradient.evaluations
    Xa = glm._add_intercept(X).with_csc()
    w0 = torch.zeros(d + 1, dtype=torch.float32, device="cuda")
    kw = dict(reg_param=cfg["reg"], num_iterations=ITERS)
    res, run_s = timed(lambda: port.run_lbfgs(
        (Xa, y), gradient, port.L2Prox(), initial_weights=w0, **kw))
    dense_launches = fk.launch_count + fk.softmax_launch_count
    Xa64, y64 = csr_f64(sparse, Xa), y.double()
    res64, run64_s = timed(lambda: port.run_lbfgs(
        (Xa64, y64), port.LogisticGradient(), port.L2Prox(),
        initial_weights=w0.double(), **kw))
    plain = port.LogisticGradient()
    _, g32, _ = plain.batch_loss_and_grad(res.weights, Xa, y)
    _, g64, _ = plain.batch_loss_and_grad(res.weights.double(), Xa64, y64)
    grad_err = float((g32.double() - g64).abs().max())
    grad_max = float(g64.abs().max())
    with torch.no_grad():
        acc = float((model.predict(X) == y).float().mean())
    checks = {
        "train_evaluations_counted": evaluations_train > 0,
        "run_evaluations_equal_num_fn_evals":
            gradient.evaluations - evaluations_train
            == int(res.num_fn_evals),
        "no_dense_kernel_launch": dense_launches == 0,
        "train_equals_run": bool(
            torch.allclose(model.weights, res.weights[1:], rtol=1e-6,
                           atol=0.0)
            and abs(model.intercept - float(res.weights[0]))
            <= 1e-6 * abs(float(res.weights[0]))),
        "grad_within_1e-4_of_f64": grad_err <= 1e-4 * grad_max,
        f"train_accuracy_above_{cfg['min_accuracy']}":
            acc > cfg["min_accuracy"],
    }
    out = {"shape": [n, d], "nnz_with_intercept": Xa.nnz, "reg": cfg["reg"],
           "train_s": train_s, "run_s": run_s, "run_f64_s": run64_s,
           "smooth_evaluations": gradient.evaluations,
           "dense_kernel_launches": dense_launches,
           "grad_max_abs_err_vs_f64": grad_err, "grad_abs_max": grad_max,
           "train_accuracy": acc,
           **lbfgs_report(res), **lbfgs_report(res64, "f64_")}
    out.update(hold_lbfgs(res, res64, checks, "lbfgs"))
    finish("rcv1_lbfgs", out, checks, t_phase, smi)


def gd_gate(port, fk, smi, launches):
    """Phase 16: the reference's correctness spec at 10M rows, AGD at 10
    iterations within 2% of MLlib GD at 50 on the Suite's problem family
    (``generate_gd_input``, A = 2, B = -1.5, seed 42, the intercept
    column), both through the margin kernel; the kernel GD held to the
    plain GD; a GD at fraction 0.1 whose masks, drawn on the card, equal
    the CPU draw bit for bit; the kernel timed at this narrow shape."""
    from spark_agd_tpu_torch.core import prng
    from spark_agd_tpu_torch.data import synthetic

    t_phase = time.perf_counter()
    Xn, yn = synthetic.generate_gd_input(2.0, -1.5, N_GATE, 42)
    X = torch.from_numpy(synthetic.with_intercept_column(Xn)).float().cuda()
    y = torch.from_numpy(yn).float().cuda()
    del Xn, yn
    gen_s = time.perf_counter() - t_phase
    w0 = torch.tensor([1.0, -1.0], device="cuda")
    fused = counting(port.FusedLogisticGradient)()
    fk.reset_launch_counts()
    (w_agd, h_agd), agd_s = timed(lambda: port.run(
        (X, y), fused, port.SimpleUpdater(), convergence_tol=1e-12,
        num_iterations=10, initial_weights=w0))
    launches_agd = fk.launch_count
    (w_gd, h_gd), gd_s = timed(lambda: port.run_minibatch_sgd(
        (X, y), fused, port.SimpleUpdater(), step_size=1.0,
        num_iterations=50, reg_param=0.0, minibatch_fraction=1.0,
        initial_weights=w0))
    launches_gd = fk.launch_count - launches_agd
    masks = []

    class Recording(port.FusedLogisticGradient):
        def batch_loss_and_grad(self, weights, X, y, mask=None):
            masks.append(X.m > 0)
            return super().batch_loss_and_grad(weights, X, y, mask)

    (w_s, h_s), sampled_s = timed(lambda: port.run_minibatch_sgd(
        (X, y), Recording(), port.SimpleUpdater(), step_size=1.0,
        num_iterations=50, minibatch_fraction=0.1, initial_weights=w0,
        seed=42))
    record_margin_path(fk, launches, "gd_gate")
    launches_sampled = fk.launch_count - launches_agd - launches_gd
    (_, h_plain), plain_gd_s = timed(lambda: port.run_minibatch_sgd(
        (X, y), port.LogisticGradient(), port.SimpleUpdater(),
        step_size=1.0, num_iterations=50, reg_param=0.0,
        minibatch_fraction=1.0, initial_weights=w0))
    # the card's masks against the CPU draw: every row of iterations 1, 2
    # and 50, the first MASK_ROWS rows of the others (the draw of a row
    # does not depend on how many follow it)
    t0 = time.perf_counter()
    masks_equal = len(masks) == 50
    for it, m in enumerate(masks, start=1):
        rows = N_GATE if it in (1, 2, 50) else MASK_ROWS
        cpu = prng.sample_mask(42, it, 0.1, rows, dtype=torch.float32,
                               device="cpu") > 0
        masks_equal = masks_equal and torch.equal(m[:rows].cpu(), cpu)
    mask_check_s = time.perf_counter() - t0
    # one evaluation at this narrow shape: the kernel (its narrow mode,
    # where each thread walks many rows) held to its plain version at the
    # start and at GD's weights, then timed against its plain version,
    # the two torch.matmul products alone and the bound (reading X, y and
    # the mask once)
    staged = fk.stage_dense(X, y)
    gradient = port.LogisticGradient()
    plan = fk.launch_shape(X)
    shape_errs = {label: compare_margin(fk, gradient, w, staged,
                                        f"gd_gate shape at {label}")
                  for label, w in (("w0", w0), ("w_gd", w_gd))}
    state_before = card_state()
    kernel_ms = time_ms(lambda: fk.fused_margin_loss_grad(gradient, w_gd,
                                                          staged))
    kernel_device_ms = device_ms(lambda: fk.fused_margin_loss_grad(
        gradient, w_gd, staged))
    plain_ms = time_ms(lambda: fk.fused_margin_loss_grad_reference(
        gradient, w_gd, staged))
    mult = torch.randn(N_GATE, device="cuda")
    two_mm_ms = time_ms(lambda: (X @ w_gd, mult @ X))
    two_mm_device_ms = two_matmuls_device_ms(X, w_gd, mult)
    state_after = card_state()
    (b_ms, bound_by), _ = margin_bounds(N_GATE, 2, 4)
    del staged, mult
    sample_fraction = float(torch.stack([m.float().mean() for m in masks])
                            .mean())
    loss_agd, loss_gd = float(h_agd[-1]), float(h_gd[-1])
    rel = abs(loss_agd - loss_gd) / max(abs(loss_agd), abs(loss_gd))
    checks = {
        "agd_within_2pct_of_gd": rel <= 0.02,
        "kernel_gd_history_rtol_1e-4_of_plain_gd": bool(np.allclose(
            h_gd, h_plain, rtol=1e-4, atol=0.0)),
        "agd_launched_the_kernel": launches_agd > 0,
        "gd_one_launch_per_iteration": launches_gd == 50,
        "sampled_gd_one_launch_per_iteration": launches_sampled == 50,
        "launches_equal_evaluations":
            launches["gd_gate"] == fused.evaluations + 50,
        "card_masks_equal_cpu_draw": masks_equal,
        "every_launch_narrow": launches["modes"]["gd_gate"]
        == {"narrow": launches["gd_gate"]},
        "narrow_mode_faster_than_two_matmuls": kernel_ms < two_mm_ms,
        "sample_fraction_near_0.1": abs(sample_fraction - 0.1) < 1e-3,
        "finite": bool(np.isfinite(h_agd).all() and np.isfinite(h_gd).all()
                       and np.isfinite(h_s).all()),
    }
    finish("gd_gate", {
        "rows": N_GATE, "generate_s": gen_s, "agd_run_s": agd_s,
        "kernel_ms": kernel_ms, "kernel_device_ms": kernel_device_ms,
        "plain_ms": plain_ms, "two_matmuls_ms": two_mm_ms,
        "two_matmuls_device_ms": two_mm_device_ms, "bound_ms": b_ms,
        "bound_by": bound_by, "plan": plan._asdict(),
        "shape_loss_rel_err": {k: e[0] for k, e in shape_errs.items()},
        "shape_grad_max_abs_err": {k: e[1] for k, e in shape_errs.items()},
        "modes": launches["modes"]["gd_gate"],
        "card_before": state_before, "card_after": state_after,
        "gd_run_s": gd_s, "plain_gd_run_s": plain_gd_s,
        "sampled_gd_run_s": sampled_s, "mask_check_s": mask_check_s,
        "mask_rows_checked_per_iteration": {"1, 2, 50": N_GATE,
                                            "others": MASK_ROWS},
        "launches": launches["gd_gate"], "launches_agd": launches_agd,
        "launches_gd": launches_gd, "launches_sampled_gd": launches_sampled,
        "agd_iterations": len(h_agd), "loss_agd_10": loss_agd,
        "loss_gd_50": loss_gd, "rel_diff": rel, "rel_tol": 0.02,
        "weights_agd": w_agd.tolist(), "weights_gd": w_gd.tolist(),
        "max_gd_hist_rel_diff_vs_plain": float(np.max(
            np.abs(h_gd - h_plain) / np.abs(h_plain))),
        "loss_history_agd": h_agd.tolist(), "loss_history_gd": h_gd.tolist(),
        "sample_fraction": sample_fraction,
        "sampled_loss_last": float(h_s[-1])}, checks, t_phase, smi)
    return {"shape": [N_GATE, 2], "ms": kernel_ms,
            "device_ms": sum(kernel_device_ms.values()) or None,
            "plain_ms": plain_ms, "bound_ms": b_ms,
            "two_matmuls_ms": two_mm_ms,
            "two_matmuls_device_ms": two_mm_device_ms}


def mid_path(port, fk, losses, device_synth, smi, launches):
    """Phase 25: a dense X of covtype.binary's width (MID: 10M x 54 f32),
    where the margin kernel runs its warp-rows mode (``dense_fit_path``).
    Returns the mode's numbers for the kernels line."""
    return dense_fit_path(port, fk, losses, device_synth, smi, launches,
                          "mid_path", MID, "warp_rows")


def epsilon_path(port, fk, losses, device_synth, smi, launches, after):
    """Phase 28: a dense X of LIBSVM epsilon's shape (EPSILON: 400,000 x
    2,000 f32), where the margin kernel runs its stream mode
    (``dense_fit_path``), then ``after(X, y, solo)`` on the same data
    (phase 29).  Returns the mode's numbers for the kernels line."""
    return dense_fit_path(port, fk, losses, device_synth, smi, launches,
                          "epsilon_path", EPSILON, "stream", after)


def snp_path(port, fk, losses, device_synth, smi, launches):
    """Phase 31: a dense X of a genotype matrix's width (SNP: 10,000 x
    500,000 f32, 20 GB), where the margin kernel runs its grid mode
    (``dense_fit_path``).  Returns the mode's numbers for the kernels
    line."""
    return dense_fit_path(port, fk, losses, device_synth, smi, launches,
                          "snp_path", SNP, "grid")


def dense_fit_path(port, fk, losses, device_synth, smi, launches, path,
                   cfg, want, after=None):
    """A dense fit phase: class-logistic data of ``cfg``'s shape made on
    the card (its seed), the flagship's AGD fit (reg 0.1, 40 iterations,
    tol 0) through ``run`` with ``FusedLogisticGradient``, every launch in
    the margin kernel's mode ``want`` (the plan's for this width), held
    to the plain fit over their common iterations; the kernel at the
    fitted weights held to f64 sums (phase 3's tolerance) and timed
    beside its bound, its plain version and the two ``torch.matmul``
    products, which it must beat; then ``after(X, y, solo)``, if given,
    with ``solo`` the run's ``(AGDResult, loss history, wall seconds)``.
    Returns the mode's numbers."""
    t_phase = time.perf_counter()
    n, d = cfg["n"], cfg["d"]
    (X, y), gen_s = timed(lambda: device_synth.class_logistic(
        n, d, seed=cfg["seed"]))
    w0 = torch.zeros(d, dtype=torch.float32, device="cuda")
    kw = dict(reg_param=REG, num_iterations=ITERS, convergence_tol=TOL,
              initial_weights=w0, return_result=True)
    fused = counting(port.FusedLogisticGradient)()
    fk.reset_launch_counts()
    (w_run, hist, res), run_s = timed(lambda: port.run(
        (X, y), fused, port.SquaredL2Updater(), **kw))
    record_margin_path(fk, launches, path)
    other = fk.lanes_launch_count + fk.softmax_launch_count
    (_, hist_plain, res_plain), plain_s = timed(lambda: port.run(
        (X, y), port.LogisticGradient(), port.SquaredL2Updater(), **kw))
    n_iters, n_plain = int(res.num_iters), int(res_plain.num_iters)
    n_common = min(n_iters, n_plain)

    gradient = losses.LogisticGradient()
    staged = fk.stage_dense(X, y)
    loss, grad = fk.fused_margin_loss_grad(gradient, w_run, staged)
    loss_err, max_abs_err = hold(loss, grad, *margin_f64(w_run, staged),
                                 f"{path} shape: kernel vs f64 sums")
    plan = fk.launch_shape(X)
    state_before = card_state()
    kernel_ms = time_ms(lambda: fk.fused_margin_loss_grad(gradient, w_run,
                                                          staged))
    kernel_device_ms = device_ms(lambda: fk.fused_margin_loss_grad(
        gradient, w_run, staged))
    plain_ms = time_ms(lambda: fk.fused_margin_loss_grad_reference(
        gradient, w_run, staged))
    mult = torch.randn(n, device="cuda")
    two_mm_ms = time_ms(lambda: (X @ w_run, mult @ X))
    two_mm_device_ms = two_matmuls_device_ms(X, w_run, mult)
    state_after = card_state()
    (b_ms, bound_by), _ = margin_bounds(n, d, 4)
    del staged, mult
    checks = {
        f"every_launch_{want}": launches["modes"][path]
        == {want: launches[path]},
        "plan_mode": plan.mode == want,
        "launches_equal_evaluations":
            launches[path] == fused.evaluations > 0,
        "no_other_kernel": other == 0,
        "same_stop_or_both_at_floor": same_stop(res, res_plain, hist,
                                                hist_plain),
        "history_rtol_1e-4": bool(np.allclose(
            hist[:n_common], hist_plain[:n_common], rtol=1e-4, atol=0.0)),
        "loss_decreases": bool(hist[-1] < hist[0]),
        "finite": bool(np.isfinite(hist).all()
                       and torch.isfinite(w_run).all()),
        "weights_shape": tuple(w_run.shape) == (d,),
        "faster_than_two_matmuls": kernel_ms < two_mm_ms,
    }
    with torch.no_grad():
        acc = float(((X @ w_run > 0).float() == y).float().mean())
    checks["accuracy_above_0.8"] = acc > 0.8
    finish(path, {
        "shape": [n, d], "x_gb": X.numel() * 4 / 1e9, "generate_s": gen_s,
        "run_s": run_s, "plain_run_s": plain_s, "num_iters": n_iters,
        "num_iters_plain": n_plain, "num_backtracks": int(res.num_backtracks),
        "launches": launches[path],
        "modes": launches["modes"][path],
        "smooth_evaluations": fused.evaluations,
        "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
        "loss_last_plain": float(hist_plain[-1]),
        "max_hist_rel_diff": float(np.max(
            np.abs(hist[:n_common] - hist_plain[:n_common])
            / np.abs(hist_plain[:n_common]))),
        "train_accuracy": acc, "plan": plan._asdict(),
        "kernel_ms": kernel_ms, "kernel_device_ms": kernel_device_ms,
        "plain_ms": plain_ms, "two_matmuls_ms": two_mm_ms,
        "two_matmuls_device_ms": two_mm_device_ms, "bound_ms": b_ms,
        "bound_by": bound_by,
        "kernel_share_of_run_wall": launches[path] * kernel_ms
        / (run_s * 1e3),
        "shape_loss_rel_err_vs_f64": loss_err,
        "shape_grad_max_abs_err_vs_f64": max_abs_err,
        "card_before": state_before, "card_after": state_after},
        checks, t_phase, smi)
    if after is not None:
        after(X, y, (res, hist, run_s))
    del X, y
    return {"shape": [n, d], "ms": kernel_ms,
            "device_ms": sum(kernel_device_ms.values()) or None,
            "plain_ms": plain_ms, "bound_ms": b_ms,
            "two_matmuls_ms": two_mm_ms,
            "two_matmuls_device_ms": two_mm_device_ms,
            "max_abs_err_vs_f64": max_abs_err}


def linreg_path(port, fk, device_synth, glm, smi, launches):
    """Phase 17: BASELINE config 2 as published, least squares on
    ``planted_dense_linreg`` 10M x 1000 (seed 2) through
    ``LinearRegressionWithAGD`` with ``FusedMarginGradient(
    LeastSquaresGradient())`` in the seat, held to the plain fit; then
    MLlib GD at config 2's step 0.1 through the kernel, held to plain
    GD."""
    t_phase = time.perf_counter()
    (X, y), gen_s = timed(lambda: device_synth.planted_dense_linreg(
        N_MAIN, D_MAIN, seed=2))
    w0 = torch.zeros(D_MAIN, dtype=torch.float32, device="cuda")
    fused = counting(port.FusedMarginGradient)(port.LeastSquaresGradient())
    # config 2 fits X as it is (benchmarks/run.py: no intercept column),
    # and a 40 GB intercept copy would not fit beside X
    trainer = glm.LinearRegressionWithAGD(add_intercept=False)
    trainer.optimizer.set_gradient(fused).setNumIterations(ITERS) \
        .setConvergenceTol(TOL)
    fk.reset_launch_counts()
    model, train_s = timed(lambda: trainer.train(X, y))
    launches_train, evals_train = fk.launch_count, fused.evaluations
    kw = dict(num_iterations=ITERS, convergence_tol=TOL,
              initial_weights=w0, return_result=True)
    (w_run, hist, res), run_s = timed(lambda: port.run(
        (X, y), fused, port.IdentityProx(), **kw))
    launches_run = fk.launch_count - launches_train
    gd_kw = dict(step_size=0.1, num_iterations=50, initial_weights=w0)
    (w_gd, h_gd), gd_s = timed(lambda: port.run_minibatch_sgd(
        (X, y), fused, port.IdentityProx(), **gd_kw))
    record_margin_path(fk, launches, "linreg_path")
    launches_gd = fk.launch_count - launches_train - launches_run
    softmax_launches = fk.softmax_launch_count
    (w_plain, hist_plain, res_plain), plain_s = timed(lambda: port.run(
        (X, y), port.LeastSquaresGradient(), port.IdentityProx(), **kw))
    (_, h_gd_plain), plain_gd_s = timed(lambda: port.run_minibatch_sgd(
        (X, y), port.LeastSquaresGradient(), port.IdentityProx(), **gd_kw))
    n_iters, n_plain = int(res.num_iters), int(res_plain.num_iters)
    n_common = min(n_iters, n_plain)
    with torch.no_grad():
        r2 = 1.0 - float(((X[:1_000_000] @ w_run - y[:1_000_000]) ** 2)
                         .mean() / y[:1_000_000].var())
    checks = {
        "train_launches_equal_evaluations":
            launches_train == evals_train > 0,
        "run_launches_equal_run_evaluations":
            launches_run == fused.evaluations - evals_train - 50 > 0,
        "gd_one_launch_per_iteration": launches_gd == 50,
        "no_softmax_launch": softmax_launches == 0,
        "train_equals_run": bool(torch.allclose(model.weights, w_run,
                                                rtol=1e-6, atol=0.0)),
        "same_stop_or_both_at_floor": same_stop(res, res_plain, hist,
                                                hist_plain),
        "history_rtol_1e-4": bool(np.allclose(
            hist[:n_common], hist_plain[:n_common], rtol=1e-4, atol=0.0)),
        "gd_history_rtol_1e-4_of_plain_gd": bool(np.allclose(
            h_gd, h_gd_plain, rtol=1e-4, atol=0.0)),
        "loss_decreases": bool(hist[-1] < hist[0] and h_gd[-1] < h_gd[0]),
        "finite": bool(np.isfinite(hist).all() and np.isfinite(h_gd).all()
                       and torch.isfinite(w_run).all()),
        "r2_above_0.9": r2 > 0.9,
    }
    finish("linreg_path", {
        "shape": [N_MAIN, D_MAIN], "generate_s": gen_s, "train_s": train_s,
        "run_s": run_s, "plain_run_s": plain_s, "gd_run_s": gd_s,
        "plain_gd_run_s": plain_gd_s, "num_iters": n_iters,
        "num_iters_plain": n_plain, "num_backtracks": int(res.num_backtracks),
        "num_restarts": int(res.num_restarts),
        "launches": launches["linreg_path"], "launches_train": launches_train,
        "launches_run": launches_run, "launches_gd": launches_gd,
        "smooth_evaluations": fused.evaluations,
        "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
        "loss_last_plain": float(hist_plain[-1]),
        "max_hist_rel_diff": float(np.max(
            np.abs(hist[:n_common] - hist_plain[:n_common])
            / np.abs(hist_plain[:n_common]))),
        "gd_loss_last": float(h_gd[-1]),
        "max_gd_hist_rel_diff_vs_plain": float(np.max(
            np.abs(h_gd - h_gd_plain) / np.abs(h_gd_plain))),
        "loss_history": hist.tolist(), "gd_loss_history": h_gd.tolist(),
        "r2_1M": r2}, checks, t_phase, smi)
    del X, y


def mlp_path(port, device_synth, smi, fk):
    """Phase 18: BASELINE config 5 as published, ``planted_mlp`` 1M x
    1024 (hidden 32, 2 classes, seed 4) through
    ``MLPClassifierWithAGD(32, 2, reg_param=1e-5)`` (tanh), held to the
    same fit at f64 over their common path and the final gradient to
    f64 sums.  Its two products are torch's: no kernel of the port."""
    from spark_agd_tpu_torch.models import mlp

    t_phase = time.perf_counter()
    n, d, h, k = MLP["n"], MLP["d"], MLP["hidden"], MLP["classes"]
    (X, y), gen_s = timed(lambda: device_synth.planted_mlp(
        n, d, h, seed=MLP["seed"]))
    trainer = mlp.MLPClassifierWithAGD(h, k, reg_param=MLP["reg"])
    trainer.optimizer.setNumIterations(ITERS).setConvergenceTol(TOL)
    fk.reset_launch_counts()
    model, train_s = timed(lambda: trainer.train(X, y))
    p0 = mlp.init_mlp_params(d, h, k, seed=0)
    kw = dict(reg_param=MLP["reg"], num_iterations=ITERS,
              convergence_tol=TOL, return_result=True)
    (w_run, hist, res), run_s = timed(lambda: port.run(
        (X, y), mlp.mlp_gradient("tanh"), port.L2Prox(),
        initial_weights=p0, **kw))
    kernel_launches = fk.launch_count + fk.softmax_launch_count
    X64 = X.double()
    (w64, hist64, res64), run64_s = timed(lambda: port.run(
        (X64, y), mlp.mlp_gradient("tanh"), port.L2Prox(),
        initial_weights={n_: v.double() for n_, v in p0.items()}, **kw))
    grad = mlp.mlp_gradient("tanh")
    _, g32, _ = grad.batch_loss_and_grad(w_run, X, y)
    _, g64, _ = grad.batch_loss_and_grad(
        {n_: v.double() for n_, v in w_run.items()}, X64, y)
    del X64
    grad_err = {n_: float((g32[n_].double() - g64[n_]).abs().max())
                for n_ in g64}
    grad_max = {n_: float(g64[n_].abs().max()) for n_ in g64}
    n_iters, n64 = int(res.num_iters), int(res64.num_iters)
    n_path = common_path(res, res64, min(n_iters, n64))
    with torch.no_grad():
        acc = float((model.predict(X) == y).float().mean())
        acc0 = float((mlp.MLPModel(p0).predict(X) == y).float().mean())
    checks = {
        "no_kernel_launch": kernel_launches == 0,
        "train_equals_run": all(torch.allclose(
            model.params[n_], w_run[n_], rtol=1e-6, atol=0.0)
            for n_ in w_run),
        "history_rtol_1e-4_vs_f64_on_the_common_path": bool(np.allclose(
            hist[:n_path], hist64[:n_path], rtol=1e-4, atol=0.0)),
        # the gradient is one vector to the optimizer: its f32 error is
        # held to 1e-4 of that vector's largest f64 entry, as phase 10
        # holds the GLM gradient (b2's entries are sums over every row
        # that cancel to a few units, so its own largest entry is no
        # scale for f32 rounding)
        "grad_within_1e-4_of_f64": max(grad_err.values())
        <= 1e-4 * max(grad_max.values()),
        "loss_decreases": bool(hist[-1] < hist[0]),
        "finite": bool(np.isfinite(hist).all() and all(
            torch.isfinite(v).all() for v in w_run.values())),
        "accuracy_rises": acc > acc0,
    }
    finish("mlp_path", {
        "shape": [n, d], "hidden": h, "classes": k, "reg": MLP["reg"],
        "generate_s": gen_s, "train_s": train_s, "run_s": run_s,
        "run_f64_s": run64_s, "num_iters": n_iters, "num_iters_f64": n64,
        "num_backtracks": int(res.num_backtracks),
        "num_restarts": int(res.num_restarts),
        "kernel_launches": kernel_launches,
        "common_path_iterations": n_path,
        "max_hist_rel_diff_vs_f64_on_the_common_path": float(np.max(
            np.abs(hist[:n_path] - hist64[:n_path])
            / np.abs(hist64[:n_path]))) if n_path else None,
        "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
        "loss_last_f64": float(hist64[-1]),
        "loss_history": hist.tolist(), "loss_history_f64": hist64.tolist(),
        "grad_max_abs_err_vs_f64": grad_err, "grad_abs_max": grad_max,
        "train_accuracy": acc, "train_accuracy_at_init": acc0},
        checks, t_phase, smi)


def wide_path(port, fk, losses, device_synth, smi, launches, after=None):
    """Phase 19: X past one row in shared memory.  The kernel against its
    plain version at WIDE_CHECK widths and one column past the cluster
    mode's and the grid mode's reach (f32 and bf16, repeat
    bit-identical), each plan's mode held to the width rule (40,000
    columns in the cluster mode); then an AGD fit at WIDE's shape (a
    gene-expression-like dense X, made on the card) through
    ``FusedLogisticGradient``, every launch in the cluster mode, held to
    the plain fit over their common iterations; one evaluation timed
    against the bound (X read once), the two-pass mode's floor (X twice)
    and the two ``torch.matmul`` products; the grid mode timed at
    GRID_TIMES and the two-pass mode one column past the grid mode's
    reach (``margin_times``); then ``after(X, y, solo)``, if given, with
    ``solo`` the fit's ``(AGDResult, loss history, wall seconds)``.
    Returns the kernel's numbers by mode: the cluster mode's, the grid
    mode's rows, the two-pass mode's."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    checks = {}
    kernel_rows = []
    both = (torch.float32, torch.bfloat16)
    reach = {xt: fk.cluster_max_width(xt) for xt in both}
    grid_reach = {xt: fk.grid_max_width(xt) for xt in both}
    cases = [(WIDE_CHECK["rows"], d, both) for d in WIDE_CHECK["widths"]]
    cases += [(WIDE_CHECK["past_rows"], edge[xt] + 1, (xt,))
              for edge in (reach, grid_reach) for xt in both]
    for rows, d, xtypes in cases:
        X32 = torch.randn((rows, d), generator=gen, device=dev)
        for xt in xtypes:
            row = check_margin_kernel(fk, losses, X32, xt, gen, "wide_path")
            kernel_rows.append(row)
            want = wide_mode(fk, d, xt)
            checks[f"{want}_at_{d}_{row['x_dtype']}"] = \
                row["plan"]["mode"] == want
            if d == WIDE["d"]:
                checks[f"cluster_at_{d}_{row['x_dtype']}"] = \
                    row["plan"]["mode"] == "cluster"
        del X32
        torch.cuda.empty_cache()

    n, d = WIDE["n"], WIDE["d"]
    (X, y), gen_s = timed(lambda: device_synth.class_logistic(
        n, d, seed=WIDE["seed"]))
    w0 = torch.zeros(d, dtype=torch.float32, device="cuda")
    kw = dict(reg_param=WIDE["reg"], num_iterations=WIDE["iters"],
              convergence_tol=0.0, initial_weights=w0, return_result=True)
    fused = counting(port.FusedLogisticGradient)()
    fk.reset_launch_counts()
    (w_run, hist, res), run_s = timed(lambda: port.run(
        (X, y), fused, port.SquaredL2Updater(), **kw))
    record_margin_path(fk, launches, "wide_path")
    softmax_launches = fk.softmax_launch_count
    (_, hist_plain, res_plain), plain_s = timed(lambda: port.run(
        (X, y), port.LogisticGradient(), port.SquaredL2Updater(), **kw))
    n_iters, n_plain = int(res.num_iters), int(res_plain.num_iters)
    n_common = min(n_iters, n_plain)

    gradient = losses.LogisticGradient()
    staged = fk.stage_dense(X, y)
    loss_err, max_abs_err = compare_margin(fk, gradient, w_run, staged,
                                           "wide_path shape")
    loss, grad = fk.fused_margin_loss_grad(gradient, w_run, staged)
    f64_loss_err, f64_abs_err = hold(loss, grad, *margin_f64(w_run, staged),
                                     "wide_path shape: kernel vs f64 sums")
    plan = fk.launch_shape(X)
    state_before = card_state()
    kernel_ms = time_ms(lambda: fk.fused_margin_loss_grad(gradient, w_run,
                                                          staged))
    kernel_device_ms = device_ms(lambda: fk.fused_margin_loss_grad(
        gradient, w_run, staged))
    plain_ms = time_ms(lambda: fk.fused_margin_loss_grad_reference(
        gradient, w_run, staged))
    mult = torch.randn(n, device="cuda")
    two_mm_ms = time_ms(lambda: (X @ w_run, mult @ X))
    two_mm_device_ms = two_matmuls_device_ms(X, w_run, mult)
    state_after = card_state()
    (b_ms, bound_by), (b2_ms, _) = margin_bounds(n, d, 4)
    del staged, mult, loss, grad
    checks.update({
        "every_launch_cluster": launches["modes"]["wide_path"]
        == {"cluster": launches["wide_path"]},
        "launches_equal_evaluations":
            launches["wide_path"] == fused.evaluations > 0,
        "no_softmax_launch": softmax_launches == 0,
        "same_stop_or_both_at_floor": same_stop(res, res_plain, hist,
                                                hist_plain),
        "history_rtol_1e-4": bool(np.allclose(
            hist[:n_common], hist_plain[:n_common], rtol=1e-4, atol=0.0)),
        "loss_decreases": bool(hist[-1] < hist[0]),
        "finite": bool(np.isfinite(hist).all()
                       and torch.isfinite(w_run).all()),
        "weights_shape": tuple(w_run.shape) == (d,),
    })
    with torch.no_grad():
        acc = float(((X @ w_run > 0).float() == y).float().mean())
    torch.cuda.empty_cache()
    grid = [margin_times(fk, gradient, GRID_TIMES_ROWS, d, xt, "grid")
            for d, xt in GRID_TIMES]
    two_pass = margin_times(fk, gradient, WIDE_CHECK["past_rows"],
                            grid_reach[torch.float32] + 1, torch.float32,
                            "two_pass")
    finish("wide_path", {
        "kernel_checks": kernel_rows, "cluster_max_width": {
            str(xt).replace("torch.", ""): w for xt, w in reach.items()},
        "grid_max_width": {
            str(xt).replace("torch.", ""): w for xt, w in grid_reach.items()},
        "shape": [n, d],
        "x_gb": n * d * 4 / 1e9, "generate_s": gen_s, "run_s": run_s,
        "plain_run_s": plain_s, "num_iters": n_iters,
        "num_iters_plain": n_plain, "num_backtracks": int(res.num_backtracks),
        "launches": launches["wide_path"],
        "modes": launches["modes"]["wide_path"],
        "smooth_evaluations": fused.evaluations,
        "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
        "loss_last_plain": float(hist_plain[-1]),
        "max_hist_rel_diff": float(np.max(
            np.abs(hist[:n_common] - hist_plain[:n_common])
            / np.abs(hist_plain[:n_common]))),
        "loss_history": hist.tolist(), "train_accuracy": acc,
        "plan": plan._asdict(), "kernel_ms": kernel_ms,
        "kernel_device_ms": kernel_device_ms, "plain_ms": plain_ms,
        "two_matmuls_ms": two_mm_ms,
        "two_matmuls_device_ms": two_mm_device_ms, "bound_ms": b_ms,
        "bound_by": bound_by, "kernel_bound_frac": b_ms / kernel_ms,
        "two_pass_bound_ms": b2_ms, "shape_loss_rel_err": loss_err,
        "shape_grad_max_abs_err": max_abs_err,
        "shape_loss_rel_err_vs_f64": f64_loss_err,
        "shape_grad_max_abs_err_vs_f64": f64_abs_err,
        "grid_times": grid, "two_pass_past_grid_reach": two_pass,
        "card_before": state_before, "card_after": state_after},
        checks, t_phase, smi)
    cluster = {"shape": [n, d], "ms": kernel_ms,
               "device_ms": sum(kernel_device_ms.values()) or None,
               "plain_ms": plain_ms, "bound_ms": b_ms,
               "two_pass_bound_ms": b2_ms, "two_matmuls_ms": two_mm_ms,
               "two_matmuls_device_ms": two_mm_device_ms,
               "max_abs_err_vs_f64": f64_abs_err, "plan": plan._asdict(),
               "cluster_max_width": {
                   str(xt).replace("torch.", ""): w
                   for xt, w in reach.items()}}
    if after is not None:
        after(X, y, (res, hist, run_s))
    del X, y
    torch.cuda.empty_cache()
    return cluster, grid, two_pass


def margin_times(fk, gradient, n, d, dtype, want):
    """The margin kernel at n x d X of ``dtype`` (random, seed 8), its
    plan held to the mode ``want``: held to f64 sums (repeat
    bit-identical), timed by events and by the profiler (device ms by
    kernel name: the two-pass mode's by pass) beside its bound (X read
    once), the two-pass floor (X twice), its plain version and the two
    ``torch.matmul`` products on X's dtype.  Emits and returns one
    ``margin_times`` line."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    X = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    y = (torch.rand(n, generator=gen, device="cuda") < 0.5).float()
    w = torch.randn(d, generator=gen, device="cuda") / d ** 0.5
    staged = fk.stage_dense(X, y)
    plan = fk.launch_shape(X)

    def call():
        return fk.fused_margin_loss_grad(gradient, w, staged)

    loss, grad = call()
    loss2, grad2 = call()
    torch.cuda.synchronize()
    same = bool(torch.equal(loss, loss2) and torch.equal(grad, grad2))
    _, abs_err = hold(loss, grad, *margin_f64(w, staged),
                      f"{plan.mode} mode {n}x{d} {dtype}: kernel vs f64 sums")
    kernel_ms = time_ms(call)
    kernel_device_ms = device_ms(call)
    plain_ms = time_ms(lambda: fk.fused_margin_loss_grad_reference(
        gradient, w, staged))
    mult = torch.randn(n, generator=gen, device="cuda").to(dtype)
    wx = w.to(dtype)
    two_mm_ms = time_ms(lambda: (X @ wx, mult @ X))
    two_mm_device_ms = two_matmuls_device_ms(X, wx, mult)
    (b_ms, bound_by), (b2_ms, _) = margin_bounds(n, d, X.element_size())
    row = {"shape": [n, d], "x_dtype": str(dtype).replace("torch.", ""),
           "plan": plan._asdict(), "ms": kernel_ms,
           "device_ms": sum(kernel_device_ms.values()) or None,
           "device_ms_by_kernel": kernel_device_ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": bound_by, "two_pass_bound_ms": b2_ms,
           "two_matmuls_ms": two_mm_ms,
           "two_matmuls_device_ms": two_mm_device_ms,
           "max_abs_err_vs_f64": abs_err, "bit_identical": same}
    emit({"phase": "margin_times", **row})
    del X, y, staged, mult, loss, grad, loss2, grad2
    torch.cuda.empty_cache()
    if plan.mode != want or not same:
        raise AssertionError(f"margin kernel at {n}x{d} {dtype}: plan "
                             f"{plan.mode} (not {want}), repeat same bits "
                             f"{same}")
    return row


def lanes_two_pass_times(fk, losses):
    """The lanes kernel's two-pass mode at LANES_TWO_PASS_ROWS rows of f32
    X one column past ``lanes_max_width`` for each of LANES_TWO_PASS_K
    lanes: held to f64 sums lane by lane, timed by events and by the
    profiler (device ms by kernel name: pass 1, the middle, pass 2, the
    final sums) beside its bound (X, W, y and the mask read once), the
    two-pass floor (X twice), its plain version and the two
    ``torch.matmul`` products on (D, K); each plan held to the two-pass
    mode.  One line a lane count; returns them by K."""
    out = {}
    for k in LANES_TWO_PASS_K:
        n = LANES_TWO_PASS_ROWS
        d = fk.lanes_max_width(k, torch.float32) + 1
        gen = torch.Generator(device="cuda")
        gen.manual_seed(9)
        X = torch.randn((n, d), generator=gen, device="cuda")
        y = (torch.rand(n, generator=gen, device="cuda") < 0.5).float()
        W = torch.randn((k, d), generator=gen, device="cuda") / d ** 0.5
        staged = fk.stage_dense(X, y)
        gradient = losses.LogisticGradient()
        plan = fk.lanes_launch_shape(X, k)

        def call():
            return fk.fused_margin_lanes_loss_grad(gradient, W, staged)

        loss, grad = call()
        _, abs_err = hold_lanes(loss, grad, *margin_lanes_f64(W, staged),
                                f"lanes two-pass {n}x{d}, K = {k}")
        kernel_ms = time_ms(call)
        kernel_device_ms = device_ms(call)
        plain_ms = time_ms(lambda: fk.fused_margin_lanes_loss_grad_reference(
            gradient, W, staged))
        mult = torch.randn((n, k), generator=gen, device="cuda")
        two_mm_ms = time_ms(lambda: (X @ W.T, mult.T @ X))
        times = [device_ms(lambda: X @ W.T), device_ms(lambda: mult.T @ X)]
        b_ms, bound_by = lanes_bound_ms(n, d, k, 4)
        row = {"shape": [n, d], "lanes": k, "plan": list(plan[:6]),
               "ms": kernel_ms,
               "device_ms": sum(kernel_device_ms.values()) or None,
               "device_ms_by_kernel": kernel_device_ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": bound_by,
               "two_pass_floor_ms": lanes_two_pass_floor_ms(n, d, k, 4),
               "two_matmuls_ms": two_mm_ms,
               "two_matmuls_device_ms": (sum(sum(t.values())
                                             for t in times)
                                         if all(times) else None),
               "max_abs_err_vs_f64": abs_err}
        emit({"phase": "lanes_two_pass_times", **row})
        if plan.mode != "lanes_two_pass":
            raise AssertionError(f"lanes kernel at {n}x{d}, K = {k}: plan "
                                 f"{plan.mode}, not lanes_two_pass")
        out[f"k{k}"] = row
        del X, y, W, staged, mult, loss, grad
        torch.cuda.empty_cache()
    return out


def mma_ab(specs):
    """``--ab mma:``: the rate of ``mma.sync`` m16n8k8 in TF32 on this
    card from each probe build in ``specs`` (NAME=SOURCE, e.g.
    ``probes/mma_rate.cu``), the instruction of the softmax kernel's
    products: each warp issues 2,048-flop products into 1 to 8
    independent accumulators, at 8 to 32 warps an SM, timed by CUDA
    events; TFLOP/s each, beside the data sheet's 495 (``wgmma``)."""
    import ctypes

    from spark_agd_tpu_torch.ops import _cuda_build, fused_kernels as fk

    names, builds = ab_builds(
        specs, lambda src: (_cuda_build.build("mma_rate", [src]),))
    sms = fk._device_sms(0)
    iters, threads = 4096, 256
    for name, (built,) in zip(names, builds):
        lib = ctypes.CDLL(str(built.path))
        lib.mma_rate_launch.argtypes = ([ctypes.c_int] * 4
                                        + [ctypes.c_void_p] * 2)
        lib.mma_rate_launch.restype = ctypes.c_int
        rows = []
        for per_sm in (1, 2, 4):
            blocks = sms * per_sm
            out = torch.empty(blocks * threads, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            for chains in (1, 2, 4, 8):
                def launch():
                    if lib.mma_rate_launch(chains, blocks, threads, iters,
                                           out.data_ptr(), stream):
                        raise RuntimeError("mma_rate_launch failed")

                ms = time_ms(launch)
                flops = (blocks * threads // 32 * iters * chains
                         * 2 * 16 * 8 * 8)
                rows.append({"warps_per_sm": per_sm * threads // 32,
                             "chains": chains, "ms": ms,
                             "tflops": flops / ms / 1e9})
            if not torch.isfinite(out).all():
                raise AssertionError(f"{name}: non-finite sums")
        emit({"phase": "ab_mma", "build": name, "instruction":
              "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
              "data_sheet_tf32_tflops": TF32_FLOPS_PER_S / 1e12,
              "rows": rows, "card": card_state()})


def softmax_build(fk, source):
    """A build of the softmax kernel from ``source``, a copy of
    ``csrc/softmax_loss_grad.cu`` with this C interface (a six-int plan)
    or, from before the two-pass mode (no
    ``softmax_mode_name``), the one-read kernel's own: ``softmax_plan``
    filling tile rows and grid, and the launch taking them as ints.
    Returns ``(BuiltLibrary, calls)`` with ``calls(n, d, sms, k)`` ->
    ``{mode: (plan, launch(W, staged))}``: the one-read kernel where it
    takes the shape, and the two-pass mode (forced where the one-read
    kernel would take it) where the build has one."""
    import ctypes

    with open(source) as f:
        modes = "softmax_mode_name" in f.read()
    if modes:
        lib, built = fk.softmax_library(source)
    else:
        lib, built = fk._load("softmax_loss_grad", "softmax", fk._HEAD + [
            ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5, source)
        lib.softmax_plan.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int)]

    def calls(n, d, sms, k=K_SM):
        if not modes:
            if k != K_SM:  # the wide shapes: no two-pass mode to time
                return {}
            rows, grid = ctypes.c_int(), ctypes.c_int()
            if lib.softmax_plan(n, d, k, 4, sms, ctypes.byref(rows),
                                ctypes.byref(grid)):
                raise RuntimeError(f"{source}: softmax_plan refused "
                                   f"{n} x {d}, K = {k}")
            plan = rows.value, grid.value
            return {"one_read": (plan, lambda W, st: fk._launch(
                lib, "softmax_loss_grad", "softmax", k, W, st, plan,
                (plan[1], plan[1])))}
        out = {}
        for two_pass in (False, True):
            plan = fk.softmax_plan_for(lib, n, d, k, 4, sms, two_pass)
            out[plan.mode] = (plan.raw, lambda W, st, plan=plan:
                              fk.softmax_launch(lib, k, W, st, plan))
        return out

    return built, calls


def softmax_ab(port, fk, device_synth, specs, seeds):
    """``--ab``: the builds ``specs`` (NAME=SOURCE) of the softmax kernel
    timed in turns (A, B, ..., then back), each held to f64 sums: at
    phase 8's shape, one line a seed, the one-read kernel of each build
    (same-bits flag against the first) and, as NAME:two_pass, the
    two-pass mode forced where the build has it; then at each of
    SOFTMAX_WIDE's shapes (phase 26's), each build's two-pass mode with
    its device ms by pass, beside the two ``torch.matmul`` products.
    Raises at the end if a build was far from the f64 sums at a wide
    shape."""
    from spark_agd_tpu_torch.models import glm

    names, builds = ab_builds(specs, lambda src: softmax_build(fk, src))
    d = D_SM + 1
    sms = fk._device_sms(0)
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
               **softmax_bound(N_SM, d, K_SM, 4), "card_before": card_state()}
        first = None
        for name, (_, calls) in zip(names + names[::-1],
                                    builds + builds[::-1]):
            for mode, (plan, launch) in calls(N_SM, d, sms).items():
                key = name if mode == "one_read" else f"{name}:{mode}"

                def call(launch=launch):
                    return launch(W, staged)

                loss, grad = call()
                r = out.setdefault(key, {"plan": list(plan), "ms": []})
                r["ms"].append(time_ms(call))
                r["grad_max_abs_err_vs_f64"] = float(
                    (grad.double() - exact_grad).abs().max())
                r["loss_rel_err_vs_f64"] = abs(
                    float(loss) - float(exact_loss)) / abs(float(exact_loss))
                if mode == "one_read":
                    if first is None:
                        first = name, loss, grad
                    r[f"same_bits_as_{first[0]}"] = bool(
                        torch.equal(loss, first[1])
                        and torch.equal(grad, first[2]))
                else:
                    loss2, grad2 = call()
                    r["same_bits_on_repeat"] = bool(
                        torch.equal(loss, loss2) and torch.equal(grad, grad2))
        out["card_after"] = card_state()
        emit(out)
        del X, y, staged, exact_grad
        torch.cuda.empty_cache()
    failed = []
    for shape, cfg in SOFTMAX_WIDE.items():
        n, dw, k = cfg["n"], cfg["d"], cfg["k"]
        X, y = device_synth.planted_softmax(n, dw, k, seed=cfg["seed"])
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cfg["seed"])
        W = torch.randn((dw, k), generator=gen, device="cuda") / dw ** 0.5
        staged = fk.stage_softmax(X, y, k)
        exact = softmax_f64(k, W, staged)
        out = {"phase": "ab_wide", "shape_name": shape, "shape": [n, dw],
               "classes": k, "grad_abs_max": float(exact[1].abs().max()),
               **softmax_bound(n, dw, k, 4), "card_before": card_state()}
        for name, (_, calls) in zip(names + names[::-1],
                                    builds + builds[::-1]):
            two = calls(n, dw, sms, k).get("two_pass")
            if two is None:
                continue
            plan, launch = two

            def call(launch=launch):
                return launch(W, staged)

            loss, grad = call()
            loss2, grad2 = call()
            r = out.setdefault(f"{name}:two_pass", {
                "plan": list(plan), "ms": [], "device_ms_by_pass": []})
            r["ms"].append(time_ms(call))
            chunks = -(-n // plan[4])
            r["device_ms_by_pass"].append(
                softmax_device_by_pass(device_ms(call), chunks))
            r["same_bits_on_repeat"] = bool(
                torch.equal(loss, loss2) and torch.equal(grad, grad2))
            try:
                r["loss_rel_err_vs_f64"], r["grad_max_abs_err_vs_f64"] = \
                    hold(loss, grad, exact[0], exact[1],
                         f"{name} at {shape}: far from the f64 sums")
            except AssertionError as e:
                r["loss_rel_err_vs_f64"] = r["grad_max_abs_err_vs_f64"] = None
                failed.append(str(e))
            if not r["same_bits_on_repeat"]:
                failed.append(f"{name} at {shape}: repeated calls differ")
        Xf = X.float()
        resid = torch.randn((n, k), device="cuda")
        out["two_matmuls_ms"] = time_ms(lambda: (Xf @ W, Xf.T @ resid))
        times = [device_ms(lambda: Xf @ W), device_ms(lambda: Xf.T @ resid)]
        out["two_matmuls_device_ms"] = (sum(sum(t.values()) for t in times)
                                        if all(times) else None)
        out["card_after"] = card_state()
        emit(out)
        del X, y, staged, exact, Xf, resid
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))


# --ab margin: the widths swept at AB_ROWS rows in f32 (and in bf16 at
# the warp-rows mode's hand-over), the single-block range past it
# (AB_RANGE_*: at AB_ROWS rows up to AB_RANGE_ROWS_UP_TO columns, else at
# the rows that make f32 X about AB_RANGE_X_BYTES, so that every SM walks
# many stages; 400,000 x 2,000 is LIBSVM's epsilon), one past a row in
# shared memory at fewer rows, and the cluster mode's two ends, f32 and
# bf16: the tile's widest before the stream mode (AB_RANGE_END) and this
# tree's max_width, each with one column past it, at AB_TILE_END_ROWS,
# and the reach (the largest, a row a stage) at AB_REACH_ROWS, rows
# enough for every resident cluster to take many stages.  Past the
# warp-rows mode the first build that can force a mode (margin_mode_plan)
# also runs the modes of AB_FORCED that take the width (the number: a
# cluster's blocks).  The f32 widths 257-289 and bf16 768-800 bracket
# the tile-to-stream hand-over (tile_max_width: 264|265 and 794|795); the
# odd widths (257, 265, 273, 289, 793, 897, 1,001, 2,001, 8,191, 16,383)
# have rows that are not 16-byte aligned.
AB_ROWS = 10_000_000
AB_WIDTHS = (1, 2, 3, 8, 16, 32, 33, 40, 48, 54, 64, 90, 96, 127, 128, 129,
             192, 255, 256, 257, 264, 265, 272, 273, 288, 289, 320, 384, 448,
             512, 1000)
AB_BF16_WIDTHS = (33, 64, 65, 127, 128, 129, 192, 255, 256, 257, 384, 512,
                  768, 793, 794, 800, 896, 897)
AB_RANGE_F32 = (1_001, 1_024, 2_000, 2_001, 3_072, 4_096, 5_000, 8_191,
                8_192, 12_288, 16_384)
AB_RANGE_BF16 = (1_000, 1_001, 2_000, 2_001, 3_072, 4_096, 8_192, 16_383,
                 16_384)
AB_RANGE_ROWS_UP_TO, AB_RANGE_X_BYTES = 1_024, 8_000_000_000
AB_RANGE_END = {torch.float32: 19_364, torch.bfloat16: 23_238}
AB_WIDE = ((100_000, 40_000, torch.float32), (100_000, 40_000,
                                               torch.bfloat16))
AB_TILE_END_ROWS, AB_REACH_ROWS = 100_000, 20_000
AB_FORCED = (("tile", 0), ("stream", 0), ("cluster", 2), ("cluster", 4))
# the "grid" group: the hand-over from the cluster mode (its probes and
# one column under each, rows not 16-byte aligned; and f32 widths
# between 131,071 and 196,607, rows not aligned, where it goes for
# those rows: 184,317 and 184,321 either side of the width at which a
# 16-block cluster's stage falls to one row), past the cluster mode's reach (262,145 and 262,148,
# aligned), phase 31's width, at AB_GRID_ROWS; the grid mode's reach and
# one column past it (appended per tree) at AB_GRID_REACH_ROWS; the modes
# forced there
AB_GRID_ROWS, AB_GRID_REACH_ROWS = 10_000, 1_000
AB_GRID_SHAPES = tuple(
    (AB_GRID_ROWS, d, xt) for d in (131_071, 131_072, 196_607, 196_608,
                                    262_143, 262_144, 262_145)
    for xt in (torch.float32, torch.bfloat16)) + tuple(
    (AB_GRID_ROWS, d, torch.float32) for d in (150_001, 170_001, 180_001,
                                               184_317, 184_321,
                                               190_001)) + (
    (AB_GRID_ROWS, 262_148, torch.float32),
    (AB_GRID_ROWS, 500_000, torch.float32))
AB_GRID_FORCED = (("cluster", 8), ("cluster", 16), ("grid", 0),
                  ("two_pass", 0))
MARGIN_AB_GROUPS = ("sweep", "grid")
# the flagship fit of --ab margin: at a fixed count of iterations, so that
# each build's fit takes as many steps (the fit stops early at the f32
# loss floor, which summation order decides: 30 or 40 iterations)
AB_FIT_ITERS = 30


def ab_range_rows(d):
    """The rows of the single-block range's shapes at width d."""
    return (AB_ROWS if d <= AB_RANGE_ROWS_UP_TO
            else AB_RANGE_X_BYTES // (4 * d))


def margin_build(fk, source):
    """A build of the margin kernel from ``source``, a copy of
    ``csrc/margin_loss_grad.cu`` with its C interface (a source from
    before the cluster mode fills four ints of the plan).  Returns
    ``(BuiltLibrary, plan, launch, forced)`` with ``plan(n, d, itemsize,
    sms)`` a ``MarginPlan``, ``launch(code, w, staged, plan)`` -> ``(loss,
    grad)`` and ``forced(n, d, itemsize, sms, mode, cluster)`` the plan of
    that mode (``margin_mode_plan``), or None where the source has no such
    function or the mode does not take the width."""
    lib, built = fk.library(source)

    def plan(n, d, itemsize, sms):
        with torch.cuda.device(0):
            return fk.plan_for(lib, n, d, itemsize, sms)

    def launch(code, w, staged, p):
        return fk.margin_launch(lib, code, w, staged, p)

    def forced(n, d, itemsize, sms, mode, cluster):
        if not hasattr(lib, "margin_mode_plan"):
            return None
        with torch.cuda.device(0):
            try:
                return fk.mode_plan_for(lib, n, d, itemsize, sms, mode,
                                        cluster)
            except ValueError:
                return None

    return built, plan, launch, forced


def margin_lanes_f64(W, staged, chunk_bytes=1 << 31):
    """The logistic loss and gradient of each row of W in f64 over row
    chunks: (K,) and (K, D)."""
    n, d = staged.X.shape
    rows = max(1, chunk_bytes // (8 * d))
    dev = staged.X.device
    loss = torch.zeros(W.shape[0], dtype=torch.float64, device=dev)
    grad = torch.zeros(W.shape, dtype=torch.float64, device=dev)
    W64 = W.double()
    for r0 in range(0, n, rows):
        Xb = staged.X[r0:r0 + rows].double()
        z = Xb @ W64.T
        yb = staged.y[r0:r0 + rows].double()[:, None]
        mb = staged.m[r0:r0 + rows].double()[:, None]
        loss += ((torch.nn.functional.softplus(-z) + (1 - yb) * z)
                 * mb).sum(0)
        grad += (mb * (torch.sigmoid(z) - yb)).T @ Xb
    return loss, grad


def margin_f64(w, staged):
    """The logistic loss and gradient at one w in f64 (``margin_lanes_f64``
    of one lane)."""
    loss, grad = margin_lanes_f64(w[None], staged)
    return loss[0], grad[0]


def margin_bounds(n, d, itemsize):
    """The bound of one evaluation (X, y and m read once) and the
    two-pass mode's (X read twice, y and m once, the (N,) multipliers
    written and read), in ms."""
    one = bound_ms(n * d * itemsize + 8 * n + 8 * d + 4, 4 * n * d)
    two = bound_ms(2 * n * d * itemsize + 16 * n + 8 * d + 4, 4 * n * d)
    return one, two


def ab_builds(specs, build):
    """``build(source)`` of each NAME=SOURCE in ``specs``, all at once,
    each a tuple that starts with its ``BuiltLibrary``; emits the
    ``ab_build`` line and returns ``(names, builds)``."""
    names = [s.split("=", 1)[0] for s in specs]
    sources = [os.path.abspath(s.split("=", 1)[1]) for s in specs]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(specs)) as pool:
        builds = list(pool.map(build, sources))
    emit({"phase": "ab_build", "seconds": time.perf_counter() - t0,
          "builds": {name: dict(build_report(b[0]), source=src)
                     for name, src, b in zip(names, sources, builds)}})
    return names, builds


def in_turns(names, builds, out, call_of, exact, what):
    """Time each build's ``call_of(build)`` in turns (A, B, ..., then
    back) into ``out[name]`` (CUDA-event and profiler ms, the error from
    the f64 sums ``exact`` = (loss, grad) held as ``hold_lanes`` holds
    them, the same-bits flag against the first build); returns the
    failed holds."""
    failed, first = [], None
    for name, b in zip(names + names[::-1], builds + builds[::-1]):
        call, plan = call_of(b)
        loss, grad = call()
        r = out.setdefault(name, {"plan": list(plan), "ms": [],
                                  "device_ms": []})
        r["ms"].append(time_ms(call))
        r["device_ms"].append(device_ms(call))
        try:
            r["loss_rel_err_vs_f64"], r["grad_max_abs_err_vs_f64"] = \
                hold_lanes(loss.reshape(-1), grad.reshape(loss.numel(), -1),
                           exact[0].reshape(-1),
                           exact[1].reshape(loss.numel(), -1),
                           f"{name} at {what}: far from the f64 sums")
        except AssertionError as e:
            r["loss_rel_err_vs_f64"] = r["grad_max_abs_err_vs_f64"] = None
            failed.append(str(e))
        if first is None:
            first = name, loss, grad
        r[f"same_bits_as_{first[0]}"] = bool(
            torch.equal(loss, first[1]) and torch.equal(grad, first[2]))
    return failed


def margin_ab_shapes(fk, groups):
    """The shapes of --ab margin:'s ``groups``, each ``(rows, width, X's
    dtype, forced modes)``."""
    shapes = []
    if "sweep" in groups:
        sweep = ([(AB_ROWS, d, torch.float32) for d in AB_WIDTHS]
                 + [(AB_ROWS, d, torch.bfloat16) for d in AB_BF16_WIDTHS]
                 + [(ab_range_rows(d), d, torch.float32)
                    for d in AB_RANGE_F32]
                 + [(ab_range_rows(d), d, torch.bfloat16)
                    for d in AB_RANGE_BF16]
                 + list(AB_WIDE))
        for xt in (torch.float32, torch.bfloat16):
            sweep += [(AB_TILE_END_ROWS, w + e, xt)
                      for w in sorted({AB_RANGE_END[xt], fk.max_width(xt)})
                      for e in (0, 1)]
            sweep.append((AB_REACH_ROWS, fk.cluster_max_width(xt), xt))
        shapes += [(n, d, xt, AB_FORCED) for n, d, xt in sweep]
    if "grid" in groups:
        grid = list(AB_GRID_SHAPES)
        for xt in (torch.float32, torch.bfloat16):
            reach = fk.grid_max_width(xt)
            grid += [(AB_GRID_REACH_ROWS, reach + e, xt) for e in (0, 1)]
        shapes += [(n, d, xt, AB_GRID_FORCED) for n, d, xt in grid]
    return shapes


def margin_ab(port, fk, device_synth, specs, groups):
    """``--ab margin:NAME=SOURCE ...``: builds of the margin kernel timed
    in turns (A, B, ..., then back) at the shapes of ``groups``
    (``margin_ab_shapes``): "sweep", AB_WIDTHS x AB_ROWS f32,
    AB_BF16_WIDTHS x AB_ROWS bf16, the single-block range (AB_RANGE_*),
    AB_WIDE and the cluster mode's ends (the tile's widest before the
    stream mode and this tree's ``max_width``, one past each, and
    ``cluster_max_width``); "grid", AB_GRID_SHAPES and this tree's
    ``grid_max_width`` and one past it.  Logistic, each held to f64
    sums, with the two ``torch.matmul`` products beside them; past the
    warp-rows mode also the group's forced modes (AB_FORCED,
    AB_GRID_FORCED), each through the first build that can force it
    (``NAME:MODE`` and a cluster's blocks); one ``ab_margin`` line a
    shape, then, with "sweep", ``margin_fit_ab``'s ``ab_margin_fit``
    line."""
    names, builds = ab_builds(specs, lambda src: margin_build(fk, src))
    dev = torch.device("cuda")
    sms = fk._device_sms(0)
    failed = []
    for n, d, xt, forced_modes in margin_ab_shapes(fk, groups):
        gen = torch.Generator(device=dev)
        gen.manual_seed(d)
        X = torch.randn((n, d), generator=gen, device=dev).to(xt)
        y = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
        w = torch.randn(d, generator=gen, device=dev) / d ** 0.5
        staged = fk.stage_dense(X, y)
        exact = margin_f64(w, staged)
        mult = torch.randn(n, generator=gen, device=dev).to(xt)
        itemsize = X.element_size()
        (b_ms, bound_by), (b2_ms, _) = margin_bounds(n, d, itemsize)
        out = {"phase": "ab_margin", "shape": [n, d],
               "x_dtype": str(xt).replace("torch.", ""), "bound_ms": b_ms,
               "bound_by": bound_by, "two_pass_bound_ms": b2_ms,
               "grad_abs_max": float(exact[1].abs().max()),
               "card_before": card_state()}
        # each build's own plan, then each forced mode through the first
        # build able to force it here
        entries = [(name, b, b[1](n, d, itemsize, sms))
                   for name, b in zip(names, builds)]
        own = list(entries)
        for mode, c in forced_modes:
            if fk.warp_rows_takes(d, xt) or d <= 32:
                break
            for name, b, mine in own:
                p = b[3](n, d, itemsize, sms, mode, c)
                if p is not None:
                    if p.raw != mine.raw:
                        entries.append((f"{name}:{mode}{c or ''}", b, p))
                    break
        by_name = {name: (b, p) for name, b, p in entries}

        def call_of(name):
            (_, _, launch, _), p = by_name[name]
            return (lambda: launch(0, w, staged, p)), p[:5]

        failed += in_turns(list(by_name), list(by_name), out, call_of,
                           exact, f"{n}x{d}")
        wx = w.to(xt)
        out["two_matmuls_ms"] = time_ms(lambda: (X @ wx, mult @ X))
        out["two_matmuls_device_ms"] = two_matmuls_device_ms(X, wx, mult)
        out["card_after"] = card_state()
        emit(out)
        del X, y, staged, mult, exact
        torch.cuda.empty_cache()
    if "sweep" in groups:
        failed += margin_fit_ab(port, device_synth, names, builds, sms)
    if failed:
        raise AssertionError("; ".join(failed))


def build_gradient(port, launch, plan):
    """A ``FusedLogisticGradient`` that launches a build's kernel
    (``launch`` of ``margin_build``) with ``plan``, counting its
    evaluations."""

    class BuildGradient(port.FusedLogisticGradient):
        evaluations = 0

        def batch_loss_and_grad(self, weights, X, y, mask=None):
            self.evaluations += 1
            loss, grad = launch(0, weights.float().contiguous(), X, plan)
            return (loss.to(weights.dtype), grad.to(weights.dtype),
                    X.n_valid)

    return BuildGradient()


def margin_fit_ab(port, device_synth, names, builds, sms):
    """The flagship fit (N_MAIN x D_MAIN f32 class-logistic data made on
    the card, seed 0; AGD with SquaredL2Updater at REG, tol 0) at
    AB_FIT_ITERS iterations through each build's kernel at its own plan,
    in turns (A, B, ..., then back); emits one ``ab_margin_fit`` line
    with each build's plan, wall seconds, iterations, evaluations, final
    loss and whether its weights equal the first build's.  Returns the
    failed holds: a fit whose loss history is further than rtol 1e-4 from
    the first build's."""
    X, y = device_synth.class_logistic(N_MAIN, D_MAIN, seed=0)
    w0 = torch.zeros(D_MAIN, dtype=torch.float32, device="cuda")
    out = {"phase": "ab_margin_fit", "shape": [N_MAIN, D_MAIN],
           "num_iterations": AB_FIT_ITERS, "card_before": card_state()}
    failed, first = [], None
    for name, (_, plan, launch, _) in zip(names + names[::-1],
                                          builds + builds[::-1]):
        p = plan(N_MAIN, D_MAIN, 4, sms)
        gradient = build_gradient(port, launch, p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w, hist, res = port.run(
            (X, y), gradient, port.SquaredL2Updater(), reg_param=REG,
            num_iterations=AB_FIT_ITERS, convergence_tol=TOL,
            initial_weights=w0, return_result=True)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        r = out.setdefault(name, {"plan": list(p[:5]), "run_s": [],
                                  "num_iters": [], "evaluations": []})
        r["run_s"].append(run_s)
        r["num_iters"].append(int(res.num_iters))
        r["evaluations"].append(gradient.evaluations)
        r["loss_last"] = float(hist[-1])
        if first is None:
            first = name, w, hist
        n_common = min(len(hist), len(first[2]))
        r[f"weights_equal_{first[0]}"] = bool(torch.equal(w, first[1]))
        r[f"max_hist_rel_diff_vs_{first[0]}"] = float(np.max(
            np.abs(hist[:n_common] - first[2][:n_common])
            / np.abs(first[2][:n_common])))
        if not np.allclose(hist[:n_common], first[2][:n_common], rtol=1e-4,
                           atol=0.0):
            failed.append(f"{name}'s fit: loss history further than rtol "
                          f"1e-4 from {first[0]}'s")
    out["card_after"] = card_state()
    emit(out)
    del X, y
    torch.cuda.empty_cache()
    return failed


# --ab lanes: three groups of shapes (--shapes picks among them):
# "sweep", the lane counts and widths timed at LANES_AB_ROWS rows of f32
# X; "edges", for each lane bucket, at LANES_AB_EDGE_ROWS: lanes_mma's
# reach and the one-read reach (lanes_max_width) in f32, and the first
# width the plan gives the cluster mode (lanes_cluster_min_width) in f32
# and bf16, each with the column beside it on the other side; and
# "handover", the widths that decide the plan's hand-overs
# (LANES_AB_HANDOVER: lanes_mma's reach and one past it, the tile's
# widest at 8 and 16 lanes and one past it, LIBSVM epsilon's 2,000
# columns at its 400,000 rows, CIFAR's 3,072, gisette's 5,000, 8,000 and
# a gene panel's 40,000; 1,536-2,560 f32 and 2,560-12,000 bf16 columns
# at 1 and 2 lanes, where the tile holds several rows; bf16 1,280-2,314
# at 4 and 8 lanes, where lanes_mma's block holds them).  The first
# build that can force a mode (lanes_mode_plan) also runs the modes of
# LANES_AB_FORCED that take the width (the number: a cluster's blocks)
# at the shapes of the edges and handover groups.
LANES_AB_ROWS, LANES_AB_EDGE_ROWS = 10_000_000, 100_003
LANES_AB_WIDTHS = (64, 256, 512, 1_000)
LANES_AB_K = (1, 2, 4, 8, 16)
LANES_AB_GROUPS = ("sweep", "edges", "handover", "two_pass")
_F32, _BF16, _E = torch.float32, torch.bfloat16, LANES_AB_EDGE_ROWS
LANES_AB_HANDOVER = (  # (rows, width, X's dtype, lane counts)
    (_E, 1_394, _F32, (8,)), (_E, 1_395, _F32, (1, 2, 4, 8)),
    (_E, 1_024, _F32, (16,)), (_E, 1_025, _F32, (16,)),
    (_E, 1_156, _F32, (16,)), (_E, 1_157, _F32, (16,)),
    (EPSILON["n"], EPSILON["d"], _F32, (1, 2, 4, 8, 16)),
    (_E, 2_224, _F32, (8,)), (_E, 2_225, _F32, (8,)),
    (_E, 3_072, _F32, (1, 2, 4, 8, 16)), (_E, 4_131, _F32, (4,)),
    (_E, 4_132, _F32, (4,)), (_E, 5_000, _F32, (1, 2, 4, 8)),
    (_E, 8_000, _F32, (1, 2)), (_E, 40_000, _F32, (8,)),
    (_E, 1_536, _F32, (1, 2)), (_E, 1_792, _F32, (1, 2)),
    (_E, 2_048, _F32, (1, 2)), (_E, 2_304, _F32, (1, 2)),
    (_E, 2_560, _F32, (1, 2)), (_E, 2_560, _BF16, (1, 2)),
    (_E, 3_072, _BF16, (1, 2)), (_E, 3_584, _BF16, (1, 2)),
    (_E, 4_096, _BF16, (1, 2)), (_E, 4_097, _BF16, (1, 2)),
    (_E, 6_000, _BF16, (1, 2)), (_E, 8_000, _BF16, (1, 2)),
    (_E, 10_000, _BF16, (1, 2)), (_E, 12_000, _BF16, (1, 2)),
    (_E, 12_000, _F32, (1, 2)),
    (_E, 1_280, _BF16, (4, 8)), (_E, 1_536, _BF16, (4, 8)),
    (_E, 2_048, _BF16, (8,)), (_E, 2_049, _BF16, (1, 2, 4, 8, 16)),
    (_E, 2_313, _BF16, (8,)), (_E, 2_314, _BF16, (8,)),
    (_E, 5_000, _BF16, (1, 2, 4, 8, 16)))
LANES_AB_FORCED = (("lanes_mma", 0), ("lanes_tile", 0), ("lanes_cluster", 2),
                   ("lanes_cluster", 4), ("lanes_cluster", 8),
                   ("lanes_cluster", 16), ("lanes_two_pass", 0))
# "two_pass": the two-pass mode's shapes (rows, width, X's dtype, lane
# counts): each K's reach of the cluster mode (14,336 f32 columns at 16
# lanes, 20,480 at 4 and 8, 10,496 at 1) and one past it, 40,000 columns,
# phase 19's 100,000 x 40,000, the margin two-pass mode's 10,000 x
# 262,145 at one lane, bf16 one past the reach at 8 and 16 lanes, and
# the hand-over region under the f32 reach (12,000 and 16,384 columns),
# and the pairs of widths either side of each hand-over to the two-pass
# mode where the plan caps the clusters (most_blocks: f32 16 lanes 2,048
# | 2,049; bf16 16 lanes 1,024 | 1,025, 1-8 lanes 4,096 | 4,097) and
# the widths between that decided each cap (f32 16 lanes 1,025-10,000,
# 8 lanes 8,000-18,000, 2 lanes at the reach; bf16 16 lanes
# 1,536-16,384, 1-4 lanes 8,192-32,768); every build runs its own plan
# and, where it can force it, its two-pass mode (NAME:lanes_two_pass),
# and the first build the other modes
LANES_AB_TWO_PASS = (
    (_E, 14_336, _F32, (16,)), (_E, 14_337, _F32, (16,)),
    (_E, 20_480, _F32, (4, 8)), (_E, 20_481, _F32, (4, 8)),
    (_E, 10_496, _F32, (1,)), (_E, 10_497, _F32, (1,)),
    (_E, 40_000, _F32, (8, 16)), (WIDE["n"], WIDE["d"], _F32, (8,)),
    (10_000, 262_145, _F32, (1,)), (_E, 32_769, _BF16, (8,)),
    (_E, 16_385, _BF16, (16,)), (_E, 12_000, _F32, (8, 16)),
    (_E, 16_384, _F32, (8, 16)), (_E, 2_048, _F32, (16,)),
    (_E, 2_049, _F32, (16,)), (_E, 1_024, _BF16, (16,)),
    (_E, 1_025, _BF16, (16,)), (_E, 4_096, _BF16, (1, 2, 4, 8)),
    (_E, 4_097, _BF16, (1, 2, 4, 8)), (_E, 8_192, _BF16, (1, 4, 16)),
    (_E, 1_025, _F32, (16,)), (_E, 3_072, _F32, (16,)),
    (_E, 4_000, _F32, (16,)), (_E, 6_000, _F32, (16,)),
    (_E, 8_000, _F32, (8, 16)), (_E, 10_000, _F32, (8, 16)),
    (_E, 14_336, _F32, (8,)), (_E, 18_000, _F32, (8,)),
    (_E, 20_480, _F32, (2,)), (_E, 1_536, _BF16, (16,)),
    (_E, 2_048, _BF16, (16,)), (_E, 2_049, _BF16, (16,)),
    (_E, 3_072, _BF16, (16,)), (_E, 12_000, _BF16, (16,)),
    (_E, 16_384, _BF16, (4, 8, 16)), (_E, 24_000, _BF16, (8,)),
    (_E, 32_768, _BF16, (1, 4, 8)))


def lanes_bound_ms(n, d, k, itemsize):
    """The lanes kernel's bound: X, y and the mask read once, W read and
    the gradients written once, against 4 N D K f32 flops."""
    return bound_ms(n * d * itemsize + 2 * n * 4 + 2 * k * d * 4 + k * 4,
                    4 * n * d * k)


def lanes_two_pass_floor_ms(n, d, k, itemsize):
    """The two-pass design's floor: X read twice, y and the mask once, W
    read and the gradients written once, the (N, K) multipliers written
    and read, at the memory rate (ms)."""
    return (2 * n * d * itemsize + 2 * n * 4 + 2 * k * d * 4 + k * 4
            + 2 * n * k * 4) / HBM_BYTES_PER_S * 1e3


def lanes_ab(fk, specs, groups=LANES_AB_GROUPS):
    """``--ab lanes:NAME=SOURCE ...``: builds of the lanes kernel (copies
    of ``csrc/margin_lanes_loss_grad.cu`` with its C interface) timed in
    turns at the shapes of ``groups`` (see LANES_AB_GROUPS), logistic,
    each held to f64 sums lane by lane, with the two ``torch.matmul``
    products on (D, K) timed each alone and as a pair; at the edges and
    handover shapes also the forced modes of LANES_AB_FORCED through the
    first build that can force them (``NAME:MODE`` and a cluster's
    blocks).  One ``ab_lanes`` line a shape and lane count."""
    names, builds = ab_builds(specs, lambda src: fk.lanes_library(src)[::-1])
    dev = torch.device("cuda")
    sms = fk._device_sms(0)
    shapes = []
    if "sweep" in groups:
        shapes += [(LANES_AB_ROWS, d, _F32, LANES_AB_K, False)
                   for d in LANES_AB_WIDTHS]
    if "edges" in groups:
        # the edges of the first build that knows the cluster mode's
        lib = next((b[1] for b in builds
                    if hasattr(b[1], "lanes_cluster_min_width")), builds[0][1])
        edges = {(int(lib.lanes_max_width(k, 4)) + e, 4, k)
                 for k in LANES_AB_K for e in (0, 1)}
        if hasattr(lib, "lanes_cluster_min_width"):
            edges |= {(int(lib.lanes_mma_max_width(k, 4)) + e, 4, k)
                      for k in LANES_AB_K for e in (0, 1)}
            edges |= {(int(lib.lanes_cluster_min_width(k, it)) + e, it, k)
                      for k in LANES_AB_K for it in (4, 2) for e in (-1, 0)}
        shapes += [(_E, d, _F32 if it == 4 else _BF16, (k,), True)
                   for d, it, k in sorted(edges)]
    if "handover" in groups:
        shapes += [shape + (True,) for shape in LANES_AB_HANDOVER]
    if "two_pass" in groups:
        shapes += [shape + ("two_pass",) for shape in LANES_AB_TWO_PASS]
    failed = []
    for n, d, xt, ks, force in shapes:
        gen = torch.Generator(device=dev)
        gen.manual_seed(d)
        X = torch.randn((n, d), generator=gen, device=dev).to(xt)
        y = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
        staged = fk.stage_dense(X, y)
        itemsize = X.element_size()
        for k in ks:
            W = torch.randn((k, d), generator=gen, device=dev) / d ** 0.5
            exact = margin_lanes_f64(W, staged)
            mult = torch.randn((n, k), generator=gen, device=dev).to(xt)
            b_ms, bound_by = lanes_bound_ms(n, d, k, itemsize)
            out = {"phase": "ab_lanes", "shape": [n, d], "lanes": k,
                   "x_dtype": str(xt).replace("torch.", ""),
                   "bound_ms": b_ms, "bound_by": bound_by,
                   "two_pass_floor_ms": lanes_two_pass_floor_ms(
                       n, d, k, itemsize),
                   "grad_abs_max": float(exact[1].abs().max()),
                   "card_before": card_state()}
            # each build's own plan, then the forced modes that the first
            # build able to force them runs here
            entries = [(name, b[1], fk.lanes_plan_for(b[1], n, d, k,
                                                      itemsize, sms))
                       for name, b in zip(names, builds)]
            first = True
            for name, lib, own in list(entries):
                if not force or not hasattr(lib, "lanes_mode_plan"):
                    continue
                for mode, c in LANES_AB_FORCED:
                    if not first and mode != "lanes_two_pass":
                        continue
                    try:
                        p = fk.lanes_mode_plan_for(lib, n, d, k, itemsize,
                                                   sms, mode, c)
                    except ValueError:
                        continue
                    if p.raw != own.raw:
                        entries.append((f"{name}:{mode}{c or ''}", lib, p))
                if force != "two_pass":
                    break
                first = False
            by_name = {name: (lib, p) for name, lib, p in entries}

            def call_of(name, W=W):
                lib, p = by_name[name]
                return (lambda: fk.lanes_launch(lib, 0, W, staged, p)), \
                    (p.mode, *p[1:6])

            failed += in_turns(list(by_name), list(by_name), out, call_of,
                               exact, f"{n}x{d}, K = {k}")
            Wx = W.to(xt)
            out["xw_ms"] = time_ms(lambda: X @ Wx.T)
            out["mx_ms"] = time_ms(lambda: mult.T @ X)
            out["two_matmuls_ms"] = time_ms(lambda: (X @ Wx.T, mult.T @ X))
            times = [device_ms(lambda: X @ Wx.T),
                     device_ms(lambda: mult.T @ X)]
            out["two_matmuls_device_ms"] = (sum(sum(t.values()) for t in times)
                                            if all(times) else None)
            out["card_after"] = card_state()
            emit(out)
            del W, Wx, mult, exact
        del X, y, staged
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))


# ---------------------------------------------------------------------------
# the lanes (phases 21-24): the lanes kernel, the regularization path,
# cross-validation and the softmax path's lanes
# ---------------------------------------------------------------------------

# phase 21: every lane bucket edge (1, 2, 4, 8, 16) and one chunk past the
# largest, at widths across the modes (and, resolved on the card for each
# bucket and dtype, lanes_mma's reach, the column before the cluster
# mode's first, the widest X read once and one column past each),
# LANES_ROWS rows up to 1,024 columns and LANES_WIDE_ROWS past them
LANES_K = (1, 2, 3, 8, 16, 17, 20)
LANES_WIDTHS = (1, 2, 33, 1_000, 1_001, 1_024, 40_000)
LANES_ROWS, LANES_WIDE_ROWS = 100_003, 3_000
# phase 22: tpu_checks.py:277's grid, 10^-1 ... 10^-8
SWEEP_REGS = [10.0 ** -(i + 1) for i in range(8)]
# phase 23: 4 strengths x 5 folds, 20 lanes
CV_REGS, CV_FOLDS = [1e-1, 1e-2, 1e-3, 1e-4], 5
# phase 24: 3 strengths, 10 iterations on phase 7's data
SOFTMAX_SWEEP_REGS, SOFTMAX_SWEEP_ITERS = [1e-2, 1e-3, 1e-4], 10


def counting_lanes(cls):
    """``cls`` with a count of lanes evaluations (rounds), to hold
    launches against them."""

    class Counting(cls):
        rounds = 0

        def lanes_loss_and_grad(self, W, X, y, masks=None):
            self.rounds += 1
            return super().lanes_loss_and_grad(W, X, y, masks)

    return Counting


def hold_lanes(loss, grad, ref_loss, ref_grad, what):
    """``hold`` lane by lane; returns the worst (loss relative error,
    grad max abs error)."""
    errs = [hold(loss[k], grad[k], ref_loss[k], ref_grad[k],
                 f"{what}, lane {k}") for k in range(loss.shape[0])]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def compare_lanes(fk, gradient, W, staged, where):
    """The lanes kernel twice (bit-identical) against its plain version,
    and each lane against the solo kernel; returns the worst errors
    against the plain version."""
    loss, grad = repeat_lanes(fk, gradient, W, staged, where)
    ref_loss, ref_grad = fk.fused_margin_lanes_loss_grad_reference(
        gradient, W, staged)
    errs = hold_lanes(loss, grad, ref_loss, ref_grad,
                      f"{where}: lanes kernel vs its plain version")
    solo = [fk.fused_margin_loss_grad(gradient, W[k], staged)
            for k in range(W.shape[0])]
    hold_lanes(loss, grad, torch.stack([s[0] for s in solo]),
               torch.stack([s[1] for s in solo]),
               f"{where}: lanes kernel vs the solo kernel")
    return errs


def repeat_lanes(fk, gradient, W, staged, where):
    """The lanes kernel twice; raises unless both give the same bits."""
    loss, grad = fk.fused_margin_lanes_loss_grad(gradient, W, staged)
    loss2, grad2 = fk.fused_margin_lanes_loss_grad(gradient, W, staged)
    torch.cuda.synchronize()
    if not (torch.equal(loss, loss2) and torch.equal(grad, grad2)):
        raise AssertionError(f"{where}: repeated lanes calls differ")
    return loss, grad


def phase_lanes_kernel(fk, losses):
    """Phase 21: the lanes kernel against its plain version (and each
    lane against the solo kernel) at every bucket and mode edge, f32 and
    bf16, masked and unmasked, all three losses at D = 1000, K = 8."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    chunk = fk.max_lanes()
    buckets = sorted({fk.lanes_launch_shape(
        torch.empty((1, 1), device=dev), min(k, chunk)).bucket
        for k in LANES_K})
    worst, modes, cases = [0.0, 0.0], {}, 0
    limits, reaches, starts = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        limits[kind] = {b: fk.lanes_max_width(b, dtype) for b in buckets}
        reaches[kind] = {b: fk.lanes_mma_max_width(b, dtype)
                         for b in buckets}
        starts[kind] = {b: fk.lanes_cluster_min_width(b, dtype)
                        for b in buckets}
        edges = {b: {w + e for w in (limits[kind][b], reaches[kind][b],
                                     starts[kind][b] - 1)
                     for e in (0, 1)} for b in buckets}
        widths = sorted(set(LANES_WIDTHS).union(*edges.values()))
        for d in widths:
            n = LANES_ROWS if d <= 1_024 else LANES_WIDE_ROWS
            gen = torch.Generator(device=dev)
            gen.manual_seed(d)
            X = torch.randn((n, d), generator=gen, device=dev).to(dtype)
            y = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
            m = (torch.rand(n, generator=gen, device=dev) < 0.7).float()
            for k in LANES_K:
                plan = fk.lanes_launch_shape(X, min(k, chunk))
                b = plan.bucket
                if d not in LANES_WIDTHS and d not in edges[b]:
                    continue
                # the width rule: one block a row below the cluster mode's
                # first width, the cluster mode up to the widest X read
                # once, the two-pass mode past it
                want = (("lanes_two_pass",) if d > limits[kind][b]
                        else ("lanes_cluster",) if d >= starts[kind][b]
                        else ("lanes_mma", "lanes_tile"))
                if plan.mode not in want:
                    raise AssertionError(f"lanes plan at d={d}, k={k}, "
                                         f"{kind}: {plan.mode}, not {want}")
                W = torch.randn((k, d), generator=gen, device=dev) / d ** 0.5
                names = (("logistic", "least_squares", "hinge")
                         if (d, k) == (1_000, 8) else ("logistic",))
                for mask in (None, m):
                    staged = fk.stage_dense(X, y, mask)
                    for name in names:
                        errs = compare_lanes(
                            fk, losses.GRADIENTS[name](), W, staged,
                            f"lanes d={d} k={k} {kind} {name} "
                            f"{'masked' if mask is not None else 'plain'}")
                        worst = [max(a, b) for a, b in zip(worst, errs)]
                        cases += 1
                modes[plan.mode] = modes.get(plan.mode, 0) + 1
            del X, y, m
    torch.cuda.empty_cache()
    emit({"phase": "lanes_kernel", "cases": cases,
          "lanes": list(LANES_K), "max_lanes": chunk,
          "one_read_max_width_by_bucket": limits,
          "lanes_mma_max_width_by_bucket": reaches,
          "cluster_min_width_by_bucket": starts,
          "plans_by_mode": modes, "max_loss_rel_err": worst[0],
          "max_grad_abs_err": worst[1],
          "seconds": time.perf_counter() - t0})


class _Lane:
    """Lane ``k`` of a batched ``AGDResult``, with the fields
    ``same_stop`` reads."""

    def __init__(self, res, k):
        """``k``: the lane's index, or its (fold, strength) pair."""
        self.num_iters = res.num_iters[k]
        self.converged = res.converged[k]
        self.aborted_non_finite = res.aborted_non_finite[k]
        self.loss_history = res.loss_history[k]
        self.hist = self.loss_history[:int(self.num_iters)].double().numpy()


def hold_paths(res, ref, hist, ref_hist, checks, label):
    """Two fits held over their common iterations (histories rtol 1e-4,
    ``same_stop``); returns the worst relative history difference."""
    n = min(len(hist), len(ref_hist))
    ok = bool(np.allclose(hist[:n], ref_hist[:n], rtol=1e-4, atol=0.0))
    checks[f"{label}_history_rtol_1e-4"] = ok
    checks[f"{label}_same_stop_or_both_at_floor"] = same_stop(
        res, ref, hist, ref_hist)
    return float(np.max(np.abs(hist[:n] - ref_hist[:n])
                        / np.abs(ref_hist[:n]))) if n else 0.0


def hold_sweep(res, ref, checks, label):
    """Every lane of ``res`` held to the same lane of ``ref``."""
    k = int(res.num_iters.shape[0])
    lane_checks, diffs = {}, []
    for i in range(k):
        a, b = _Lane(res, i), _Lane(ref, i)
        diffs.append(hold_paths(a, b, a.hist, b.hist, lane_checks,
                                f"lane_{i}"))
    checks[f"{label}_every_lane_history_rtol_1e-4"] = all(
        v for c, v in lane_checks.items() if c.endswith("rtol_1e-4"))
    checks[f"{label}_every_lane_same_stop_or_both_at_floor"] = all(
        v for c, v in lane_checks.items() if c.endswith("at_floor"))
    checks[f"{label}_finite"] = bool(
        torch.isfinite(res.weights).all()
        and not bool(res.aborted_non_finite.any()))
    return {f"{label}_max_hist_rel_diff_by_lane": diffs,
            f"{label}_num_iters": res.num_iters.tolist(),
            f"{label}_num_iters_plain": ref.num_iters.tolist(),
            f"{label}_num_backtracks": res.num_backtracks.tolist(),
            f"{label}_num_restarts": res.num_restarts.tolist()}


def sweep_path(port, fk, losses, smi, X, y, solo, launches,
               path="sweep_path", want=None, iters=ITERS, keep=None):
    """Phase 22, on phase 5's data (and phase 29, ``path`` =
    "epsilon_sweep", on phase 28's; phase 30, "wide_sweep", on phase
    19's): the regularization path over SWEEP_REGS through
    ``FusedLogisticGradient`` at ``iters`` iterations (every launch the
    lanes kernel, one per evaluation round, and with ``want`` every launch
    in that mode), each lane held to the plain sweep and the 0.1 lane to
    the solo fit ``solo`` on the same data (``(AGDResult, loss history,
    wall seconds)``); the kernel at this shape, K = 8, held to f64 sums
    and timed (device ms by kernel name: by pass in the two-pass mode).
    Returns the lanes kernel's entry of the kernels line; ``keep["res"]``
    (a dict, optional) receives the sweep's result (phase 33 holds its
    streamed path to it)."""
    t_phase = time.perf_counter()
    k = len(SWEEP_REGS)
    n, d = X.shape
    w0 = torch.zeros(d, dtype=torch.float32, device="cuda")
    fused = counting_lanes(port.FusedLogisticGradient)()

    def opt(gradient):
        return (port.AcceleratedGradientDescent(gradient,
                                                port.SquaredL2Updater())
                .setNumIterations(iters).setConvergenceTol(TOL))

    fk.reset_launch_counts()
    res, sweep_s = timed(lambda: opt(fused).sweep((X, y), SWEEP_REGS, w0))
    lanes_launches, rounds = fk.lanes_launch_count, fused.rounds
    modes = {m: c for m, c in fk.lanes_mode_launches.items() if c}
    other = fk.launch_count + fk.softmax_launch_count
    launches[path] = lanes_launches
    launches.setdefault("lanes_modes", {})[path] = modes
    plain, plain_s = timed(lambda: opt(port.LogisticGradient()).sweep(
        (X, y), SWEEP_REGS, w0))
    checks = {"launches_equal_rounds": lanes_launches == rounds > 0,
              "only_the_lanes_kernel": other == 0,
              "weights_shape": tuple(res.weights.shape) == (k, d)}
    if want is not None:
        checks[f"every_launch_{want}"] = modes == {want: lanes_launches}
    out = {"shape": [n, d], "regs": SWEEP_REGS,
           "iterations": iters, "sweep_s": sweep_s, "plain_sweep_s": plain_s,
           "solo_run_s": solo[2], "eight_solo_runs_s": k * solo[2],
           "rounds": rounds, "launches": lanes_launches, "modes": modes,
           "wall_ms_per_round": sweep_s * 1e3 / rounds,
           "loss_last_by_lane": [float(_Lane(res, i).hist[-1])
                                 for i in range(k)]}
    out.update(hold_sweep(res, plain, checks, "sweep"))
    if keep is not None:
        keep["res"] = res
    lane0 = _Lane(res, 0)
    out["lane_0.1_max_hist_rel_diff_vs_solo"] = hold_paths(
        lane0, solo[0], lane0.hist, solo[1], checks, "lane_0.1_vs_solo")

    # the kernel at this shape held to f64 sums at 8 random weight rows
    # (as --ab margin: holds the solo kernel), and at the sweep's final
    # weights its distance from them beside the solo kernel's and the
    # plain version's: there the small-strength lanes' gradients are
    # near 0, a difference of sums over 10M rows, and every f32
    # evaluation is about as far from f64 as their largest entry allows
    gradient = losses.LogisticGradient()
    staged = fk.stage_dense(X, y)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    W_rand = torch.randn((k, d), generator=gen, device="cuda") / d ** 0.5
    loss, grad = repeat_lanes(fk, gradient, W_rand, staged, f"{path} shape")
    exact_loss, exact_grad = margin_lanes_f64(W_rand, staged)
    loss_err, max_abs_err = hold_lanes(loss, grad, exact_loss, exact_grad,
                                       f"{path} shape vs f64 sums")
    out["grad_abs_max_f64_random_w"] = float(exact_grad.abs().max())
    W = res.weights.contiguous()
    _, exact_grad = margin_lanes_f64(W, staged)
    dist = {"lanes_kernel": fk.fused_margin_lanes_loss_grad(
                gradient, W, staged)[1],
            "solo_kernel": torch.stack([fk.fused_margin_loss_grad(
                gradient, W[i], staged)[1] for i in range(k)]),
            "plain": fk.fused_margin_lanes_loss_grad_reference(
                gradient, W, staged)[1]}
    out["at_sweep_weights_grad_abs_max_f64_by_lane"] = \
        exact_grad.abs().amax(dim=1).tolist()
    out["at_sweep_weights_grad_max_abs_err_vs_f64_by_lane"] = {
        name: (g.double() - exact_grad).abs().amax(dim=1).tolist()
        for name, g in dist.items()}
    del dist, exact_grad
    state_before = card_state()

    def lanes_call():
        return fk.fused_margin_lanes_loss_grad(gradient, W, staged)

    kernel_ms = time_ms(lanes_call)
    kernel_device_ms = device_ms(lanes_call)
    plain_ms = time_ms(lambda: fk.fused_margin_lanes_loss_grad_reference(
        gradient, W, staged))
    mult = torch.randn((n, k), device="cuda")
    two_mm_ms = time_ms(lambda: (X @ W.T, mult.T @ X))
    times = [device_ms(lambda: X @ W.T), device_ms(lambda: mult.T @ X)]
    two_mm_device_ms = (sum(sum(t.values()) for t in times)
                        if all(times) else None)
    solo_ms = time_ms(lambda: [fk.fused_margin_loss_grad(gradient, W[i],
                                                         staged)
                               for i in range(k)])
    state_after = card_state()
    b_ms, bound_by = lanes_bound_ms(n, d, k, 4)
    floor_ms = lanes_two_pass_floor_ms(n, d, k, 4)
    plan = fk.lanes_launch_shape(X, k)
    out.update({
        "kernel_ms": kernel_ms, "kernel_device_ms": kernel_device_ms,
        "bound_ms": b_ms, "bound_by": bound_by,
        "two_pass_floor_ms": floor_ms,
        "bound_source": "H100 SXM data sheet 3.35 TB/s, 67 TFLOP/s f32",
        "kernel_bound_frac": b_ms / kernel_ms, "plain_ms": plain_ms,
        "two_matmuls_ms": two_mm_ms,
        "two_matmuls_device_ms": two_mm_device_ms,
        "eight_solo_launches_ms": solo_ms,
        "kernel_share_of_sweep_wall": rounds * kernel_ms / (sweep_s * 1e3),
        "plan": list(plan[:6]),
        "loss_rel_err_vs_f64": loss_err,
        "grad_max_abs_err_vs_f64": max_abs_err,
        "card_before": state_before, "card_after": state_after})
    if want is not None:
        checks["plan_mode"] = plan.mode == want
    del staged, mult
    finish(path, out, checks, t_phase, smi)
    return {"name": "margin_lanes_loss_grad", "route": "cuda",
            "source": "spark_agd_tpu_torch/csrc/margin_lanes_loss_grad.cu",
            "replaces": "spark_agd_tpu/ops/pallas_kernels.py:207",
            "counterpart": "spark_agd_tpu/ops/pallas_kernels.py:"
                           "fused_margin_loss_grad under jax.vmap "
                           "(api.sweep)",
            "launches": lanes_launches,
            # the error the run asserts: against the f64 sums
            "max_abs_err": max_abs_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": bound_by, "library_ms": None,
            "two_pass_floor_ms": floor_ms,
            "two_matmuls_ms": two_mm_ms,
            "device_ms": sum(kernel_device_ms.values()) or None,
            "device_ms_by_kernel": kernel_device_ms,
            "two_matmuls_device_ms": two_mm_device_ms,
            "eight_solo_launches_ms": solo_ms, "lanes": k,
            "shape": [n, d], "plan": list(plan[:6])}


def wide_sweep_path(port, fk, losses, smi, X, y, solo, launches):
    """Phase 30, on phase 19's data (WIDE, 100,000 x 40,000 f32): the
    path of phase 22 (SWEEP_REGS, WIDE's iterations, tol 0) read as phase
    22 is, every launch in the mode the lanes kernel's plan gives there,
    which the width rule makes the two-pass mode (40,000 columns lie past
    ``lanes_max_width`` for 8 lanes); the 0.1 lane held to phase 19's
    solo fit."""
    k, d = len(SWEEP_REGS), X.shape[1]
    want = fk.lanes_launch_shape(X, k).mode
    rule = ("lanes_two_pass" if d > fk.lanes_max_width(k, X.dtype)
            else "lanes_cluster")
    if want != rule:
        raise AssertionError(f"wide_sweep: the plan gives {want} at "
                             f"{d} columns, the width rule {rule}")
    return sweep_path(port, fk, losses, smi, X, y, solo, launches,
                      "wide_sweep", want, WIDE["iters"])


class _LbfgsLane:
    """Lane ``k`` of a batched ``LBFGSResult``, with the fields
    ``lbfgs_common_path`` and ``hold_lbfgs`` read."""

    def __init__(self, res, k):
        for f in ("weights", "loss_history", "num_iters", "num_fn_evals",
                  "converged", "ls_failed", "aborted_non_finite",
                  "ls_stop_reason", "diag_step", "diag_evals"):
            setattr(self, f, getattr(res, f)[k])


def lbfgs_sweep_path(port, fk, smi, X, y, launches, keep=None):
    """Phase 27, on phase 5's data after phase 22: the L-BFGS
    regularization path over SWEEP_REGS (``LBFGS.sweep`` through
    ``FusedLogisticGradient``, 40 iterations at MLlib's tol 1e-4): one
    launch of the lanes kernel a round, every lane held to its solo
    ``run_lbfgs`` through the margin kernel over their common path, and
    the path's wall time beside the 8 solo fits'; ``keep["res"]`` (a
    dict, optional) receives the path's result."""
    t_phase = time.perf_counter()
    k = len(SWEEP_REGS)
    w0 = torch.zeros(D_MAIN, dtype=torch.float32, device="cuda")
    fused = counting_lanes(port.FusedLogisticGradient)()
    fk.reset_launch_counts()
    res, sweep_s = timed(lambda: port.LBFGS(fused, port.SquaredL2Updater())
                         .setNumIterations(ITERS)
                         .sweep((X, y), SWEEP_REGS, w0))
    lanes_launches, rounds = fk.lanes_launch_count, fused.rounds
    modes = {m: c for m, c in fk.lanes_mode_launches.items() if c}
    other = fk.launch_count + fk.softmax_launch_count
    launches["lbfgs_sweep_path"] = lanes_launches
    launches.setdefault("lanes_modes", {})["lbfgs_sweep_path"] = modes
    solos, solo_s = [], []
    for reg in SWEEP_REGS:
        r, t = timed(lambda reg=reg: port.run_lbfgs(
            (X, y), port.FusedLogisticGradient(), port.SquaredL2Updater(),
            reg_param=reg, num_iterations=ITERS, initial_weights=w0))
        solos.append(r)
        solo_s.append(t)
    solo_launches = fk.launch_count
    checks = {"one_lanes_launch_a_round": lanes_launches == rounds > 0,
              "rounds_are_the_most_evaluations_of_a_lane":
                  rounds == int(res.num_fn_evals.max()) == res.eval_rounds,
              "no_other_kernel_in_the_sweep": other == 0,
              "solo_launches_equal_their_evaluations": solo_launches
              == sum(int(r.num_fn_evals) for r in solos),
              "weights_shape": tuple(res.weights.shape) == (k, D_MAIN)}
    out = {"shape": [N_MAIN, D_MAIN], "regs": SWEEP_REGS,
           "iterations": ITERS, "sweep_s": sweep_s,
           "eight_solo_run_lbfgs_s": sum(solo_s), "solo_run_s": solo_s,
           "rounds": rounds, "launches": lanes_launches, "modes": modes,
           "solo_evaluations": [int(r.num_fn_evals) for r in solos],
           "wall_ms_per_round": sweep_s * 1e3 / rounds,
           "num_iters": res.num_iters.tolist(),
           "num_fn_evals": res.num_fn_evals.tolist(),
           "ls_stop_reason": res.ls_stop_reason.tolist(),
           "solo_num_iters": [int(r.num_iters) for r in solos]}
    for i, solo in enumerate(solos):
        out.update(hold_lbfgs(_LbfgsLane(res, i), solo, checks,
                              f"lane_{i}"))
    if keep is not None:
        keep["res"] = res
    finish("lbfgs_sweep_path", out, checks, t_phase, smi)


def cv_path(port, fk, glm, smi, X, y, launches):
    """Phase 23, on phase 5's data: 5-fold CV over CV_REGS (20 lanes)
    through ``LogisticRegressionWithAGD(add_intercept=False)
    .cross_validate`` with the plain gradient and its refit; the fold
    ids drawn on the card against the CPU draw, two lanes against solo
    runs under their train masks, ``val_loss`` against each lane's
    held-out mean loss."""
    from spark_agd_tpu_torch import api

    t_phase = time.perf_counter()
    trainer = glm.LogisticRegressionWithAGD(add_intercept=False)
    trainer.optimizer.setNumIterations(ITERS).setConvergenceTol(TOL)
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launch_counts()
    (model, cv), cv_s = timed(lambda: trainer.cross_validate(
        X, y, CV_REGS, n_folds=CV_FOLDS))
    launches["cv_path"] = fk.lanes_launch_count
    kernel_launches = (fk.launch_count + fk.lanes_launch_count
                       + fk.softmax_launch_count)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cpu_ids, cpu_draw_s = timed(lambda: api.fold_assignment(
        N_MAIN, CV_FOLDS, 0, "cpu"))
    res = cv.train_result
    checks = {
        "fold_ids_equal_the_cpu_draw": bool(torch.equal(cv.fold_ids.cpu(),
                                                        cpu_ids)),
        "plain_gradient_launches_no_kernel": kernel_launches == 0,
        "shapes": tuple(cv.val_loss.shape) == (CV_FOLDS, len(CV_REGS))
        and tuple(res.weights.shape) == (CV_FOLDS, len(CV_REGS), D_MAIN),
        "val_loss_finite": bool(torch.isfinite(cv.val_loss).all()),
        "refit_finite": bool(torch.isfinite(model.weights).all()),
    }
    out = {"shape": [N_MAIN, D_MAIN], "regs": CV_REGS, "folds": CV_FOLDS,
           "lanes": CV_FOLDS * len(CV_REGS), "iterations": ITERS,
           "cv_and_refit_s": cv_s, "cpu_fold_draw_s": cpu_draw_s,
           "peak_gb": peak_gb, "val_loss": cv.val_loss.tolist(),
           "mean_val_loss": cv.mean_val_loss.tolist(),
           "best_index": int(cv.best_index),
           "best_reg": CV_REGS[int(cv.best_index)],
           "num_iters": res.num_iters.tolist()}
    w0 = torch.zeros(D_MAIN, dtype=torch.float32, device="cuda")
    val_errs = []
    gradient = port.LogisticGradient()
    for f in range(CV_FOLDS):
        held = (cv.fold_ids == f).float()
        for r, reg in enumerate(CV_REGS):
            ls, _, cnt = gradient.batch_loss_and_grad(res.weights[f, r], X,
                                                      y, held)
            want = float(ls) / float(cnt)
            val_errs.append(abs(float(cv.val_loss[f, r]) - want) / abs(want))
    checks["val_loss_equals_each_lanes_held_out_loss_rtol_1e-5"] = \
        max(val_errs) < 1e-5
    out["val_loss_max_rel_diff"] = max(val_errs)
    solo_s = []
    for f, r in ((0, 0), (CV_FOLDS - 1, len(CV_REGS) - 1)):
        train = (cv.fold_ids != f).float()
        (_, hist, solo), s = timed(lambda: port.run(
            (X, y, train), port.LogisticGradient(), port.L2Prox(),
            reg_param=float(np.float32(CV_REGS[r])), num_iterations=ITERS,
            convergence_tol=TOL, initial_weights=w0, return_result=True))
        solo_s.append(s)
        lane = _Lane(res, (f, r))
        out[f"lane_{f}_{r}_max_hist_rel_diff_vs_solo"] = hold_paths(
            lane, solo, lane.hist, hist, checks, f"lane_{f}_{r}_vs_solo")
    out["solo_run_s"] = solo_s
    finish("cv_path", out, checks, t_phase, smi)


def softmax_sweep(port, fk, glm, smi, Xa, y, launches):
    """Phase 24, on phase 7's data with its intercept column:
    ``SoftmaxRegressionWithAGD.train_path`` with ``FusedSoftmaxGradient``
    in the seat (``add_intercept=False``: Xa has the column), one softmax
    launch a lane per round, each lane held to the plain sweep."""
    t_phase = time.perf_counter()
    k = len(SOFTMAX_SWEEP_REGS)
    fused = counting_lanes(port.FusedSoftmaxGradient)(
        port.SoftmaxGradient(K_SM))
    trainer = glm.SoftmaxRegressionWithAGD(
        K_SM, updater=port.SquaredL2Updater(), add_intercept=False)
    trainer.optimizer.set_gradient(fused) \
        .setNumIterations(SOFTMAX_SWEEP_ITERS).setConvergenceTol(TOL)
    fk.reset_launch_counts()
    (models, res), path_s = timed(lambda: trainer.train_path(
        Xa, y, SOFTMAX_SWEEP_REGS))
    softmax_launches, rounds = fk.softmax_launch_count, fused.rounds
    launches["softmax_sweep"] = softmax_launches
    softmax_modes(fk, launches, "softmax_sweep")
    other = fk.launch_count + fk.lanes_launch_count
    w0 = torch.zeros((Xa.shape[1], K_SM), dtype=torch.float32,
                     device="cuda")
    plain, plain_s = timed(lambda: port.sweep(
        (Xa, y), port.SoftmaxGradient(K_SM), port.SquaredL2Updater(),
        SOFTMAX_SWEEP_REGS, num_iterations=SOFTMAX_SWEEP_ITERS,
        convergence_tol=TOL, initial_weights=w0))
    checks = {
        "one_softmax_launch_a_lane_per_round":
            softmax_launches == k * rounds > 0,
        "no_margin_launch": other == 0,
        "models": len(models) == k
        and tuple(models[0].weights.shape) == (Xa.shape[1], K_SM),
    }
    out = {"shape": list(Xa.shape), "classes": K_SM,
           "regs": SOFTMAX_SWEEP_REGS, "iterations": SOFTMAX_SWEEP_ITERS,
           "train_path_s": path_s, "plain_sweep_s": plain_s,
           "rounds": rounds, "softmax_launches": softmax_launches}
    out.update(hold_sweep(res, plain, checks, "softmax_sweep"))
    finish("softmax_sweep", out, checks, t_phase, smi)


# ---------------------------------------------------------------------------
# Phases 32-34: the streamed data plane
# ---------------------------------------------------------------------------

# phases 32-33: phase 5's data streamed from pinned host memory in
# macro-batches of STREAM_ROWS rows (the last a ragged 562,816), phase 32
# with STREAM_PREFETCH batches prepared ahead (the sweeps take no thread);
# each fit capped at STREAM_ITERS
STREAM_ROWS, STREAM_PREFETCH, STREAM_ITERS = 1_048_576, 2, 10
# phase 34: phase 10's rcv1-like data as LIBSVM part files
STREAM_PARTS, STREAM_PART_BATCH_ROWS, STREAM_LIBSVM_ITERS = 8, 65_536, 3
# host memory to leave free beside the pinned copy of phase 5's data
STREAM_HOST_HEADROOM = 8 << 30


def mem_available():
    """``MemAvailable`` of ``/proc/meminfo`` in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable")


def pinned_copy(streaming, X, y):
    """X and y copied once into pinned host memory (``pin_host``: page-
    locked at their exact size); raises, before allocating, when the
    host has not the memory for them."""
    need = X.numel() * X.element_size() + y.numel() * 4
    available = mem_available()
    if available < need + STREAM_HOST_HEADROOM:
        raise AssertionError(
            f"stream_path: MemAvailable {available / 1e9:.1f} GB cannot "
            f"hold phase 5's data ({need / 1e9:.1f} GB) and "
            f"{STREAM_HOST_HEADROOM / 1e9:.1f} GB beside it")
    t0 = time.perf_counter()
    Xh = streaming.pin_host(torch.empty(X.shape, dtype=X.dtype))
    yh = streaming.pin_host(torch.empty(y.shape, dtype=torch.float32))
    pin_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Xh.copy_(X)
    yh.copy_(y)
    torch.cuda.synchronize()
    return {"X": Xh, "y": yh, "mem_available_gb": available / 1e9,
            "pin_s": pin_s, "d2h_s": time.perf_counter() - t0}


def copy_yardstick(X, y, rows, repeats=3):
    """Plain pinned ``copy_`` rates in GB/s, each by CUDA events: one
    batch (X's first ``rows`` rows and their labels) 5 times, and the
    whole pass (every batch back to back on one stream into two device
    buffers in turn) ``repeats`` times.  Returns both lists and the
    first batch on the card."""
    n = X.shape[0]
    row_bytes = X[0].numel() * X.element_size() + y.element_size()
    bufs = [(torch.empty((rows,) + tuple(X.shape[1:]), dtype=X.dtype,
                         device="cuda"),
             torch.empty(rows, dtype=y.dtype, device="cuda"))
            for _ in range(2)]

    def copy(i, lo):
        hi = min(lo + rows, n)
        dX, dy = bufs[i]
        dX[:hi - lo].copy_(X[lo:hi], non_blocking=True)
        dy[:hi - lo].copy_(y[lo:hi], non_blocking=True)
        return (hi - lo) * row_bytes

    def whole_pass():
        return sum(copy(b % 2, lo)
                   for b, lo in enumerate(range(0, n, rows)))

    def gb_per_s(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        nbytes = fn()
        end.record()
        end.synchronize()
        return nbytes / (start.elapsed_time(end) / 1e3) / 1e9

    copy(0, 0)
    torch.cuda.synchronize()
    one = [gb_per_s(lambda: copy(0, 0)) for _ in range(5)]
    whole = [gb_per_s(whole_pass) for _ in range(repeats)]
    copy(0, 0)
    torch.cuda.synchronize()
    return one, whole, bufs[0]


def pass_report(stats, prefix=""):
    """The passes' wall seconds, the stall and throttle shares and the
    host-to-device GB/s, from ``fold_stream``'s stats."""
    pass_s = [s["pass_s"] for s in stats]
    total = sum(pass_s)
    return {f"{prefix}passes": len(stats),
            f"{prefix}pass_s_mean": total / len(stats),
            f"{prefix}pass_s_min": min(pass_s),
            f"{prefix}pass_s_max": max(pass_s),
            f"{prefix}stall_share": sum(s["stall_s"] for s in stats) / total,
            f"{prefix}throttle_share": sum(s.get("throttle_s", 0.0)
                                           for s in stats) / total,
            f"{prefix}h2d_gb_per_s": sum(s.get("h2d_bytes", 0)
                                         for s in stats) / total / 1e9}


class _F64Sums:
    """A gradient whose batch sums are the f64 ones (``margin_f64``), for
    holding a streamed evaluation to f64 over the same stream."""

    def __init__(self, fk):
        self.fk = fk

    def batch_loss_and_grad(self, weights, X, y, mask=None):
        staged = self.fk.stage_dense(X, y, mask)
        loss, grad = margin_f64(weights, staged)
        return loss, grad, staged.n_valid


def stream_path(port, fk, streaming, smi, host, solo, launches,
                keep=None):
    """Phase 32: phase 5's data from pinned host memory through
    ``StreamingDataset.from_arrays`` (STREAM_ROWS a batch, STREAM_PREFETCH
    ahead), ``make_streaming_smooth(FusedLogisticGradient())`` and
    ``run_agd_host`` at phase 5's settings capped at STREAM_ITERS: every
    launch in the stream mode, one a batch a pass; its first evaluation
    and one at phase 5's weights held to f64 sums over the same stream,
    its loss history to phase 5's over their common iterations (rtol
    1e-4); pass seconds, stall share, host-to-device GB/s beside plain
    pinned copies of one batch and of the whole pass back to back
    (``copy_yardstick``), the kernel's device ms a batch and the card's
    peak allocation, which must stay under (prefetch + 2) batches + 1
    GB.  ``keep["carry"]`` (a dict, optional) receives the fit's carry
    after SUP_STREAM_ITERS iterations (phase 37 holds to it)."""
    from spark_agd_tpu_torch.core import smooth as smooth_lib

    t_phase = time.perf_counter()
    Xh, yh = host["X"], host["y"]
    n, d = Xh.shape
    batches = -(-n // STREAM_ROWS)
    batch_bytes = STREAM_ROWS * d * Xh.element_size()
    ds = streaming.StreamingDataset.from_arrays(Xh, yh, STREAM_ROWS)
    one_copy, pass_copy, (dX, dy) = copy_yardstick(Xh, yh, STREAM_ROWS)
    gradient = port.LogisticGradient()
    staged = fk.stage_dense(dX, dy)
    w_solo = solo[0].weights
    kernel_device_ms = device_ms(lambda: fk.fused_margin_loss_grad(
        gradient, w_solo, staged))
    plan = fk.launch_shape(dX)
    del staged, dX, dy
    torch.cuda.empty_cache()

    fused = counting(port.FusedLogisticGradient)()
    stats = []
    sm, sl = streaming.make_streaming_smooth(
        fused, ds, prefetch=STREAM_PREFETCH, pass_stats=stats)
    px, rv = smooth_lib.make_prox(port.SquaredL2Updater(), REG)
    cfg = port.AGDConfig(convergence_tol=TOL, num_iterations=STREAM_ITERS)
    w0 = torch.zeros(d, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fk.reset_launch_counts()
    carries = {} if keep is None else keep

    def on_iteration(carry):
        if carry["prior_iters"] == SUP_STREAM_ITERS:
            carries["carry"] = carry

    res, fit_s = timed(lambda: port.run_agd_host(
        sm, px, rv, w0, cfg, smooth_loss=sl, on_iteration=on_iteration))
    launches_fit = fk.launch_count
    evaluations_fit = fused.evaluations  # batch calls: one a batch a pass
    modes = margin_modes(fk)
    other = fk.lanes_launch_count + fk.softmax_launch_count
    record_margin_path(fk, launches, "stream_path")
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    fit_stats = list(stats)

    # the first evaluation (at w0) and one at phase 5's weights against
    # f64 sums over the same stream
    sm64, _ = streaming.make_streaming_smooth(_F64Sums(fk), ds,
                                              prefetch=STREAM_PREFETCH)
    errs = {}
    for name, w in (("first_evaluation", w0), ("at_phase5_weights",
                                               w_solo)):
        f, g = sm(w)
        f64, g64 = sm64(w)
        errs[name] = hold(f, g, f64, g64, f"stream_path {name} vs f64 sums")

    hist, ref = res.loss_history, solo[1]
    n_common = min(len(hist), len(ref))
    pass_bytes = Xh.numel() * Xh.element_size() + n * 4
    report = pass_report(fit_stats)
    checks = {
        "one_launch_a_batch_a_pass":
            launches_fit == batches * len(fit_stats) == evaluations_fit > 0,
        "every_launch_stream": modes == {"stream": launches_fit}
        and plan.mode == "stream",
        "no_other_kernel": other == 0,
        "every_pass_every_row": all(s["rows"] == n and s["batches"]
                                    == batches for s in fit_stats),
        "history_rtol_1e-4_vs_phase5": bool(np.allclose(
            hist[:n_common], ref[:n_common], rtol=1e-4, atol=0.0)),
        "iterations": res.num_iters == STREAM_ITERS,
        "finite": bool(np.isfinite(hist).all()
                       and torch.isfinite(res.weights).all()),
        "peak_under_prefetch_plus_2_batches_plus_1GB":
            peak_gb * 1e9 < (STREAM_PREFETCH + 2) * batch_bytes + 1e9,
        "direct_copies_only": all(
            s["h2d_bytes"] == pass_bytes and s["staged_copies"] == 0
            for s in fit_stats)}
    out = {"shape": [n, d], "batch_rows": STREAM_ROWS,
           "last_batch_rows": n - (batches - 1) * STREAM_ROWS,
           "batches": batches, "prefetch": STREAM_PREFETCH,
           "mem_available_gb": host["mem_available_gb"],
           "pin_s": host["pin_s"], "d2h_s": host["d2h_s"],
           "fit_s": fit_s, "num_iters": res.num_iters,
           "num_backtracks": res.num_backtracks,
           "batch_evaluations": evaluations_fit, "launches": launches_fit,
           "modes": modes, "plan": list(plan[:5]),
           "loss_history": hist.tolist(),
           "phase5_loss_history": ref[:n_common].tolist(),
           "max_hist_rel_diff_vs_phase5": float(np.max(
               np.abs(hist[:n_common] - ref[:n_common])
               / np.abs(ref[:n_common]))),
           "vs_f64": {k: {"loss_rel_err": v[0], "grad_max_abs_err": v[1]}
                      for k, v in errs.items()},
           **report,
           "pass_bytes": pass_bytes,
           "one_copy_gb_per_s": one_copy,
           "pass_copy_gb_per_s": pass_copy,
           "pass_copy_s_best": pass_bytes / (max(pass_copy) * 1e9),
           "pass_s_over_pass_copy_s_best": report["pass_s_mean"]
           / (pass_bytes / (max(pass_copy) * 1e9)),
           "kernel_device_ms_per_batch": kernel_device_ms,
           "kernel_share_of_pass": batches * sum(kernel_device_ms.values())
           / 1e3 / report["pass_s_mean"] if kernel_device_ms else None,
           "peak_gb": peak_gb,
           "peak_limit_gb": ((STREAM_PREFETCH + 2) * batch_bytes + 1e9)
           / 1e9,
           "dataset_gb": pass_bytes / 1e9}
    finish("stream_path", out, checks, t_phase, smi)
    carries.update(loss_history=hist, pass_s_mean=report["pass_s_mean"])
    return {"kernel_device_ms_per_batch": kernel_device_ms,
            "pass_s_mean": report["pass_s_mean"]}


def stream_sweep(port, fk, streaming, smi, host, sweep_ref, lbfgs_ref,
                 launches):
    """Phase 33, on phase 32's stream: ``streaming_sweep`` over
    SWEEP_REGS through ``FusedLogisticGradient`` capped at STREAM_ITERS,
    every launch in the lanes kernel's ``lanes_mma`` mode at K = 8, one a
    batch a pass, each lane held to phase 22's in-memory sweep over
    common iterations (rtol 1e-4); then ``streaming_lbfgs_sweep`` over
    the same strengths, each lane held to phase 27's ``LBFGS.sweep``
    over common iterations."""
    t_phase = time.perf_counter()
    Xh, yh = host["X"], host["y"]
    n, d = Xh.shape
    k = len(SWEEP_REGS)
    batches = -(-n // STREAM_ROWS)
    ds = streaming.StreamingDataset.from_arrays(Xh, yh, STREAM_ROWS)
    w0 = torch.zeros(d, dtype=torch.float32, device="cuda")
    stats = []
    fused = counting_lanes(port.FusedLogisticGradient)()
    fk.reset_launch_counts()
    res, sweep_s = timed(lambda: port.streaming_sweep(
        ds, fused, port.SquaredL2Updater(), SWEEP_REGS,
        num_iterations=STREAM_ITERS, convergence_tol=TOL,
        initial_weights=w0, pass_stats=stats))
    lanes_launches = fk.lanes_launch_count
    modes = {m: c for m, c in fk.lanes_mode_launches.items() if c}
    other = fk.launch_count + fk.softmax_launch_count
    launches["stream_sweep"] = lanes_launches
    launches.setdefault("lanes_modes", {})["stream_sweep"] = modes
    checks = {"one_lanes_launch_a_batch_a_pass":
              lanes_launches == batches * len(stats) == fused.rounds > 0,
              "every_launch_lanes_mma": modes == {"lanes_mma":
                                                  lanes_launches},
              "no_other_kernel": other == 0}
    diffs = []
    for i in range(k):
        hist = res.loss_history[:int(res.num_iters[i]), i]
        ref = _Lane(sweep_ref, i).hist
        m = min(len(hist), len(ref))
        checks[f"lane_{i}_history_rtol_1e-4_vs_phase22"] = bool(
            np.allclose(hist[:m], ref[:m], rtol=1e-4, atol=0.0))
        diffs.append(float(np.max(np.abs(hist[:m] - ref[:m])
                                  / np.abs(ref[:m]))))
    checks["finite"] = bool(torch.isfinite(res.weights).all()
                            and not res.aborted_non_finite.any())
    out = {"shape": [n, d], "regs": SWEEP_REGS, "batch_rows": STREAM_ROWS,
           "iterations": STREAM_ITERS, "sweep_s": sweep_s, "rounds": fused.rounds,
           "launches": lanes_launches, "modes": modes,
           "num_iters": res.num_iters.tolist(),
           "max_hist_rel_diff_vs_phase22_by_lane": diffs,
           **pass_report(stats)}

    lstats = []
    fused_l = counting_lanes(port.FusedLogisticGradient)()
    fk.reset_launch_counts()
    lres, lbfgs_s = timed(lambda: port.streaming_lbfgs_sweep(
        ds, fused_l, port.SquaredL2Updater(), SWEEP_REGS,
        num_iterations=STREAM_ITERS, initial_weights=w0,
        pass_stats=lstats))
    l_launches = fk.lanes_launch_count
    l_modes = {m: c for m, c in fk.lanes_mode_launches.items() if c}
    l_other = fk.launch_count + fk.softmax_launch_count
    launches["stream_lbfgs_sweep"] = l_launches
    launches["lanes_modes"]["stream_lbfgs_sweep"] = l_modes
    checks.update({
        "lbfgs_one_lanes_launch_a_batch_a_round":
            l_launches == batches * lres.eval_rounds == batches
            * len(lstats) > 0,
        "lbfgs_every_launch_lanes_mma": l_modes == {"lanes_mma":
                                                    l_launches},
        "lbfgs_no_other_kernel": l_other == 0})
    l_diffs, l_evals = [], []
    for i in range(k):
        hist = lres.loss_history[i, :int(lres.num_iters[i]) + 1]
        ref = _LbfgsLane(lbfgs_ref, i)
        ref_hist = ref.loss_history[:int(ref.num_iters) + 1].double().numpy()
        m = min(len(hist), len(ref_hist))
        checks[f"lbfgs_lane_{i}_history_rtol_1e-4_vs_phase27"] = bool(
            np.allclose(hist[:m], ref_hist[:m], rtol=1e-4, atol=0.0))
        l_diffs.append(float(np.max(np.abs(hist[:m] - ref_hist[:m])
                                    / np.abs(ref_hist[:m]))))
        l_evals.append([int(lres.num_fn_evals[i]), 1 + int(
            ref.diag_evals[:int(lres.num_iters[i])].sum())])
    checks["lbfgs_finite"] = bool(torch.isfinite(lres.weights).all()
                                  and not lres.aborted_non_finite.any())
    out.update({"lbfgs_s": lbfgs_s, "lbfgs_eval_rounds": lres.eval_rounds,
                "lbfgs_launches": l_launches, "lbfgs_modes": l_modes,
                "lbfgs_num_iters": lres.num_iters.tolist(),
                "lbfgs_max_hist_rel_diff_vs_phase27_by_lane": l_diffs,
                "lbfgs_evaluations_vs_phase27_same_iterations": l_evals,
                **pass_report(lstats, "lbfgs_")})
    finish("stream_sweep", out, checks, t_phase, smi)


def split_libsvm(path, parts, out_dir):
    """``path`` cut at line ends into ``parts`` files of about equal
    size; returns their paths."""
    with open(path, "rb") as f:
        data = f.read()
    cuts = [0]
    for i in range(1, parts):
        at = data.find(b"\n", len(data) * i // parts)
        cuts.append(len(data) if at < 0 else at + 1)
    cuts.append(len(data))
    paths = []
    for i in range(parts):
        p = os.path.join(out_dir, f"part-{i:05d}")
        with open(p, "wb") as f:
            f.write(data[cuts[i]:cuts[i + 1]])
        paths.append(p)
    return paths


def stream_libsvm(port, streaming, smi, path, data, Xf, cfg, launches):
    """Phase 34, inside phase 11 on its file: phase 10's rcv1-like data
    cut into STREAM_PARTS LIBSVM part files, streamed through
    ``from_libsvm_parts`` (STREAM_PART_BATCH_ROWS a batch, STREAM_PREFETCH
    ahead) for a STREAM_LIBSVM_ITERS-iteration logistic AGD fit through
    ``run_agd_host``, held to the same fit of the parsed arrays in memory
    (``run``) over common iterations (rtol 1e-4); the parse MB/s of one
    part, the passes' MB/s and stall share.  CSR runs the sparse
    products: no kernel launches."""
    from spark_agd_tpu_torch.core import smooth as smooth_lib
    from spark_agd_tpu_torch.ops import fused_kernels as fk

    t_phase = time.perf_counter()
    d = cfg["d"]
    t0 = time.perf_counter()
    paths = split_libsvm(path, STREAM_PARTS, os.path.dirname(path))
    split_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    port.load_libsvm(paths[0], n_features=d)
    parse_s = time.perf_counter() - t0
    part_mb = os.path.getsize(paths[0]) / 1e6
    file_mb = sum(os.path.getsize(p) for p in paths) / 1e6
    stats = []
    ds = streaming.StreamingDataset.from_libsvm_parts(
        paths, n_features=d, batch_rows=STREAM_PART_BATCH_ROWS)
    sm, sl = streaming.make_streaming_smooth(
        port.LogisticGradient(), ds, prefetch=STREAM_PREFETCH,
        pass_stats=stats)
    px, rv = smooth_lib.make_prox(port.L2Prox(), cfg["reg"])
    agd_cfg = port.AGDConfig(convergence_tol=TOL,
                             num_iterations=STREAM_LIBSVM_ITERS)
    w0 = torch.zeros(d, dtype=torch.float32, device="cuda")
    fk.reset_launch_counts()
    res, fit_s = timed(lambda: port.run_agd_host(sm, px, rv, w0, agd_cfg,
                                                 smooth_loss=sl))
    launched = fk.launch_count + fk.lanes_launch_count \
        + fk.softmax_launch_count
    launches["stream_libsvm"] = launched
    launches.setdefault("modes", {})["stream_libsvm"] = {}
    labels = torch.from_numpy(data.binarized_labels().astype(np.float32))
    _, ref, ref_res = port.run(
        (Xf, labels), port.LogisticGradient(), port.L2Prox(),
        reg_param=cfg["reg"], num_iterations=STREAM_LIBSVM_ITERS,
        convergence_tol=TOL, initial_weights=w0, return_result=True)
    hist = res.loss_history
    m = min(len(hist), len(ref))
    rows = len(data.labels)
    checks = {"no_kernel_launch": launched == 0,
              "every_pass_every_row": all(s["rows"] == rows
                                          for s in stats),
              "history_rtol_1e-4_vs_in_memory": bool(np.allclose(
                  hist[:m], ref[:m], rtol=1e-4, atol=0.0)),
              "iterations": res.num_iters == int(ref_res.num_iters)
              == STREAM_LIBSVM_ITERS,
              "finite": bool(np.isfinite(hist).all()
                             and torch.isfinite(res.weights).all())}
    report = pass_report(stats)
    out = {"rows": rows, "features": d, "parts": STREAM_PARTS,
           "batch_rows": STREAM_PART_BATCH_ROWS,
           "prefetch": STREAM_PREFETCH, "file_mb": file_mb,
           "split_s": split_s, "parse_mb_per_s_one_part": part_mb / parse_s,
           "pass_mb_per_s": file_mb / report["pass_s_mean"],
           "fit_s": fit_s, "num_iters": res.num_iters,
           "loss_history": hist.tolist(), "in_memory_loss_history":
           [float(v) for v in ref[:m]],
           "max_hist_rel_diff": float(np.max(np.abs(hist[:m] - ref[:m])
                                             / np.abs(ref[:m]))),
           **report}
    finish("stream_libsvm", out, checks, t_phase, smi)


# ---------------------------------------------------------------------------
# Phases 35-38: single-device resilience
# ---------------------------------------------------------------------------

# phase 35: the supervised flagship fit in segments of SUP_SEGMENT
# iterations, checkpointed every SUP_SEGMENT with SUP_KEEP generations;
# the scripted faults of (b) and (c)
SUP_SEGMENT, SUP_KEEP = 5, 2
SUP_FAULTS = dict(device_loss_at_iter=10, nan_at_iter=20)
SUP_SIGTERM_AT = 15
# phase 36: the AGD path stopped after SUP_PATH_STOP iterations and
# resumed, in segments of SUP_PATH_SEGMENT; L-BFGS split 2 + 3
SUP_PATH_STOP, SUP_PATH_SEGMENT = 20, 10
SUP_LBFGS_SPLIT = (2, 5)
# phase 37: a streamed fit of SUP_STREAM_ITERS iterations, a segment an
# iteration, a cursor committed every SUP_STREAM_COMMIT batches
SUP_STREAM_ITERS, SUP_STREAM_COMMIT = 3, 4
# phase 38: seeded campaigns that together carry every in-run and file
# kind the campaign draw makes (nan, device_loss, sigterm, fatal,
# truncate_ckpt and scramble_ckpt), in segments of CHAOS_SEGMENT
CHAOS_SEEDS, CHAOS_SEGMENT = (0, 1, 5, 7, 13), 4


def sup_policy(port, **kw):
    """The supervised phases' policy: no backoff sleeps, no jitter."""
    return port.ResiliencePolicy(backoff_base=0.0, jitter=0.0, seed=0,
                                 **kw)


def save_costs(ck, wall_s):
    """An ``AutoCheckpointer``'s host copies and file writes: ms each and
    their share of the fit's wall seconds."""
    copy, write = ck.copy_seconds, ck.write_seconds
    return {"updates": len(copy), "saves": len(write),
            "d2h_ms_per_update": [t * 1e3 for t in copy],
            "write_ms_per_save": [t * 1e3 for t in write],
            "save_share_of_wall": (sum(copy) + sum(write)) / wall_s}


def chain_iters(ckpt, path, keep, template):
    """``prior_iters`` of each generation of the chain at ``path``
    (newest first; None for a missing or corrupt file)."""
    from spark_agd_tpu_torch.resilience import generation_paths

    out = []
    for g in generation_paths(path, keep):
        try:
            loaded = ckpt.load_checkpoint(g, template,
                                          fallback_to_bak=False)
        except ckpt.CheckpointCorruptError:
            loaded = None
        out.append(None if loaded is None else int(loaded.warm.prior_iters))
    return out


def supervised_fit(port, fk, smi, X, y, solo, launches):
    """Phase 35, on phase 5's data: the flagship fit under the supervisor
    (ResiliencePolicy(segment_iters=SUP_SEGMENT), an AutoCheckpointer
    every SUP_SEGMENT iterations, SUP_KEEP generations): (a) the clean
    supervised ``run`` gives phase 5's bits, in at most 1.1x phase 5's
    wall time (the limit of PERF.md section 2); (b) a scripted device loss
    and NaN: one retry, one rollback, the ledger as scripted, the fit
    ends at phase 5's loss floor; (c) a scripted SIGTERM raises
    ``Preempted``, the newest generation is truncated, and the rerun
    resumes from what survives to (a)'s bits.  Every launch the margin
    kernel's stream mode; the checkpointer's host copies and writes
    timed."""
    from spark_agd_tpu_torch import resilience
    from spark_agd_tpu_torch.core import smooth as smooth_lib
    from spark_agd_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    w0 = torch.zeros(D_MAIN, dtype=torch.float32, device="cuda")
    policy = sup_policy(port, segment_iters=SUP_SEGMENT)
    fused = counting(port.FusedLogisticGradient)()
    kw = dict(reg_param=REG, num_iterations=ITERS, convergence_tol=TOL,
              initial_weights=w0, return_result=True)
    res5, hist5, run5_s = solo
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        fk.reset_launch_counts()
        ck_a = resilience.AutoCheckpointer(
            os.path.join(tmp, "a.npz"), every_iters=SUP_SEGMENT,
            keep=SUP_KEEP)
        (w_a, hist_a, sres_a), run_a_s = timed(lambda: port.run(
            (X, y), fused, port.SquaredL2Updater(), resilience=policy,
            checkpointer=ck_a, **kw))
        launches_a = fk.launch_count

        staged = smooth_lib.make_smooth_staged(fused, X, y)
        px, rv = smooth_lib.make_prox(port.SquaredL2Updater(), REG)
        cfg = port.AGDConfig(convergence_tol=TOL, num_iterations=ITERS)

        def supervise(path, faults=None):
            return resilience.run_agd_supervised(
                prox=px, reg_value=rv, w0=w0, config=cfg, policy=policy,
                staged=staged, faults=faults,
                checkpointer=resilience.AutoCheckpointer(
                    path, every_iters=SUP_SEGMENT, keep=SUP_KEEP))

        script = resilience.FaultScript(**SUP_FAULTS)
        sres_b, run_b_s = timed(lambda: supervise(
            os.path.join(tmp, "b.npz"), script))

        path_c = os.path.join(tmp, "c.npz")
        t0 = time.perf_counter()
        preempted = False
        try:
            supervise(path_c, resilience.FaultScript(
                sigterm_at_iter=SUP_SIGTERM_AT))
        except resilience.Preempted:
            preempted = True
        killed_s = time.perf_counter() - t0
        chain_before = chain_iters(ckpt, path_c, SUP_KEEP, w0)
        torn_bytes = resilience.faults.truncate_file(path_c, 0.4)
        chain_torn = chain_iters(ckpt, path_c, SUP_KEEP, w0)
        ck_c = resilience.AutoCheckpointer(path_c, every_iters=SUP_SEGMENT,
                                           keep=SUP_KEEP)
        (w_c, hist_c, sres_c), resume_c_s = timed(lambda: port.run(
            (X, y), fused, port.SquaredL2Updater(), resilience=policy,
            checkpointer=ck_c, **kw))
        record_margin_path(fk, launches, "supervised_fit")
        other = fk.lanes_launch_count + fk.softmax_launch_count
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    ledger_b = [(e["outcome"], e["failure_kind"], e["start_iter"])
                for e in sres_b.attempts]
    want_b = [("ok", None, 0), ("ok", None, 5),
              ("failed", "transient", 10), ("ok", None, 10),
              ("ok", None, 15), ("aborted_non_finite", "numeric", 20),
              ("ok", None, 20)]
    modes = launches["modes"]["supervised_fit"]
    checks = {
        "a_weights_bit_identical_to_phase5":
            bool(torch.equal(w_a, res5.weights)),
        "a_history_bit_identical_to_phase5":
            bool(np.array_equal(hist_a, hist5)),
        "a_segments_all_ok": [e["outcome"] for e in sres_a.attempts]
        == ["ok"] * -(-len(hist5) // SUP_SEGMENT),
        "a_within_1.1x_phase5_wall": run_a_s <= 1.1 * run5_s,
        "b_one_retry_one_rollback": (sres_b.retries, sres_b.rollbacks)
        == (1, 1),
        "b_fired_as_scripted": script.fired == [
            ("device_loss", SUP_FAULTS["device_loss_at_iter"]),
            ("nan", SUP_FAULTS["nan_at_iter"])],
        "b_ledger_as_scripted": ledger_b[:len(want_b)] == want_b
        and all(e[0] == "ok" for e in ledger_b[len(want_b):]),
        "b_finishes": bool(sres_b.converged
                           or sres_b.num_iters == ITERS),
        "b_final_loss_rtol_1e-4_vs_phase5": bool(np.isclose(
            sres_b.loss_history[-1], hist5[-1], rtol=1e-4, atol=0.0)),
        "b_finite": bool(np.isfinite(sres_b.loss_history).all()
                         and torch.isfinite(sres_b.weights).all()),
        "c_preempted": preempted,
        "c_resumes_from_what_survives":
            sres_c.resumed_from == next(i for i in chain_torn
                                        if i is not None) > 0,
        "c_weights_bit_identical_to_a": bool(torch.equal(w_c, w_a)),
        "c_history_bit_identical_to_a": bool(np.array_equal(hist_c,
                                                            hist_a)),
        "launches_equal_evaluations": launches["supervised_fit"]
        == fused.evaluations > 0,
        "every_launch_stream": modes == {"stream":
                                         launches["supervised_fit"]},
        "no_other_kernel": other == 0}
    finish("supervised_fit", {
        "shape": [N_MAIN, D_MAIN], "segment_iters": SUP_SEGMENT,
        "every_iters": SUP_SEGMENT, "keep": SUP_KEEP,
        "phase5_run_s": run5_s, "a_run_s": run_a_s,
        "a_over_phase5_wall": run_a_s / run5_s, "a_launches": launches_a,
        "a_num_iters": len(hist_a), **{f"a_{k}": v for k, v in
                                       save_costs(ck_a, run_a_s).items()},
        "b_run_s": run_b_s, "b_num_iters": sres_b.num_iters,
        "b_retries": sres_b.retries, "b_rollbacks": sres_b.rollbacks,
        "b_ledger": ledger_b, "b_fired": script.fired,
        "b_loss_last": float(sres_b.loss_history[-1]),
        "phase5_loss_last": float(hist5[-1]),
        "c_killed_run_s": killed_s, "c_chain_prior_iters": chain_before,
        "c_truncated_to_bytes": torn_bytes,
        "c_chain_after_truncation": chain_torn,
        "c_resumed_from": sres_c.resumed_from, "c_resume_run_s": resume_c_s,
        "launches": launches["supervised_fit"], "modes": modes,
        "smooth_evaluations": fused.evaluations}, checks, t_phase, smi)


def supervised_path(port, fk, smi, X, y, sweep_ref, lbfgs_ref, launches):
    """Phase 36, on phase 5's data: ``run_agd_multi_checkpointed`` over
    SWEEP_REGS (phase 22's strengths, 40 iterations, tol 0) stopped after
    SUP_PATH_STOP iterations and resumed gives, lane by lane, the bits of
    the same call run straight, every launch the lanes kernel in
    ``lanes_mma``; its largest difference from phase 22's ``sweep``
    (the same lock-step driver); then ``run_lbfgs_checkpointed`` on the
    flagship split 2 + 3 gives the bits of the same call run straight
    for 5, held to phase 13's ``run_lbfgs`` over their common iterations
    at phase 13's tolerance (rtol 1e-4)."""
    from spark_agd_tpu_torch.core import host_agd, lbfgs as lbfgs_lib
    from spark_agd_tpu_torch.core import smooth as smooth_lib
    from spark_agd_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    k = len(SWEEP_REGS)
    fused = counting_lanes(port.FusedLogisticGradient)()
    sm, sl = smooth_lib.lanes_smooth(fused, *fused.prepare(X, y, None))
    px, rv = host_agd.make_prox_multi(port.SquaredL2Updater(), torch.tensor(
        SWEEP_REGS, dtype=torch.float32))
    w0 = torch.zeros((k, D_MAIN), dtype=torch.float32, device="cuda")
    cfg = port.AGDConfig(convergence_tol=TOL, num_iterations=ITERS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        def multi(path, config):
            return ckpt.run_agd_multi_checkpointed(
                sm, px, rv, w0, config, path=os.path.join(tmp, path),
                segment_iters=SUP_PATH_SEGMENT, smooth_loss_multi=sl)

        fk.reset_launch_counts()
        straight, straight_s = timed(lambda: multi("straight.npz", cfg))
        part, part_s = timed(lambda: multi(
            "killed.npz", dataclasses.replace(cfg,
                                              num_iterations=SUP_PATH_STOP)))
        resumed, resumed_s = timed(lambda: multi("killed.npz", cfg))
        lanes_launches, rounds = fk.lanes_launch_count, fused.rounds
        lanes_modes = {m: c for m, c in fk.lanes_mode_launches.items() if c}
        other = fk.launch_count + fk.softmax_launch_count
        launches["supervised_path"] = lanes_launches
        launches.setdefault("lanes_modes", {})["supervised_path"] = \
            lanes_modes

        solo = counting(port.FusedLogisticGradient)()
        obj = lbfgs_lib.make_objective(smooth_lib.make_smooth(solo, X, y),
                                       port.SquaredL2Updater(), REG)
        w1 = torch.zeros(D_MAIN, dtype=torch.float32, device="cuda")
        first, total = SUP_LBFGS_SPLIT
        lcfg = port.LBFGSConfig(num_iterations=total)

        def lbfgs(path, config, segment):
            return ckpt.run_lbfgs_checkpointed(
                obj, w1, config, os.path.join(tmp, path),
                segment_iters=segment)

        fk.reset_launch_counts()
        l_straight, l_straight_s = timed(lambda: lbfgs("l.npz", lcfg,
                                                       total))
        l_part, _ = timed(lambda: lbfgs(
            "lk.npz", dataclasses.replace(lcfg, num_iterations=first),
            first))
        l_resumed, l_resumed_s = timed(lambda: lbfgs("lk.npz", lcfg,
                                                     total - first))
        record_margin_path(fk, launches, "supervised_path_lbfgs")
        l_other = fk.lanes_launch_count + fk.softmax_launch_count
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    sweep = sweep_ref["res"]
    w_diff = float((straight.weights - sweep.weights).abs().max())
    h_diff = 0.0
    for i in range(k):
        n_i = int(straight.num_iters[i])
        a = straight.loss_history[:n_i, i]
        b = sweep.loss_history[i, :n_i].double().numpy()
        h_diff = max(h_diff, float(np.max(np.abs(a - b))) if n_i else 0.0)
    ref = lbfgs_ref["res"]
    m = min(l_resumed.num_iters, int(ref.num_iters)) + 1
    ref_hist = ref.loss_history[:m].double().numpy()
    l_modes = launches["modes"]["supervised_path_lbfgs"]
    checks = {
        "path_resumed_from_the_stop": bool(
            (resumed.resumed_from == SUP_PATH_STOP).all()),
        "path_weights_bit_identical_lane_by_lane": bool(
            torch.equal(resumed.weights, straight.weights)),
        "path_history_bit_identical": bool(np.array_equal(
            resumed.loss_history, straight.loss_history)),
        "path_num_iters_identical": bool(np.array_equal(
            resumed.num_iters, straight.num_iters)),
        "path_one_lanes_launch_a_round": lanes_launches == rounds > 0,
        "path_every_launch_lanes_mma": lanes_modes == {
            "lanes_mma": lanes_launches},
        "path_no_other_kernel": other == 0,
        "lbfgs_resumed_from_the_split": l_resumed.resumed_from == first,
        "lbfgs_weights_bit_identical": bool(torch.equal(
            l_resumed.weights, l_straight.weights)),
        "lbfgs_history_bit_identical": bool(np.array_equal(
            l_resumed.loss_history, l_straight.loss_history)),
        "lbfgs_history_rtol_1e-4_vs_phase13": bool(np.allclose(
            l_resumed.loss_history[:m], ref_hist, rtol=1e-4, atol=0.0)),
        "lbfgs_launches_equal_evaluations":
            launches["supervised_path_lbfgs"] == solo.evaluations > 0,
        "lbfgs_every_launch_stream": l_modes == {
            "stream": launches["supervised_path_lbfgs"]},
        "lbfgs_no_other_kernel": l_other == 0}
    finish("supervised_path", {
        "shape": [N_MAIN, D_MAIN], "regs": SWEEP_REGS, "iterations": ITERS,
        "stop_at": SUP_PATH_STOP, "segment_iters": SUP_PATH_SEGMENT,
        "straight_s": straight_s, "killed_s": part_s,
        "resumed_s": resumed_s, "num_iters": straight.num_iters.tolist(),
        "rounds": rounds, "launches": lanes_launches, "modes": lanes_modes,
        "max_weight_abs_diff_vs_phase22_sweep": w_diff,
        "max_history_abs_diff_vs_phase22_sweep": h_diff,
        "lbfgs_split": list(SUP_LBFGS_SPLIT),
        "lbfgs_straight_s": l_straight_s, "lbfgs_resumed_s": l_resumed_s,
        "lbfgs_num_iters": l_resumed.num_iters,
        "lbfgs_converged": l_resumed.converged,
        "lbfgs_loss_history": l_resumed.loss_history.tolist(),
        "phase13_loss_history": ref_hist.tolist(),
        "lbfgs_launches": launches["supervised_path_lbfgs"],
        "lbfgs_modes": l_modes}, checks, t_phase, smi)


def supervised_stream(port, fk, streaming, smi, host, stream_ref, launches):
    """Phase 37, on phase 32's stream (the pinned source still held): a
    SUP_STREAM_ITERS-iteration ``run_agd_supervised(driver="host")`` over
    the streamed smooth, a segment an iteration, a ``StreamCheckpoint``
    every SUP_STREAM_COMMIT batches; a SIGTERM from a ``threading.Timer``
    about half a pass into iteration 2 raises ``Preempted`` (the
    handler's flush carries the cursor, the abandon flush after it the
    clean boundary).  Two resumes: from the newest generation (iteration
    2 replayed from its start) and from a copy of the cursor's generation
    (its committed batches skipped); each gives the bits of phase 32's
    fit after SUP_STREAM_ITERS iterations.  Every launch the margin
    kernel's stream mode."""
    from spark_agd_tpu_torch import resilience
    from spark_agd_tpu_torch.core import smooth as smooth_lib
    from spark_agd_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    Xh, yh = host["X"], host["y"]
    n, d = Xh.shape
    batches = -(-n // STREAM_ROWS)
    ds = streaming.StreamingDataset.from_arrays(Xh, yh, STREAM_ROWS)
    px, rv = smooth_lib.make_prox(port.SquaredL2Updater(), REG)
    cfg = port.AGDConfig(convergence_tol=TOL, num_iterations=SUP_STREAM_ITERS)
    policy = sup_policy(port, segment_iters=1)
    w0 = torch.zeros(d, dtype=torch.float32, device="cuda")
    fused = counting(port.FusedLogisticGradient)()
    pass_s = stream_ref["pass_s_mean"]
    carry = stream_ref["carry"]

    def fit(path, stats, on_commit=None):
        ck = resilience.AutoCheckpointer(path, every_iters=1, keep=2)
        sc = streaming.StreamCheckpoint(
            ck, every_batches=SUP_STREAM_COMMIT,
            on_commit=None if on_commit is None else
            lambda count: on_commit(ck, count))
        sm, sl = streaming.make_streaming_smooth(
            fused, ds, prefetch=STREAM_PREFETCH, stream_ckpt=sc,
            pass_stats=stats)
        return resilience.run_agd_supervised(
            smooth=sm, smooth_loss=sl, prox=px, reg_value=rv, w0=w0,
            config=cfg, policy=policy, checkpointer=ck, driver="host")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    timers = []

    def arm(ck, count):
        # two updates (generation zero, iteration 1's boundary) and no
        # third: the first commit of iteration 2, about 0.4 of a pass in
        if len(ck.copy_seconds) == 2 and not timers:
            timers.append(threading.Timer(
                0.1 * pass_s, os.kill, (os.getpid(), signal.SIGTERM)))
            timers[0].start()

    try:
        # a signal can land between a launch and its count, so the
        # killed run's launches are added to the path's uncompared
        fk.reset_launch_counts()
        path = os.path.join(tmp, "s.npz")
        killed_stats = []
        t0 = time.perf_counter()
        preempted = False
        try:
            fit(path, killed_stats, arm)
        except resilience.Preempted:
            preempted = True
        finally:
            for t in timers:  # a timer that has not fired never will
                t.cancel()
                t.join()
        killed_s = time.perf_counter() - t0
        killed_launches, killed_modes = fk.launch_count, margin_modes(fk)
        killed_evaluations = fused.evaluations
        bak = resilience.generation_paths(path, 2)[1]
        landed = ckpt.load_checkpoint(bak, w0, fallback_to_bak=False)
        cursor = streaming.cursor_from_extras(landed.extras)
        newest = ckpt.load_checkpoint(path, w0, fallback_to_bak=False)
        cursor_path = os.path.join(tmp, "cursor.npz")
        shutil.copyfile(bak, cursor_path)

        boundary_stats, cursor_stats = [], []
        fk.reset_launch_counts()
        res_b, resume_b_s = timed(lambda: fit(path, boundary_stats))
        res_c, resume_c_s = timed(lambda: fit(cursor_path, cursor_stats))
        record_margin_path(fk, launches, "supervised_stream")
        other = fk.lanes_launch_count + fk.softmax_launch_count
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    ref_hist = stream_ref["loss_history"][:SUP_STREAM_ITERS]
    modes = launches["modes"]["supervised_stream"]
    skipped = sum(s.get("skipped_batches", 0) for s in cursor_stats)
    checks = {
        "preempted": preempted,
        "landed_in_iteration_2": landed.warm.prior_iters == 1
        and newest.warm.prior_iters == 1,
        "cursor_rode_the_flush": cursor is not None,
        "abandon_flush_is_a_clean_boundary": newest.extras == {},
        "boundary_resume_from_iteration_1": res_b.resumed_from == 1,
        "cursor_resume_from_iteration_1": res_c.resumed_from == 1,
        "cursor_resume_skipped_the_committed_batches":
            cursor is not None and skipped == cursor.batch_index > 0,
        "boundary_resume_bits_equal_phase32": bool(
            torch.equal(res_b.weights, carry["x"])),
        "cursor_resume_bits_equal_phase32": bool(
            torch.equal(res_c.weights, carry["x"])),
        "boundary_history_equals_phase32": bool(np.array_equal(
            res_b.loss_history, ref_hist)),
        "cursor_history_equals_phase32": bool(np.array_equal(
            res_c.loss_history, ref_hist)),
        "resume_launches_equal_batch_evaluations":
            launches["supervised_stream"]
            == fused.evaluations - killed_evaluations > 0,
        "every_launch_stream": set(modes) | set(killed_modes)
        == {"stream"},
        "no_other_kernel": other == 0}
    launches["supervised_stream"] += killed_launches
    modes = launches["modes"]["supervised_stream"] = {
        "stream": launches["supervised_stream"]}
    replayed = (None if cursor is None
                else cursor.pass_offset * batches + cursor.batch_index)
    finish("supervised_stream", {
        "shape": [n, d], "batch_rows": STREAM_ROWS, "batches": batches,
        "iterations": SUP_STREAM_ITERS,
        "commit_every_batches": SUP_STREAM_COMMIT,
        "timer_s_after_first_commit_of_iteration_2": 0.1 * pass_s,
        "killed_run_s": killed_s, "killed_passes": len(killed_stats),
        "killed_launches": killed_launches,
        "landed_pass_since_boundary": None if cursor is None
        else cursor.pass_offset,
        "landed_after_committed_batch": None if cursor is None
        else cursor.batch_index,
        "boundary_resume_replayed_at_least_batches": replayed,
        "boundary_resume_s": resume_b_s,
        "boundary_resume_passes": len(boundary_stats),
        "cursor_resume_s": resume_c_s,
        "cursor_resume_passes": len(cursor_stats),
        "cursor_resume_skipped_batches": skipped,
        "loss_history": res_b.loss_history.tolist(),
        "phase32_loss_history": list(map(float, ref_hist)),
        "launches": launches["supervised_stream"], "modes": modes},
        checks, t_phase, smi)


def chaos_soak(port, fk, smi, X, y, solo, launches):
    """Phase 38, on phase 28's data (epsilon's shape, 400,000 x 2,000
    f32): the CHAOS_SEEDS campaigns (``ChaosCampaign.generate(seed,
    iters=40)``) through ``run_campaign`` over the flagship's settings, in
    segments of CHAOS_SEGMENT, every launch the margin kernel's stream
    mode; every outcome ``converged`` (within run_campaign's 1e-6 of the
    clean supervised run's final loss, which has phase 28's bits, and
    the clean run's bits exactly where no NaN rolled a segment back) or
    ``gave_up`` (typed, where a ``fatal`` fault fired), never
    ``mismatch`` or ``stalled``."""
    from spark_agd_tpu_torch import resilience
    from spark_agd_tpu_torch.core import smooth as smooth_lib

    t_phase = time.perf_counter()
    n, d = X.shape
    w0 = torch.zeros(d, dtype=torch.float32, device="cuda")
    fused = counting(port.FusedLogisticGradient)()
    staged = smooth_lib.make_smooth_staged(fused, X, y)
    px, rv = smooth_lib.make_prox(port.SquaredL2Updater(), REG)
    cfg = port.AGDConfig(convergence_tol=TOL, num_iterations=ITERS)
    policy = sup_policy(port, segment_iters=CHAOS_SEGMENT)
    seg_cache = {}
    fk.reset_launch_counts()
    clean, clean_s = timed(lambda: resilience.run_agd_supervised(
        prox=px, reg_value=rv, w0=w0, config=cfg, policy=policy,
        staged=staged, seg_cache=seg_cache))
    baseline = float(clean.loss_history[-1])
    rows, kinds = [], set()
    for seed in CHAOS_SEEDS:
        campaign = resilience.ChaosCampaign.generate(seed, iters=ITERS)
        kinds |= {f.kind for f in campaign.faults}
        workdir = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
        try:
            out, seconds = timed(lambda: resilience.run_campaign(
                campaign, staged=staged, prox=px, reg_value=rv, w0=w0,
                config=cfg, policy=policy, workdir=workdir,
                baseline_loss=baseline, seg_cache=seg_cache))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        rows.append({"seed": seed, "campaign": campaign.describe(),
                     "outcome": out.outcome, "diff": out.diff,
                     "relaunches": out.relaunches, "fired": out.fired,
                     "file_applied": out.file_applied,
                     "num_iters": out.num_iters,
                     "expects_giveup": campaign.expects_giveup,
                     "rolled_back": any(f == "nan" for f, _ in out.fired),
                     "weights_equal_clean": out.weights is not None
                     and bool(torch.equal(out.weights, clean.weights)),
                     "giveup": out.giveup_message, "seconds": seconds})
    record_margin_path(fk, launches, "chaos_soak")
    other = fk.lanes_launch_count + fk.softmax_launch_count
    modes = launches["modes"]["chaos_soak"]
    checks = {
        "clean_run_bits_equal_phase28": bool(torch.equal(
            clean.weights, solo[0].weights)),
        "every_kind_drawn": kinds >= {"nan", "device_loss", "sigterm",
                                      "fatal", "truncate_ckpt",
                                      "scramble_ckpt"},
        "no_mismatch_or_stalled": all(
            r["outcome"] in ("converged", "gave_up") for r in rows),
        # a fit that stops (an exact-zero step at the f32 floor) before
        # its fatal iteration never meets the fault
        "gave_up_exactly_where_a_fatal_fired": all(
            (r["outcome"] == "gave_up")
            == any(kind == "fatal" for kind, _ in r["fired"])
            for r in rows),
        "clean_bits_where_nothing_rolled_back": all(
            r["diff"] == 0.0 and r["weights_equal_clean"] for r in rows
            if r["outcome"] == "converged" and not r["rolled_back"]),
        "every_launch_stream": modes == {"stream": launches["chaos_soak"]},
        "launches_equal_evaluations": launches["chaos_soak"]
        == fused.evaluations > 0,
        "no_other_kernel": other == 0}
    finish("chaos_soak", {
        "shape": [n, d], "iterations": ITERS,
        "segment_iters": CHAOS_SEGMENT, "clean_run_s": clean_s,
        "phase28_run_s": solo[2], "baseline_loss": baseline,
        "campaigns": rows, "launches": launches["chaos_soak"],
        "modes": modes}, checks, t_phase, smi)


def main(argv):
    parser = argparse.ArgumentParser(
        description="Drive the PyTorch port on one CUDA card.")
    parser.add_argument("--ab", nargs="+",
                        metavar="[margin:|lanes:|mma:]NAME=SOURCE",
                        help="time these builds of the softmax kernel "
                             "(or, each prefixed margin:, lanes: or mma:, "
                             "of the margin or lanes kernel or of the "
                             "mma.sync rate probe) instead of running the "
                             "phases")
    parser.add_argument("--seeds", default="3",
                        help="data seeds of --ab, comma-separated")
    parser.add_argument("--shapes",
                        help="the shape groups of --ab lanes: (sweep, "
                             "edges, handover, two_pass) or --ab margin: "
                             "(sweep, grid), comma-separated; all by "
                             "default")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import spark_agd_tpu_torch as port
    from spark_agd_tpu_torch import native
    from spark_agd_tpu_torch.data import device_synth, streaming
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
        kinds = {s.split(":", 1)[0] if s.split("=", 1)[0].count(":") else ""
                 for s in args.ab}
        if len(kinds) != 1 or not kinds <= {"", "margin", "lanes", "mma"}:
            parser.error("--ab takes softmax builds, margin: builds, "
                         "lanes: builds or mma: probes, one kind at a time")
        kind = kinds.pop()
        specs = [s[len(kind) + 1:] if kind else s for s in args.ab]
        if kind == "mma":
            mma_ab(specs)
        elif kind in ("margin", "lanes"):
            known = MARGIN_AB_GROUPS if kind == "margin" else LANES_AB_GROUPS
            groups = args.shapes.split(",") if args.shapes else list(known)
            if not set(groups) <= set(known):
                parser.error(f"--shapes of {kind}: takes {', '.join(known)}")
            if kind == "margin":
                margin_ab(port, fk, device_synth, specs, groups)
            else:
                lanes_ab(fk, specs, groups)
        else:
            softmax_ab(port, fk, device_synth, specs,
                       [int(s) for s in args.seeds.split(",")])
        return 0

    # 2-4. build, and each kernel against its plain version
    registers = phase_build(fk)
    phase_kernel(fk, losses)
    phase_softmax_kernel(fk)
    # 21. the lanes kernel at its bucket and mode edges
    phase_lanes_kernel(fk, losses)

    # 5-8, 13-14 and 22-24. the two dense paths at full width, one after
    # the other, each followed by L-BFGS and the lanes on the same data
    launches = {}  # each path's kernel launches, for the kernels line
    lanes = {}
    # phases 22 and 27's results and phase 5's data in pinned host memory
    # with its fit, for the streamed phases 32-33
    sweep_ref, lbfgs_ref, flagship = {}, {}, {}
    lbfgs13, stream_ref = {}, {}  # phases 13 and 32 for phases 36-37

    def on_flagship(X, y, solo):
        lbfgs_path(port, fk, smi, X, y, launches, keep=lbfgs13)
        lanes.update(sweep_path(port, fk, losses, smi, X, y, solo,
                                launches, keep=sweep_ref))
        torch.cuda.empty_cache()
        lbfgs_sweep_path(port, fk, smi, X, y, launches, keep=lbfgs_ref)
        torch.cuda.empty_cache()
        # 35-36. the supervised fit, the checkpointed path and L-BFGS
        supervised_fit(port, fk, smi, X, y, solo, launches)
        supervised_path(port, fk, smi, X, y, sweep_ref, lbfgs13, launches)
        torch.cuda.empty_cache()
        cv_path(port, fk, glm, smi, X, y, launches)
        torch.cuda.empty_cache()
        flagship.update(host=pinned_copy(streaming, X, y), solo=solo)

    def on_softmax(Xa, y):
        softmax_lbfgs_path(port, fk, glm, smi, Xa, y, launches)
        softmax_sweep(port, fk, glm, smi, Xa, y, launches)

    margin = margin_path(port, fk, losses, device_synth, on_flagship)
    torch.cuda.empty_cache()
    # 32-33 and 37. the same data streamed from pinned host memory, the
    # card's copy freed: the fit, the AGD and L-BFGS paths, the
    # supervised streamed fit preempted mid-pass and resumed
    stream = stream_path(port, fk, streaming, smi, flagship["host"],
                         flagship["solo"], launches, keep=stream_ref)
    stream_sweep(port, fk, streaming, smi, flagship["host"],
                 sweep_ref.pop("res"), lbfgs_ref.pop("res"), launches)
    supervised_stream(port, fk, streaming, smi, flagship["host"],
                      stream_ref, launches)
    stream_ref.clear()
    for t in (flagship["host"]["X"], flagship["host"]["y"]):
        streaming.unpin_host(t)
    flagship.clear()
    torch.cuda.empty_cache()
    softmax = softmax_path(port, fk, device_synth, on_softmax)
    torch.cuda.empty_cache()

    # 9-12. the sparse data plane: the products, BASELINE configs 1 and 3
    t0 = time.perf_counter()
    phase_sparse_ops(port, fk, sparse, device_synth, glm)
    torch.cuda.empty_cache()
    rcv1 = sparse_path(port, fk, sparse, device_synth, glm, "rcv1_path",
                       RCV1, glm.LogisticRegressionWithAGD,
                       port.LogisticGradient, port.L2Prox)
    # 34 (inside 11). the file cut into part files and streamed
    phase_libsvm(port, sparse, native, rcv1, lambda path, data, Xf:
                 stream_libsvm(port, streaming, smi, path, data, Xf,
                               rcv1["cfg"], launches))
    rcv1_lbfgs(port, fk, sparse, glm, smi, rcv1)
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

    # 16-18 and 25. the GD gate, the mid widths, BASELINE configs 2 and 5
    narrow = gd_gate(port, fk, smi, launches)
    torch.cuda.empty_cache()
    mid = mid_path(port, fk, losses, device_synth, smi, launches)
    torch.cuda.empty_cache()
    # 28-29 and 38. LIBSVM epsilon's shape: the stream mode, the path over
    # 8 strengths in the lanes kernel's cluster mode, the chaos campaigns
    epsilon_sweep = {}

    def on_epsilon(X, y, solo):
        epsilon_sweep.update(sweep_path(
            port, fk, losses, smi, X, y, solo, launches, "epsilon_sweep",
            "lanes_cluster"))
        chaos_soak(port, fk, smi, X, y, solo, launches)

    epsilon = epsilon_path(port, fk, losses, device_synth, smi, launches,
                           on_epsilon)
    torch.cuda.empty_cache()
    linreg_path(port, fk, device_synth, glm, smi, launches)
    torch.cuda.empty_cache()
    mlp_path(port, device_synth, smi, fk)
    torch.cuda.empty_cache()

    # 19. X past one row in shared memory: the cluster mode, the grid
    # mode past its reach and the two-pass mode past the grid mode's; 30.
    # on its data, the path over 8 strengths in the lanes kernel's plan
    # there (its two-pass mode); then the lanes kernel's two-pass mode
    # past each reach
    wide_sweep = {}
    wide, wide_grid, wide_two_pass = wide_path(
        port, fk, losses, device_synth, smi, launches,
        lambda X, y, solo: wide_sweep.update(wide_sweep_path(
            port, fk, losses, smi, X, y, solo, launches)))
    torch.cuda.empty_cache()
    lanes_two_pass = lanes_two_pass_times(fk, losses)
    # 31. a genotype matrix's width, past the cluster mode: the grid mode
    snp = snp_path(port, fk, losses, device_synth, smi, launches)
    torch.cuda.empty_cache()

    # 26. the softmax kernel's two-pass mode at published shapes
    wide_softmax = softmax_wide(port, fk, device_synth, glm, smi, launches)

    # 20. the kernels line, the card, the result
    paths = ("lbfgs_path", "gd_gate", "mid_path", "epsilon_path",
             "linreg_path", "wide_path", "snp_path", "stream_path",
             "stream_libsvm", "supervised_fit", "supervised_path_lbfgs",
             "supervised_stream", "chaos_soak")
    margin["launches_by_path"] = {"main_path": margin["launches"],
                                  **{p: launches[p] for p in paths}}
    margin["modes_by_path"] = {"main_path": margin.pop("main_path_modes"),
                               **{p: launches["modes"][p] for p in paths}}
    # each mode's numbers at a shape of a path that runs it: the stream
    # mode's at the main path's shape and at epsilon's, the grid mode's at
    # phase 31's (and at phase 19's GRID_TIMES)
    if set(margin["modes_by_path"]["main_path"]) != {"stream"}:
        raise AssertionError("the main path ran the margin kernel in "
                             f"{margin['modes_by_path']['main_path']}, "
                             "not only in the stream mode")
    margin["by_mode"] = {
        "stream": {k: margin[k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "two_matmuls_ms",
            "two_matmuls_device_ms")} | {"shape": [N_MAIN, D_MAIN]},
        "stream_epsilon": epsilon, "narrow": narrow, "warp_rows": mid,
        "cluster": wide, "grid": snp, "grid_past_cluster_reach": wide_grid,
        "two_pass": wide_two_pass, "stream_streamed": stream}
    softmax_paths = ("softmax_lbfgs_path", "softmax_sweep", "softmax_wide")
    softmax["launches_by_path"] = {"softmax_path": softmax["launches"],
                                   **{p: launches[p] for p in softmax_paths}}
    softmax["modes_by_path"] = {
        "softmax_path": softmax.pop("softmax_path_modes"),
        **{p: launches["softmax_modes"][p] for p in softmax_paths}}
    softmax["by_mode"] = {
        "one_read": {k: softmax[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "two_matmuls_ms")}
        | {"shape": [N_SM, D_SM + 1], "classes": K_SM},
        "two_pass": {name: {k: row[k] for k in (
            "shape", "classes", "kernel_ms", "kernel_device_ms_per_call",
            "kernel_device_ms_by_pass", "plain_ms", "bound_ms", "bound_by",
            "x_once_ms", "two_pass_floor_ms", "f32_fma_ms",
            "kernel_bound_frac", "two_matmuls_ms", "two_matmuls_device_ms",
            "grad_max_abs_err_vs_f64")}
            for name, row in wide_softmax.items()}}
    lanes_paths = ("sweep_path", "cv_path", "lbfgs_sweep_path",
                   "epsilon_sweep", "wide_sweep", "stream_sweep",
                   "stream_lbfgs_sweep", "supervised_path")
    lanes["launches_by_path"] = {p: launches[p] for p in lanes_paths}
    lanes["modes_by_path"] = {p: launches["lanes_modes"][p]
                              for p in ("sweep_path", "lbfgs_sweep_path",
                                        "epsilon_sweep", "wide_sweep",
                                        "stream_sweep",
                                        "stream_lbfgs_sweep",
                                        "supervised_path")}
    # each mode's numbers at a shape of a path that runs it: lanes_mma's
    # at the main path's (the entry's own), lanes_cluster's at epsilon's,
    # lanes_two_pass's at phase 30's (and one past each reach)
    lanes["by_mode"] = {
        "lanes_mma": {key: lanes[key] for key in (
            "shape", "plan", "ms", "device_ms", "plain_ms", "bound_ms",
            "two_matmuls_ms", "two_matmuls_device_ms",
            "eight_solo_launches_ms")},
        "lanes_cluster": {key: epsilon_sweep[key] for key in (
            "shape", "plan", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "two_matmuls_ms", "two_matmuls_device_ms",
            "eight_solo_launches_ms", "max_abs_err")},
        "lanes_two_pass": {key: wide_sweep[key] for key in (
            "shape", "plan", "ms", "device_ms", "device_ms_by_kernel",
            "plain_ms", "bound_ms", "bound_by", "two_pass_floor_ms",
            "two_matmuls_ms", "two_matmuls_device_ms",
            "eight_solo_launches_ms", "max_abs_err")},
        "lanes_two_pass_past_reach": lanes_two_pass}
    for entry, lib in ((margin, "margin_loss_grad"),
                       (lanes, "margin_lanes_loss_grad"),
                       (softmax, "softmax_loss_grad")):
        # [registers, spilled bytes, stack frame bytes] of each kernel
        entry["ptxas_by_kernel"] = registers[lib]
    emit({"kernels": [margin, lanes, softmax]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
