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
    (weights and history), STEADY_RUNS (3) times in turns with as many
    plain ``run``s of the same fit, and the median of its wall times is
    within 1.1x the plain runs' median (every sample printed; the
    checkpoints in ``/dev/shm``, as phase 43's generations); (b) ``run_agd_supervised`` under
    ``FaultScript(device_loss_at_iter=10, nan_at_iter=20)``: one retry,
    one rollback, the ledger as scripted, the fit ends at phase 5's loss
    (rtol 1e-4); (c) ``FaultScript(sigterm_at_iter=15)`` raises
    ``Preempted``, the newest generation is truncated, and the rerun
    resumes from the generation that survives to (a)'s bits; the
    checkpointer's device-to-host copy and
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
    fault fired, never ``mismatch`` or ``stalled``;
39. mesh_fit, first on phase 5's data: the same fit through
    ``run(mesh=)`` over meshes of 1, 3 and 4 slots, each the one card (3
    slots pad two rows), each held to phase 5's fit over common
    iterations (rtol 1e-4) and its final gradient to f64 sums; the
    margin kernel launched once a slot an evaluation (``stream``); the
    card's peak within phase 5's plus the padding rows plus 1 GB (the
    shards are views of X); wall time beside phase 5's and the
    combine's share of an evaluation;
40. mesh_softmax, first on phase 7's data (config 4 over 4 slots, a
    softmax launch a slot an evaluation, held to phase 7, no third copy
    of X), and mesh_sparse_rcv1 after phase 10 (config 1 as a
    ``RowShardedCSR`` over 4 slots, nnz-balanced, held to phase 10 over
    the iterations before they part and to f64 sums);
41. mesh_stream, after phase 37 on the pinned stream: 2 slots at 3
    iterations, held to phase 32's history, each batch copied once a
    pass, directly from the pinned source through the card's placer;
    then ``streaming_sweep(mesh=)`` over the same 2 slots (a lanes
    launch a slot a batch, every launch ``lanes_mma``), each lane held to
    phase 33's; then ``parallel.dryrun.dryrun_multichip(4, "cuda")``
    (its eight paths: DP x TP softmax, feature sharding and the mesh
    sweep among them; the mesh sweep's lanes launches a slot a round);
42. multiprocess, inside phase 34 while its part files exist: two
    processes on the card in a gloo group (``--mp-child``), each reading
    its 4 of the 8 parts with ``from_partitioned_files_csr`` onto a
    4-slot mesh across them, 10 iterations: the ranks' histories and
    weights bit-equal and held to the one-process fit on all files; then
    a one-rank NCCL group fitting phase 5's problem on 1M rows over 2
    slots, held to the same fit on one device;
43. dist_ckpt_fit, after phase 36 on phase 5's data: the fit through
    ``run(resilience=, checkpointer=DistributedCheckpointer(every_iters=
    5))`` and through ``run_agd_supervised`` with a ``HeartbeatWriter``,
    a ``HostMonitor`` and a ``StragglerScheduler`` on one process, each
    3 times in turns with as many plain ``run``s of the same fit: each
    run phase 5's bits, each fit's median wall time within 1.1x the
    plain runs' median (every sample printed; the generations in
    ``/dev/shm``), each generation's shard write and commit timed apart; a SIGTERM at 15, the newest committed
    shard truncated: ``load_for_topology`` falls back one generation and
    ``run`` resumes to the same bits (every launch ``stream``);
44. dist_fault_drill, after phase 25: covtype.binary's published size
    (581,012 x 54) made on the card, written as 8 LIBSVM part files; two
    pairs of gloo ranks (``--mp-child ... --drill``), 4 parts a rank
    through ``from_partitioned_files`` onto 2 slots a rank (every launch
    ``warp_rows``), a generation committed every 5 iterations: (a)
    uninterrupted; (b) rank 1 SIGKILLed at 15, the loss read from its
    heartbeat by the parent's ``HostMonitor`` (latency from the last
    beat), the survivor reaped, the newest shard truncated, one process
    resuming elastically on all 8 parts to (a)'s final loss (rtol
    1e-5); (c) a ``DegradedCheckpointer(surviving=[0])`` continuation
    on rank 0's parts, bit-equal to an uninterrupted fit from the same
    iterate;
45. straggler_rebalance, on phase 44's files: two gloo ranks, rank 1 a
    persistent ``slow_host`` scaled by its share of the parts, the fit
    with an observe-only scheduler, with a ``StragglerScheduler`` that
    rebuilds its data (``from_partitioned_files(assignment=,
    pad_to_rows=)``) and with no straggler and the same decisions
    replayed: a rebalance committed in the next generation, the
    rebalanced fit bit-equal to the replay and its loss within rtol 1e-5
    of 44 (a), its wall time below the observe-only fit's, rank 1 read
    SLOW and never LOST;
46. mesh_sweep, on phase 5's data after phase 23: ``sweep(mesh=)`` over
    4 slots of the card through ``FusedLogisticGradient`` (one lanes
    launch a slot a round, all ``lanes_mma``), every lane held to phase
    22's (the same iterations or both at the loss floor, histories at
    the mesh tolerances 1e-5/1e-7), the card's peak within phase 22's +
    1 GB; ``LBFGS.sweep(mesh=)`` held to phase 27; the trainer's
    ``cross_validate`` over the mesh (plain gradient) held to phase 23
    (fold ids, best strength, validation losses rtol 1e-4); wall times
    beside theirs;
47. sharded_update, on phase 5's data after 46: ``run(mesh=,
    sharded_update=True)`` over 4 slots with the plain gradient held to
    the replicated mesh fit, ``FusedLogisticGradient`` refused with a
    ``ValueError``, a generation written in either mode resumed in the
    other; then sharded_update_mp, after phase 45 on its files: two gloo
    ranks with ``sharded_update=True``, bit-equal, held to the
    one-process replicated fit, each rank's census of collectives;
48. tensor_parallel, on phase 7's data after 40: a {data: 2, model: 2}
    mesh in ``dist_mode="auto"``: the plain class-sharded fit held to
    phase 7's plain fit, ``FusedSoftmaxGradient`` (a ``one_read`` launch
    a data slot an evaluation) held to phase 7's fit and to the plain
    mesh fit, its evaluation to f64 sums at W = 0, random W and the fit's,
    ``SoftmaxRegressionWithAGD(mesh=)``; no further copy of Xa;
49. feature_sharded_rcv1, after phase 40 (a): config 1's columns over 4
    model slots (``shard_csr_by_columns``), held to phase 10, its host
    layout's seconds; feature_sharded_epsilon, inside phase 28's
    ``after``: ``shard_batch_by_features`` over 4 model slots, held to
    phase 28's plain fit, its pad weights exactly zero;
50. serve, after phase 18: phase 5's flagship logistic model (D =
    1,000), phase 7's config-4 softmax model (784 features and the
    intercept, K = 10) and phase 18's config-5 MLP (1,024 wide), their
    weights kept on the host, each in a ``ServeEngine`` on the card
    (buckets 8, 16, 32, 64): every op at every bucket and at 1, 7, 9, 63,
    65 and 200 rows (chunked) held to the model's own ``predict`` /
    ``predict_proba`` on the card (f32 rtol 1e-5, atol 1e-7; labels equal
    but where the margin, or the top two probabilities, lie within that
    tolerance of each other), a repeated call bit-identical, the census
    unchanged; a ``MicroBatchQueue`` under 4 client threads of 2,000
    requests each (1-16 rows, both ops): every answer equal to the
    engine's direct answer (the same tolerance), fewer batches than
    requests, a hot swap in the middle of the stream dropping nothing and
    each result naming the generation whose answer it holds; a small
    ``max_queue_rows`` raising typed ``ServeOverloaded``; a
    ``ModelRegistry`` in ``/dev/shm``: three generations, a tampered CRC
    refused and the fallback, ``refresh`` binding the newest, ``gc``
    keeping the newest; p50, p99 and requests per second printed, not
    gated; no kernel launched;
51. pipeline, after phase 50: the continuous-learning drill at the
    flagship width: 4 epochs of 1,048,576 x 1,000 f32 rows made on the
    card from one planted model, each a ``ContinuousTrainer`` epoch
    through ``FusedLogisticGradient`` supervised in segments of 10 with
    an ``AutoCheckpointer`` in ``/dev/shm``, published and canaried on
    live traffic (4 client threads the whole time, slice 0.5, at least
    16 shadow requests, latency slack 5.0) and decided by the
    ``Promoter``; at epoch 3 the published weights are corrupted and
    ``quality_override`` lies to the canary, so the post-promotion check
    rolls HEAD back: at least one ``promoted``, exactly one
    ``rolled_back`` to the generation serving before, no admitted
    request dropped, served answers equal to HEAD's model after each
    decision, ``gate_promotion`` re-run over the canary records giving
    the recorded verdicts, the records valid, each epoch's history held
    to a plain ``LogisticGradient`` epoch from the same start over their
    common path (rtol 1e-4), every launch the margin kernel's stream
    mode (``launches_by_path["pipeline"]``); the trainer (so its
    supervisor and checkpointers), the canary, the promoter, the
    registry and HEAD's engine and queue report through one
    ``obs.Telemetry`` (in memory and a JSONL file in ``/dev/shm``), as in
    ``tools/pipeline_drill.py``: its records schema-valid, ``gate_promotion`` re-run
    over its canary records giving the recorded verdicts, its promotion
    records the decisions, an epoch span an epoch and no iteration
    record (the epochs run ``stream_iterations=False``);
52. fleet, after phase 51: ``tools/fleet_drill.py``'s story at the
    flagship width (FLEET): phase 5's weights, kept on the host,
    published into a ``ModelRegistry`` in ``/dev/shm`` and served by 3
    ``ReplicaServer`` processes on the card (``--fleet-child``, started
    together; a 4th started with them waits to join), a ``FleetRouter``
    with a ``HostMonitor`` and a ``Telemetry`` in front; 4 client
    threads x 500 requests of 1-16 rows under two tenants; replica 1
    slowed 0.4 s a request from its 40th (a persistent
    ``slow_replica``), replica 2 SIGKILLed at its 150th
    (``kill_replica``); a second generation published after 1,000
    requests; then the 4th replica joins, then one tenant floods past a
    cap of 2.  Checked by values and counts only: every answer equal to
    its generation's ``predict_proba`` on the card (f32 rtol 1e-5), no
    admitted request dropped, replica 1 read SLOW and never LOST,
    replica 2 evicted once with a retry and not brought back by the
    join, a hedge won, every live replica on generation 2, the flood
    shed typed (``shed_tenant``) while the quiet tenant is answered in
    full, ``gate_fleet`` passing over every process's records, every
    record schema-valid and naming the card; p50, p99 and requests per
    second printed, not gated; no kernel launched (the replicas' products
    are ``torch.matmul``);
53. telemetry, on phase 5's data after 47: (a) phase 5's fit through
    ``run(telemetry=Telemetry(profile_dir=))``: its history and weights
    bit-equal to phase 5's, its iteration records equal to the history,
    the spans ``h2d_transfer``, ``trace``, ``compile``, ``execute`` and
    the ``run`` record valid; the profiler's Chrome trace of ``execute``
    parsed, holding the margin kernel's ``margin_stream`` symbol exactly
    as often as the fit launched it, but for kernel records the profiler
    dropped (launches in the trace without their kernel, counted and
    printed; at most 1%); no CUDA activity in it fails the phase; the device-busy share of ``execute`` read from the trace and
    the wall-time ratio of a telemetry fit to a plain one (medians of 3
    each, in turns), printed with the card; (b) ``run_lbfgs`` and OWL-QN
    with ``telemetry=``: each fit's iteration records equal its history;
    (c) a 10-iteration flagship fit supervised with a
    ``DistributedCheckpointer(telemetry=)`` every 5 (a ``ckpt_commit``
    span a generation) and, after phase 37, ``run_agd_host`` over 3
    pinned batches of 1,048,576 rows (a ``stream_epoch`` record a pass),
    both on one ``Telemetry``.

Launch counts are set to 0 just before each path (phases 5, 7, 10-19,
22-53) and read just after it; the sparse paths launch neither kernel,
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
import glob
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
    PEAKS["main_path"] = peak_gb

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
    after(Xa, y, (res, hist, res_plain, hist_plain))
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
            "cfg": cfg, "run": (res, hist),
            "row": {"shape": [n, d + 1], "nnz": Xa.nnz, "eval_ms": eval_ms,
                    "matvec_ms": matvec_ms, "rmatvec_ms": rmatvec_ms,
                    "bound_ms": b_ms,
                    "products_per_fit": 2 * (gradient.evaluations
                                             - evaluations_train),
                    "cusparse": library, "segment_reduce_1d": cub_1d}}


def decimal_fields(v):
    """The decimal text of the f32 values ``v`` as a (len, 15) uint8
    array, 0 where a field has no byte: ``[-]d[.dddddddd]e[-]d[d]``,
    nine significant digits (an f32 reads back exactly), the fraction's
    trailing zeros dropped; a zero as ``0``."""
    v = np.asarray(v, np.float32)
    a = np.abs(v).astype(np.float64)
    zero = a == 0
    a[zero] = 1.0
    e = np.floor(np.log10(a))
    m = np.rint(a / 10.0 ** (e - 8))
    off = (m < 1e8).astype(np.int8) - (m >= 1e9)  # log10 a power off
    if off.any():
        e -= off
        m = np.where(off != 0, np.rint(a / 10.0 ** (e - 8)), m)
    up = m >= 1e9  # rounded up to the next power of ten
    e += up
    m[up] = 1e8
    m, e = m.astype(np.uint32), e.astype(np.int32)
    digits = []
    for _ in range(9):
        m, digit = np.divmod(m, np.uint32(10))
        digits.append(digit.astype(np.uint8))
    digits.reverse()
    blank = np.uint8(0)
    cols = [np.where(v < 0, np.uint8(ord("-")), blank),
            digits[0] + np.uint8(ord("0"))]
    kept, fraction = np.zeros(v.size, bool), []
    for digit in reversed(digits[1:]):  # a digit stays if any after it
        kept = kept | (digit != 0)      # is nonzero
        fraction.append(np.where(kept, digit + np.uint8(ord("0")), blank))
    cols.append(np.where(kept, np.uint8(ord(".")), blank))
    cols += reversed(fraction)
    tens, units = np.divmod(np.abs(e).astype(np.uint8), np.uint8(10))
    cols += [np.full(v.size, ord("e"), np.uint8),
             np.where(e < 0, np.uint8(ord("-")), blank),
             np.where(tens > 0, tens + np.uint8(ord("0")), blank),
             units + np.uint8(ord("0"))]
    out = np.stack(cols, axis=1)
    out[zero] = 0
    out[zero, 1] = ord("0")
    return out


def write_libsvm(path, cid, val, y, k, rows):
    """The first ``rows`` rows (``k`` entries each: column ids ``cid``,
    f32 values ``val``) as LIBSVM text, every number read back exactly
    (:func:`decimal_fields`), built in numpy about 2^20 entries at a
    time; returns the seconds it took."""
    t0 = time.perf_counter()
    width = len(str(int(cid[:rows * k].max()) + 1)) if rows else 1
    block = max(1, (1 << 20) // k)
    with open(path, "wb") as f:
        for r0 in range(0, rows, block):
            r1 = min(rows, r0 + block)
            n = r1 - r0
            ids = cid[r0 * k:r1 * k].astype(np.uint32) + np.uint32(1)
            cols = []
            for _ in range(width):  # leading zeros left out
                ids, digit = np.divmod(ids, np.uint32(10))
                cols.append(np.where((digit > 0) | (ids > 0),
                                     digit.astype(np.uint8)
                                     + np.uint8(ord("0")), np.uint8(0)))
            cols.reverse()
            entry = np.concatenate(
                [np.full((n * k, 1), ord(" "), np.uint8),
                 np.stack(cols, axis=1),
                 np.full((n * k, 1), ord(":"), np.uint8),
                 decimal_fields(val[r0 * k:r1 * k])], axis=1)
            line = np.concatenate(
                [decimal_fields(y[r0:r1]), entry.reshape(n, -1),
                 np.full((n, 1), ord("\n"), np.uint8)], axis=1).ravel()
            f.write(line[line != 0].tobytes())
    return time.perf_counter() - t0


def write_parts(X, y, parts, out_dir):
    """Dense rows as ``parts`` LIBSVM part files of contiguous rows, every
    column written (:func:`write_libsvm`), a thread a part.  Returns the
    paths and each part's rows."""
    X, y = X.cpu().numpy(), y.cpu().numpy()
    n, d = X.shape

    def write(i):
        r0, r1 = n * i // parts, n * (i + 1) // parts
        path = os.path.join(out_dir, f"part-{i:05d}")
        write_libsvm(path, np.tile(np.arange(d), r1 - r0),
                     X[r0:r1].ravel(), y[r0:r1], d, r1 - r0)
        return path, r1 - r0

    with concurrent.futures.ThreadPoolExecutor(parts) as pool:
        paths, rows = zip(*pool.map(write, range(parts)))
    return list(paths), list(rows)


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


def alternating_walls(plain, fits, runs=None):
    """Wall seconds of ``plain()`` and of each ``fits[name](i)``, timed in
    turns for ``runs`` rounds (STEADY_RUNS by default), plain first in
    even rounds and last in odd ones, so that the card's state drifts
    alike over both sides of a ratio; returns ``(seconds, outs)``: each
    name's samples in order and each call's result, ``"plain"`` among
    the names."""
    seconds = {"plain": [], **{name: [] for name in fits}}
    outs = {name: [] for name in seconds}
    calls = (("plain", lambda i: plain()),) + tuple(fits.items())
    for i in range(STEADY_RUNS if runs is None else runs):
        for name, fn in calls if i % 2 == 0 else calls[::-1]:
            out, sec = timed(lambda: fn(i))
            seconds[name].append(sec)
            outs[name].append(out)
    return seconds, outs


def median_ratio(seconds, name):
    """The median of ``name``'s samples over the median of the plain
    fit's."""
    return (float(np.median(seconds[name]))
            / float(np.median(seconds["plain"])))


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


def mlp_path(port, device_synth, smi, fk, keep=None):
    """Phase 18: BASELINE config 5 as published, ``planted_mlp`` 1M x
    1024 (hidden 32, 2 classes, seed 4) through
    ``MLPClassifierWithAGD(32, 2, reg_param=1e-5)`` (tanh), held to the
    same fit at f64 over their common path and the final gradient to
    f64 sums.  Its two products are torch's: no kernel of the port.
    ``keep["mlp"]`` (when given) gets the trained parameters on the
    host."""
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
    if keep is not None:
        keep["mlp"] = {n_: v.detach().cpu() for n_, v in model.params.items()}
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
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, sweep_s = timed(lambda: opt(fused).sweep((X, y), SWEEP_REGS, w0))
    peak_above = (torch.cuda.max_memory_allocated() - base) / 1e9
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
    out["peak_gb_above_x"] = peak_above
    if keep is not None:
        keep.update(res=res, s=sweep_s, peak_above=peak_above)
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
        keep.update(res=res, s=sweep_s)
    finish("lbfgs_sweep_path", out, checks, t_phase, smi)


def cv_path(port, fk, glm, smi, X, y, launches, keep=None):
    """Phase 23, on phase 5's data: 5-fold CV over CV_REGS (20 lanes)
    through ``LogisticRegressionWithAGD(add_intercept=False)
    .cross_validate`` with the plain gradient and its refit; the fold
    ids drawn on the card against the CPU draw, two lanes against solo
    runs under their train masks, ``val_loss`` against each lane's
    held-out mean loss.  ``keep`` (a dict, optional) receives the
    ``CVResult``, the refit model and the wall seconds."""
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
    if keep is not None:
        keep.update(cv=cv, model=model, s=cv_s)
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
    carries["hist"] = res.loss_history
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
                 launches, keep=None):
    """Phase 33, on phase 32's stream: ``streaming_sweep`` over
    SWEEP_REGS through ``FusedLogisticGradient`` capped at STREAM_ITERS,
    every launch in the lanes kernel's ``lanes_mma`` mode at K = 8, one a
    batch a pass, each lane held to phase 22's in-memory sweep over
    common iterations (rtol 1e-4); then ``streaming_lbfgs_sweep`` over
    the same strengths, each lane held to phase 27's ``LBFGS.sweep``
    over common iterations.  ``keep`` (a dict, optional) receives the
    streamed sweep's result (phase 41 holds its mesh stream to it)."""
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
    if keep is not None:
        keep["res"] = res

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
    return paths


# ---------------------------------------------------------------------------
# Phases 35-38: single-device resilience
# ---------------------------------------------------------------------------

# phase 35: the supervised flagship fit in segments of SUP_SEGMENT
# iterations, checkpointed every SUP_SEGMENT with SUP_KEEP generations;
# the scripted faults of (b) and (c)
SUP_SEGMENT, SUP_KEEP = 5, 2
SUP_FAULTS = dict(device_loss_at_iter=10, nan_at_iter=20)
SUP_SIGTERM_AT = 15
# phases 35 and 43 hold a checkpointed fit's wall time to 1.1x a plain
# run of the same fit: the medians of this many samples of each, timed
# in turns within the phase
STEADY_RUNS = 3
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
    supervised ``run``, STEADY_RUNS times in turns with as many plain
    ``run``s of the same fit: every one gives phase 5's bits, and the
    supervised runs' median wall time is within 1.1x the plain runs'
    median (the limit of PERF.md section 2); (b) a scripted device loss
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
    tmp = shm_dir("chip_smoke_ckpt_")
    try:
        fk.reset_launch_counts()
        cks_a = [resilience.AutoCheckpointer(
            os.path.join(tmp, f"a{i}.npz"), every_iters=SUP_SEGMENT,
            keep=SUP_KEEP) for i in range(STEADY_RUNS)]
        # (a) in turns with a plain run of the same fit, each a fresh
        # checkpoint chain
        walls, outs = alternating_walls(
            lambda: port.run((X, y), fused, port.SquaredL2Updater(), **kw),
            {"a": lambda i: port.run(
                (X, y), fused, port.SquaredL2Updater(), resilience=policy,
                checkpointer=cks_a[i], **kw)})
        w_a, hist_a, sres_a = outs["a"][0]
        ck_a, run_a_s = cks_a[0], walls["a"][0]
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
        "a_weights_bit_identical_to_phase5": all(
            torch.equal(o[0], res5.weights) for o in outs["a"] + outs["plain"]),
        "a_history_bit_identical_to_phase5": all(
            np.array_equal(o[1], hist5) for o in outs["a"] + outs["plain"]),
        "a_segments_all_ok": all(
            [e["outcome"] for e in o[2].attempts]
            == ["ok"] * -(-len(hist5) // SUP_SEGMENT) for o in outs["a"]),
        # the median of STEADY_RUNS supervised runs over that of as many
        # plain runs of the same fit, timed in turns in this phase
        "a_within_1.1x_phase5_wall": median_ratio(walls, "a") <= 1.1,
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
        "a_run_s_samples": walls["a"], "plain_run_s_samples": walls["plain"],
        "a_over_plain_median_wall": median_ratio(walls, "a"),
        "a_launches": launches_a,
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


# ---------------------------------------------------------------------------
# Phases 39-42: data parallelism (the mesh slice)
# ---------------------------------------------------------------------------

# phase 39: phase 5's flagship over meshes of these slot counts on the one
# card (3 slots pad two rows; 4 divide 10M rows)
MESH_SLOTS = (1, 3, 4)
# phase 40: configs 1 and 4 over 4 slots
MESH_SPARSE_SLOTS = 4
# phase 41: phase 32's stream over 2 slots at 3 iterations
MESH_STREAM_SLOTS, MESH_STREAM_ITERS = 2, 3
# phase 42: two processes on the card over phase 34's part files, and a
# one-rank NCCL group fitting phase 39's problem on 1M rows
MP_ITERS, MP_NCCL_ROWS = 10, 1_000_000
# a child's wall limit, and the limit of each of its collectives
MP_CHILD_TIMEOUT_S, MP_COLLECTIVE_TIMEOUT_S = 240, 120
# every peak of the main path as it ran (phase 5's, for phase 39's check)
PEAKS = {}


def card_mesh(mesh_lib, k):
    """A mesh of ``k`` slots, each the current card."""
    dev = torch.device("cuda", torch.cuda.current_device())
    return mesh_lib.make_mesh({mesh_lib.DATA_AXIS: k}, devices=[dev] * k)


def combine_times(gradient, mesh, X, y, w, repeats=20):
    """Evaluations of the mesh smooth, each timed whole and its combine
    (``dist_smooth._combine``: the slots' sums added on the lead device in
    slot order; off the lead device also their copies, none here) timed
    inside it, by CUDA events recorded on the card's stream just before
    and just after the combine's launches: the combine's device time,
    with any wait for the host to launch it.  Medians over ``repeats``
    evaluations after a warm-up."""
    from spark_agd_tpu_torch.parallel import dist_smooth

    build, shards = dist_smooth.make_dist_smooth_staged(gradient, X, y,
                                                        mesh=mesh)
    smooth = build(*shards)[0]
    real = dist_smooth._combine
    marks = []

    def timed_combine(*a):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real(*a)
        ev[1].record()
        marks.append(ev)
        return out

    smooth(w)
    torch.cuda.synchronize()
    whole = []
    dist_smooth._combine = timed_combine
    try:
        for _ in range(repeats):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            smooth(w)
            ev[1].record()
            whole.append(ev)
    finally:
        dist_smooth._combine = real
    torch.cuda.synchronize()
    smooth_ms = float(np.median([a.elapsed_time(b) for a, b in whole]))
    combine_ms = float(np.median([a.elapsed_time(b) for a, b in marks]))
    return {"smooth_ms": smooth_ms, "combine_ms": combine_ms,
            "combine_share": combine_ms / smooth_ms,
            "combine_timed_inside_evaluations": len(marks), "w_copies": 0}


def mesh_fit(port, fk, smi, X, y, solo, launches):
    """Phase 39, inside phase 5's ``after`` on its 10M x 1000 f32 X: the
    flagship fit (``run(mesh=)``, ``FusedLogisticGradient``) over MESH_SLOTS
    slots of the card, each held to phase 5's fit over common iterations
    (rtol 1e-4) and its final gradient to f64 sums; the margin kernel
    launched once a slot an evaluation, all in the stream mode; the
    card's peak within phase 5's plus one shard's padding rows plus 1 GB
    (shards are views of X); wall time beside phase 5's fit and the
    combine's share of one evaluation."""
    from spark_agd_tpu_torch.parallel import dist_smooth, mesh as mesh_lib

    t_phase = time.perf_counter()
    res5, hist5, run5_s = solo
    w0 = torch.zeros(D_MAIN, dtype=torch.float32, device="cuda")
    staged = fk.stage_dense(X, y)
    rows, checks = {}, {}
    for k in MESH_SLOTS:
        mesh = card_mesh(mesh_lib, k)
        fused = counting(port.FusedLogisticGradient)()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fk.reset_launch_counts()
        dist_smooth.reset_counts()
        (w, hist, res), wall = timed(lambda: port.run(
            (X, y), fused, port.SquaredL2Updater(), reg_param=REG,
            num_iterations=ITERS, convergence_tol=TOL, initial_weights=w0,
            mesh=mesh, return_result=True))
        peak = torch.cuda.max_memory_allocated() / 1e9
        evals = dist_smooth.mesh_evaluations
        slot_evals = dist_smooth.slot_evaluations
        launched = fk.launch_count
        modes = margin_modes(fk)
        path = f"mesh_fit_{k}"
        record_margin_path(fk, launches, path)
        n_common = min(int(res.num_iters), int(res5.num_iters))
        rps = -(-N_MAIN // k)
        tail_gb = (rps * k - N_MAIN) * D_MAIN * 4 / 1e9
        loss64, grad64 = margin_f64(w, staged)
        mean64 = grad64 / N_MAIN
        sm = dist_smooth.make_dist_smooth(port.FusedLogisticGradient(), X,
                                          y, mesh=mesh)[0]
        f_mesh, g_mesh = sm(w)
        g_err = float((g_mesh.double() - mean64).abs().max())
        g_max = float(mean64.abs().max())
        row = {
            "slots": k, "wall_s": wall, "phase5_run_s": run5_s,
            "wall_vs_phase5": wall / run5_s, "num_iters": int(res.num_iters),
            "mesh_evaluations": evals, "slot_evaluations": slot_evals,
            "kernel_launches": launched,
            "modes": modes, "peak_gb": peak,
            "phase5_peak_gb": PEAKS["main_path"], "pad_rows": rps * k
            - N_MAIN, "tail_gb": tail_gb,
            "max_hist_rel_diff_vs_phase5": float(np.max(
                np.abs(hist[:n_common] - hist5[:n_common])
                / np.abs(hist5[:n_common]))),
            "loss_rel_err_vs_f64": abs(float(f_mesh) * N_MAIN
                                       - float(loss64)) / abs(float(loss64)),
            "grad_max_abs_err_vs_f64": g_err, "grad_abs_max": g_max,
            **combine_times(port.FusedLogisticGradient(), mesh, X, y, w)}
        rows[str(k)] = row
        checks.update({
            f"{k}_launches_equal_slots_x_evaluations":
                launched == fused.evaluations == k * evals > 0,
            f"{k}_every_launch_stream": set(modes) == {"stream"},
            f"{k}_same_stop_or_both_at_floor": same_stop(res, res5, hist,
                                                         hist5),
            f"{k}_history_rtol_1e-4_vs_phase5": bool(np.allclose(
                hist[:n_common], hist5[:n_common], rtol=1e-4, atol=0.0)),
            f"{k}_grad_within_1e-4_of_f64": g_err <= 1e-4 * g_max,
            f"{k}_peak_within_phase5_plus_tail_plus_1gb":
                peak <= PEAKS["main_path"] + tail_gb + 1.0,
            f"{k}_finite": bool(np.isfinite(hist).all()
                                and torch.isfinite(w).all())})
    del staged
    launches["mesh_fit"] = sum(launches[f"mesh_fit_{k}"] for k in MESH_SLOTS)
    launches["modes"]["mesh_fit"] = {"stream": launches["mesh_fit"]}
    finish("mesh_fit", {"shape": [N_MAIN, D_MAIN], "by_slots": rows},
           checks, t_phase, smi)


def mesh_rcv1(port, fk, sparse, glm, smi, rcv1, launches):
    """Phase 40 (a), after phase 10 on its data: BASELINE config 1
    (rcv1-like, with the trainer's intercept column) as a
    ``RowShardedCSR`` over MESH_SPARSE_SLOTS slots (nnz-balanced,
    ``shard_csr_batch``) through ``run(mesh=)``, held to phase 10's fit
    over the iterations before they part (rtol 1e-4) and its final
    gradient to f64 sums; no dense kernel launched; the card's peak."""
    from spark_agd_tpu_torch.parallel import dist_smooth, mesh as mesh_lib

    t_phase = time.perf_counter()
    cfg = rcv1["cfg"]
    res10, hist10 = rcv1["run"]
    d = cfg["d"] + 1
    Xa = glm._add_intercept(rcv1["X"]).with_csc()
    y = rcv1["y"]
    mesh = card_mesh(mesh_lib, MESH_SPARSE_SLOTS)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batch, layout_s = timed(lambda: mesh_lib.shard_csr_batch(mesh, Xa, y))
    fk.reset_launch_counts()
    dist_smooth.reset_counts()
    w0 = torch.zeros(d, dtype=torch.float32, device="cuda")
    (w, hist, res), wall = timed(lambda: port.run(
        batch, port.LogisticGradient(), port.L2Prox(), reg_param=cfg["reg"],
        num_iterations=ITERS, convergence_tol=TOL, initial_weights=w0,
        return_result=True))
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    dense = fk.launch_count + fk.softmax_launch_count + fk.lanes_launch_count
    n_common = min(int(res.num_iters), int(res10.num_iters))
    n_path = common_path(res, res10, n_common)
    Xa64 = csr_f64(sparse, Xa)
    _, g64, _ = port.LogisticGradient().batch_loss_and_grad(
        w.double(), Xa64, y.double())
    sm = dist_smooth.make_dist_smooth(port.LogisticGradient(), batch,
                                      mesh=mesh)[0]
    g_mesh = sm(w)[1]
    mean64 = g64 / cfg["n"]
    g_err = float((g_mesh.double() - mean64).abs().max())
    g_max = float(mean64.abs().max())
    out = {"shape": [cfg["n"], d], "nnz": Xa.nnz, "slots": MESH_SPARSE_SLOTS,
           "nnz_per_shard": batch.X.nnz_per_shard,
           "rows_per_shard": batch.X.rows_per_shard, "layout_s": layout_s,
           "wall_s": wall, "num_iters": int(res.num_iters),
           "mesh_evaluations": dist_smooth.mesh_evaluations,
           "slot_evaluations": dist_smooth.slot_evaluations,
           "dense_kernel_launches": dense, "common_path_iterations": n_path,
           "max_hist_rel_diff_vs_phase10_on_the_common_path": float(np.max(
               np.abs(hist[:n_path] - hist10[:n_path])
               / np.abs(hist10[:n_path]))),
           "grad_max_abs_err_vs_f64": g_err, "grad_abs_max": g_max,
           "peak_gb_above_phase10_data": peak}
    checks = {
        "no_dense_kernel_launch": dense == 0,
        "slot_evaluations": dist_smooth.slot_evaluations
        == MESH_SPARSE_SLOTS * dist_smooth.mesh_evaluations > 0,
        "common_path_of_10_iterations_or_more": n_path >= 10,
        "history_rtol_1e-4_vs_phase10_on_the_common_path": bool(np.allclose(
            hist[:n_path], hist10[:n_path], rtol=1e-4, atol=0.0)),
        "grad_within_1e-4_of_f64": g_err <= 1e-4 * g_max,
        "finite": bool(np.isfinite(hist).all()
                       and torch.isfinite(w).all())}
    del batch, Xa, Xa64
    finish("mesh_sparse_rcv1", out, checks, t_phase, smi)


def mesh_softmax(port, fk, smi, Xa, y, solo, launches):
    """Phase 40 (b), inside phase 7's ``after`` on its data (X with the
    intercept column, 25.4 GB): BASELINE config 4 through ``run(mesh=)``
    over MESH_SPARSE_SLOTS slots with ``FusedSoftmaxGradient``, a softmax
    launch a slot an evaluation, held to phase 7's fit over common
    iterations (rtol 1e-4); the card holds no third copy of X (the
    shards are views: the peak stays within 1 GB of what phase 7 left
    allocated)."""
    from spark_agd_tpu_torch.parallel import dist_smooth, mesh as mesh_lib

    t_phase = time.perf_counter()
    res7, hist7 = solo[:2]
    d = D_SM + 1
    mesh = card_mesh(mesh_lib, MESH_SPARSE_SLOTS)
    fused = counting(port.FusedSoftmaxGradient)(port.SoftmaxGradient(K_SM))
    w0 = torch.zeros((d, K_SM), dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launch_counts()
    dist_smooth.reset_counts()
    (w, hist, res), wall = timed(lambda: port.run(
        (Xa, y), fused, port.SquaredL2Updater(), reg_param=REG_SM,
        num_iterations=ITERS, convergence_tol=TOL, initial_weights=w0,
        mesh=mesh, return_result=True))
    peak_above = (torch.cuda.max_memory_allocated() - base) / 1e9
    launched = fk.softmax_launch_count
    launches["mesh_softmax"] = launched
    softmax_modes(fk, launches, "mesh_softmax")
    n_common = min(int(res.num_iters), int(res7.num_iters))
    out = {"shape": [N_SM, d], "classes": K_SM, "slots": MESH_SPARSE_SLOTS,
           "x_gb": Xa.numel() * 4 / 1e9, "wall_s": wall,
           "num_iters": int(res.num_iters),
           "mesh_evaluations": dist_smooth.mesh_evaluations,
           "kernel_launches": launched,
           "modes": launches["softmax_modes"]["mesh_softmax"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_gb_above_x": peak_above,
           "max_hist_rel_diff_vs_phase7": float(np.max(
               np.abs(hist[:n_common] - hist7[:n_common])
               / np.abs(hist7[:n_common])))}
    checks = {
        "launches_equal_slots_x_evaluations": launched == fused.evaluations
        == MESH_SPARSE_SLOTS * dist_smooth.mesh_evaluations > 0,
        "no_margin_kernel_launch": fk.launch_count == 0,
        "same_stop_or_both_at_floor": same_stop(res, res7, hist, hist7),
        "history_rtol_1e-4_vs_phase7": bool(np.allclose(
            hist[:n_common], hist7[:n_common], rtol=1e-4, atol=0.0)),
        "no_third_copy_of_x": peak_above < 1.0,
        "finite": bool(np.isfinite(hist).all()
                       and torch.isfinite(w).all())}
    finish("mesh_softmax", out, checks, t_phase, smi)


def mesh_stream(port, fk, streaming, smi, host, stream_ref, sweep33,
                launches):
    """Phase 41: phase 32's stream (phase 5's data in pinned host memory,
    batches of STREAM_ROWS) through ``make_streaming_smooth(mesh=)`` over
    MESH_STREAM_SLOTS slots, ``run_agd_host`` at MESH_STREAM_ITERS
    iterations, held to phase 32's history (rtol 1e-4), the margin kernel
    launched once a slot a batch, each batch copied to the card once a
    pass (directly: the source is pinned); then ``streaming_sweep(mesh=)``
    over the same slots at MESH_STREAM_ITERS iterations, one lanes launch
    a slot a batch, every lane held to phase 33's streamed sweep
    ``sweep33`` over their common iterations (rtol 1e-4); then
    ``dryrun_multichip(4, "cuda")`` (dense DP, DP x TP softmax, feature
    sharding, CSR DP, the fused kernel in each shard, the mesh-streamed
    CSR fit, the mesh sweep through the lanes kernel, mesh L-BFGS, each
    held to its single-device run)."""
    from spark_agd_tpu_torch.core import smooth as smooth_lib
    from spark_agd_tpu_torch.parallel import dist_smooth, dryrun
    from spark_agd_tpu_torch.parallel import mesh as mesh_lib

    t_phase = time.perf_counter()
    ds = streaming.StreamingDataset.from_arrays(host["X"], host["y"],
                                                STREAM_ROWS)
    mesh = card_mesh(mesh_lib, MESH_STREAM_SLOTS)
    fused = counting(port.FusedLogisticGradient)()
    stats = []
    sm, sl = streaming.make_streaming_smooth(fused, ds, mesh=mesh,
                                             pass_stats=stats)
    px, rv = smooth_lib.make_prox(port.SquaredL2Updater(), REG)
    cfg = port.AGDConfig(convergence_tol=TOL,
                         num_iterations=MESH_STREAM_ITERS)
    w0 = torch.zeros(D_MAIN, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launch_counts()
    dist_smooth.reset_counts()
    res, fit_s = timed(lambda: port.run_agd_host(sm, px, rv, w0, cfg,
                                                 smooth_loss=sl))
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    launched = fk.launch_count
    evals = dist_smooth.mesh_evaluations
    modes = margin_modes(fk)
    record_margin_path(fk, launches, "mesh_stream")
    batches = -(-N_MAIN // STREAM_ROWS)
    ref = stream_ref["hist"]
    m = min(len(res.loss_history), len(ref))
    # the streamed sweep over the same mesh: a lanes launch a slot a batch
    sstats = []
    fused_s = counting_lanes(port.FusedLogisticGradient)()
    fk.reset_launch_counts()
    sres, ssweep_s = timed(lambda: port.streaming_sweep(
        ds, fused_s, port.SquaredL2Updater(), SWEEP_REGS,
        num_iterations=MESH_STREAM_ITERS, convergence_tol=TOL,
        initial_weights=w0, mesh=mesh, pass_stats=sstats))
    s_launches = fk.lanes_launch_count
    s_modes = {k_: c for k_, c in fk.lanes_mode_launches.items() if c}
    launches["mesh_stream_sweep"] = s_launches
    launches.setdefault("lanes_modes", {})["mesh_stream_sweep"] = s_modes
    s_diffs, s_ok = [], True
    for i in range(len(SWEEP_REGS)):
        hist_i = sres.loss_history[:int(sres.num_iters[i]), i]
        ref_i = sweep33.loss_history[:int(sweep33.num_iters[i]), i]
        mi = min(len(hist_i), len(ref_i))
        s_ok = s_ok and bool(np.allclose(hist_i[:mi], ref_i[:mi],
                                         rtol=1e-4, atol=0.0))
        s_diffs.append(float(np.max(np.abs(hist_i[:mi] - ref_i[:mi])
                                    / np.abs(ref_i[:mi]))))
    fk.reset_launch_counts()
    dry, dry_s = timed(lambda: dryrun.dryrun_multichip(4, "cuda"))
    record_margin_path(fk, launches, "dryrun")
    launches["dryrun_lanes"] = fk.lanes_launch_count
    launches["lanes_modes"]["dryrun"] = {
        k_: c for k_, c in fk.lanes_mode_launches.items() if c}
    out = {"shape": [N_MAIN, D_MAIN], "slots": MESH_STREAM_SLOTS,
           "batch_rows": STREAM_ROWS, "fit_s": fit_s,
           "num_iters": res.num_iters, "mesh_evaluations": evals,
           "passes": evals // batches, "kernel_launches": launched,
           "modes": modes, "peak_gb_above_before": peak,
           "loss_history": list(res.loss_history),
           "phase32_loss_history": [float(v) for v in ref[:m]],
           "max_hist_rel_diff_vs_phase32": float(np.max(
               np.abs(res.loss_history[:m] - ref[:m]) / np.abs(ref[:m]))),
           "pass_s": [st["pass_s"] for st in stats],
           "h2d_bytes_per_pass": [st["h2d_bytes"] for st in stats],
           "direct_copies_per_pass": [st["direct_copies"] for st in stats],
           "staged_copies_per_pass": [st["staged_copies"] for st in stats],
           "throttle_s_per_pass": [st["throttle_s"] for st in stats],
           "sweep_s": ssweep_s, "sweep_launches": s_launches,
           "sweep_modes": s_modes, "sweep_rounds": fused_s.rounds,
           "sweep_num_iters": sres.num_iters.tolist(),
           "sweep_max_hist_rel_diff_vs_phase33_by_lane": s_diffs,
           "dryrun_slot_evaluations": dry, "dryrun_s": dry_s,
           "dryrun_kernel_launches": launches["dryrun"],
           "dryrun_lanes_launches": launches["dryrun_lanes"]}
    pass_bytes = host["X"].nbytes + host["y"].nbytes
    checks = {
        "launches_equal_slots_x_batches_x_passes": launched
        == fused.evaluations
        == MESH_STREAM_SLOTS * evals > 0 and evals % batches == 0,
        "every_launch_stream": set(modes) == {"stream"},
        "history_rtol_1e-4_vs_phase32": bool(np.allclose(
            res.loss_history[:m], ref[:m], rtol=1e-4, atol=0.0)),
        "iterations": res.num_iters == MESH_STREAM_ITERS,
        "each_batch_copied_once_directly_from_pinned_memory": bool(stats)
        and all(st["h2d_bytes"] == pass_bytes and st["batches"] == batches
                and st["staged_copies"] == 0 for st in stats),
        "dryrun_fused_launches_a_slot_an_evaluation":
            launches["dryrun"] == dry["fused_dp"] > 0,
        "dryrun_mesh_sweep_a_lanes_launch_a_slot_a_round":
            launches["dryrun_lanes"] == dry["mesh_sweep"] > 0,
        "sweep_one_lanes_launch_a_slot_a_batch": s_launches
        == fused_s.rounds == MESH_STREAM_SLOTS * batches * len(sstats) > 0,
        "sweep_every_launch_lanes_mma": s_modes == {"lanes_mma":
                                                    s_launches},
        "sweep_every_lane_history_rtol_1e-4_vs_phase33": s_ok,
        "peak_within_4_batches_plus_1gb": peak <= 4 * STREAM_ROWS * D_MAIN
        * 4 / 1e9 + 1.0}
    finish("mesh_stream", out, checks, t_phase, smi)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _hexes(a):
    return [float(v).hex() for v in np.asarray(a, np.float64).reshape(-1)]


def mp_child(port, spec, drill=None):
    """The child of phases 42, 44 and 45 (``--mp-child BACKEND ADDR WORLD
    RANK DIR``): one rank of a process group on the card.  With a part
    directory, ``from_partitioned_files_csr`` over its part files onto a
    mesh of 2 slots a rank and MP_ITERS iterations of logistic AGD; with
    ``-`` (a one-rank NCCL group), phase 39's fit on MP_NCCL_ROWS rows
    over 2 slots against the same fit without a mesh; with ``--drill
    JSON``, the supervised fits of phases 44-45 (:func:`drill_child`).
    Prints one RESULT line."""
    import datetime
    import glob
    import hashlib

    from spark_agd_tpu_torch.data import device_synth, ingest
    from spark_agd_tpu_torch.ops import fused_kernels as fk
    from spark_agd_tpu_torch.parallel import dist_smooth, mesh as mesh_lib
    from spark_agd_tpu_torch.parallel import multihost as mh

    backend, addr, world, rank, parts = spec
    world, rank = int(world), int(rank)
    mh.initialize(addr, world, rank, backend=backend, device="cuda:0",
                  timeout=datetime.timedelta(
                      seconds=MP_COLLECTIVE_TIMEOUT_S))
    out = {"rank": rank, "backend": backend, "world": mh.process_count()}
    mesh = mesh_lib.make_mesh({mesh_lib.DATA_AXIS: 2 * world},
                              devices=[torch.device("cuda", 0)] * 2)
    if drill is not None:
        out.update(drill_child(port, mesh, parts, json.loads(drill)))
        torch.cuda.synchronize()
        print("RESULT " + json.dumps(out), flush=True)
        mh.shutdown()
        return 0
    fk.reset_launch_counts()
    dist_smooth.reset_counts()
    if parts != "-":
        paths = sorted(glob.glob(os.path.join(parts, "part-*")))
        d = RCV1["d"]
        (batch, ingest_s) = timed(lambda: ingest.from_partitioned_files_csr(
            paths, mesh, n_features=d))
        w0 = torch.zeros(d, dtype=torch.float32, device="cuda")
        (w, hist, res), fit_s = timed(lambda: port.run(
            batch, port.LogisticGradient(), port.L2Prox(),
            reg_param=RCV1["reg"], num_iterations=MP_ITERS,
            convergence_tol=TOL, initial_weights=w0, return_result=True))
        out.update(rows=batch.X.shape[0], ingest_s=ingest_s)
    else:
        X, y = device_synth.class_logistic(MP_NCCL_ROWS, D_MAIN, seed=0)
        w0 = torch.zeros(D_MAIN, dtype=torch.float32, device="cuda")
        kw = dict(reg_param=REG, num_iterations=ITERS, convergence_tol=TOL,
                  initial_weights=w0, return_result=True)
        (w, hist, res), fit_s = timed(lambda: port.run(
            (X, y), port.FusedLogisticGradient(), port.SquaredL2Updater(),
            mesh=mesh, **kw))
        out["kernel_launches"] = fk.launch_count
        _, hist1, res1 = port.run((X, y), port.FusedLogisticGradient(),
                                  port.SquaredL2Updater(), mesh=False,
                                  device="cuda", **kw)
        n_common = min(int(res.num_iters), int(res1.num_iters))
        out["single_device_hist"] = _hexes(hist1)
        out["max_hist_rel_diff_vs_single_device"] = float(np.max(
            np.abs(hist[:n_common] - hist1[:n_common])
            / np.abs(hist1[:n_common])))
        out["history_rtol_1e-4_vs_single_device"] = bool(np.allclose(
            hist[:n_common], hist1[:n_common], rtol=1e-4, atol=0.0))
    out.update(hist=_hexes(hist), diag_l=_hexes(res.diag_l[:len(hist)]),
               w_sha256=hashlib.sha256(
                   w.detach().cpu().numpy().tobytes()).hexdigest(),
               iters=int(res.num_iters), fit_s=fit_s,
               mesh_evaluations=dist_smooth.mesh_evaluations,
               slot_evaluations=dist_smooth.slot_evaluations)
    torch.cuda.synchronize()
    print("RESULT " + json.dumps(out), flush=True)
    mh.shutdown()
    return 0


def start_children(args_list, flag="--mp-child"):
    """Start one ``flag`` child process (``--mp-child`` or
    ``--fleet-child``) an argument tuple, all together: each a fresh
    interpreter of this script, never a fork of this process."""
    script = os.path.abspath(__file__)
    return [subprocess.Popen([sys.executable, script, flag, *a],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True,
                             cwd=os.path.dirname(script))
            for a in args_list]


def run_children(args_list):
    """Start the children together and collect them
    (:func:`collect_children`)."""
    return collect_children(start_children(args_list))


def collect_children(procs, killed=()):
    """Wait for each child under MP_CHILD_TIMEOUT_S, kill any left; on a
    failure print each child's stderr and raise.  Returns their RESULT
    objects.  The children at the indices ``killed`` must have died by
    SIGKILL (their result is None): anywhere else a SIGKILL is a
    failure."""
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=MP_CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                err += f"\n[timed out after {MP_CHILD_TIMEOUT_S} s]"
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for i, (rc, out, err) in enumerate(outs):
        if i in killed and rc == -signal.SIGKILL:
            results.append(None)
            continue
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        if rc != 0 or not line or i in killed:
            for i, (_, _, e) in enumerate(outs):
                print(f"--- child {i} stderr ---\n{e[-6000:]}",
                      file=sys.stderr, flush=True)
            raise AssertionError(f"multiprocess: a child failed (rc {rc})")
        results.append(json.loads(line[-1][len("RESULT "):]))
    return results


def multiprocess(port, fk, smi, paths, launches):
    """Phase 42, inside phase 11 while phase 34's part files exist: two
    processes on the one card in a gloo group
    (``multihost.initialize(backend="gloo")``: NCCL refuses two ranks on
    one device), each reading its 4 of the 8 rcv1-like part files with
    ``from_partitioned_files_csr`` onto a 4-slot mesh across them
    (MP_ITERS iterations of logistic AGD); both ranks' histories and
    weights bit-equal, and held to the one-process fit on all 8 files
    over the iterations before they part (rtol 1e-4).  Then a one-rank
    NCCL group fitting phase 39's problem on MP_NCCL_ROWS rows, its
    combine through the group's all-gather, held to the same fit without
    a mesh.  Every child runs under a timeout; its stderr is printed on a
    failure."""
    from spark_agd_tpu_torch.data import ingest
    from spark_agd_tpu_torch.parallel import mesh as mesh_lib

    t_phase = time.perf_counter()
    parts_dir = os.path.dirname(paths[0])
    addr = f"localhost:{_free_port()}"
    (r0, r1), gloo_s = timed(lambda: run_children(
        [("gloo", addr, "2", str(r), parts_dir) for r in range(2)]))
    d = RCV1["d"]
    mesh = card_mesh(mesh_lib, 4)
    batch = ingest.from_partitioned_files_csr(paths, mesh, n_features=d)
    w0 = torch.zeros(d, dtype=torch.float32, device="cuda")
    _, hist_ref, res_ref = port.run(
        batch, port.LogisticGradient(), port.L2Prox(), reg_param=RCV1["reg"],
        num_iterations=MP_ITERS, convergence_tol=TOL, initial_weights=w0,
        return_result=True)
    del batch
    hist = np.array([float.fromhex(v) for v in r0["hist"]])
    l_mp = np.array([float.fromhex(v) for v in r0["diag_l"]])
    n_common = min(len(hist), int(res_ref.num_iters))
    l_ref = res_ref.diag_l[:n_common].double().numpy()
    parted = ~np.isclose(l_mp[:n_common], l_ref, rtol=1e-4, atol=0.0)
    n_path = int(np.argmax(parted)) - 1 if parted.any() else n_common
    fk.reset_launch_counts()
    (nccl,), nccl_s = timed(lambda: run_children(
        [("nccl", f"localhost:{_free_port()}", "1", "0", "-")]))
    launches["multiprocess"] = nccl["kernel_launches"]
    launches.setdefault("modes", {})["multiprocess"] = {
        "stream": nccl["kernel_launches"]}
    out = {"parts": len(paths), "gloo_ranks": 2, "slots_per_rank": 2,
           "gloo_wall_s": gloo_s, "rank_fit_s": [r0["fit_s"], r1["fit_s"]],
           "rank_ingest_s": [r0["ingest_s"], r1["ingest_s"]],
           "rows": r0["rows"], "num_iters": r0["iters"],
           "common_path_iterations": n_path,
           "max_hist_rel_diff_vs_one_process": float(np.max(
               np.abs(hist[:n_path] - hist_ref[:n_path])
               / np.abs(hist_ref[:n_path]))) if n_path > 0 else None,
           "loss_history": hist.tolist(),
           "one_process_loss_history": hist_ref.tolist(),
           "nccl_wall_s": nccl_s, "nccl_fit_s": nccl["fit_s"],
           "nccl_shape": [MP_NCCL_ROWS, D_MAIN],
           "nccl_kernel_launches": nccl["kernel_launches"],
           "nccl_mesh_evaluations": nccl["mesh_evaluations"],
           "nccl_max_hist_rel_diff_vs_single_device":
               nccl["max_hist_rel_diff_vs_single_device"]}
    checks = {
        "ranks_bit_equal": (r0["hist"], r0["diag_l"], r0["w_sha256"])
        == (r1["hist"], r1["diag_l"], r1["w_sha256"]),
        "ranks_in_a_group_of_2": (r0["world"], r1["world"]) == (2, 2),
        "iterations": r0["iters"] == int(res_ref.num_iters) == MP_ITERS,
        "common_path_of_3_iterations_or_more": n_path >= 3,
        "history_rtol_1e-4_vs_one_process_on_the_common_path": bool(
            np.allclose(hist[:n_path], hist_ref[:n_path], rtol=1e-4,
                        atol=0.0)),
        "slot_evaluations": r0["slot_evaluations"]
        == 2 * r0["mesh_evaluations"] > 0,
        "nccl_group_of_1": nccl["world"] == 1,
        "nccl_launches_a_slot_an_evaluation": nccl["kernel_launches"]
        == nccl["slot_evaluations"] == 2 * nccl["mesh_evaluations"] > 0,
        "nccl_history_rtol_1e-4_vs_single_device":
            nccl["history_rtol_1e-4_vs_single_device"],
        "finite": bool(np.isfinite(hist).all())}
    finish("multiprocess", out, checks, t_phase, smi)


# ---------------------------------------------------------------------------
# Phases 43-45: multi-host resilience
# ---------------------------------------------------------------------------

# phase 43: phase 5's fit with a generation committed every SUP_SEGMENT
# iterations (DIST_KEEP kept), a SIGTERM at SUP_SIGTERM_AT
DIST_KEEP = 2
# phases 44-45: covtype.binary's published size and width, made on the
# card and written as DRILL_PARTS LIBSVM part files; two gloo ranks, 2
# slots a rank, ITERS iterations of the flagship's fit in segments of
# DRILL_SEGMENT, a generation committed every segment; rank 1 killed at
# the boundary of DRILL_KILL_AT; the parent's HostMonitor window
DRILL = dict(n=581_012, d=54, seed=11)
DRILL_PARTS, DRILL_SEGMENT, DRILL_KILL_AT, DRILL_STALE_S = 8, 5, 15, 2.0
# phase 45: fits of STRAGGLER_ITERS iterations, under where the f32 fit
# stops on its own (its iterate frozen: 20 iterations on this data), so
# every fit compared runs as many iterations, and a multiple of
# DRILL_SEGMENT, so phase 44 (a) has a generation there; segments of
# STRAGGLER_SEGMENT; rank 1 sleeps STRAGGLER_SLOW_S at every boundary,
# scaled by its share of the parts; the scheduler decides after 2 syncs
# over threshold; the monitor's window
STRAGGLER_SEGMENT, STRAGGLER_ITERS = 1, 15
STRAGGLER_SLOW_S, STRAGGLER_STALE_S = 0.6, 5.0


def time_calls(obj, name):
    """Wrap the method ``obj.name`` so that each call's wall seconds land
    in the returned list."""
    seconds, call = [], getattr(obj, name)

    def timed_call(*a, **kw):
        t0 = time.perf_counter()
        try:
            return call(*a, **kw)
        finally:
            seconds.append(time.perf_counter() - t0)

    setattr(obj, name, timed_call)
    return seconds


def dist_ckpt_fit(port, fk, smi, X, y, solo, launches):
    """Phase 43, on phase 5's data: the flagship fit checkpointed in
    barrier-committed generations on one process.  (a) ``run(...,
    resilience=, checkpointer=DistributedCheckpointer(every_iters=5))``,
    then ``run_agd_supervised`` with the same checkpointer kind and a
    ``HeartbeatWriter``, a ``HostMonitor`` and a ``StragglerScheduler``,
    each STEADY_RUNS times in turns with as many plain ``run``s of the
    same fit: every one gives phase 5's bits, and each fit's median wall
    time is held to 1.1x the plain runs' median; each generation's shard write and commit (the exchange
    and the manifest writes, on the checkpointer's writer thread), the
    time each save held the fit, and each beat and monitor check are
    timed; (b) a scripted SIGTERM at SUP_SIGTERM_AT flushes a
    generation and raises ``Preempted``; the newest committed shard is
    truncated, ``load_for_topology`` refuses it and falls back one
    generation, and ``run`` resumes from there to (a)'s bits.  Every
    launch the margin kernel's stream mode."""
    from spark_agd_tpu_torch import resilience
    from spark_agd_tpu_torch.core import smooth as smooth_lib

    t_phase = time.perf_counter()
    w0 = torch.zeros(D_MAIN, dtype=torch.float32, device="cuda")
    policy = sup_policy(port, segment_iters=SUP_SEGMENT)
    fused = counting(port.FusedLogisticGradient)()
    kw = dict(reg_param=REG, num_iterations=ITERS, convergence_tol=TOL,
              initial_weights=w0, return_result=True)
    res5, hist5, run5_s = solo
    tmp = shm_dir("chip_smoke_dist_")

    def checkpointer(name):
        return resilience.DistributedCheckpointer(
            os.path.join(tmp, name), every_iters=SUP_SEGMENT, keep=DIST_KEEP)

    try:
        fk.reset_launch_counts()
        staged = smooth_lib.make_smooth_staged(fused, X, y)
        px, rv = smooth_lib.make_prox(port.SquaredL2Updater(), REG)
        cfg = port.AGDConfig(convergence_tol=TOL, num_iterations=ITERS)
        cks_a = [checkpointer(f"a{i}") for i in range(STEADY_RUNS)]
        cks_h = [checkpointer(f"h{i}") for i in range(STEADY_RUNS)]
        hbs, monitors, scheds, beat_s, check_s = [], [], [], [], []
        for i in range(STEADY_RUNS):
            hb_dir = os.path.join(tmp, f"hb{i}")
            hbs.append(resilience.HeartbeatWriter(hb_dir))
            monitors.append(resilience.HostMonitor(hb_dir))
            beat_s.append(time_calls(hbs[i], "beat"))
            check_s.append(time_calls(monitors[i], "check"))
            scheds.append(resilience.StragglerScheduler(["flagship"]))
        # (a) and the hooks' fit in turns with a plain run of the same
        # fit, each with fresh generations and heartbeats
        walls, outs = alternating_walls(
            lambda: port.run((X, y), fused, port.SquaredL2Updater(), **kw),
            {"a": lambda i: port.run(
                (X, y), fused, port.SquaredL2Updater(), resilience=policy,
                checkpointer=cks_a[i], **kw),
             "hooks": lambda i: resilience.run_agd_supervised(
                 prox=px, reg_value=rv, w0=w0, config=cfg, policy=policy,
                 staged=staged, checkpointer=cks_h[i], heartbeat=hbs[i],
                 monitor=monitors[i], scheduler=scheds[i])})
        w_a, hist_a, _ = outs["a"][0]
        ck_a, run_a_s = cks_a[0], walls["a"][0]
        ck_h, run_h_s = cks_h[0], walls["hooks"][0]
        last_beats = [json.loads(open(h.path).read()) for h in hbs]

        dir_b = os.path.join(tmp, "b")
        t0 = time.perf_counter()
        preempted = False
        try:
            resilience.run_agd_supervised(
                prox=px, reg_value=rv, w0=w0, config=cfg, policy=policy,
                staged=staged, checkpointer=checkpointer("b"),
                faults=resilience.FaultScript(sigterm_at_iter=SUP_SIGTERM_AT))
        except resilience.Preempted:
            preempted = True
        killed_s = time.perf_counter() - t0
        gens = resilience.manifest.committed_generations(dir_b)
        newest = resilience.manifest.load_manifest(dir_b, gens[0])
        torn_bytes = resilience.faults.truncate_file(
            newest.shard_path(dir_b, 0), 0.4)
        fallback = resilience.load_for_topology(dir_b, w0)
        ck_b = checkpointer("b")
        (w_b, hist_b, sres_b), resume_b_s = timed(lambda: port.run(
            (X, y), fused, port.SquaredL2Updater(), resilience=policy,
            checkpointer=ck_b, **kw))
        record_margin_path(fk, launches, "dist_ckpt_fit")
        other = fk.lanes_launch_count + fk.softmax_launch_count
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    modes = launches["modes"]["dist_ckpt_fit"]
    ms = lambda ts: [t * 1e3 for t in ts]  # noqa: E731
    held_a = sum(ck_a.copy_seconds) + sum(ck_a.save_seconds)
    held_h = (sum(ck_h.copy_seconds) + sum(ck_h.save_seconds)
              + sum(beat_s[0]) + sum(check_s[0]))
    checks = {
        "a_weights_bit_identical_to_phase5": all(
            torch.equal(o[0], res5.weights) for o in outs["a"] + outs["plain"]),
        "a_history_bit_identical_to_phase5": all(
            np.array_equal(o[1], hist5) for o in outs["a"] + outs["plain"]),
        # each the median of STEADY_RUNS fits over that of as many plain
        # runs of the same fit, timed in turns in this phase
        "a_within_1.1x_phase5_wall": median_ratio(walls, "a") <= 1.1,
        "a_generation_a_segment": all(
            ck.saves == ITERS // SUP_SEGMENT + 2 for ck in cks_a),
        "hooks_weights_bit_identical_to_phase5": all(
            torch.equal(o.weights, res5.weights) for o in outs["hooks"]),
        "hooks_history_bit_identical_to_phase5": all(
            np.array_equal(o.loss_history, hist5) for o in outs["hooks"]),
        "hooks_within_1.1x_phase5_wall": median_ratio(walls, "hooks") <= 1.1,
        "hooks_beat_every_boundary_and_at_exit": all(
            h.beats == ITERS // SUP_SEGMENT + 1 and last["phase"] == "exit"
            for h, last in zip(hbs, last_beats)),
        "hooks_no_rebalance_on_one_process": all(
            sc.rebalances == 0 for sc in scheds),
        "b_preempted": preempted,
        "b_newest_generation_at_the_signal":
            newest.prior_iters == SUP_SIGTERM_AT,
        "b_torn_generation_refused_one_back":
            fallback is not None and fallback.generation == gens[1],
        "b_resumes_from_the_fallback":
            sres_b.resumed_from == fallback.warm.prior_iters > 0,
        "b_weights_bit_identical_to_a": bool(torch.equal(w_b, w_a)),
        "b_history_bit_identical_to_a": bool(np.array_equal(hist_b,
                                                            hist_a)),
        "launches_equal_evaluations": launches["dist_ckpt_fit"]
        == fused.evaluations > 0,
        "every_launch_stream": modes == {"stream":
                                         launches["dist_ckpt_fit"]},
        "no_other_kernel": other == 0}
    finish("dist_ckpt_fit", {
        "shape": [N_MAIN, D_MAIN], "segment_iters": SUP_SEGMENT,
        "every_iters": SUP_SEGMENT, "keep": DIST_KEEP,
        "phase5_run_s": run5_s, "a_run_s": run_a_s,
        "a_run_s_samples": walls["a"], "hooks_run_s_samples": walls["hooks"],
        "plain_run_s_samples": walls["plain"],
        "a_over_plain_median_wall": median_ratio(walls, "a"),
        "hooks_over_plain_median_wall": median_ratio(walls, "hooks"),
        "a_held_s": held_a,
        "a_generations": ck_a.saves,
        "a_d2h_ms_per_update": ms(ck_a.copy_seconds),
        "a_save_held_ms": ms(ck_a.save_seconds),
        "a_shard_write_ms": ms(ck_a.write_seconds),
        "a_commit_ms": ms(ck_a.commit_seconds),
        "a_held_share_of_wall": held_a / run_a_s,
        "hooks_run_s": run_h_s, "hooks_held_s": held_h,
        "hooks_beat_ms": ms(beat_s[0]), "hooks_check_ms": ms(check_s[0]),
        "hooks_save_held_ms": ms(ck_h.save_seconds),
        "hooks_shard_write_ms": ms(ck_h.write_seconds),
        "hooks_commit_ms": ms(ck_h.commit_seconds),
        "hooks_beats": hbs[0].beats,
        "b_killed_run_s": killed_s, "b_generations": gens,
        "b_newest_prior_iters": newest.prior_iters,
        "b_truncated_to_bytes": torn_bytes,
        "b_fallback_generation": fallback.generation,
        "b_resumed_from": sres_b.resumed_from, "b_resume_run_s": resume_b_s,
        "launches": launches["dist_ckpt_fit"], "modes": modes,
        "smooth_evaluations": fused.evaluations}, checks, t_phase, smi)


def parse_parts(port, paths, cache=None):
    """The parts not in ``cache`` parsed, the native parser on a thread a
    part (it releases the GIL), and added to it: path -> ``CSRData``."""
    cache = {} if cache is None else cache
    todo = [p for p in paths if p not in cache]
    if todo:
        with concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
            cache.update(zip(todo, pool.map(
                lambda p: port.load_libsvm(p, n_features=DRILL["d"]),
                todo)))
    return cache


def drill_batch(port, mesh, paths, cache, assignment=None, pad=None):
    """``from_partitioned_files`` over the parts onto ``mesh`` (parsed
    parts from ``cache``, others parsed and added)."""
    from spark_agd_tpu_torch.data import ingest

    def loader(path, n_features=None):
        if path not in cache:
            cache[path] = port.load_libsvm(path, n_features=n_features)
        return cache[path]

    return ingest.from_partitioned_files(
        paths, mesh, n_features=DRILL["d"], loader=loader,
        assignment=assignment, pad_to_rows=pad)


def drill_staged(port, mesh, paths, cache, assignment=None, pad=None):
    """:func:`drill_batch` staged for the flagship's fused gradient over
    ``mesh``."""
    from spark_agd_tpu_torch.parallel import dist_smooth

    return dist_smooth.make_dist_smooth_staged(
        port.FusedLogisticGradient(),
        drill_batch(port, mesh, paths, cache, assignment, pad), mesh=mesh)


def drill_fit(port, staged, segment, iters=ITERS, **kw):
    """The drill's supervised fit: the flagship's AGD (reg 0.1, ``iters``
    iterations, tol 0) over ``staged`` in segments of ``segment``."""
    from spark_agd_tpu_torch import resilience
    from spark_agd_tpu_torch.core import smooth as smooth_lib

    px, rv = smooth_lib.make_prox(port.SquaredL2Updater(), REG)
    w0 = torch.zeros(DRILL["d"], dtype=torch.float32, device="cuda")
    return resilience.run_agd_supervised(
        prox=px, reg_value=rv, w0=w0, config=drill_config(port, iters),
        policy=sup_policy(port, segment_iters=segment), staged=staged, **kw)


def drill_config(port, iters=ITERS):
    return port.AGDConfig(convergence_tol=TOL, num_iterations=iters)


def drill_fingerprint(port, iters=ITERS):
    from spark_agd_tpu_torch.utils import checkpoint as ckpt

    w0 = torch.zeros(DRILL["d"], dtype=torch.float32, device="cuda")
    return ckpt.problem_fingerprint(w0, drill_config(port, iters))


def drill_child(port, mesh, parts_dir, spec):
    """One rank's fits in phases 44-45 (``--drill JSON``).  ``kind``
    "base": the supervised fit over its round-robin half of the parts, a
    generation committed into ``work/ck`` every segment, heartbeats into
    ``work/hb``; "killed": the same, rank 1 SIGKILLing itself at the
    boundary of ``kill_at``; "straggler": two fits in segments of
    STRAGGLER_SEGMENT, rank 1 sleeping ``slow_s`` at every boundary
    (a persistent ``slow_host``, scaled by its share of the parts,
    beating ``"slow"``), first with an observe-only scheduler, then with
    a ``StragglerScheduler`` that rebuilds the data for ``decision.mine``
    with ``from_partitioned_files(assignment=, pad_to_rows=)``, then with
    no straggler and the same decisions replayed at the same
    boundaries; "sharded": the flagship's AGD with the plain gradient
    and ``sharded_update=True`` over its half of the parts, SHARDED_ITERS
    iterations, and the rank's census of collectives."""
    import glob

    from spark_agd_tpu_torch import resilience
    from spark_agd_tpu_torch.data import ingest
    from spark_agd_tpu_torch.ops import fused_kernels as fk
    from spark_agd_tpu_torch.parallel import mesh as mesh_lib
    from spark_agd_tpu_torch.parallel import multihost as mh

    rank, world = mh.process_index(), mh.process_count()
    paths = sorted(glob.glob(os.path.join(parts_dir, "part-*")))
    mine = ingest.local_partitions(paths)
    (cache, parse_s) = timed(lambda: parse_parts(port, mine))
    staged, ingest_s = timed(lambda: drill_staged(port, mesh, paths, cache))
    fk.reset_launch_counts()

    def fit(work, segment, iters=ITERS, **kw):
        hb = resilience.HeartbeatWriter(os.path.join(work, "hb"))
        ck = resilience.DistributedCheckpointer(
            os.path.join(work, "ck"), every_iters=segment, keep=spec["keep"],
            fingerprint=drill_fingerprint(port, iters),
            mesh_shape=dict(mesh.shape), partitions=mine)
        res, fit_s = timed(lambda: drill_fit(
            port, staged, segment, iters, checkpointer=ck, heartbeat=hb,
            **kw))
        return {"hist": _hexes(res.loss_history),
                "w": _hexes(res.weights.cpu()), "iters": int(res.num_iters),
                "fit_s": fit_s, "beats": hb.beats,
                "shard_write_ms": [t * 1e3 for t in ck.write_seconds],
                "commit_ms": [t * 1e3 for t in ck.commit_seconds]}

    out = {"parse_s": parse_s, "ingest_s": ingest_s,
           "rows": sum(len(cache[p].labels) for p in mine)}
    if spec["kind"] == "sharded":
        mh.reset_census()
        w0 = torch.zeros(DRILL["d"], dtype=torch.float32, device="cuda")
        (w, hist, res), fit_s = timed(lambda: port.run(
            drill_batch(port, mesh, paths, cache), port.LogisticGradient(),
            port.SquaredL2Updater(), reg_param=REG,
            num_iterations=SHARDED_ITERS, convergence_tol=TOL,
            initial_weights=w0, sharded_update=True, return_result=True))
        out.update(hist=_hexes(hist), w=_hexes(w.cpu()),
                   iters=int(res.num_iters), fit_s=fit_s,
                   census=dict(mh.census))
    elif spec["kind"] in ("base", "killed"):
        faults = (resilience.FaultScript(sigkill_at_iter=spec["kill_at"])
                  if spec["kind"] == "killed" and rank == 1 else None)
        out.update(fit(spec["work"], DRILL_SEGMENT, faults=faults))
    else:
        rows_of = dict(zip(paths, spec["part_rows"]))
        rebuilt = []  # (decision, what the rebuild did)

        def rebuild(decision):
            pad = max(sum(rows_of[p] for p in a)
                      for a in decision.assignments)
            slots = mesh.local_shape[mesh_lib.DATA_AXIS]
            pad = -(-pad // slots) * slots
            new, dt = timed(lambda: drill_staged(
                port, mesh, paths, parse_parts(port, decision.mine, cache),
                list(decision.mine), pad))
            rebuilt.append((decision, {
                "at_iter": decision.at_iter,
                "assignments": decision.assignments, "skew": decision.skew,
                "straggler": decision.straggler, "rebuild_s": dt,
                "pad_to_rows": pad}))
            return new

        for name, rebalance in (("observe", False), ("rebalance", True)):
            sched = resilience.StragglerScheduler(
                paths, policy=resilience.ReschedulePolicy(
                    trigger_segments=2, min_shard=1, rebalance=rebalance),
                rebuild=rebuild if rebalance else None)
            scales = []  # each sleep's scale: its share over an even one

            def scale(s=sched):
                scales.append(len(s.assignment) * world / len(s.union))
                return scales[-1]

            chaos = (resilience.ChaosSchedule(
                [resilience.ScheduledFault("slow_host", 0,
                                           payload=spec["slow_s"],
                                           persist=True)],
                slow_scale=scale) if rank == 1 else None)
            out[name] = fit(os.path.join(spec["work"], name),
                            STRAGGLER_SEGMENT, STRAGGLER_ITERS,
                            faults=chaos, scheduler=sched)
            out[name].update(rebalances=sched.rebalances,
                             assignment=sched.assignment,
                             slow_sleeps=len(chaos.fired) if chaos else 0,
                             slow_scales=scales)
        made = list(rebuilt)
        out["rebalance"]["rebuilt"] = [info for _, info in made]
        # the rebalanced fit's data schedule with no straggler: the same
        # decisions applied at the same boundaries
        out["scripted"] = fit(os.path.join(spec["work"], "scripted"),
                              STRAGGLER_SEGMENT, STRAGGLER_ITERS,
                              scheduler=_Scripted(
                                  [d for d, _ in made], rebuild))
    out.update(launches=fk.launch_count, modes=margin_modes(fk))
    return out


class _Scripted:
    """A scheduler that applies recorded ``RebalanceDecision``s at the
    boundaries they were made at, with no exchange: a straggler's
    rebalances replayed on a fit without the straggler."""

    def __init__(self, decisions, rebuild):
        self.decisions, self.rebuild = list(decisions), rebuild

    def after_segment(self, *, start_iter, iters, boundary_s,
                      segment_s=None):
        return next((d for d in self.decisions
                     if d.at_iter == start_iter + iters), None)

    def apply(self, decision, *, checkpointer=None):
        checkpointer.partitions = list(decision.mine)
        return self.rebuild(decision)


def _unhex(values):
    return np.array([float.fromhex(v) for v in values])


def drill_args(addr, parts_dir, spec):
    return [("gloo", addr, "2", str(r), parts_dir, "--drill",
             json.dumps(spec)) for r in range(2)]


def dist_fault_drill(port, fk, smi, device_synth, launches):
    """Phase 44: covtype.binary's published size (DRILL: 581,012 x 54
    f32) made on the card from its seed and written as DRILL_PARTS
    LIBSVM part files; two pairs of gloo ranks on the card at once
    (``--mp-child ... --drill``), each rank reading its 4 parts with
    ``from_partitioned_files`` onto a 2-slot mesh, the fused gradient in
    its warp-rows mode: (a) the uninterrupted supervised fit, a
    generation committed every DRILL_SEGMENT iterations and heartbeats,
    the ranks bit-equal; (b) the same fit, rank 1 SIGKILLing itself at
    DRILL_KILL_AT: the parent's ``HostMonitor`` raises ``HostLost`` from
    the dead rank's heartbeat alone (the detection latency from its last
    beat) and reaps the survivor; the parent truncates the newest
    generation's shard, ``load_for_topology`` on one process refuses it
    and falls back one generation, and one process resumes elastically
    (2 -> 1, the 8 parts re-split by ``reshard_partitions``) to (a)'s
    final loss (rtol 1e-5, the port's f32 mesh tolerance) and history
    over their common iterations; (c) from the same generation, a
    ``DegradedCheckpointer(surviving=[0])`` continuation on rank 0's
    parts only, bit-equal to an uninterrupted fit over those parts from
    the same iterate.  Then phase 45 on the same files."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_drill_")
    try:
        parts_dir, part_rows, base = _dist_fault_drill(
            port, fk, smi, device_synth, launches, tmp)
        straggler_rebalance(port, fk, smi, parts_dir, part_rows, base,
                            launches, os.path.join(tmp, "s"))
        # 47 (b). the sharded update over two gloo ranks
        sharded_update_mp(port, fk, smi, parts_dir, launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _dist_fault_drill(port, fk, smi, device_synth, launches, tmp):
    """Phase 44 in ``tmp``; returns the part directory, each part's rows
    and (a)'s history and weights at STRAGGLER_ITERS (its generation
    there) for phase 45."""
    from spark_agd_tpu_torch import resilience
    from spark_agd_tpu_torch.core import agd, smooth as smooth_lib
    from spark_agd_tpu_torch.parallel import mesh as mesh_lib
    from spark_agd_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    parts_dir = os.path.join(tmp, "parts")
    os.makedirs(parts_dir)
    X, y = device_synth.class_logistic(DRILL["n"], DRILL["d"],
                                       seed=DRILL["seed"])
    (paths, part_rows), write_s = timed(lambda: write_parts(
        X, y, DRILL_PARTS, parts_dir))
    del X, y
    torch.cuda.empty_cache()
    file_mb = sum(os.path.getsize(p) for p in paths) / 1e6
    base_dir, killed_dir = (os.path.join(tmp, k) for k in ("a", "b"))
    t0 = time.perf_counter()
    base = start_children(drill_args(
        f"localhost:{_free_port()}", parts_dir,
        {"kind": "base", "work": base_dir, "keep": 8}))
    killed = start_children(drill_args(
        f"localhost:{_free_port()}", parts_dir,
        {"kind": "killed", "work": killed_dir, "keep": 4,
         "kill_at": DRILL_KILL_AT}))
    try:
        victim_rc = killed[1].wait(timeout=MP_CHILD_TIMEOUT_S)
        t_exit = time.time()
        if victim_rc != -signal.SIGKILL:
            print(killed[1].stderr.read()[-6000:], file=sys.stderr,
                  flush=True)
        monitor = resilience.HostMonitor(
            os.path.join(killed_dir, "hb"), expected=[1],
            stale_after_s=DRILL_STALE_S)
        lost, deadline = None, time.monotonic() + 60
        while lost is None and time.monotonic() < deadline:
            try:
                monitor.check()
                time.sleep(0.05)
            except resilience.HostLost as e:
                lost, t_lost = e, time.time()
        last_beat = json.loads(open(os.path.join(
            killed_dir, "hb", "heartbeat.h001.json")).read())
        survivor_alive = killed[0].poll() is None
        if survivor_alive:
            killed[0].kill()
        survivor_out, survivor_err = killed[0].communicate(timeout=60)
        killed_s = time.perf_counter() - t0
        r0, r1 = collect_children(base)
        base_s = time.perf_counter() - t0
    finally:
        for p in base + killed:
            if p.poll() is None:
                p.kill()
                p.wait()
    if lost is None:
        print(survivor_err[-6000:], file=sys.stderr, flush=True)
        raise AssertionError("dist_fault_drill: no HostLost from the "
                             "dead rank's heartbeat")

    base_ck = os.path.join(base_dir, "ck")
    base_newest = resilience.manifest.load_manifest(base_ck)
    # (a) at STRAGGLER_ITERS, phase 45's reference: its generation there
    base_at = next(m for g in resilience.manifest.committed_generations(
        base_ck) if (m := resilience.manifest.load_manifest(
            base_ck, g)).prior_iters == STRAGGLER_ITERS)
    base_at = ckpt.read_npz_entries(base_at.shard_path(base_ck, 0))
    base_at = {"hist": _hexes(base_at["loss_history"]),
               "w": _hexes(base_at["x_0"])}
    ck_dir = os.path.join(killed_dir, "ck")
    gens = resilience.manifest.committed_generations(ck_dir)
    newest = resilience.manifest.load_manifest(ck_dir, gens[0])
    torn_bytes = resilience.faults.truncate_file(
        newest.shard_path(ck_dir, 0), 0.4)
    w0 = torch.zeros(DRILL["d"], dtype=torch.float32, device="cuda")
    fp = drill_fingerprint(port)
    fallback = resilience.load_for_topology(
        ck_dir, w0, process_index=0, process_count=1, fingerprint=fp)
    degraded_dir = os.path.join(tmp, "c")
    shutil.copytree(ck_dir, degraded_dir)
    mesh = card_mesh(mesh_lib, 2)
    cache, parse_s = timed(lambda: parse_parts(port, paths))
    fk.reset_launch_counts()
    ck = resilience.DistributedCheckpointer(
        ck_dir, every_iters=DRILL_SEGMENT, keep=4, fingerprint=fp,
        process_index=0, process_count=1)
    elastic, elastic_s = timed(lambda: drill_fit(
        port, drill_staged(port, mesh, paths, cache,
                           list(fallback.partitions)),
        DRILL_SEGMENT, checkpointer=ck))
    dck = resilience.DegradedCheckpointer(
        degraded_dir, surviving=[0], original_process_index=0,
        every_iters=DRILL_SEGMENT, keep=4, fingerprint=fp)
    dl = dck.load(w0)
    staged = drill_staged(port, mesh, paths, cache, list(dl.partitions))
    degraded, degraded_s = timed(lambda: drill_fit(
        port, staged, DRILL_SEGMENT, checkpointer=dck))
    sm, sl = staged[0](*staged[1])
    px, rv = smooth_lib.make_prox(port.SquaredL2Updater(), REG)
    ref = agd.run_agd(sm, px, rv, dl.warm.x, dataclasses.replace(
        drill_config(port), num_iterations=ITERS - dl.warm.prior_iters),
        smooth_loss=sl, warm=dl.warm)
    parent_launches, parent_modes = fk.launch_count, margin_modes(fk)
    del cache, staged, sm, sl
    torch.cuda.empty_cache()

    hist_a = _unhex(r0["hist"])
    n_common = min(len(hist_a), len(elastic.loss_history))
    n_ref = int(ref.num_iters)
    ref_hist = ref.loss_history[:n_ref].cpu().numpy()
    launches["dist_fault_drill"] = (r0["launches"] + r1["launches"]
                                    + parent_launches)
    modes = {}
    for m in (r0["modes"], r1["modes"], parent_modes):
        for k, v in m.items():
            modes[k] = modes.get(k, 0) + v
    launches["modes"]["dist_fault_drill"] = modes
    checks = {
        "a_ranks_bit_equal": (r0["hist"], r0["w"]) == (r1["hist"],
                                                      r1["w"]),
        "a_iterations_past_the_kill": r0["iters"] > DRILL_KILL_AT,
        "a_final_state_committed": (base_newest.prior_iters,
                                    base_newest.process_count)
        == (r0["iters"], 2),
        "a_history_committed_at_phase45_iters":
            base_at["hist"] == r0["hist"][:STRAGGLER_ITERS],
        "a_rows_of_the_dataset": r0["rows"] + r1["rows"] == DRILL["n"],
        "b_victim_died_by_sigkill": victim_rc == -signal.SIGKILL,
        "b_host_lost_from_heartbeats": lost.process_index == 1,
        "b_last_beat_at_the_kill": last_beat["iter"] == DRILL_KILL_AT,
        "b_survivor_did_not_finish": "RESULT " not in survivor_out,
        "b_newest_generation_at_the_kill":
            newest.prior_iters == DRILL_KILL_AT,
        "b_torn_generation_refused_one_back":
            fallback.generation == gens[1] and fallback.elastic,
        "b_elastic_all_parts": tuple(fallback.partitions)
        == tuple(sorted(paths)),
        "b_resumed_from_the_fallback":
            elastic.resumed_from == fallback.warm.prior_iters > 0,
        "b_final_loss_rtol_1e-5_vs_a": bool(np.isclose(
            elastic.loss_history[-1], hist_a[-1], rtol=1e-5, atol=0.0)),
        "b_history_rtol_1e-5_vs_a_on_common_iterations": bool(np.allclose(
            elastic.loss_history[:n_common], hist_a[:n_common], rtol=1e-5,
            atol=0.0)),
        "c_same_generation_as_b": dl.generation == fallback.generation,
        "c_rank0_parts_only": tuple(dl.partitions)
        == tuple(sorted(paths)[0::2]),
        "c_dropped_rank1_parts": dck.dropped_partitions
        == tuple(sorted(paths)[1::2]),
        "c_weights_bit_equal_to_uninterrupted": bool(torch.equal(
            degraded.weights, ref.weights)),
        "c_history_bit_equal_to_uninterrupted": bool(np.array_equal(
            degraded.loss_history[dl.warm.prior_iters:], ref_hist)),
        "every_launch_warp_rows": set(modes) == {"warp_rows"},
        "finite": bool(np.isfinite(elastic.loss_history).all()
                       and np.isfinite(degraded.loss_history).all())}
    finish("dist_fault_drill", {
        "shape": [DRILL["n"], DRILL["d"]], "parts": len(paths),
        "part_rows": part_rows, "file_mb": file_mb, "write_s": write_s,
        "gloo_ranks": 2, "slots_per_rank": 2, "segment_iters": DRILL_SEGMENT,
        "a_rank_parse_s": [r0["parse_s"], r1["parse_s"]],
        "a_rank_ingest_s": [r0["ingest_s"], r1["ingest_s"]],
        "a_rank_fit_s": [r0["fit_s"], r1["fit_s"]],
        "a_shard_write_ms": r0["shard_write_ms"],
        "a_commit_ms": [r0["commit_ms"], r1["commit_ms"]],
        "a_children_wall_s": base_s,
        "a_num_iters": r0["iters"], "a_loss_last": float(hist_a[-1]),
        "b_kill_at": DRILL_KILL_AT, "b_victim_rc": victim_rc,
        "b_stale_after_s": DRILL_STALE_S,
        "b_detection_s_from_last_beat": t_lost - last_beat["time"],
        "b_detection_s_from_exit": t_lost - t_exit,
        "b_survivor_alive_at_detection": survivor_alive,
        "b_survivor_rc": killed[0].returncode,
        "b_children_wall_s": killed_s, "b_generations": gens,
        "b_truncated_to_bytes": torn_bytes,
        "b_fallback_generation": fallback.generation,
        "b_resumed_from": elastic.resumed_from, "b_resume_run_s": elastic_s,
        "b_parent_parse_s": parse_s,
        "b_loss_last": float(elastic.loss_history[-1]),
        "b_final_loss_rel_diff_vs_a": float(abs(
            elastic.loss_history[-1] - hist_a[-1]) / abs(hist_a[-1])),
        "c_generation": dl.generation, "c_resumed_from": degraded.resumed_from,
        "c_run_s": degraded_s, "c_dropped_parts": len(dck.dropped_partitions),
        "c_loss_last": float(degraded.loss_history[-1]),
        "launches": launches["dist_fault_drill"], "modes": modes},
        checks, t_phase, smi)
    return parts_dir, part_rows, base_at


def straggler_rebalance(port, fk, smi, parts_dir, part_rows, base,
                        launches, work):
    """Phase 45, on phase 44's files: two gloo ranks (``--drill``
    "straggler"), rank 1 sleeping STRAGGLER_SLOW_S at every boundary
    times its share of the parts (``ChaosSchedule(slow_scale=)``, its
    heartbeat beating ``"slow"`` through each sleep), each rank running
    the fit with an observe-only ``StragglerScheduler``, then with one
    that rebalances and rebuilds its data for ``decision.mine``
    (``from_partitioned_files(assignment=, pad_to_rows=)``), then with
    no straggler and the same decisions applied at the same boundaries;
    each fit STRAGGLER_ITERS iterations.  At least one rebalance,
    committed in the generation right after it (every shard carrying its
    process's new parts); the rebalanced fit bit-equal to that last fit
    (the same rows on every slot at every iteration), its final loss and
    history within rtol 1e-5 of phase 44 (a) at STRAGGLER_ITERS (the
    same objective, the rows summed in another order; its weights'
    distance reported); the observe-only fit bit-equal to 44 (a) there;
    the rebalanced fit's wall time below the observe-only one's, and the
    straggler size where the sleep it saves pays for its rebuild
    reported; the parent's ``HostMonitor`` reads rank 1 SLOW, never
    LOST."""
    from spark_agd_tpu_torch import resilience
    from spark_agd_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    procs = start_children(drill_args(
        f"localhost:{_free_port()}", parts_dir,
        {"kind": "straggler", "work": work, "keep": 64,
         "slow_s": STRAGGLER_SLOW_S, "part_rows": part_rows}))
    monitors = {name: resilience.HostMonitor(
        os.path.join(work, name, "hb"), stale_after_s=STRAGGLER_STALE_S)
        for name in ("observe", "rebalance")}
    seen = {name: {0: set(), 1: set()} for name in monitors}
    try:
        while any(p.poll() is None for p in procs):
            for name, mon in monitors.items():
                beats = mon.poll()
                for p, verdict in mon.verdicts().items():
                    if beats.get(p, {}).get("phase") != "exit":
                        seen[name][p].add(verdict)
            time.sleep(0.05)
        r0, r1 = collect_children(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t_phase

    reb, obs = r0["rebalance"], r0["observe"]
    decisions = reb["rebuilt"]
    ck_dir = os.path.join(work, "rebalance", "ck")
    committed = None
    if decisions:
        # the generation right after the decision: the forced commit
        at = decisions[0]["at_iter"]
        gens = sorted(resilience.manifest.committed_generations(ck_dir))
        at_gens = [g for g in gens if resilience.manifest.load_manifest(
            ck_dir, g).prior_iters == at]
        m = resilience.manifest.load_manifest(ck_dir, at_gens[-1])
        committed = [[str(p) for p in ckpt.read_npz_entries(
            m.shard_path(ck_dir, r))["partitions"]] for r in range(2)]
    shutil.rmtree(work, ignore_errors=True)
    hist_a, w_a = _unhex(base["hist"]), _unhex(base["w"])
    hist_r, w_r = _unhex(reb["hist"]), _unhex(reb["w"])
    n_common = min(len(hist_a), len(hist_r))
    launches["straggler_rebalance"] = r0["launches"] + r1["launches"]
    modes = {}
    for m in (r0["modes"], r1["modes"]):
        for k, v in m.items():
            modes[k] = modes.get(k, 0) + v
    launches["modes"]["straggler_rebalance"] = modes
    fit_s = {name: max(r0[name]["fit_s"], r1[name]["fit_s"])
             for name in ("observe", "rebalance")}
    # the straggler's sleep the rebalance saved, in units of slow_s, and
    # the size at which that pays for the rebuild
    saved_units = (sum(r1["observe"]["slow_scales"])
                   - sum(r1["rebalance"]["slow_scales"]))
    rebuild_s = decisions[0]["rebuild_s"] if decisions else None
    checks = {
        "ranks_bit_equal": all(
            (r0[n]["hist"], r0[n]["w"]) == (r1[n]["hist"], r1[n]["w"])
            for n in ("observe", "rebalance", "scripted")),
        "every_fit_runs_straggler_iters": all(
            r[n]["iters"] == STRAGGLER_ITERS for r in (r0, r1)
            for n in ("observe", "rebalance", "scripted")),
        "observe_no_rebalance": obs["rebalances"] == 0,
        "rebalanced_at_least_once": reb["rebalances"] >= 1,
        "rebalance_names_rank1": bool(decisions)
        and decisions[0]["straggler"] == 1,
        "rebalance_moves_parts_off_rank1": bool(decisions) and len(
            decisions[0]["assignments"][1]) < len(
            decisions[0]["assignments"][0]),
        "next_generation_carries_the_new_assignment":
            committed is not None and committed == [
                sorted(a) for a in decisions[0]["assignments"]],
        "rebalance_bit_equal_to_its_schedule_without_the_straggler":
            (reb["hist"], reb["w"]) == (r0["scripted"]["hist"],
                                        r0["scripted"]["w"]),
        "rebalance_final_loss_rtol_1e-5_vs_44a": bool(np.isclose(
            hist_r[-1], hist_a[-1], rtol=1e-5, atol=0.0)),
        "rebalance_history_rtol_1e-5_vs_44a": bool(np.allclose(
            hist_r[:n_common], hist_a[:n_common], rtol=1e-5, atol=0.0)),
        "observe_bit_equal_to_44a": (obs["hist"], obs["w"])
        == (base["hist"], base["w"]),
        "rebalance_wall_below_observe": fit_s["rebalance"]
        < fit_s["observe"],
        "rank1_read_slow_never_lost": all(
            "slow" in seen[n][1] and "lost" not in seen[n][1]
            and "lost" not in seen[n][0] for n in seen),
        "every_launch_warp_rows": set(modes) == {"warp_rows"}}
    finish("straggler_rebalance", {
        "shape": [DRILL["n"], DRILL["d"]], "parts": DRILL_PARTS,
        "segment_iters": STRAGGLER_SEGMENT, "iterations": STRAGGLER_ITERS,
        "slow_s": STRAGGLER_SLOW_S,
        "observe_fit_s": fit_s["observe"],
        "rebalance_fit_s": fit_s["rebalance"],
        "rebalance_over_observe_wall": fit_s["rebalance"] / fit_s["observe"],
        "rank1_slow_sleeps": {n: r1[n]["slow_sleeps"]
                              for n in ("observe", "rebalance")},
        "rank1_slow_scales": {n: r1[n]["slow_scales"]
                              for n in ("observe", "rebalance")},
        "saved_sleep_s": saved_units * STRAGGLER_SLOW_S,
        "rebuild_s": rebuild_s,
        "break_even_slow_s": (rebuild_s / saved_units
                              if rebuild_s and saved_units > 0 else None),
        "decisions": decisions, "rebalances": reb["rebalances"],
        "rank_assignment_after": [r0["rebalance"]["assignment"],
                                  r1["rebalance"]["assignment"]],
        "committed_after_decision": committed,
        "verdicts_seen": {n: {str(p): sorted(v) for p, v in seen[n].items()}
                          for n in seen},
        "rebalance_weight_rel_diff_vs_44a": float(
            np.linalg.norm(w_r - w_a) / np.linalg.norm(w_a)),
        "rebalance_max_abs_weight_diff_vs_44a": float(np.max(
            np.abs(w_r - w_a))),
        "rebalance_max_entry_rel_diff_vs_44a": float(np.max(
            np.abs(w_r - w_a) / np.maximum(np.abs(w_a), 1e-30))),
        "rebalance_loss_last": float(hist_r[-1]),
        "children_wall_s": wall_s,
        "launches": launches["straggler_rebalance"], "modes": modes},
        checks, t_phase, smi)


# --- model parallelism (phases 46-49) -------------------------------------

# slots of the card on the meshes of phases 46, 47 and 49; phase 48's
# mesh; the iterations of phase 47's fits
MODEL_SLOTS = 4
TP_AXES = {"data": 2, "model": 2}
SHARDED_ITERS = 20
_RTOL, _ATOL = 1e-5, 1e-7  # the mesh paths' (__graft_entry__.py:28-29)


def hold_mesh_lanes(res, ref, checks, label):
    """Every lane of a mesh grid fit held to the same lane of its
    one-device run: the same ``num_iters`` (or both stopped at the f32
    loss floor, ``same_stop``) and the histories over their common
    iterations at the mesh paths' ``_RTOL``/``_ATOL``; returns the worst
    relative difference by lane."""
    diffs, same_iters, ok, stop = [], True, True, True
    for i in range(int(res.num_iters.shape[0])):
        a, b = _Lane(res, i), _Lane(ref, i)
        n = min(len(a.hist), len(b.hist))
        same_iters = same_iters and len(a.hist) == len(b.hist)
        stop = stop and same_stop(a, b, a.hist, b.hist)
        ok = ok and bool(np.allclose(a.hist[:n], b.hist[:n], rtol=_RTOL,
                                     atol=_ATOL))
        diffs.append(float(np.max(np.abs(a.hist[:n] - b.hist[:n])
                                  / np.abs(b.hist[:n]))) if n else 0.0)
    checks[f"{label}_same_num_iters_or_both_at_floor"] = stop
    checks[f"{label}_every_lane_history_within_rtol_atol"] = ok
    return {f"{label}_same_num_iters": same_iters,
            f"{label}_max_hist_rel_diff_by_lane": diffs,
            f"{label}_num_iters": res.num_iters.tolist()}


def mesh_sweep(port, fk, glm, smi, X, y, refs, launches):
    """Phase 46, inside phase 5's ``after`` after phases 22, 27 and 23
    (``refs``: their results and wall seconds): the grid fits over
    MODEL_SLOTS slots of the card, rows sharded as views of X.
    ``sweep(mesh=)`` over SWEEP_REGS through ``FusedLogisticGradient``,
    one launch of the lanes kernel a slot a round (all ``lanes_mma``),
    every lane held to phase 22's (the same ``num_iters``, histories at
    ``_RTOL``/``_ATOL``), the card's peak within phase 22's + 1 GB;
    ``LBFGS.sweep(mesh=)`` held to phase 27 as phase 33 holds it; and
    ``cross_validate(mesh=)`` (the trainer's, plain gradient, CV_FOLDS x
    CV_REGS, its refit over the mesh) held to phase 23: the same fold
    ids, best strength and validation losses (rtol 1e-4).  Wall times
    beside phases 22, 27 and 23's."""
    from spark_agd_tpu_torch.parallel import dist_smooth, mesh as mesh_lib

    t_phase = time.perf_counter()
    k, d = len(SWEEP_REGS), X.shape[1]
    mesh = card_mesh(mesh_lib, MODEL_SLOTS)
    w0 = torch.zeros(d, dtype=torch.float32, device="cuda")
    fused = counting_lanes(port.FusedLogisticGradient)()
    fk.reset_launch_counts()
    dist_smooth.reset_counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, sweep_s = timed(lambda: (
        port.AcceleratedGradientDescent(fused, port.SquaredL2Updater())
        .setNumIterations(ITERS).setConvergenceTol(TOL).set_mesh(mesh)
        .sweep((X, y), SWEEP_REGS, w0)))
    peak_above = (torch.cuda.max_memory_allocated() - base) / 1e9
    rounds = dist_smooth.mesh_evaluations
    lanes_launches = fk.lanes_launch_count
    modes = {m: c for m, c in fk.lanes_mode_launches.items() if c}
    other = fk.launch_count + fk.softmax_launch_count
    launches["mesh_sweep"] = lanes_launches
    launches.setdefault("lanes_modes", {})["mesh_sweep"] = modes
    ref22 = refs["sweep"]
    checks = {
        "sweep_launches_equal_slots_x_rounds": lanes_launches
        == fused.rounds == MODEL_SLOTS * rounds > 0,
        "sweep_every_launch_lanes_mma": modes == {"lanes_mma":
                                                  lanes_launches},
        "sweep_no_other_kernel": other == 0,
        "sweep_peak_within_phase22_plus_1gb":
            peak_above <= ref22["peak_above"] + 1.0,
        "sweep_finite": bool(torch.isfinite(res.weights).all())}
    out = {"shape": [N_MAIN, d], "slots": MODEL_SLOTS, "regs": SWEEP_REGS,
           "iterations": ITERS, "sweep_s": sweep_s,
           "phase22_sweep_s": ref22["s"], "rounds": rounds,
           "launches": lanes_launches, "modes": modes,
           "wall_ms_per_round": sweep_s * 1e3 / rounds,
           "peak_gb_above_x": peak_above,
           "phase22_peak_gb_above_x": ref22["peak_above"]}
    out.update(hold_mesh_lanes(res, ref22["res"], checks, "sweep"))
    del res
    torch.cuda.empty_cache()

    # the L-BFGS path over the same mesh
    fused_l = counting_lanes(port.FusedLogisticGradient)()
    fk.reset_launch_counts()
    dist_smooth.reset_counts()
    lres, lbfgs_s = timed(lambda: port.LBFGS(fused_l,
                                             port.SquaredL2Updater())
                          .setNumIterations(ITERS).set_mesh(mesh)
                          .sweep((X, y), SWEEP_REGS, w0))
    l_launches = fk.lanes_launch_count
    l_modes = {m: c for m, c in fk.lanes_mode_launches.items() if c}
    launches["mesh_lbfgs_sweep"] = l_launches
    launches["lanes_modes"]["mesh_lbfgs_sweep"] = l_modes
    ref27 = refs["lbfgs"]
    l_diffs, l_ok = [], True
    for i in range(k):
        hist = lres.loss_history[i, :int(lres.num_iters[i]) + 1]
        r = _LbfgsLane(ref27["res"], i)
        rh = r.loss_history[:int(r.num_iters) + 1]
        m = min(len(hist), len(rh))
        l_ok = l_ok and bool(np.allclose(hist[:m].double().numpy(),
                                         rh[:m].double().numpy(),
                                         rtol=1e-4, atol=0.0))
        l_diffs.append(float(((hist[:m].double() - rh[:m].double()).abs()
                              / rh[:m].double().abs()).max()))
    checks.update({
        "lbfgs_launches_equal_slots_x_rounds": l_launches
        == fused_l.rounds == MODEL_SLOTS * lres.eval_rounds > 0,
        "lbfgs_every_launch_lanes_mma": l_modes == {"lanes_mma":
                                                    l_launches},
        "lbfgs_every_lane_history_rtol_1e-4_vs_phase27": l_ok})
    out.update({"lbfgs_s": lbfgs_s, "phase27_lbfgs_s": ref27["s"],
                "lbfgs_eval_rounds": lres.eval_rounds,
                "lbfgs_launches": l_launches, "lbfgs_modes": l_modes,
                "lbfgs_num_iters": lres.num_iters.tolist(),
                "lbfgs_num_iters_phase27":
                    ref27["res"].num_iters.tolist(),
                "lbfgs_max_hist_rel_diff_vs_phase27_by_lane": l_diffs})
    del lres
    torch.cuda.empty_cache()

    # cross-validation over the same mesh: the plain gradient
    trainer = glm.LogisticRegressionWithAGD(add_intercept=False)
    trainer.optimizer.setNumIterations(ITERS).setConvergenceTol(TOL) \
        .set_mesh(mesh)
    fk.reset_launch_counts()
    (model, cv), cv_s = timed(lambda: trainer.cross_validate(
        X, y, CV_REGS, n_folds=CV_FOLDS))
    kernels = (fk.launch_count + fk.lanes_launch_count
               + fk.softmax_launch_count)
    ref23 = refs["cv"]
    cv23 = ref23["cv"]
    val_diff = float(((cv.val_loss.double() - cv23.val_loss.double()).abs()
                      / cv23.val_loss.double().abs()).max())
    checks.update({
        "cv_fold_ids_equal_phase23": bool(torch.equal(
            cv.fold_ids.cpu(), cv23.fold_ids.cpu())),
        "cv_best_strength_equals_phase23":
            int(cv.best_index) == int(cv23.best_index),
        "cv_val_loss_rtol_1e-4_vs_phase23": val_diff <= 1e-4,
        "cv_plain_gradient_launches_no_kernel": kernels == 0,
        "cv_refit_finite": bool(torch.isfinite(model.weights).all())})
    out.update({"cv_and_refit_s": cv_s, "phase23_cv_and_refit_s":
                ref23["s"], "cv_val_loss_max_rel_diff_vs_phase23": val_diff,
                "cv_best_reg": CV_REGS[int(cv.best_index)],
                "cv_num_iters": cv.train_result.num_iters.tolist()})
    finish("mesh_sweep", out, checks, t_phase, smi)


def sharded_update(port, fk, smi, X, y, launches):
    """Phase 47 (a), inside phase 5's ``after``: the flagship over
    MODEL_SLOTS slots with ``run(mesh=, sharded_update=True)`` and the
    plain ``LogisticGradient`` (SHARDED_ITERS iterations), held to the
    replicated mesh fit with the same gradient (the same iterations,
    histories at ``_RTOL``/``_ATOL``); ``FusedLogisticGradient`` refused
    with the JAX package's ``ValueError``; a generation written in one
    mode resumed in the other, both ways (``AutoCheckpointer`` and a
    one-process ``DistributedCheckpointer``), each resumed fit held to
    the uninterrupted fit of its mode at ``_RTOL``."""
    from spark_agd_tpu_torch import resilience
    from spark_agd_tpu_torch.parallel import dist_smooth, mesh as mesh_lib
    from spark_agd_tpu_torch.parallel import multihost

    t_phase = time.perf_counter()
    mesh = card_mesh(mesh_lib, MODEL_SLOTS)
    w0 = torch.zeros(X.shape[1], dtype=torch.float32, device="cuda")
    kw = dict(reg_param=REG, num_iterations=SHARDED_ITERS,
              convergence_tol=TOL, initial_weights=w0, mesh=mesh,
              return_result=True)
    fk.reset_launch_counts()
    (_, h_rep, r_rep), rep_s = timed(lambda: port.run(
        (X, y), port.LogisticGradient(), port.SquaredL2Updater(), **kw))
    multihost.reset_census()
    dist_smooth.reset_counts()
    (w_sh, h_sh, r_sh), sh_s = timed(lambda: port.run(
        (X, y), port.LogisticGradient(), port.SquaredL2Updater(),
        sharded_update=True, **kw))
    slot_evals = dist_smooth.slot_evaluations
    evals = dist_smooth.mesh_evaluations
    try:
        port.run((X, y), port.FusedLogisticGradient(),
                 port.SquaredL2Updater(), sharded_update=True, **kw)
        refused = False
    except ValueError as e:
        refused = "fused" in str(e)
    kernels = (fk.launch_count + fk.lanes_launch_count
               + fk.softmax_launch_count)
    pol = sup_policy(port, segment_iters=4)
    half = 8  # a boundary of the checkpointers' cadence of 4
    resumed = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        for first, second, ck_of in (
                (False, True, lambda d: resilience.AutoCheckpointer(
                    os.path.join(d, "c.npz"), every_iters=4)),
                (True, False, lambda d: resilience.DistributedCheckpointer(
                    d, every_iters=4, process_index=0, process_count=1))):
            d = os.path.join(tmp, f"{int(first)}{int(second)}")
            os.makedirs(d)
            port.run((X, y), port.LogisticGradient(),
                     port.SquaredL2Updater(), resilience=pol,
                     checkpointer=ck_of(d), sharded_update=first,
                     **dict(kw, num_iterations=half))
            (_, h, sres), t = timed(lambda: port.run(
                (X, y), port.LogisticGradient(), port.SquaredL2Updater(),
                resilience=pol, checkpointer=ck_of(d),
                sharded_update=second, **kw))
            ref = h_sh if second else h_rep
            m = min(len(h), len(ref))
            resumed["sharded_resumes_replicated" if second
                    else "replicated_resumes_sharded"] = {
                "resumed_from": sres.resumed_from, "run_s": t,
                "iterations": len(h),
                "max_hist_rel_diff_vs_uninterrupted": float(np.max(
                    np.abs(h[:m] - ref[:m]) / np.abs(ref[:m]))),
                "ok": sres.resumed_from == half and bool(np.allclose(
                    h[:m], ref[:m], rtol=_RTOL, atol=_ATOL))}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n = min(len(h_sh), len(h_rep))
    checks = {
        "same_iterations_as_replicated": int(r_sh.num_iters)
        == int(r_rep.num_iters),
        "history_within_rtol_atol_vs_replicated": bool(np.allclose(
            h_sh[:n], h_rep[:n], rtol=_RTOL, atol=_ATOL)),
        "weights_within_rtol_atol_vs_replicated": bool(torch.allclose(
            w_sh, r_rep.weights, rtol=_RTOL, atol=_ATOL)),
        "slot_evaluations_equal_slots_x_evaluations":
            slot_evals == MODEL_SLOTS * evals > 0,
        "fused_gradient_refused_with_value_error": refused,
        "plain_gradient_launches_no_kernel": kernels == 0,
        **{f"{k}_resumed_within_rtol_atol": v["ok"]
           for k, v in resumed.items()},
        "finite": bool(np.isfinite(h_sh).all())}
    finish("sharded_update", {
        "shape": [N_MAIN, X.shape[1]], "slots": MODEL_SLOTS,
        "iterations": SHARDED_ITERS, "replicated_s": rep_s,
        "sharded_s": sh_s, "sharded_vs_replicated": sh_s / rep_s,
        "num_iters": int(r_sh.num_iters), "mesh_evaluations": evals,
        "max_hist_rel_diff_vs_replicated": float(np.max(
            np.abs(h_sh[:n] - h_rep[:n]) / np.abs(h_rep[:n]))),
        "max_weight_abs_diff_vs_replicated": float(
            (w_sh - r_rep.weights).abs().max()),
        "census_one_process": dict(multihost.census),
        "cross_mode_resume": resumed}, checks, t_phase, smi)


def sharded_update_mp(port, fk, smi, parts_dir, launches):
    """Phase 47 (b), on phase 44's files: two gloo ranks on the card
    (``--drill`` "sharded"), each reading its 4 parts onto a 2-slot mesh
    and fitting with ``sharded_update=True`` and the plain gradient
    (SHARDED_ITERS iterations): the ranks bit-equal (the gathered
    weights, the histories), held to the one-process replicated fit on
    all 8 parts over a 4-slot mesh (histories at ``_RTOL``/``_ATOL``);
    each rank's census of collectives printed: the reduce-scatter of the
    gradient, the all-gather of the weights, the control scalars."""
    from spark_agd_tpu_torch.parallel import mesh as mesh_lib

    t_phase = time.perf_counter()
    paths = sorted(glob.glob(os.path.join(parts_dir, "part-*")))
    (r0, r1), children_s = timed(lambda: run_children(drill_args(
        f"localhost:{_free_port()}", parts_dir, {"kind": "sharded",
                                                 "keep": 1})))
    mesh = card_mesh(mesh_lib, 4)
    w0 = torch.zeros(DRILL["d"], dtype=torch.float32, device="cuda")
    (w1, h1, res1), one_s = timed(lambda: port.run(
        drill_batch(port, mesh, paths, {}), port.LogisticGradient(),
        port.SquaredL2Updater(), reg_param=REG, num_iterations=SHARDED_ITERS,
        convergence_tol=TOL, initial_weights=w0, return_result=True))
    h0 = _unhex(r0["hist"])
    n = min(len(h0), len(h1))
    censuses = [r0["census"], r1["census"]]
    checks = {
        "ranks_bit_equal": (r0["hist"], r0["w"]) == (r1["hist"], r1["w"]),
        "same_iterations_as_one_process": r0["iters"] == int(res1.num_iters),
        "history_within_rtol_atol_vs_one_process_replicated": bool(
            np.allclose(h0[:n], h1[:n], rtol=_RTOL, atol=_ATOL)),
        "census_reduce_scatter_and_all_gather": all(
            c.get("reduce-scatter", {}).get("count", 0) > 0
            and c.get("all-gather", {}).get("count", 0) > 0
            and "sums" not in c for c in censuses),
        "scalar_collectives_at_most_96_bytes": all(
            c["scalars"]["max_bytes"] <= 96 for c in censuses)}
    finish("sharded_update_mp", {
        "shape": [DRILL["n"], DRILL["d"]], "parts": len(paths),
        "gloo_ranks": 2, "slots_per_rank": 2, "iterations": SHARDED_ITERS,
        "rank_fit_s": [r0["fit_s"], r1["fit_s"]],
        "children_wall_s": children_s, "one_process_run_s": one_s,
        "max_hist_rel_diff_vs_one_process": float(np.max(
            np.abs(h0[:n] - h1[:n]) / np.abs(h1[:n]))),
        "census_by_rank": censuses}, checks, t_phase, smi)


def tensor_parallel(port, fk, glm, smi, Xa, y, solo, launches):
    """Phase 48, inside phase 7's ``after`` on its data (config 4 with
    the intercept column, 25.4 GB): a {data: 2, model: 2} mesh of the
    card, ``run(mesh=, dist_mode="auto")``.  The plain
    ``SoftmaxGradient``'s class-sharded evaluation (each slot its
    classes' logits, the rows' max and sum of exponentials combined over
    the model slots, each slot its gradient columns) held to phase 7's
    plain fit; ``FusedSoftmaxGradient``, W's classes gathered onto each
    data slot, one softmax launch a data slot an evaluation (all
    ``one_read``), held to phase 7's fused fit and to the plain mesh fit
    just before it, and its evaluation at W = 0, at random W and at its
    fit's weights held to the f64 sums at the kernel's tolerance (the
    plain class-sharded evaluation's errors reported beside); then
    ``SoftmaxRegressionWithAGD(mesh=)`` (``add_intercept=False`` on the
    same Xa, the optimizer in ``dist_mode="auto"``) held to the plain
    fit; no further copy of Xa (the peak within 1 GB of what phase 7
    left allocated)."""
    from spark_agd_tpu_torch.parallel import dist_smooth, mesh as mesh_lib

    t_phase = time.perf_counter()
    res7, hist7, res7p, hist7p = solo
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_lib.make_mesh(TP_AXES, devices=[dev] * 4)
    d = D_SM + 1
    w0 = torch.zeros((d, K_SM), dtype=torch.float32, device="cuda")
    kw = dict(reg_param=REG_SM, num_iterations=ITERS, convergence_tol=TOL,
              initial_weights=w0, mesh=mesh, dist_mode="auto",
              return_result=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launch_counts()
    dist_smooth.reset_counts()
    (wp, hp, rp), plain_s = timed(lambda: port.run(
        (Xa, y), port.SoftmaxGradient(K_SM), port.SquaredL2Updater(), **kw))
    plain_launches = fk.softmax_launch_count + fk.launch_count
    plain_evals = dist_smooth.slot_evaluations
    plain_mesh_evals = dist_smooth.mesh_evaluations
    fused = counting(port.FusedSoftmaxGradient)(port.SoftmaxGradient(K_SM))
    fk.reset_launch_counts()
    dist_smooth.reset_counts()
    (wf, hf, rf), fused_s = timed(lambda: port.run(
        (Xa, y), fused, port.SquaredL2Updater(), **kw))
    launched = fk.softmax_launch_count
    evals = dist_smooth.mesh_evaluations
    launches["tensor_parallel"] = launched
    softmax_modes(fk, launches, "tensor_parallel")
    modes = launches["softmax_modes"]["tensor_parallel"]
    trainer = glm.SoftmaxRegressionWithAGD(K_SM, reg_param=REG_SM,
                                           updater=port.SquaredL2Updater(),
                                           add_intercept=False, mesh=mesh)
    trainer.optimizer.setNumIterations(ITERS).setConvergenceTol(TOL) \
        .set_dist_mode("auto")
    model, train_s = timed(lambda: trainer.train(Xa, y))
    peak_above = (torch.cuda.max_memory_allocated() - base) / 1e9
    # the kernel on this path's inputs and shapes held to the f64 sums at
    # the kernel's stated tolerance (as phase 8 holds it: over 8.1M rows
    # two f32 sums differ by their order, so the plain f32 evaluation is
    # no yardstick; its error is reported beside): the mesh evaluations
    # at the fits' start (W = 0), at seeded random weights and at the
    # fused fit's weights (these launches are not the path's: its counts
    # were read above)
    sm_k = dist_smooth.make_dist_smooth(
        port.FusedSoftmaxGradient(port.SoftmaxGradient(K_SM)), Xa, y,
        mesh=mesh, mode="auto")[0]
    sm_p = dist_smooth.make_dist_smooth(
        port.SoftmaxGradient(K_SM), Xa, y, mesh=mesh, mode="auto")[0]
    staged = fk.stage_softmax(Xa, y, K_SM)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(48)
    at_w = {}
    for name, W in (("zero", torch.zeros_like(wf)),
                    ("random", torch.randn(wf.shape, generator=gen,
                                           device="cuda") / d ** 0.5),
                    ("fused_fit", wf)):
        exact_loss, exact_grad = softmax_f64(K_SM, W, staged)
        exact_loss, exact_grad = exact_loss / N_SM, exact_grad / N_SM
        gmax = float(exact_grad.abs().max())
        out = {"grad_max_abs_f64": gmax}
        for who, sm in (("fused", sm_k), ("plain", sm_p)):
            f, g = sm(W)
            err = (g.double() - exact_grad).abs()
            out[who + "_loss_rel_err_vs_f64"] = abs(
                float(f) - float(exact_loss)) / abs(float(exact_loss))
            out[who + "_grad_max_abs_err_vs_f64"] = float(err.max())
            out[who + "_within_kernel_tol"] = bool(
                out[who + "_loss_rel_err_vs_f64"] <= LOSS_RTOL
                and (err <= GRAD_RTOL * exact_grad.abs()
                     + GRAD_ATOL_REL * gmax).all())
        at_w[name] = out
    del sm_k, sm_p, staged, exact_grad, g, err
    np_, nf = min(len(hp), len(hist7p)), min(len(hf), len(hist7))
    nfp = min(len(hf), len(hp))
    tw = torch.cat([model.intercept.reshape(1, -1), model.weights]) \
        if model.weights.shape[0] == d - 1 else model.weights
    checks = {
        "plain_launches_no_kernel": plain_launches == 0,
        "plain_one_evaluation_a_data_slot":
            plain_evals == TP_AXES["data"] * plain_mesh_evals > 0,
        "plain_same_stop_or_both_at_floor_vs_phase7_plain": same_stop(
            rp, res7p, hp, hist7p),
        "plain_history_rtol_1e-4_vs_phase7_plain": bool(np.allclose(
            hp[:np_], hist7p[:np_], rtol=1e-4, atol=0.0)),
        "fused_launches_equal_data_slots_x_evaluations": launched
        == fused.evaluations == TP_AXES["data"] * evals > 0,
        "fused_every_launch_one_read": modes == {"one_read": launched},
        "fused_no_margin_kernel_launch": fk.launch_count == 0,
        "fused_same_stop_or_both_at_floor_vs_phase7": same_stop(
            rf, res7, hf, hist7),
        "fused_history_rtol_1e-4_vs_phase7": bool(np.allclose(
            hf[:nf], hist7[:nf], rtol=1e-4, atol=0.0)),
        "fused_same_stop_or_both_at_floor_vs_plain_mesh_fit": same_stop(
            rf, rp, hf, hp),
        "fused_history_rtol_1e-4_vs_plain_mesh_fit": bool(np.allclose(
            hf[:nfp], hp[:nfp], rtol=1e-4, atol=0.0)),
        "fused_eval_within_kernel_tol_of_f64_at_zero_random_and_fit_w":
            all(v["fused_within_kernel_tol"] for v in at_w.values()),
        "trainer_weights_close_to_the_plain_run": bool(torch.allclose(
            tw, wp, rtol=1e-3, atol=1e-4)),
        "no_further_copy_of_xa": peak_above < 1.0,
        "finite": bool(np.isfinite(hp).all() and np.isfinite(hf).all())}
    finish("tensor_parallel", {
        "shape": [N_SM, d], "classes": K_SM, "mesh": TP_AXES,
        "plain_run_s": plain_s, "fused_run_s": fused_s,
        "trainer_train_s": train_s, "num_iters_plain": int(rp.num_iters),
        "num_iters_fused": int(rf.num_iters),
        "mesh_evaluations_fused": evals, "kernel_launches": launched,
        "modes": modes, "peak_gb_above_xa": peak_above,
        "plain_max_hist_rel_diff_vs_phase7_plain": float(np.max(
            np.abs(hp[:np_] - hist7p[:np_]) / np.abs(hist7p[:np_]))),
        "fused_max_hist_rel_diff_vs_phase7": float(np.max(
            np.abs(hf[:nf] - hist7[:nf]) / np.abs(hist7[:nf]))),
        "fused_max_hist_rel_diff_vs_plain_mesh_fit": float(np.max(
            np.abs(hf[:nfp] - hp[:nfp]) / np.abs(hp[:nfp]))),
        "eval_vs_f64": at_w},
        checks, t_phase, smi)


def feature_sharded_rcv1(port, fk, sparse, glm, smi, rcv1, launches):
    """Phase 49 (a), after phase 40 (a) on phase 10's data: BASELINE
    config 1 (rcv1-like, with the trainer's intercept column) with its
    columns over MODEL_SLOTS model slots (``shard_csr_by_columns``: the
    greedy nnz balance, a local CSR with its column-sorted twin a slot),
    the AGD fit on the padded state held to phase 10's fit over the
    iterations before they part (rtol 1e-4); the host layout's seconds;
    the unused padded positions exactly zero; no dense kernel launched."""
    from spark_agd_tpu_torch.core import agd, smooth as smooth_lib
    from spark_agd_tpu_torch.parallel import feature_sharded
    from spark_agd_tpu_torch.parallel import mesh as mesh_lib

    t_phase = time.perf_counter()
    cfg = rcv1["cfg"]
    res10, hist10 = rcv1["run"]
    d = cfg["d"] + 1
    Xa = glm._add_intercept(rcv1["X"])
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_lib.make_mesh({mesh_lib.MODEL_AXIS: MODEL_SLOTS},
                              devices=[dev] * MODEL_SLOTS)
    host = (Xa.indptr.cpu().numpy(), Xa.col_ids.cpu().numpy(),
            Xa.values.cpu().numpy(), rcv1["y"].cpu().numpy())
    del Xa
    batch, layout_s = timed(lambda: feature_sharded.shard_csr_by_columns(
        host[0], host[1], host[2], d, host[3], mesh))
    sm, sl = feature_sharded.make_feature_sharded_smooth(
        port.LogisticGradient(), batch, mesh=mesh)
    px, rv = smooth_lib.make_prox(port.L2Prox(), cfg["reg"])
    fk.reset_launch_counts()
    res, fit_s = timed(lambda: agd.run_agd(
        sm, px, rv, feature_sharded.shard_weights(np.zeros(d), batch, mesh),
        port.AGDConfig(num_iterations=ITERS, convergence_tol=TOL),
        smooth_loss=sl))
    dense = fk.launch_count + fk.softmax_launch_count + fk.lanes_launch_count
    hist = res.loss_history[:int(res.num_iters)].double().numpy()
    n_common = min(int(res.num_iters), int(res10.num_iters))
    n_path = common_path(res, res10, n_common)
    full = res.weights.cpu().numpy()
    unused = np.ones(full.shape[0], bool)
    unused[batch.positions] = False
    nnz = [s.nnz for s in batch.shards]
    checks = {
        "no_dense_kernel_launch": dense == 0,
        "common_path_of_10_iterations_or_more": n_path >= 10,
        "history_rtol_1e-4_vs_phase10_on_the_common_path": bool(np.allclose(
            hist[:n_path], hist10[:n_path], rtol=1e-4, atol=0.0)),
        "unused_positions_exactly_zero": bool((full[unused] == 0).all()),
        "finite": bool(np.isfinite(hist).all())}
    finish("feature_sharded_rcv1", {
        "shape": [cfg["n"], d], "model_slots": MODEL_SLOTS,
        "d_local": batch.d_local, "nnz_per_shard": nnz,
        "nnz_padding_blowup": MODEL_SLOTS * max(nnz) / len(host[1]),
        "host_layout_s": layout_s, "fit_s": fit_s,
        "num_iters": int(res.num_iters), "common_path_iterations": n_path,
        "max_hist_rel_diff_vs_phase10_on_the_common_path": float(np.max(
            np.abs(hist[:n_path] - hist10[:n_path])
            / np.abs(hist10[:n_path])))}, checks, t_phase, smi)


def feature_sharded_dense(port, fk, smi, X, y, launches):
    """Phase 49 (b), inside phase 28's ``after`` on its data (LIBSVM
    epsilon's 400,000 x 2,000 f32): ``shard_batch_by_features`` over
    MODEL_SLOTS model slots (column views of X), ``run(dist_mode=
    "auto")`` from ``shard_weights_by_features``, the plain
    ``LogisticGradient`` (the partial dots summed over the slots in slot
    order), held to phase 28's plain fit (the same ``run``, recomputed
    here) over common iterations (rtol 1e-4); the pad columns' weights
    exactly zero; no kernel launched."""
    from spark_agd_tpu_torch.parallel import mesh as mesh_lib

    t_phase = time.perf_counter()
    n, d = X.shape
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_lib.make_mesh({mesh_lib.MODEL_AXIS: MODEL_SLOTS},
                              devices=[dev] * MODEL_SLOTS)
    batch = mesh_lib.shard_batch_by_features(mesh, X, y)
    w0 = mesh_lib.shard_weights_by_features(
        torch.zeros(d, dtype=torch.float32, device="cuda"), batch, mesh)
    kw = dict(reg_param=REG, num_iterations=ITERS, convergence_tol=TOL,
              return_result=True)
    fk.reset_launch_counts()
    (w, hist, res), fit_s = timed(lambda: port.run(
        batch, port.LogisticGradient(), port.SquaredL2Updater(),
        dist_mode="auto", initial_weights=w0, **kw))
    kernels = fk.launch_count + fk.softmax_launch_count \
        + fk.lanes_launch_count
    (w1, hist1, res1), plain_s = timed(lambda: port.run(
        (X, y), port.LogisticGradient(), port.SquaredL2Updater(),
        initial_weights=torch.zeros(d, dtype=torch.float32, device="cuda"),
        **kw))
    m = min(len(hist), len(hist1))
    checks = {
        "no_kernel_launch": kernels == 0,
        "views_of_x": all(s.data_ptr() == X[:, i * batch.X.cols_per_shard:]
                          .data_ptr() for i, s in enumerate(batch.X.shards)),
        "same_stop_or_both_at_floor_vs_phase28_plain": same_stop(
            res, res1, hist, hist1),
        "history_rtol_1e-4_vs_phase28_plain": bool(np.allclose(
            hist[:m], hist1[:m], rtol=1e-4, atol=0.0)),
        "pad_weights_exactly_zero": bool((w[d:] == 0).all()),
        "finite": bool(np.isfinite(hist).all())}
    finish("feature_sharded_epsilon", {
        "shape": [n, d], "model_slots": MODEL_SLOTS,
        "padded_width": batch.X.shape[1], "fit_s": fit_s,
        "plain_run_s": plain_s, "num_iters": int(res.num_iters),
        "num_iters_plain": int(res1.num_iters),
        "max_hist_rel_diff_vs_phase28_plain": float(np.max(
            np.abs(hist[:m] - hist1[:m]) / np.abs(hist1[:m]))),
        "max_weight_abs_diff_vs_plain": float(
            (w[:d] - w1).abs().max())}, checks, t_phase, smi)


# phase 50: the serving engine's ladder (max_batch 64), the request sizes
# past its buckets (200 runs in chunks), the queue's load
SERVE = dict(max_batch=64, buckets=(8, 16, 32, 64),
             sizes=(1, 7, 9, 63, 65, 200), clients=4, requests=2_000,
             max_rows=16, seed=50)
# served values against the model's own on the card: f32 rtol, and an
# absolute floor for probabilities near 0
SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-7
# phase 51: the pipeline drill at the flagship width (epochs of 2^20 rows)
PIPE = dict(n=1_048_576, d=D_MAIN, epochs=4, fail_epoch=3, iters=30,
            segment=10, clients=4, slice=0.5, min_shadow=16,
            shadow_wait=200, slack=5.0, holdout=65_536, seed=51)


def shm_dir(prefix):
    """A fresh directory in ``/dev/shm`` (tmpfs; on the card's machine
    ``/`` and ``/tmp`` are a network share whose file operations take
    0.2-10 ms, which phases 35 and 43 would time as supervision), else in
    the temp dir."""
    shm = "/dev/shm"
    base = shm if os.path.isdir(shm) and os.access(shm, os.W_OK) else None
    return tempfile.mkdtemp(prefix=prefix, dir=base)


def hold_served(got, want, proba=None):
    """Whether served values equal the model's own: values within
    SERVE_RTOL (SERVE_ATOL); labels (``proba`` given: the model's
    probabilities on the same rows) equal but on rows whose probability
    lies within that tolerance of the threshold 0.5, or whose top two
    class probabilities lie within it of each other."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if proba is None:
        return bool(np.allclose(got, want, rtol=SERVE_RTOL,
                                atol=SERVE_ATOL))
    P = np.asarray(proba)
    if P.ndim == 1:
        gap, scale = np.abs(P - 0.5), 0.5
    else:
        top = np.sort(P, axis=1)
        gap, scale = top[:, -1] - top[:, -2], top[:, -1]
    near = gap <= SERVE_RTOL * scale + SERVE_ATOL
    return bool(np.all((got == want) | near))


def model_answer(model, X, op):
    """``model``'s own ``op`` on host rows ``X``, on the card: the values
    and, for labels, the probabilities ``hold_served`` reads."""
    Xc = torch.from_numpy(X).cuda()
    want = getattr(model, op)(Xc).cpu().numpy()
    proba = model.predict_proba(Xc).cpu().numpy() if op == "predict" \
        else None
    return want, proba


def serve_phase(port, fk, smi, kept):
    """Phase 50: the models phases 5, 7 and 18 fit, from the weights kept
    on the host, served on the card: each engine at every bucket and
    size, the micro-batching queue under concurrent clients with a hot
    swap in the stream, its overload, and the registry in /dev/shm."""
    from spark_agd_tpu_torch import serve
    from spark_agd_tpu_torch.models import glm, mlp
    from spark_agd_tpu_torch.resilience import errors, faults, manifest
    from spark_agd_tpu_torch.utils.checkpoint import CheckpointCorruptError

    t_phase = time.perf_counter()
    w_sm = kept["softmax"].cuda()
    models = {
        "logistic": glm.LogisticRegressionModel(kept["logistic"].cuda(),
                                                0.0),
        "softmax": glm.SoftmaxRegressionModel(w_sm[1:], w_sm[0]),
        "mlp": mlp.MLPModel({k: v.cuda() for k, v in kept["mlp"].items()}),
    }
    rng = np.random.default_rng(SERVE["seed"])
    fk.reset_launch_counts()
    checks, out = {}, {"models": {}}
    for kind, model in models.items():
        eng, build_s = timed(lambda: serve.ServeEngine(
            model, max_batch=SERVE["max_batch"]))
        census = eng.compile_census()
        d = eng.spec.n_features
        held, same = [], []
        for op in eng.ops:
            for n in eng.ladder.buckets + SERVE["sizes"]:
                X = rng.standard_normal((n, d), dtype=np.float32)
                got = eng.predict(X, op)
                held.append(hold_served(got, *model_answer(model, X, op)))
                same.append(np.array_equal(eng.predict(X, op), got))
        checks[f"{kind}_ladder_8_to_64"] = \
            eng.ladder.buckets == SERVE["buckets"]
        checks[f"{kind}_every_op_and_size_held_to_the_model"] = all(held)
        checks[f"{kind}_repeat_bit_identical"] = all(same)
        checks[f"{kind}_census_unchanged"] = eng.compile_census() == census
        out["models"][kind] = {"spec": dataclasses.asdict(eng.spec),
                               "ops": list(eng.ops), "build_s": build_s,
                               "programs": len(census)}

    # the queue: 4 clients, a hot swap half way through the stream
    m1 = models["logistic"]
    m2 = glm.LogisticRegressionModel(m1.weights * 0.5, 0.25)
    gens = {1: m1, 2: m2}
    direct = {g: serve.ServeEngine(m, generation=g,
                                   max_batch=SERVE["max_batch"])
              for g, m in gens.items()}
    eng = serve.ServeEngine(m1, generation=1, max_batch=SERVE["max_batch"])
    census = eng.compile_census()
    d = eng.spec.n_features
    answers = [[] for _ in range(SERVE["clients"])]
    failures, done, lock = [], [0], threading.Lock()
    total = SERVE["clients"] * SERVE["requests"]

    def client(c):
        r = np.random.default_rng(SERVE["seed"] * 100 + c)
        for i in range(SERVE["requests"]):
            X = r.standard_normal((int(r.integers(1, SERVE["max_rows"] + 1)),
                                   d), dtype=np.float32)
            op = "predict_proba" if i % 3 else "predict"
            try:
                res = q.submit(X, op).result(timeout=60)
            except Exception as e:  # noqa: BLE001 — a check below
                failures.append(repr(e)[:200])
                continue
            answers[c].append((X, op, res))
            with lock:
                done[0] += 1

    with serve.MicroBatchQueue(eng, max_wait_us=500) as q:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE["clients"])]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        while done[0] < total // 2 and any(t.is_alive() for t in threads):
            time.sleep(0.001)
        eng.bind(m2, 2)
        swapped_at = done[0]
        for t in threads:
            t.join(timeout=600)
        stream_s = time.perf_counter() - t0
        alive = any(t.is_alive() for t in threads)
        batches = q.batches
        summary = q.latency_summary()
    held, bit_equal, per_client_monotone = [], 0, []
    for rows in answers:
        gs = [res.generation for _, _, res in rows]
        per_client_monotone.append(gs == sorted(gs))
        for X, op, res in rows:
            want = direct[res.generation].predict(X, op)
            proba = direct[res.generation].predict(X, "predict_proba") \
                if op == "predict" else None
            held.append(hold_served(res.value, want, proba))
            bit_equal += bool(np.array_equal(res.value, want))
    served_gens = sorted({res.generation for rows in answers
                          for _, _, res in rows})
    checks.update({
        "queue_every_request_answered": not alive and not failures
        and sum(map(len, answers)) == total,
        "queue_answers_equal_the_engine": all(held),
        "queue_fewer_batches_than_requests": batches < total,
        "queue_hot_swap_dropped_nothing": served_gens == [1, 2]
        and all(per_client_monotone),
        "queue_census_unchanged": eng.compile_census() == census
        and eng.hot_swaps == 1})

    # overload: a queue of 16 rows holding its batch for 300 ms
    admitted, rejected = [], []
    with serve.MicroBatchQueue(eng, max_wait_us=300_000,
                               max_queue_rows=16) as q:
        for _ in range(20):
            try:
                admitted.append(q.submit(rng.standard_normal(
                    (4, d), dtype=np.float32)))
            except errors.ServeOverloaded as e:
                rejected.append(e)
        drained = all(f.result(timeout=30).rows == 4 for f in admitted)
    checks["overload_typed_transient_and_admitted_drained"] = bool(
        rejected) and drained and all(
        errors.classify_failure(e) == errors.TRANSIENT
        and e.limit_rows == 16 and e.queued_rows > 16 for e in rejected)

    # the registry in /dev/shm
    tmp = shm_dir("chip_smoke_registry_")
    try:
        m3 = glm.LogisticRegressionModel(m1.weights * 0.25, -0.25)
        reg = serve.ModelRegistry(tmp)
        published = [reg.publish(m) for m in (m1, m2, m3)]
        reg_eng = serve.ServeEngine(m1, generation=0,
                                    max_batch=SERVE["max_batch"])
        man3 = manifest.load_manifest(tmp, 3)
        faults.scramble_file(os.path.join(tmp, man3.shards[0].path))
        try:
            reg.load(3)
            refused = False
        except CheckpointCorruptError:
            refused = True
        fallback = reg.load_newest().generation
        X = rng.standard_normal((37, d), dtype=np.float32)
        swapped = reg.refresh(reg_eng)
        serves_2 = hold_served(reg_eng.predict(X, "predict_proba"),
                               *model_answer(m2, X, "predict_proba"))
        g4 = reg.publish(m3)
        swapped_4 = reg.refresh(reg_eng)
        serves_4 = hold_served(reg_eng.predict(X, "predict_proba"),
                               *model_answer(m3, X, "predict_proba"))
        reg.keep = 2
        reg.gc()
        kept_gens = manifest.committed_generations(tmp)
        newest = reg.load_newest().generation
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    checks.update({
        "registry_three_generations": published == [1, 2, 3],
        "registry_tampered_crc_refused_and_fell_back": refused
        and fallback == 2,
        "registry_refresh_binds_the_newest": swapped == 2 and serves_2
        and g4 == 4 and swapped_4 == 4 and serves_4
        and reg_eng.generation == 4,
        "registry_gc_keeps_the_newest": kept_gens == [4, 3] and newest == 4,
        "no_kernel_launched": fk.launch_count + fk.softmax_launch_count
        + fk.lanes_launch_count == 0})
    finish("serve", {
        **out, "clients": SERVE["clients"], "requests": total,
        "request_rows": [1, SERVE["max_rows"]], "batches": batches,
        "stream_s": stream_s, "requests_per_s": total / stream_s,
        "p50_ms": summary.get("p50_ms"), "p99_ms": summary.get("p99_ms"),
        "mean_ms": summary.get("mean_ms"), "max_ms": summary.get("max_ms"),
        "swapped_after_requests": swapped_at,
        "answers_bit_equal_to_direct": bit_equal,
        "overload_admitted": len(admitted), "overload_rejected":
        len(rejected), "registry_dir": "/dev/shm" if tmp.startswith(
            "/dev/shm") else os.path.dirname(tmp)}, checks, t_phase, smi)


def pipeline_batch(n, d, mu, seed):
    """``n`` rows of class_logistic's two-class mixture around ``±mu`` (one
    planted model for every epoch), made on the card."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    y = (torch.rand(n, generator=gen, device="cuda") < 0.5).float()
    X = torch.randn((n, d), generator=gen, device="cuda")
    X.addr_(2.0 * y - 1.0, mu)
    return X, y


def pipeline_phase(port, fk, smi, launches):
    """Phase 51: ``tools/pipeline_drill.py``'s story at the flagship
    width: epochs through ``FusedLogisticGradient`` published, canaried
    under live load and decided, one of them corrupted and rolled back."""
    from spark_agd_tpu_torch import pipeline, serve
    from spark_agd_tpu_torch.core import smooth as smooth_lib
    from spark_agd_tpu_torch.models import evaluation, glm
    from spark_agd_tpu_torch.obs import (InMemorySink, JSONLSink, Telemetry,
                                         perfgate, schema)

    t_phase = time.perf_counter()
    n, d, iters = PIPE["n"], PIPE["d"], PIPE["iters"]
    thresholds = {"p50_ms": PIPE["slack"], "p99_ms": PIPE["slack"]}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(PIPE["seed"])
    mu = torch.randn(d, generator=gen, device="cuda") / d ** 0.5
    Xv, yv = pipeline_batch(PIPE["holdout"], d, mu, PIPE["seed"] * 1000)

    def make_model(w):
        return glm.LogisticRegressionModel(w, 0.0)

    def holdout_loss(model):
        return float(evaluation.log_loss(model.predict_proba(Xv), yv))

    clean = {}  # the fault epoch's clean weights: the canary's lie

    def weight_fault(epoch, w):
        if epoch != PIPE["fail_epoch"]:
            return w
        clean[epoch] = w.clone()
        noise = torch.randn(d, generator=torch.Generator(
            device="cuda").manual_seed(777), device="cuda")
        return w + 25.0 * noise

    tmp = shm_dir("chip_smoke_pipeline_")
    # the trainer, its supervisor and checkpointers, the canary and the
    # promoter report through one bus, and so do the registry and HEAD's
    # engine and queue, as in tools/pipeline_drill.py: the canary's
    # shadow leg records every request, so HEAD's leg, whose latency the
    # canary grades it against, pays for its records too
    mem = InMemorySink()
    tel = Telemetry([mem, JSONLSink(os.path.join(tmp, "records.jsonl"))])
    zero = torch.zeros(d, dtype=torch.float32, device="cuda")
    registry = serve.ModelRegistry(os.path.join(tmp, "registry"),
                                   telemetry=tel)
    registry.publish(make_model(zero))
    engine = serve.ServeEngine(make_model(zero), generation=1, max_batch=64,
                               telemetry=tel)
    registry.refresh(engine)
    queue = serve.MicroBatchQueue(engine, max_wait_us=1500,
                                  max_queue_rows=64 * 16,
                                  telemetry=tel).start()
    controller = pipeline.CanaryController(
        registry, engine, queue, holdout=(Xv, yv),
        slice_fraction=PIPE["slice"], telemetry=tel,
        min_shadow_requests=PIPE["min_shadow"], thresholds=thresholds)
    last_good = {"loss": holdout_loss(registry.current.model)}

    def post_check(loaded):
        live = holdout_loss(loaded.model)
        if live <= last_good["loss"] * 1.5 + 1e-6:
            return True, ""
        return False, (f"holdout loss {live:.4f} regressed vs last "
                       f"healthy HEAD {last_good['loss']:.4f}")

    promoter = pipeline.Promoter(registry, engine, telemetry=tel,
                                 post_check=post_check)
    fused = counting(port.FusedLogisticGradient)()
    px, rv = smooth_lib.make_prox(port.SquaredL2Updater(), REG)
    trainer = pipeline.ContinuousTrainer(
        registry, fused, prox=px, reg_value=rv, w0=zero,
        config=port.AGDConfig(convergence_tol=TOL, num_iterations=iters),
        make_model=make_model,
        policy=sup_policy(port, segment_iters=PIPE["segment"]),
        checkpoint_path=os.path.join(tmp, "ckpt", "epoch"),
        checkpoint_every=PIPE["segment"], weight_fault=weight_fault,
        telemetry=tel)

    stop = threading.Event()
    traffic = {"served": 0, "dropped": 0, "rejected": 0, "errors": []}
    lock = threading.Lock()

    def client(c):
        r = np.random.default_rng(PIPE["seed"] * 100 + c)
        i = 0
        while not stop.is_set():
            X = r.standard_normal((int(r.integers(1, 17)), d),
                                  dtype=np.float32)
            op = "predict_proba" if i % 3 else "predict"
            i += 1
            try:
                future = controller.submit(X, op)
            except serve.ServeOverloaded:
                with lock:
                    traffic["rejected"] += 1  # never admitted
                continue
            try:
                future.result(timeout=60)
            except Exception as e:  # noqa: BLE001 — a check below
                with lock:
                    traffic["dropped"] += 1
                    traffic["errors"].append(repr(e)[:200])
                continue
            with lock:
                traffic["served"] += 1

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(PIPE["clients"])]
    fk.reset_launch_counts()
    for t in threads:
        t.start()
    epochs, reports, decisions, head_held = [], [], [], []
    probe = np.random.default_rng(PIPE["seed"]).standard_normal(
        (16, d), dtype=np.float32)
    try:
        for epoch in range(1, PIPE["epochs"] + 1):
            X, y = pipeline_batch(n, d, mu, PIPE["seed"] + epoch)
            w_start = trainer.weights.clone()
            er, fit_s = timed(lambda: trainer.run_epoch(X, y))
            _, hist_plain, _ = port.run(
                (X, y), port.LogisticGradient(), port.SquaredL2Updater(),
                reg_param=REG, num_iterations=iters, convergence_tol=TOL,
                initial_weights=w_start, return_result=True)
            del X, y
            hist = np.asarray(er.result.loss_history)
            k = min(len(hist), len(hist_plain))
            lie = (holdout_loss(make_model(clean[epoch]))
                   if epoch in clean else None)
            controller.start_canary(er.generation, epoch=epoch,
                                    quality_override=lie)
            deadline = time.monotonic() + 30.0
            while (controller.shadow_count < PIPE["shadow_wait"]
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            report = controller.finish_canary()
            decision = promoter.decide(report)
            if decision.decision == "promoted":
                last_good["loss"] = holdout_loss(registry.current.model)
            res = queue.submit(probe, "predict_proba").result(timeout=30)
            head = registry.current
            head_held.append(
                res.generation == head.generation == engine.generation
                and hold_served(res.value, *model_answer(
                    head.model, probe, "predict_proba")))
            reports.append(report)
            decisions.append(decision)
            epochs.append({
                "epoch": epoch, "generation": er.generation,
                "fit_s": fit_s, "num_iters": int(er.result.num_iters),
                "segments": len(er.result.attempts),
                "final_loss": er.final_loss,
                "history_rtol_1e-4_vs_plain": bool(np.allclose(
                    hist[:k], hist_plain[:k], rtol=1e-4, atol=0.0)),
                "max_hist_rel_diff_vs_plain": float(np.max(
                    np.abs(hist[:k] - hist_plain[:k])
                    / np.abs(hist_plain[:k]))),
                "canary": report.verdict,
                "shadow_requests": report.record.get("shadow_requests"),
                "shadow_p50_ms": report.record.get("p50_ms"),
                "shadow_p99_ms": report.record.get("p99_ms"),
                "head_p50_ms": report.record.get("baseline_p50_ms"),
                "head_p99_ms": report.record.get("baseline_p99_ms"),
                "quality_candidate": report.record.get("quality_candidate"),
                "quality_baseline": report.record.get("quality_baseline"),
                "decision": decision.decision,
                "head_after": decision.to_generation})
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        alive = any(t.is_alive() for t in threads)
        summary = queue.latency_summary()
        queue.stop()
        tel.flush()
        shutil.rmtree(tmp, ignore_errors=True)
    record_margin_path(fk, launches, "pipeline")
    other = fk.lanes_launch_count + fk.softmax_launch_count
    modes = launches["modes"]["pipeline"]

    by = {}
    for dec in decisions:
        by.setdefault(dec.decision, []).append(dec)
    rb = by.get("rolled_back", [])
    regates = []
    for rep in reports:
        gate = perfgate.gate_promotion(
            [rep.record], thresholds=thresholds,
            min_shadow_requests=PIPE["min_shadow"])
        regates.append("refused" if gate.refused
                       else "fail" if gate.failures else "pass")
    records = [r.record for r in reports] + [dec.record for dec in decisions]
    # the bus's own records: the canary records it carried, regraded
    bus = list(mem.records)
    bus_kinds = {}
    for r in bus:
        bus_kinds[r.get("kind")] = bus_kinds.get(r.get("kind"), 0) + 1
    canaries = [r for r in bus if r.get("kind") == "canary"]
    bus_regates = []
    for rec in canaries:
        gate = perfgate.gate_promotion(
            [rec], thresholds=thresholds,
            min_shadow_requests=PIPE["min_shadow"])
        bus_regates.append("refused" if gate.refused
                           else "fail" if gate.failures else "pass")
    checks = {
        "every_epoch_published": [e["generation"] for e in epochs]
        == list(range(2, PIPE["epochs"] + 2)),
        "at_least_one_promoted": len(by.get("promoted", [])) >= 1,
        "exactly_one_rolled_back": len(rb) == 1,
        "rolled_back_at_the_fault_epoch_to_the_generation_before":
            len(rb) == 1 and rb[0].record.get("epoch") == PIPE["fail_epoch"]
            and rb[0].to_generation == rb[0].from_generation is not None,
        "corrupted_candidate_not_serving": len(rb) == 1
        and registry.current.generation != rb[0].candidate_generation,
        "no_admitted_request_dropped": not alive
        and traffic["dropped"] == 0 and traffic["served"] > 0,
        "served_equals_head_after_each_decision": all(head_held),
        "shadow_requests_at_least_min": all(
            (r.record.get("shadow_requests") or 0) >= PIPE["min_shadow"]
            for r in reports),
        "gate_rerun_gives_the_recorded_verdicts":
            regates == [r.verdict for r in reports],
        "records_valid": all(not schema.validate_record(r)
                             for r in records),
        "telemetry_records_valid": bool(bus) and all(
            not schema.validate_record(r) for r in bus),
        "telemetry_gate_rerun_gives_the_recorded_verdicts":
            bus_regates == [r["verdict"] for r in canaries]
            == [r.verdict for r in reports],
        "telemetry_one_epoch_span_an_epoch": len(
            [r for r in bus if r.get("name") == "pipeline_epoch"
             and r.get("status") == "ok"]) == PIPE["epochs"],
        "telemetry_decisions_on_record": [
            r["decision"] for r in bus if r.get("kind") == "promotion"]
            == [dec.decision for dec in decisions],
        "telemetry_streams_no_iteration": "iteration" not in bus_kinds,
        "epoch_histories_rtol_1e-4_vs_plain": all(
            e["history_rtol_1e-4_vs_plain"] for e in epochs),
        "launches_equal_evaluations": launches["pipeline"]
        == fused.evaluations > 0,
        "every_launch_stream": modes == {"stream": launches["pipeline"]},
        "no_other_kernel": other == 0}
    finish("pipeline", {
        "shape": [n, d], "epochs": epochs, "iters": iters,
        "segment_iters": PIPE["segment"], "clients": PIPE["clients"],
        "slice": PIPE["slice"], "latency_slack": PIPE["slack"],
        "decisions": [dec.decision for dec in decisions],
        "verdicts": [r.verdict for r in reports], "regated": regates,
        "head": registry.current.generation, "served": traffic["served"],
        "rejected": traffic["rejected"], "dropped": traffic["dropped"],
        "errors": traffic["errors"][:3], "head_p50_ms":
        summary.get("p50_ms"), "head_p99_ms": summary.get("p99_ms"),
        "head_qps": summary.get("qps"), "launches": launches["pipeline"],
        "modes": modes, "smooth_evaluations": fused.evaluations,
        "telemetry_records": bus_kinds}, checks, t_phase, smi)


# phase 52: the fleet drill's story (tools/fleet_drill.py) at the flagship
# width: 3 replica processes on the card, replica 1 slowed 0.4 s a request
# from its 40th, replica 2 SIGKILLed at its 150th, 4 clients x 500
# requests of 1-16 rows under two tenants, a publish after 1,000
# requests, then a 4th replica joining, then one tenant flooding; the
# monitor's staleness window and the slow sleep are the drill's
FLEET = dict(replicas=3, clients=4, requests=500, max_rows=16, pool=512,
             tenants=("alice", "bob"), slow=1, slow_at=40, slow_s=0.4,
             killed=2, kill_at=150, joined=3, publish_after=1_000,
             join_requests=200, flood_tenant="mallory", flood_threads=8,
             flood_requests=160, quiet_requests=48, flood_cap=2,
             stale_after_s=4.0, slow_after_s=1.5, max_batch=64,
             start_s=120.0, settle_s=20.0, seed=52)


def fleet_child(spec):
    """The child of phase 52 (``--fleet-child REPLICA DIR SPEC``): one
    ``ReplicaServer`` process on the card, serving the newest generation
    of ``DIR/registry`` with its telemetry in ``DIR/records.hNNN.jsonl``
    and a chaos schedule from SPEC (``slow_at``/``slow_s``,
    ``kill_at``).  With ``go`` in SPEC it makes its CUDA context first,
    then waits for that file before it loads the registry (the join).
    SIGTERM stops it; it prints one RESULT line."""
    from spark_agd_tpu_torch import obs, serve
    from spark_agd_tpu_torch.resilience import chaos

    replica, workdir, spec = int(spec[0]), spec[1], json.loads(spec[2])
    torch.zeros(1, device="cuda")  # the context, before the wait
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    if spec.get("go"):
        deadline = time.monotonic() + MP_CHILD_TIMEOUT_S
        while not os.path.exists(spec["go"]):
            if stop.is_set() or time.monotonic() > deadline:
                print("RESULT " + json.dumps({"replica": replica,
                                              "joined": False}), flush=True)
                return 0
            time.sleep(0.02)
    tel = obs.Telemetry([obs.JSONLSink(os.path.join(
        workdir, f"records.h{replica:03d}.jsonl"))])
    registry = serve.ModelRegistry(os.path.join(workdir, "registry"),
                                   telemetry=tel)
    loaded = registry.load_newest()
    engine = serve.ServeEngine(loaded.model, generation=loaded.generation,
                               max_batch=FLEET["max_batch"])
    faults = []
    if spec.get("slow_at") is not None:
        faults.append(chaos.ScheduledFault(
            "slow_replica", at_iter=spec["slow_at"], process=replica,
            payload=spec["slow_s"], persist=True))
    if spec.get("kill_at") is not None:
        faults.append(chaos.ScheduledFault(
            "kill_replica", at_iter=spec["kill_at"], process=replica))
    server = serve.ReplicaServer(
        os.path.join(workdir, "fleet"), replica, engine, registry=registry,
        telemetry=tel,
        chaos=chaos.ChaosSchedule(faults, telemetry=tel) if faults else None,
        max_queue_rows=16 * FLEET["max_batch"], poll_every_s=0.1)
    server.start()
    while not stop.wait(0.05):
        pass
    server.stop()
    tel.flush()
    print("RESULT " + json.dumps({
        "replica": replica, "joined": True,
        "requests_seen": server.requests_seen,
        "generation": int(engine.generation),
        "hot_swaps": int(engine.hot_swaps)}), flush=True)
    return 0


def fleet_phase(port, fk, smi, weights):
    """Phase 52: the replica fleet and its router on the card
    (``tools/fleet_drill.py``'s story): phase 5's flagship logistic
    weights, kept on the host, published into a ``ModelRegistry`` in
    /dev/shm and served by ``ReplicaServer`` processes on the card,
    routed by a ``FleetRouter`` with a ``HostMonitor`` and a
    ``Telemetry``; every check decided by values and counts."""
    from spark_agd_tpu_torch import serve
    from spark_agd_tpu_torch.models import glm
    from spark_agd_tpu_torch.obs import (InMemorySink, JSONLSink, Telemetry,
                                         perfgate, schema)
    from spark_agd_tpu_torch.resilience.distributed import HostMonitor

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    fk.reset_launch_counts()
    tmp = shm_dir("chip_smoke_fleet_")
    fleet_dir = os.path.join(tmp, "fleet")
    d = int(weights.shape[0])
    gen = torch.Generator(device="cuda").manual_seed(FLEET["seed"])
    w1 = weights.cuda()
    models = {1: glm.LogisticRegressionModel(w1, 0.0),
              2: glm.LogisticRegressionModel(
                  w1 + 0.05 * torch.randn(d, generator=gen, device="cuda"),
                  0.1)}
    registry = serve.ModelRegistry(os.path.join(tmp, "registry"))
    registry.publish(models[1])
    rng = np.random.default_rng(FLEET["seed"])
    pool = rng.standard_normal((FLEET["pool"], d), dtype=np.float32)
    pool_c = torch.from_numpy(pool).cuda()
    refs = {g: m.predict_proba(pool_c).cpu().numpy()
            for g, m in models.items()}
    go = os.path.join(tmp, "go")

    def spec(r):
        out = {}
        if r == FLEET["slow"]:
            out.update(slow_at=FLEET["slow_at"], slow_s=FLEET["slow_s"])
        if r == FLEET["killed"]:
            out.update(kill_at=FLEET["kill_at"])
        if r == FLEET["joined"]:
            out.update(go=go)
        return json.dumps(out)

    mem = InMemorySink()
    tel = Telemetry([mem, JSONLSink(os.path.join(tmp, "records.parent"
                                                       ".jsonl"))])
    lock = threading.Lock()
    answers, drops, sheds = [], [], []
    verdicts_of = {r: set() for r in range(FLEET["replicas"] + 1)}
    completed = [0]
    published = threading.Event()
    procs = start_children([(str(r), tmp, spec(r)) for r in range(
        FLEET["replicas"] + 1)], flag="--fleet-child")
    router = None
    results = []
    try:
        def members(want):
            deadline = time.monotonic() + FLEET["start_s"]
            while time.monotonic() < deadline:
                found = serve.discover_replicas(fleet_dir)
                if want <= set(found):
                    return found
                for r in want:
                    if procs[r].poll() is not None:
                        raise AssertionError(
                            f"fleet: replica {r} exited "
                            f"({procs[r].returncode}) before it joined: "
                            f"{procs[r].stderr.read()[-4000:]}")
                time.sleep(0.05)
            raise AssertionError(f"fleet: replicas {sorted(want)} did not "
                                 f"announce within {FLEET['start_s']} s")

        (handles, start_s) = timed(lambda: members(
            set(range(FLEET["replicas"]))))
        monitor = HostMonitor(fleet_dir,
                              stale_after_s=FLEET["stale_after_s"],
                              slow_after_s=FLEET["slow_after_s"],
                              telemetry=tel)
        router = serve.FleetRouter(handles, monitor=monitor, telemetry=tel,
                                   tenant_max_outstanding=64,
                                   request_timeout_s=30.0)
        stop_poll = threading.Event()

        def poll_verdicts():
            while not stop_poll.wait(0.03):
                for r, v in monitor.verdicts().items():
                    with lock:
                        verdicts_of.setdefault(r, set()).add(v)

        poller = threading.Thread(target=poll_verdicts, daemon=True)
        poller.start()

        def soak(leg, n, threads, tenants, pace_s=0.0):
            counter = iter(range(n))
            lat = []

            def client(c):
                r = np.random.default_rng(FLEET["seed"] * 1000 + c
                                          + 100 * len(leg))
                while True:
                    with lock:
                        i = next(counter, None)
                    if i is None:
                        return
                    k = int(r.integers(1, FLEET["max_rows"] + 1))
                    lo = int(r.integers(0, FLEET["pool"] - k))
                    tenant = tenants[i % len(tenants)]
                    try:
                        res = router.request(pool[lo:lo + k],
                                             op="predict_proba",
                                             tenant=tenant)
                    except serve.ServeOverloaded as e:
                        with lock:
                            sheds.append((leg, tenant, str(e)))
                        continue
                    except Exception as e:  # noqa: BLE001 — a check
                        with lock:
                            drops.append((leg, repr(e)[:300]))
                        continue
                    ref = refs.get(res.generation)
                    ok = ref is not None and hold_served(
                        np.asarray(res.values, np.float32),
                        ref[lo:lo + k])
                    with lock:
                        answers.append((leg, tenant, res.replica,
                                        res.generation, ok))
                        lat.append(res.latency_ms)
                        completed[0] += 1
                        if completed[0] == FLEET["publish_after"]:
                            registry.publish(models[2])
                            published.set()
                    if pace_s:
                        time.sleep(pace_s)

            ts = [threading.Thread(target=client, args=(c,))
                  for c in range(threads)]
            t0 = time.perf_counter()
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=300)
            if any(t.is_alive() for t in ts):
                raise AssertionError(f"fleet: the {leg} clients hung")
            return lat, time.perf_counter() - t0

        n_main = FLEET["clients"] * FLEET["requests"]
        lat_main, soak_s = soak("main", n_main, FLEET["clients"],
                                FLEET["tenants"])
        # every live replica serves generation 2: asked directly
        live = [r for r in range(FLEET["replicas"])
                if r != FLEET["killed"]]
        probe = pool[:8]
        on_g2 = set()
        deadline = time.monotonic() + FLEET["settle_s"]
        while on_g2 != set(live) and time.monotonic() < deadline:
            for r in set(live) - on_g2:
                resp = handles[r].predict(probe, op="predict_proba")
                if resp["generation"] == 2 and hold_served(
                        np.asarray(resp["values"], np.float32),
                        refs[2][:8]):
                    on_g2.add(r)
            time.sleep(0.05)
        stats_main = dataclasses.asdict(router.stats)
        # the elastic join: replica 3 loads the newest generation
        open(go, "w").close()
        members({FLEET["joined"]})
        monitor.poll()
        alive = {r: h for r, h in serve.discover_replicas(fleet_dir).items()
                 if monitor.verdicts().get(r) != "lost"}
        delta = router.refresh_membership(alive)
        soak("join", FLEET["join_requests"], FLEET["clients"],
             FLEET["tenants"])
        # one tenant floods past the admission cap; the quiet one flows
        router.tenant_max_outstanding = FLEET["flood_cap"]
        flood = threading.Thread(target=soak, args=(
            "flood", FLEET["flood_requests"], FLEET["flood_threads"],
            (FLEET["flood_tenant"],)))
        flood.start()
        soak("quiet", FLEET["quiet_requests"], 1, ("alice",), 0.005)
        flood.join(timeout=300)
        flood_done = not flood.is_alive()
        router.tenant_max_outstanding = 64
        stop_poll.set()
        poller.join(timeout=10)
        stats = dataclasses.asdict(router.stats)
        members_after = router.members
        router.close()
        router = None
        for i, p in enumerate(procs):
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        results = collect_children(procs, killed=(FLEET["killed"],))
    finally:
        if router is not None:
            router.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    killed_rc = procs[FLEET["killed"]].returncode
    tel.flush()
    records = list(mem.records)
    for path in sorted(glob.glob(os.path.join(tmp, "records.h*.jsonl"))):
        records.extend(schema.read_jsonl(path))
    shutil.rmtree(tmp, ignore_errors=True)
    gate = perfgate.gate_fleet(records)
    invalid = [r for r in records if schema.validate_record(
        json.loads(json.dumps(r, default=str)))]
    decisions = {}
    for r in records:
        if r.get("kind") == "fleet_route":
            decisions[r["decision"]] = decisions.get(r["decision"], 0) + 1
    evicts = [r.get("process") for r in records
              if r.get("action") == "replica_evict"]
    retries = [r for r in records if r.get("action") == "request_retry"]
    by_leg = {}
    for leg, tenant, replica, generation, ok in answers:
        by_leg.setdefault(leg, []).append((tenant, replica, generation, ok))
    flood_sheds = [s for s in sheds if s[0] == "flood"]
    quiet = by_leg.get("quiet", [])
    lat = sorted(lat_main)
    checks = {
        "every_answer_equals_its_generations_model": bool(answers)
        and all(a[4] for a in answers),
        "no_admitted_request_dropped": not drops,
        "main_soak_all_answered": len(by_leg.get("main", [])) == n_main,
        "slow_replica_read_slow": "slow" in verdicts_of[FLEET["slow"]],
        "slow_replica_never_lost": "lost" not in verdicts_of[FLEET["slow"]],
        "slow_replica_still_a_member": FLEET["slow"] in members_after,
        "killed_replica_sigkilled": killed_rc == -signal.SIGKILL,
        "killed_replica_evicted_once": evicts.count(FLEET["killed"]) == 1
        and stats["evictions"] == 1,
        "at_least_one_request_retry": len(retries) >= 1
        and stats["retries"] >= 1,
        "join_did_not_bring_back_the_killed": FLEET["joined"]
        in delta["joined"] and FLEET["killed"] not in members_after,
        "joined_replica_served": any(
            a[1] == FLEET["joined"] for a in by_leg.get("join", [])),
        "hedged_and_a_hedge_won": stats["hedges"] >= 1
        and stats["hedges_won"] >= 1,
        "both_generations_served": {a[2] for a in
                                    by_leg.get("main", [])} == {1, 2},
        "every_live_replica_serves_generation_2": on_g2 == set(live)
        and all(r["generation"] == 2 for r in results
                if r is not None and r.get("joined")),
        "flood_tenant_shed_typed": len(flood_sheds) >= 1
        and all("admission cap" in s[2] for s in flood_sheds)
        and decisions.get("shed_tenant", 0) >= 1,
        "flood_leg_finished": flood_done,
        "quiet_tenant_all_answered": len(quiet)
        == FLEET["quiet_requests"] and not [s for s in sheds
                                            if s[1] == "alice"],
        "gate_fleet_passes": gate.exit_code() == 0,
        "records_schema_valid": not invalid,
        "records_name_the_card": all(
            r.get("device_kind") == torch.cuda.get_device_name(0)
            for r in records),
        "no_kernel_launched": fk.launch_count == 0
        and fk.lanes_launch_count == 0 and fk.softmax_launch_count == 0,
    }
    finish("fleet", {
        "width": d, "replicas": FLEET["replicas"],
        "clients": FLEET["clients"], "requests": n_main,
        "start_s": start_s, "soak_s": soak_s,
        "p50_ms": lat[len(lat) // 2] if lat else None,
        "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))]
        if lat else None,
        "requests_per_s": len(lat) / soak_s if soak_s else None,
        "stats_main": stats_main, "stats": stats,
        "served_by_replica_main": {
            str(r): sum(1 for a in by_leg.get("main", []) if a[1] == r)
            for r in range(FLEET["replicas"])},
        "verdicts_seen": {str(r): sorted(v) for r, v in
                          verdicts_of.items()},
        "join_delta": delta, "sheds": len(flood_sheds),
        "drops": drops[:3], "decisions": decisions,
        "gate": {"pre_share": gate.pre_share, "post_share": gate.post_share,
                 "refusals": gate.refusals},
        "records": len(records), "invalid_records": len(invalid),
        "children": results}, checks, t_phase, smi)


# phase 53: the fit's spans and its first profiler trace; the margin
# kernel's symbol in the trace (the stream mode at the flagship's width)
TEL_STREAM_BATCHES, TEL_STREAM_ITERS = 3, 1
TEL_CKPT_ITERS, TEL_CKPT_EVERY = 10, 5
MARGIN_STREAM_SYMBOL = "margin_stream"
FIT_SPANS = ("h2d_transfer", "trace", "compile", "execute")


def trace_events(log_dir):
    """The events of the one Chrome trace ``utils.profiling`` wrote into
    ``log_dir`` (a failure when there is not exactly one)."""
    files = sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json")))
    if len(files) != 1:
        raise AssertionError(f"telemetry: {len(files)} trace files in "
                             f"{log_dir}, not 1")
    with open(files[0]) as f:
        return json.load(f)["traceEvents"], os.path.getsize(files[0])


def dropped_kernel_records(events):
    """The kernel launches of a trace whose kernel record the profiler
    dropped: ``cudaLaunchKernel`` runtime events whose correlation id no
    kernel event carries (in a whole trace each launch has one)."""
    kernels = {e["args"].get("correlation") for e in events
               if e.get("cat") == "kernel"}
    return sum(1 for e in events if e.get("cat") == "cuda_runtime"
               and "LaunchKernel" in e.get("name", "")
               and e["args"].get("correlation") not in kernels)


def busy_share(events, name):
    """The share of the host range ``name`` (a ``record_function``) in
    which the card ran a kernel, a copy or a set: the union of the
    device's intervals inside the range over the range's length."""
    spans = [e for e in events if e.get("name") == name
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise AssertionError(f"telemetry: {len(spans)} '{name}' ranges in "
                             "the trace, not 1")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    device = sorted(
        (max(t0, float(e["ts"])), min(t1, float(e["ts"]) + float(e["dur"])))
        for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                            "gpu_memset"))
    busy, end = 0.0, t0
    for a, b in device:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return busy / (t1 - t0), (t1 - t0) / 1e3


def records_valid(records):
    """Every record valid under ``obs.schema`` and naming the card."""
    from spark_agd_tpu_torch.obs import schema

    kind = torch.cuda.get_device_name(0)
    return all(schema.validate_record(r) == [] and r.get("device_kind")
               == kind for r in records)


def telemetry_phase(port, fk, smi, X, y, solo, launches, tel_c):
    """Phase 53 (a, b and the checkpointed fit of c), on phase 5's data:
    (a) phase 5's fit through ``run(telemetry=Telemetry(profile_dir=))``
    (``FusedLogisticGradient``): its history and weights bit-equal to
    phase 5's fit in this call, the iteration records equal to the
    history, the spans ``h2d_transfer``, ``trace``, ``compile`` and
    ``execute`` (in that order) and the ``run`` record, each record
    valid; the profiler's trace of ``execute`` parsed, holding the
    margin kernel's ``margin_stream`` symbol exactly as often as the fit
    launched it, but for kernel records the profiler dropped
    (:func:`dropped_kernel_records`), CUDA activity or a failure; the
    device-busy share of
    ``execute`` from the trace; the wall-time ratio of a telemetry fit to
    a plain one (medians of STEADY_RUNS each, in turns).  (b) ``run_lbfgs``
    and OWL-QN (``L1Prox``, L1_MAIN) with ``telemetry=``: each fit's
    iteration records equal its history.  (c, first half) a
    TEL_CKPT_ITERS-iteration flagship fit supervised with a
    ``DistributedCheckpointer(telemetry=tel_c)`` every TEL_CKPT_EVERY in
    ``/dev/shm``: a closed ``ckpt_commit`` span a generation, holding its
    save's recovery record."""
    from spark_agd_tpu_torch import resilience
    from spark_agd_tpu_torch.obs import Telemetry

    t_phase = time.perf_counter()
    res5, hist5 = solo[0], solo[1]
    w0 = torch.zeros(D_MAIN, dtype=torch.float32, device="cuda")
    kw = dict(reg_param=REG, num_iterations=ITERS, convergence_tol=TOL,
              initial_weights=w0, return_result=True)
    prof_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    checks = {}

    # (a) the traced fit
    tel = Telemetry(profile_dir=prof_dir)
    fk.reset_launch_counts()
    (w, hist, res), traced_s = timed(lambda: port.run(
        (X, y), port.FusedLogisticGradient(), port.SquaredL2Updater(),
        telemetry=tel, **kw))
    traced_launches = fk.launch_count
    modes = margin_modes(fk)
    its = tel.iterations("agd")
    spans = [r["name"] for r in tel.records if r["kind"] == "span"]
    checks["bit_equal_to_phase5_history"] = bool(np.array_equal(hist,
                                                                hist5))
    checks["bit_equal_to_phase5_weights"] = bool(torch.equal(
        w, res5.weights))
    checks["iteration_records_equal_history"] = [
        r["loss"] for r in its] == hist.tolist()
    checks["iteration_count"] = len(its) == int(res.num_iters) == len(hist)
    checks["four_spans_in_order"] = spans == list(FIT_SPANS)
    checks["one_run_record"] = [r["kind"] for r in tel.records].count(
        "run") == 1 and tel.records[-1]["kind"] == "run"
    checks["records_valid"] = records_valid(tel.records)
    checks["only_stream_mode"] = set(modes) == {"stream"}
    events, trace_bytes = trace_events(prof_dir)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    in_trace = sum(MARGIN_STREAM_SYMBOL in e.get("name", "")
                   for e in kernels)
    checks["cuda_activity_in_trace"] = len(kernels) > 0
    # exactly the fit's launches; where the profiler dropped kernel
    # records (launches in the trace without their kernel: 7 of 1,844 in
    # one run of three on the H100), the margin kernel's missing ones
    # must be among those drops, and the drops under 1% of the launches
    dropped = dropped_kernel_records(events)
    checks["kernel_in_trace_as_launched"] = (
        0 < in_trace <= traced_launches <= in_trace + dropped
        and dropped <= 0.01 * len(kernels))
    share, execute_ms = busy_share(events, "execute")
    span_s = {r["name"]: r["seconds"] for r in tel.records
              if r["kind"] == "span"}
    shutil.rmtree(prof_dir, ignore_errors=True)

    # the cost of the instrumentation: telemetry fits against plain ones
    def plain():
        return port.run((X, y), port.FusedLogisticGradient(),
                        port.SquaredL2Updater(), **kw)

    def with_telemetry(i):
        return port.run((X, y), port.FusedLogisticGradient(),
                        port.SquaredL2Updater(), telemetry=Telemetry(),
                        **kw)

    seconds, outs = alternating_walls(plain, {"telemetry": with_telemetry})
    checks["timed_fits_bit_equal"] = all(
        torch.equal(o[0], res5.weights) for name in outs
        for o in outs[name])
    ratio = median_ratio(seconds, "telemetry")

    # (b) L-BFGS and OWL-QN
    qn = {}
    for algorithm, updater, reg in (("lbfgs", port.SquaredL2Updater(), REG),
                                    ("owlqn", port.L1Prox(), L1_MAIN)):
        t = Telemetry()
        r, qn_s = timed(lambda: port.run_lbfgs(
            (X, y), port.FusedLogisticGradient(), updater, reg_param=reg,
            num_iterations=ITERS, initial_weights=w0, telemetry=t))
        k = int(r.num_iters)
        checks[f"{algorithm}_records_equal_history"] = [
            x["loss"] for x in t.iterations(algorithm)] \
            == r.loss_history[1:k + 1].tolist() and k > 0
        checks[f"{algorithm}_records_valid"] = records_valid(t.records)
        qn[algorithm] = {"iters": k, "seconds": qn_s,
                         "records": len(t.records)}

    # (c) the checkpointed fit, its commit spans on the shared bus
    tmp = shm_dir("chip_smoke_tel_ckpt_")
    try:
        ck = resilience.DistributedCheckpointer(
            tmp, every_iters=TEL_CKPT_EVERY, telemetry=tel_c)
        (wc, hc), ckpt_s = timed(lambda: port.run(
            (X, y), port.FusedLogisticGradient(), port.SquaredL2Updater(),
            reg_param=REG, num_iterations=TEL_CKPT_ITERS,
            convergence_tol=TOL, initial_weights=w0,
            resilience=resilience.ResiliencePolicy(
                segment_iters=TEL_CKPT_EVERY),
            checkpointer=ck, telemetry=tel_c))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    commits = [r for r in tel_c.records if r.get("name") == "ckpt_commit"
               and r["kind"] == "span" and r.get("status") != "open"]
    saves = [r for r in tel_c.records if r["kind"] == "recovery"
             and r.get("source") == "dist_ckpt"]
    checks["a_commit_span_a_generation"] = (
        [r["generation"] for r in commits]
        == [r["generation"] for r in saves] == list(range(ck.saves))
        and ck.saves >= TEL_CKPT_ITERS // TEL_CKPT_EVERY)
    checks["checkpointed_history_is_phase5s"] = bool(np.array_equal(
        hc, hist5[:TEL_CKPT_ITERS]))
    record_margin_path(fk, launches, "telemetry")
    finish("telemetry", {
        "shape": [N_MAIN, D_MAIN], "launches_traced_fit": traced_launches,
        "margin_stream_in_trace": in_trace, "trace_events": len(events),
        "kernel_records_dropped": dropped,
        "trace_kernel_events": len(kernels), "trace_mb": trace_bytes / 1e6,
        "traced_fit_s": traced_s, "span_s": span_s,
        "execute_ms_in_trace": execute_ms,
        "execute_device_busy_share": share,
        "telemetry_over_plain_wall": ratio,
        "walls_s": seconds, "quasi_newton": qn,
        "checkpointed_fit_s": ckpt_s, "commits": len(commits),
        "launches": launches["telemetry"],
        "modes": launches["modes"]["telemetry"]}, checks, t_phase, smi)
    print(f"telemetry: traced fit, telemetry/plain wall {ratio:.4f} "
          f"(median of {STEADY_RUNS} each), execute device-busy share "
          f"{share:.4f}; {smi}", flush=True)


def telemetry_stream(port, fk, streaming, smi, host, tel_c, launches):
    """Phase 53 (c, second half): ``run_agd_host`` over
    TEL_STREAM_BATCHES batches of phase 5's pinned rows (STREAM_ROWS a
    batch) with ``make_streaming_smooth(telemetry=tel_c)``, the bus that
    took phase 53's checkpointed fit: a ``stream_epoch`` record a pass,
    numbered on, each with the pass's batches and rows; the records of
    both fits valid."""
    from spark_agd_tpu_torch.core import smooth as smooth_lib

    t_phase = time.perf_counter()
    rows = TEL_STREAM_BATCHES * STREAM_ROWS
    Xh, yh = host["X"][:rows], host["y"][:rows]
    ds = streaming.StreamingDataset.from_arrays(Xh, yh, STREAM_ROWS)
    stats = []
    before = len(tel_c.records)
    sm, sl = streaming.make_streaming_smooth(
        port.FusedLogisticGradient(), ds, prefetch=STREAM_PREFETCH,
        pass_stats=stats, telemetry=tel_c)
    px, rv = smooth_lib.make_prox(port.SquaredL2Updater(), REG)
    cfg = port.AGDConfig(convergence_tol=TOL,
                         num_iterations=TEL_STREAM_ITERS)
    w0 = torch.zeros(Xh.shape[1], dtype=torch.float32, device="cuda")
    fk.reset_launch_counts()
    res, fit_s = timed(lambda: port.run_agd_host(
        sm, px, rv, w0, cfg, smooth_loss=sl))
    epochs = [r for r in tel_c.records[before:]
              if r["kind"] == "stream_epoch"]
    launches["telemetry"] += fk.launch_count
    for mode, n in margin_modes(fk).items():
        launches["modes"]["telemetry"][mode] = \
            launches["modes"]["telemetry"].get(mode, 0) + n
    checks = {
        "a_stream_epoch_a_pass": len(epochs) == len(stats) >= 2,
        "epochs_numbered": [r["epoch"] for r in epochs]
        == list(range(1, len(stats) + 1)),
        "epoch_batches_and_rows": all(
            r["batches"] == TEL_STREAM_BATCHES and r["rows"] == rows
            for r in epochs),
        "a_launch_a_batch_a_pass":
            fk.launch_count == TEL_STREAM_BATCHES * len(stats),
        "finite": bool(np.isfinite(np.asarray(res.loss_history)[
            :int(res.num_iters)]).all()),
        "records_valid": records_valid(tel_c.records),
    }
    finish("telemetry_stream", {
        "rows": rows, "passes": len(stats), "fit_s": fit_s,
        "pass_s": [r["pass_s"] for r in epochs],
        "stall_fraction": [r["stall_fraction"] for r in epochs],
        "records": len(tel_c.records)}, checks, t_phase, smi)


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
    parser.add_argument("--mp-child", nargs=5,
                        metavar=("BACKEND", "ADDR", "WORLD", "RANK", "DIR"),
                        help="run one rank of phase 42's, 44's or 45's "
                             "process group (started by the script itself)")
    parser.add_argument("--fleet-child", nargs=3,
                        metavar=("REPLICA", "DIR", "SPEC"),
                        help="run one replica of phase 52's fleet (started "
                             "by the script itself)")
    parser.add_argument("--drill", metavar="JSON",
                        help="with --mp-child: the supervised fits of "
                             "phases 44-45 this rank runs")
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
    if args.mp_child:
        return mp_child(port, args.mp_child, args.drill)
    if args.fleet_child:
        return fleet_child(args.fleet_child)

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
    cv_ref, stream33 = {}, {}  # phases 23 and 33 for phases 46 and 41
    served = {}  # phases 5, 7 and 18's weights on the host, for phase 50
    from spark_agd_tpu_torch.obs import Telemetry

    tel53 = Telemetry()  # phase 53's bus: a checkpointed and a streamed fit

    def on_flagship(X, y, solo):
        served["logistic"] = solo[0].weights.detach().cpu()
        # 39. the same fit over meshes of 1, 3 and 4 slots of the card
        mesh_fit(port, fk, smi, X, y, solo, launches)
        torch.cuda.empty_cache()
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
        # 43. the same fit checkpointed in barrier-committed generations
        dist_ckpt_fit(port, fk, smi, X, y, solo, launches)
        cv_path(port, fk, glm, smi, X, y, launches, keep=cv_ref)
        torch.cuda.empty_cache()
        # 46-47. the grid fits over 4 slots held to phases 22, 27 and 23;
        # the sharded weight update
        mesh_sweep(port, fk, glm, smi, X, y, {
            "sweep": sweep_ref, "lbfgs": lbfgs_ref, "cv": cv_ref}, launches)
        cv_ref.clear()
        torch.cuda.empty_cache()
        sharded_update(port, fk, smi, X, y, launches)
        torch.cuda.empty_cache()
        # 53 (a, b, c's checkpointed fit). the fit's spans and its trace
        telemetry_phase(port, fk, smi, X, y, solo, launches, tel53)
        torch.cuda.empty_cache()
        flagship.update(host=pinned_copy(streaming, X, y), solo=solo)

    def on_softmax(Xa, y, solo):
        served["softmax"] = solo[0].weights.detach().cpu()
        # 40 (b). config 4 over 4 slots, shard views of Xa
        mesh_softmax(port, fk, smi, Xa, y, solo, launches)
        torch.cuda.empty_cache()
        # 48. a {data: 2, model: 2} mesh: classes over the model axis
        tensor_parallel(port, fk, glm, smi, Xa, y, solo, launches)
        torch.cuda.empty_cache()
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
                 sweep_ref.pop("res"), lbfgs_ref.pop("res"), launches,
                 keep=stream33)
    supervised_stream(port, fk, streaming, smi, flagship["host"],
                      stream_ref, launches)
    # 53 (c). a shallow streamed fit on phase 53's bus
    telemetry_stream(port, fk, streaming, smi, flagship["host"], tel53,
                     launches)
    # 41. the stream over a mesh of 2 slots, then the dry run
    mesh_stream(port, fk, streaming, smi, flagship["host"], stream_ref,
                stream33.pop("res"), launches)
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
    # 40 (a). config 1 as a RowShardedCSR over 4 slots
    mesh_rcv1(port, fk, sparse, glm, smi, rcv1, launches)
    torch.cuda.empty_cache()
    # 49 (a). its columns over 4 model slots
    feature_sharded_rcv1(port, fk, sparse, glm, smi, rcv1, launches)
    torch.cuda.empty_cache()
    # 34 and 42 (inside 11). the file cut into part files and streamed,
    # then read by two processes of a gloo group
    phase_libsvm(port, sparse, native, rcv1, lambda path, data, Xf:
                 multiprocess(port, fk, smi, stream_libsvm(
                     port, streaming, smi, path, data, Xf, rcv1["cfg"],
                     launches), launches))
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
    # 44-45. covtype.binary's published size as part files over two gloo
    # ranks: a rank killed, detected from heartbeats, resumed elastically
    # and degraded; then a straggler rebalanced away
    dist_fault_drill(port, fk, smi, device_synth, launches)
    torch.cuda.empty_cache()
    # 28-29 and 38. LIBSVM epsilon's shape: the stream mode, the path over
    # 8 strengths in the lanes kernel's cluster mode, the chaos campaigns
    epsilon_sweep = {}

    def on_epsilon(X, y, solo):
        epsilon_sweep.update(sweep_path(
            port, fk, losses, smi, X, y, solo, launches, "epsilon_sweep",
            "lanes_cluster"))
        chaos_soak(port, fk, smi, X, y, solo, launches)
        # 49 (b). its columns over 4 model slots
        feature_sharded_dense(port, fk, smi, X, y, launches)

    epsilon = epsilon_path(port, fk, losses, device_synth, smi, launches,
                           on_epsilon)
    torch.cuda.empty_cache()
    linreg_path(port, fk, device_synth, glm, smi, launches)
    torch.cuda.empty_cache()
    mlp_path(port, device_synth, smi, fk, keep=served)
    torch.cuda.empty_cache()
    # 50-52. the three models served; the train -> canary -> promote loop;
    # the flagship model served by a fleet of replica processes
    fleet_w = served["logistic"]
    serve_phase(port, fk, smi, served)
    served.clear()
    pipeline_phase(port, fk, smi, launches)
    torch.cuda.empty_cache()
    fleet_phase(port, fk, smi, fleet_w)
    del fleet_w
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
             "supervised_stream", "chaos_soak", "mesh_fit", "mesh_stream",
             "dryrun", "multiprocess", "dist_ckpt_fit", "dist_fault_drill",
             "straggler_rebalance", "pipeline", "telemetry")
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
    softmax_paths = ("softmax_lbfgs_path", "softmax_sweep", "softmax_wide",
                     "mesh_softmax", "tensor_parallel")
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
                   "stream_lbfgs_sweep", "supervised_path", "mesh_sweep",
                   "mesh_lbfgs_sweep", "mesh_stream_sweep")
    lanes["launches_by_path"] = {p: launches[p] for p in lanes_paths}
    lanes["launches_by_path"]["dryrun"] = launches["dryrun_lanes"]
    lanes["modes_by_path"] = {p: launches["lanes_modes"][p]
                              for p in ("sweep_path", "lbfgs_sweep_path",
                                        "epsilon_sweep", "wide_sweep",
                                        "stream_sweep",
                                        "stream_lbfgs_sweep",
                                        "supervised_path", "mesh_sweep",
                                        "mesh_lbfgs_sweep",
                                        "mesh_stream_sweep", "dryrun")}
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
