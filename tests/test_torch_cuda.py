"""The port's CUDA kernels and models on the card (``-m cuda``; skips
without one).

This file imports only torch and the port, so that it runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)
Tolerances are those of ``tests/test_pallas.py``: loss rtol 1e-5,
gradient rtol 1e-4 with an absolute floor of 1e-4 of its largest entry."""

import time

import numpy as np
import pytest
import torch

import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.ops import fused_kernels as fk, losses


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["logistic", "least_squares", "hinge"])
def test_kernel_matches_plain_version(cuda, name):
    """Ragged shapes, f32 and bf16 X, masked rows; two calls give the
    same bits and each adds one launch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    for n, d in [(1003, 777), (37, 13), (4099, 1000)]:
        X = torch.randn((n, d), generator=gen, device=cuda)
        y = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
        m = (torch.rand(n, generator=gen, device=cuda) < 0.7).float()
        w = torch.randn(d, generator=gen, device=cuda) / d ** 0.5
        for xt in (X, X.to(torch.bfloat16)):
            staged = fk.stage_dense(xt, y, m)
            inner = losses.GRADIENTS[name]()
            before = fk.launch_count
            loss, grad = fk.fused_margin_loss_grad(inner, w, staged)
            loss2, grad2 = fk.fused_margin_loss_grad(inner, w, staged)
            torch.cuda.synchronize()
            assert fk.launch_count == before + 2
            assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
            ref_loss, ref_grad = fk.fused_margin_loss_grad_reference(
                inner, w, staged)
            assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
            torch.testing.assert_close(
                grad, ref_grad, rtol=1e-4,
                atol=1e-4 * float(ref_grad.abs().max()))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    X = torch.randn((8, 4), device=cuda)
    staged = fk.stage_dense(X, torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="w must be"):
        fk.fused_margin_loss_grad(losses.LogisticGradient(),
                                  torch.zeros(5, device=cuda), staged)
    bad = fk.StagedDense(X.T, staged.y, staged.m, staged.n_valid)
    with pytest.raises(ValueError, match="contiguous"):
        fk.fused_margin_loss_grad(losses.LogisticGradient(),
                                  torch.zeros(8, device=cuda), bad)


# the narrow mode's register-bucket edges, the warp-rows mode's column
# buckets and its hand-over to the tile ("hand", resolved on the card),
# the tile's hand-over to the stream mode ("tile"), the stream mode's
# register buckets where its rows a stage change (1,024 | 1,025, 2,048 |
# 2,049, 4,096 | 4,097), its widest X ("max"), one column past it (the
# cluster mode), a gene-expression-like width, the cluster mode's widest
# X ("cmax") and one column past it (the grid mode), the grid mode's
# widest X ("gmax") and one column past it (the two-pass mode)
WIDTHS = [1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 64, 65, 127, 129, "hand-1",
          "hand", "hand+1", "tile", "tile+1", 1000, 1_024, 1_025, 2_048,
          2_049, 4_096, 4_097, "max", "max+1", 40_000, "cmax", "cmax+1",
          "gmax", "gmax+1"]


def _warp_rows(d, dtype, hand):
    """The warp-rows mode's widths: 33 to the hand-over, bf16 X of odd
    width only to 128 columns."""
    return 32 < d <= hand and (dtype == torch.float32 or d % 2 == 0
                               or d <= 128)


def _wide_mode(d, dtype, cmax):
    """Past one block a row: the cluster mode to ``cmax``, but f32 rows
    that are not 16-byte aligned from ``grid_unaligned_from_width``; the
    grid mode to ``grid_max_width``; the two-pass mode past it."""
    unaligned_from = fk.grid_unaligned_from_width(dtype)
    unaligned = d * torch.tensor([], dtype=dtype).element_size() % 16 != 0
    if d <= cmax and not (unaligned and unaligned_from
                          and d >= unaligned_from):
        return "cluster"
    return "grid" if d <= fk.grid_max_width(dtype) else "two_pass"


def _expected_mode(d, dtype, hand, limit, cmax):
    return ("narrow" if d <= 32 else "warp_rows" if _warp_rows(d, dtype, hand)
            else "tile" if d <= fk.tile_max_width(dtype)
            else "stream" if d <= limit else _wide_mode(d, dtype, cmax))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("width", WIDTHS, ids=str)
def test_width_rule_and_tile_budget(cuda, width, dtype):
    """Every width launches the kernel: the narrow mode up to 32 columns,
    the warp-rows mode to its hand-over, the tile up to
    ``tile_max_width``, the stream mode up to ``max_width`` (the widest X
    one block a row takes), the cluster mode past it up to
    ``cluster_max_width`` (at least 40,000 columns), the grid mode up to
    ``grid_max_width`` (past 2M columns on 132 SMs), the two-pass mode
    past that.  Each call agrees with the plain version, repeats give the
    same bits, and each launch counts once, under the mode that
    ``launch_shape`` reports."""
    limit = fk.max_width(dtype)
    hand = fk.warp_rows_max_width()
    tile = fk.tile_max_width(dtype)
    cmax = fk.cluster_max_width(dtype)
    gmax = fk.grid_max_width(dtype)
    assert 32 < hand < tile < 1000 < 8_192 <= limit < 40_000 <= cmax < gmax
    d = {"max": limit, "max+1": limit + 1, "hand-1": hand - 1, "hand": hand,
         "hand+1": hand + 1, "tile": tile, "tile+1": tile + 1,
         "cmax": cmax, "cmax+1": cmax + 1, "gmax": gmax,
         "gmax+1": gmax + 1}.get(width, width)
    n = 4_099 if d <= 1000 else 300
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    X = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
    y = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
    m = (torch.rand(n, generator=gen, device=cuda) < 0.7).float()
    w = torch.randn(d, generator=gen, device=cuda) / d ** 0.5
    staged = fk.FusedLogisticGradient().prepare(X, y, m)[0]
    plan = fk.launch_shape(staged.X)
    assert plan.mode == _expected_mode(d, dtype, hand, limit, cmax)
    assert fk.warp_rows_takes(d, dtype) == (plan.mode == "warp_rows")
    assert (plan.cluster > 1) == (plan.mode == "cluster")
    if plan.mode == "tile":
        # whole warps per tile
        assert plan.tile_rows % 8 == 0
    if plan.mode == "stream":
        # a ring of 2 to 4 stages, one block an SM
        assert 2 <= plan.tile_rows <= 4 and plan.grid == plan.partials
        assert plan.grid <= fk._device_sms(cuda.index or 0)
    if plan.mode == "grid":
        # a block on every SM, stages of 1 to 8 rows, the outputs written
        # by the blocks themselves
        assert plan.grid == fk._device_sms(cuda.index or 0)
        assert 1 <= plan.tile_rows <= 8 and plan.partials == 0
    assert plan.grid >= 1 and plan.partials >= (plan.mode != "grid")
    inner = losses.LogisticGradient()
    before = fk.launch_count
    before_mode = fk.margin_mode_launches[plan.mode]
    loss, grad = fk.fused_margin_loss_grad(inner, w, staged)
    assert fk.launch_count == before + 1
    assert fk.margin_mode_launches[plan.mode] == before_mode + 1
    loss2, grad2 = fk.fused_margin_loss_grad(inner, w, staged)
    torch.cuda.synchronize()
    assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
    ref_loss, ref_grad = fk.fused_margin_loss_grad_reference(inner, w,
                                                             staged)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-4,
                               atol=1e-4 * float(ref_grad.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_warp_rows_mode_edges(cuda, dtype):
    """The warp-rows mode at its edges: 32 | 33 columns (narrow | warp
    rows), its column buckets (64 | 65, 128 | 129), widths whose rows are
    not aligned to 16 bytes or to a column pair (54, 90, 127), the
    hand-over to the tile and one column either side; row counts of 1,
    one short of a warp's rows and not a multiple of them; masked and
    unmasked.  Each call agrees with the plain version and repeats give
    the same bits."""
    hand = fk.warp_rows_max_width()
    gen = torch.Generator(device=cuda)
    gen.manual_seed(11)
    inner = losses.LogisticGradient()
    for d in (32, 33, 54, 64, 65, 90, 127, 128, 129, hand - 1, hand,
              hand + 1):
        for n in (1, 7, 4_099):
            X = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
            y = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
            m = (torch.rand(n, generator=gen, device=cuda) < 0.7).float()
            w = torch.randn(d, generator=gen, device=cuda) / d ** 0.5
            for mask in (None, m):
                staged = fk.stage_dense(X, y, mask)
                plan = fk.launch_shape(staged.X)
                assert plan.mode == _expected_mode(
                    d, dtype, hand, fk.max_width(dtype),
                    fk.cluster_max_width(dtype)), (d, plan)
                loss, grad = fk.fused_margin_loss_grad(inner, w, staged)
                loss2, grad2 = fk.fused_margin_loss_grad(inner, w, staged)
                torch.cuda.synchronize()
                assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
                ref_loss, ref_grad = fk.fused_margin_loss_grad_reference(
                    inner, w, staged)
                assert float(loss) == pytest.approx(float(ref_loss),
                                                    rel=1e-5, abs=1e-30)
                torch.testing.assert_close(
                    grad, ref_grad, rtol=1e-4,
                    atol=1e-4 * float(ref_grad.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_stream_mode_edges(cuda, dtype):
    """The stream mode at its edges: the narrowest width it takes (one
    past ``tile_max_width``), a flagship width, rows not 16-byte aligned
    (odd widths, and X one element into its buffer: each stage's bulk
    copy covers its rows with whole 16-byte chunks, and the elements of
    a chunk that X does not fill are copied plainly) and the widest X it
    takes; no rows,
    one row, fewer rows than a stage and a ragged last stage; masked and
    unmasked; all three losses at one width.  Each call agrees with the
    plain version (loss rtol 1e-5, gradient rtol 1e-4 + 1e-4 max|g|),
    repeats give the same bits, and each launch counts once under the
    stream mode."""
    limit = fk.max_width(dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(15)
    first = fk.tile_max_width(dtype) + 1
    cases = [(first, 0), (1000, 0), (1000, 1), (2_001, 0), (limit, 0),
             (limit, 1)]
    for d, offset in cases:
        for n in (0, 1, 7, 1_003):
            X, y, m, w = _cluster_case(gen, cuda, n, d, dtype, offset)
            names = (["logistic", "least_squares", "hinge"]
                     if d == 2_001 else ["logistic"])
            for name, mask in [(nm, mk) for nm in names for mk in (None, m)]:
                inner = losses.GRADIENTS[name]()
                staged = fk.stage_dense(X, y, mask)
                plan = fk.launch_shape(staged.X)
                assert plan.mode == "stream", (d, plan)
                before = fk.launch_count, fk.margin_mode_launches["stream"]
                loss, grad = fk.fused_margin_loss_grad(inner, w, staged)
                loss2, grad2 = fk.fused_margin_loss_grad(inner, w, staged)
                torch.cuda.synchronize()
                assert (fk.launch_count, fk.margin_mode_launches["stream"]) \
                    == (before[0] + 2, before[1] + 2)
                assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
                ref_loss, ref_grad = fk.fused_margin_loss_grad_reference(
                    inner, w, staged)
                assert float(loss) == pytest.approx(float(ref_loss),
                                                    rel=1e-5, abs=1e-30)
                torch.testing.assert_close(
                    grad, ref_grad, rtol=1e-4,
                    atol=1e-4 * float(ref_grad.abs().max()))


def _wide_fit(n, d, seed, mode):
    """An 8-iteration logistic AGD fit of n x d f32 X through the kernel,
    every launch in ``mode``, against the plain fit."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-X[:, 0] + X[:, 1]))) \
        .astype(np.float32)
    w0 = np.zeros(d, np.float32)
    kw = dict(reg_param=0.1, num_iterations=8, convergence_tol=0.0,
              initial_weights=w0)
    before = fk.launch_count
    before_mode = fk.margin_mode_launches[mode]
    w, hist = port.run((X, y), port.FusedLogisticGradient(),
                       port.SquaredL2Updater(), **kw)
    assert w.device.type == "cuda"
    launched = fk.launch_count - before
    assert launched > 0
    assert fk.margin_mode_launches[mode] - before_mode == launched
    _, hist_plain = port.run((X, y), port.LogisticGradient(),
                             port.SquaredL2Updater(), **kw)
    np.testing.assert_allclose(hist, hist_plain, rtol=1e-4)


@pytest.mark.cuda
def test_wide_fused_fit_on_the_card_matches_the_plain_fit(cuda):
    """2,000 x 25,000 f32, past the one-pass tile: the cluster mode
    carries the fit, one launch per evaluation."""
    _wide_fit(2_000, 25_000, 12, "cluster")


@pytest.mark.cuda
def test_fit_past_the_cluster_reach_runs_the_two_pass_mode(cuda):
    """A few rows one column past the grid mode's reach, which lies past
    the cluster mode's: the two-pass mode carries the fit."""
    _wide_fit(64, fk.grid_max_width(torch.float32) + 1, 13, "two_pass")


@pytest.mark.cuda
def test_fit_past_the_cluster_mode_runs_the_grid_mode(cuda):
    """A few rows one column past the cluster mode's widest X: the grid
    mode carries the fit, one launch per evaluation."""
    _wide_fit(64, fk.cluster_max_width(torch.float32) + 1, 15, "grid")


def _cluster_case(gen, cuda, n, d, dtype, offset):
    """n x d X of ``dtype`` starting ``offset`` elements into its buffer
    (an offset of 1 leaves no row slice 16-byte aligned), labels, a mask
    and weights."""
    buf = torch.randn(n * d + offset, generator=gen, device=cuda).to(dtype)
    X = buf[offset:].view(n, d)
    y = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
    m = (torch.rand(n, generator=gen, device=cuda) < 0.7).float()
    w = torch.randn(d, generator=gen, device=cuda) / d ** 0.5
    return X, y, m, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cluster_mode_edges(cuda, dtype):
    """The cluster mode at its edges: one column past the tile, widths
    whose rows are 16-byte aligned (bulk copies) or not (odd widths, and
    X one element into its buffer: cp.async copies), so that the last
    block's slice is ragged, and the mode's widest X; no rows, rows of 1,
    7 and not a multiple of a stage's rows times the clusters; masked and
    unmasked; all three losses at one width.  Each call agrees with the
    plain version and repeats give the same bits."""
    limit = fk.max_width(dtype)
    cmax = fk.cluster_max_width(dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(14)
    cases = [(limit + 1, 0), (40_000, 0), (40_000, 1), (40_001, 0),
             (65_537, 0), (cmax, 0)]
    for d, offset in cases:
        for n in (0, 1, 7, 1_003 if d < cmax else 97):
            X, y, m, w = _cluster_case(gen, cuda, n, d, dtype, offset)
            names = (["logistic", "least_squares", "hinge"]
                     if d == 40_001 else ["logistic"])
            for name, mask in [(nm, mk) for nm in names for mk in (None, m)]:
                inner = losses.GRADIENTS[name]()
                staged = fk.stage_dense(X, y, mask)
                plan = fk.launch_shape(staged.X)
                assert plan.mode == "cluster" and plan.cluster > 1, (d, plan)
                assert plan.grid == plan.partials * plan.cluster
                before = fk.margin_mode_launches["cluster"]
                loss, grad = fk.fused_margin_loss_grad(inner, w, staged)
                loss2, grad2 = fk.fused_margin_loss_grad(inner, w, staged)
                torch.cuda.synchronize()
                assert fk.margin_mode_launches["cluster"] == before + 2
                assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
                ref_loss, ref_grad = fk.fused_margin_loss_grad_reference(
                    inner, w, staged)
                assert float(loss) == pytest.approx(float(ref_loss),
                                                    rel=1e-5, abs=1e-30)
                torch.testing.assert_close(
                    grad, ref_grad, rtol=1e-4,
                    atol=1e-4 * float(ref_grad.abs().max()))


@pytest.mark.cuda
def test_rejected_cluster_plan_raises_and_launches_nothing_else(cuda,
                                                                monkeypatch):
    """A cluster plan that fails the kernel's check of its arguments (a
    grid that is not whole clusters) comes back as a CUDA error code: the
    wrapper raises on it, counts nothing and launches no other mode in
    its place, as it does for any code that the launch returns."""
    d = 40_000
    X = torch.randn((64, d), device=cuda)
    staged = fk.stage_dense(X, torch.zeros(64, device=cuda))
    plan = fk.launch_shape(X)
    assert plan.mode == "cluster"
    raw = list(plan.raw)
    raw[2] += 1
    monkeypatch.setattr(fk, "launch_shape", lambda X: plan._replace(
        grid=raw[2], raw=tuple(raw)))
    before = fk.launch_count, dict(fk.margin_mode_launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        fk.fused_margin_loss_grad(losses.LogisticGradient(),
                                  torch.zeros(d, device=cuda), staged)
    assert (fk.launch_count, dict(fk.margin_mode_launches)) == before


def _assert_plain(loss, grad, inner, w, staged):
    ref_loss, ref_grad = fk.fused_margin_loss_grad_reference(inner, w,
                                                             staged)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5,
                                        abs=1e-30)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-4,
                               atol=1e-4 * float(ref_grad.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_grid_mode_edges(cuda, dtype):
    """The grid mode one column past the hand-over from the cluster mode,
    one past the cluster mode's reach (262,145: rows not 16-byte
    aligned), and at 262,152 columns, whose rows are aligned (bulk
    copies), and the same with X one element into its buffer (cp.async
    copies); no rows, rows of 1, 7 and 97 (not a multiple of a stage's
    rows); masked and unmasked; all three losses at two widths.  Each
    call agrees with the plain version, repeats give the same bits and
    each launch counts once under the grid mode."""
    cmax = fk.cluster_max_width(dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(16)
    cases = [(cmax + 1, 0), (262_145, 0), (262_152, 0), (262_152, 1)]
    for d, offset in cases:
        for n in (0, 1, 7, 97):
            X, y, m, w = _cluster_case(gen, cuda, n, d, dtype, offset)
            names = (["logistic", "least_squares", "hinge"]
                     if d in (cmax + 1, 262_152) and n == 97
                     else ["logistic"])
            for name, mask in [(nm, mk) for nm in names for mk in (None, m)]:
                inner = losses.GRADIENTS[name]()
                staged = fk.stage_dense(X, y, mask)
                plan = fk.launch_shape(staged.X)
                assert plan.mode == "grid" and plan.partials == 0, (d, plan)
                before = fk.margin_mode_launches["grid"]
                loss, grad = fk.fused_margin_loss_grad(inner, w, staged)
                loss2, grad2 = fk.fused_margin_loss_grad(inner, w, staged)
                torch.cuda.synchronize()
                assert fk.margin_mode_launches["grid"] == before + 2
                assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
                _assert_plain(loss, grad, inner, w, staged)


@pytest.mark.cuda
def test_grid_mode_words_are_clean_between_calls(cuda):
    """The grid mode's tagged words start at zero in every call: a call,
    the same call back to back, then after a call with no rows and one
    with a single row (whose words end at other stages), gives the same
    bits."""
    d = fk.cluster_max_width(torch.float32) + 1
    gen = torch.Generator(device=cuda)
    gen.manual_seed(17)
    inner = losses.LogisticGradient()
    X, y, m, w = _cluster_case(gen, cuda, 97, d, torch.float32, 0)
    staged = fk.stage_dense(X, y, m)
    first = fk.fused_margin_loss_grad(inner, w, staged)
    again = fk.fused_margin_loss_grad(inner, w, staged)
    for n in (0, 1):
        Xs, ys, _, _ = _cluster_case(gen, cuda, n, d, torch.float32, 0)
        other = fk.stage_dense(Xs, ys)
        assert fk.launch_shape(other.X).mode == "grid"
        fk.fused_margin_loss_grad(inner, w, other)
        after = fk.fused_margin_loss_grad(inner, w, staged)
        torch.cuda.synchronize()
        assert torch.equal(first[0], after[0])
        assert torch.equal(first[1], after[1])
    assert torch.equal(first[0], again[0]) and torch.equal(first[1],
                                                           again[1])
    _assert_plain(*first, inner, w, staged)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_grid_plan_takes_the_widths_between_the_hand_overs(cuda, dtype):
    """At a few hundred rows the plan gives the cluster mode up to
    ``cluster_max_width``, the grid mode from the next column up to
    ``grid_max_width`` and the two-pass mode one column past it; f32 rows
    that are not 16-byte aligned take the grid mode from
    ``grid_unaligned_from_width`` (184,321 columns: the unaligned width
    under it, and aligned widths about it, the cluster mode; bf16 none); a
    grid plan has a block on every SM."""
    lib = fk.library()[0]
    sms = fk._device_sms(cuda.index or 0)
    size = torch.tensor([], dtype=dtype).element_size()
    cmax, gmax = fk.cluster_max_width(dtype), fk.grid_max_width(dtype)
    assert cmax < 500_000 < gmax
    unaligned_from = fk.grid_unaligned_from_width(dtype)
    assert unaligned_from == (184_321 if size == 4 else 0)
    cases = [(cmax, "cluster"), (cmax + 1, "grid"), (500_000, "grid"),
             (gmax, "grid"), (gmax + 1, "two_pass"),
             (184_317, "cluster"), (184_320, "cluster"),
             (184_321, "grid" if size == 4 else "cluster"),
             (196_607, "grid" if size == 4 else "cluster"),
             (262_143, "grid" if size == 4 else "cluster")]
    for d, want in cases:
        plan = fk.plan_for(lib, 300, d, size, sms)
        assert plan.mode == want, (d, plan)
        if want == "grid":
            assert plan.grid == sms and plan.partials == plan.cluster == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1_000, 5_000, 40_000])
def test_forced_grid_plan_below_the_hand_over_matches_plain(cuda, d):
    """The grid mode forced where the plan gives another mode (a block
    for each 32-column unit at 1,000 columns, fewer blocks than SMs; a
    block on every SM at 5,000 and 40,000): the plain version's result,
    the same bits on repeat."""
    lib = fk.library()[0]
    sms = fk._device_sms(cuda.index or 0)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(18)
    inner = losses.HingeGradient()
    X, y, m, w = _cluster_case(gen, cuda, 1_003, d, torch.float32, 0)
    staged = fk.stage_dense(X, y, m)
    plan = fk.mode_plan_for(lib, 1_003, d, 4, sms, "grid")
    assert plan.mode == "grid" and fk.launch_shape(X).mode != "grid"
    assert plan.grid == min(sms, -(-d // 32))
    loss, grad = fk.margin_launch(lib, 2, w, staged, plan)
    loss2, grad2 = fk.margin_launch(lib, 2, w, staged, plan)
    torch.cuda.synchronize()
    assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
    _assert_plain(loss, grad, inner, w, staged)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("units", [1, 2])
def test_forced_grid_plan_at_narrow_slices_repeats_its_bits(cuda, dtype,
                                                            units):
    """The grid mode forced at 32 and 64 columns a block on every SM (the
    last block a column short), where a stage's dots take a block least
    time and its warps run furthest ahead of its partial-dot store: 20
    calls of 4,003 rows give the same bits, and the plain version's
    result."""
    lib = fk.library()[0]
    sms = fk._device_sms(cuda.index or 0)
    d = sms * 32 * units - 1
    gen = torch.Generator(device=cuda)
    gen.manual_seed(19)
    X, y, m, w = _cluster_case(gen, cuda, 4_003, d, dtype, 0)
    staged = fk.stage_dense(X, y, m)
    plan = fk.mode_plan_for(lib, 4_003, d, X.element_size(), sms, "grid")
    assert plan.mode == "grid" and plan.grid == sms
    for code, inner in ((0, losses.LogisticGradient()),
                        (2, losses.HingeGradient())):
        loss, grad = fk.margin_launch(lib, code, w, staged, plan)
        for _ in range(20):
            loss2, grad2 = fk.margin_launch(lib, code, w, staged, plan)
            assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
        _assert_plain(loss, grad, inner, w, staged)


@pytest.mark.cuda
def test_refused_cooperative_launch_raises_and_launches_nothing_else(
        cuda, monkeypatch):
    """A grid plan of one block more than the SMs, whose blocks take more
    than half an SM's shared memory, cannot be resident at once: the
    card refuses the cooperative launch, the wrapper raises, counts
    nothing and launches no other mode in its place; the refusal is not
    reported again against the next launch."""
    d = 300_000
    X = torch.randn((64, d), device=cuda)
    staged = fk.stage_dense(X, torch.zeros(64, device=cuda))
    plan = fk.launch_shape(X)
    assert plan.mode == "grid"
    raw = list(plan.raw)
    raw[2] += 1
    monkeypatch.setattr(fk, "launch_shape", lambda X: plan._replace(
        grid=raw[2], raw=tuple(raw)))
    before = fk.launch_count, dict(fk.margin_mode_launches)
    w = torch.zeros(d, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        fk.fused_margin_loss_grad(losses.LogisticGradient(), w, staged)
    assert (fk.launch_count, dict(fk.margin_mode_launches)) == before
    loss, grad = fk.margin_launch(fk.library()[0], 0, w, staged, plan)
    ref_loss, ref_grad = fk.fused_margin_loss_grad_reference(
        losses.LogisticGradient(), w, staged)
    torch.cuda.synchronize()
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [-1, 1, 3])
def test_stream_plan_of_another_depth_raises(cuda, monkeypatch, offset):
    """The stream mode's ring has the one depth its plan gives the width:
    a plan of another depth fails the kernel's check, the wrapper raises,
    counts nothing and launches no other mode; a forced stream plan
    (``mode_plan_for``) is the plan's own whatever its last argument."""
    d = 2_000
    X = torch.randn((64, d), device=cuda)
    staged = fk.stage_dense(X, torch.zeros(64, device=cuda))
    plan = fk.launch_shape(X)
    assert plan.mode == "stream"
    lib = fk.library()[0]
    sms = fk._device_sms(cuda.index or 0)
    for c in (0, 2, 6):
        assert fk.mode_plan_for(lib, 64, d, 4, sms, "stream", c) == plan
    raw = list(plan.raw)
    raw[1] += offset
    monkeypatch.setattr(fk, "launch_shape", lambda X: plan._replace(
        tile_rows=raw[1], raw=tuple(raw)))
    before = fk.launch_count, dict(fk.margin_mode_launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        fk.fused_margin_loss_grad(losses.LogisticGradient(),
                                  torch.zeros(d, device=cuda), staged)
    assert (fk.launch_count, dict(fk.margin_mode_launches)) == before


@pytest.mark.cuda
def test_fused_fit_on_the_card_matches_the_plain_fit(cuda):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((20_000, 64)).astype(np.float32)
    y = (rng.random(20_000) < 1 / (1 + np.exp(-X[:, 0]))).astype(np.float32)
    w0 = np.zeros(64, np.float32)
    g = port.FusedLogisticGradient()
    before = fk.launch_count
    w, hist = port.run((X, y), g, port.SquaredL2Updater(), reg_param=0.1,
                       num_iterations=8, convergence_tol=0.0,
                       initial_weights=w0)
    assert w.device.type == "cuda"
    assert fk.launch_count > before
    _, hist_plain = port.run((X, y), port.LogisticGradient(),
                             port.SquaredL2Updater(), reg_param=0.1,
                             num_iterations=8, convergence_tol=0.0,
                             initial_weights=w0)
    np.testing.assert_allclose(hist, hist_plain, rtol=1e-4)


def _softmax_case(gen, dev, n, d, k):
    X = torch.randn((n, d), generator=gen, device=dev)
    y = torch.randint(0, k, (n,), generator=gen, device=dev)
    m = (torch.rand(n, generator=gen, device=dev) < 0.7).float()
    W = torch.randn((d, k), generator=gen, device=dev) / d ** 0.5
    return X, y, m, W


def _assert_softmax_close(loss, grad, ref_loss, ref_grad):
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-4,
                               atol=1e-4 * float(ref_grad.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8, 9, 10, 16, 17, 32])
def test_softmax_kernel_matches_plain_version(cuda, k):
    """Ragged shapes, f32 and bf16 X, masked rows, W = 0 and random; two
    calls give the same bits and each adds one launch.  K = 8, 9 and 16
    sit at the edges of the kernel's n8-tile class buckets."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(k)
    for n, d in [(1003, 777), (37, 13), (4099, 785)]:
        X, y, m, W = _softmax_case(gen, cuda, n, d, k)
        for xt in (X, X.to(torch.bfloat16)):
            for mask in (None, m):
                staged = fk.stage_softmax(xt, y, k, mask)
                for w in (torch.zeros_like(W), W):
                    before = fk.softmax_launch_count
                    loss, grad = fk.fused_softmax_loss_grad(k, w, staged)
                    loss2, grad2 = fk.fused_softmax_loss_grad(k, w, staged)
                    torch.cuda.synchronize()
                    assert fk.softmax_launch_count == before + 2
                    assert torch.equal(loss, loss2)
                    assert torch.equal(grad, grad2)
                    _assert_softmax_close(
                        loss, grad,
                        *fk.fused_softmax_loss_grad_reference(k, w, staged))


def _softmax_mode_case(gen, cuda, n, d, k, dtype, want_mode):
    """The kernel against its plain version at (n, d, k) in ``dtype``,
    masked, with the plan's mode held to ``want_mode`` and the launch
    counted under it."""
    X, y, m, W = _softmax_case(gen, cuda, n, d, k)
    staged = fk.stage_softmax(X.to(dtype), y, k, m)
    assert fk.softmax_launch_shape(staged.X, k).mode == want_mode
    before = fk.softmax_mode_launches[want_mode]
    _assert_softmax_close(*fk.fused_softmax_loss_grad(k, W, staged),
                          *fk.fused_softmax_loss_grad_reference(k, W,
                                                                staged))
    assert fk.softmax_mode_launches[want_mode] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_class_limit(cuda, dtype):
    """No class limit: across the hand-over from the one-read kernel to
    the two-pass mode, at D = 785 with K = 32, 33, 64, 100 and 1000 and
    at K = 10 around the widest X the one-read kernel takes, the kernel
    agrees with its plain version in the mode the plan names."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    assert fk.softmax_one_read_max_width(32, dtype) >= 785
    assert fk.softmax_one_read_max_width(33, dtype) == 0
    for k in (32, 33, 64, 100, 1000):
        _softmax_mode_case(gen, cuda, 2000, 785, k, dtype,
                           "one_read" if k <= 32 else "two_pass")
    edge = fk.softmax_one_read_max_width(10, dtype)
    assert edge >= 785
    for d in (edge - 1, edge, edge + 1):
        _softmax_mode_case(gen, cuda, 1003, d, 10, dtype,
                           "one_read" if d <= edge else "two_pass")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 100])
def test_softmax_two_pass_same_bits_on_repeat(cuda, k):
    """The two-pass mode (forced at K = 10, where the one-read kernel
    fits; the plan's own at K = 100) gives the same bits on repeat and
    agrees with the plain version; at K = 10 with the one-read kernel
    too.  More rows than one chunk of residuals at K = 100."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(k)
    n = 180_001 if k == 100 else 20_011
    X, y, m, W = _softmax_case(gen, cuda, n, 257, k)
    lib = fk.softmax_library()[0]
    sms = fk._device_sms(X.device.index)
    for xt in (X, X.to(torch.bfloat16)):
        staged = fk.stage_softmax(xt, y, k, m)
        plan = fk.softmax_plan_for(lib, n, 257, k, xt.element_size(), sms,
                                   two_pass=True)
        assert plan.mode == "two_pass"
        assert fk.softmax_launch_shape(xt, k).mode == (
            "one_read" if k <= 32 else "two_pass")
        if k == 100:
            assert plan.chunk < n  # the rows run in several chunks
        ref = fk.fused_softmax_loss_grad_reference(k, W, staged)
        loss, grad = fk.softmax_launch(lib, k, W, staged, plan)
        loss2, grad2 = fk.softmax_launch(lib, k, W, staged, plan)
        torch.cuda.synchronize()
        assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
        _assert_softmax_close(loss, grad, *ref)
        _assert_softmax_close(*fk.fused_softmax_loss_grad(k, W, staged),
                              *ref)


# the two-pass mode's edges: class counts around its 16-, 32-, 64- and
# 128-class tiles and past one tile; widths of 1 and 7 columns, one past
# a 128-column block and one past 3,072 (rows that are not 16-byte
# aligned); bf16 of odd width; fewer rows than one tile and ragged tiles
TWO_PASS_K = [1, 8, 9, 33, 100, 127, 128, 129, 1000]
TWO_PASS_SHAPES = [(5, 7, torch.float32), (37, 1, torch.float32),
                   (1003, 129, torch.float32), (301, 3073, torch.float32),
                   (517, 129, torch.bfloat16), (70, 3073, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", TWO_PASS_K)
def test_softmax_two_pass_edges(cuda, k):
    """The two-pass mode (forced where the one-read kernel takes the
    shape) at every TWO_PASS_SHAPES shape, masked and not, against the
    plain version; two calls give the same bits."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(k)
    lib = fk.softmax_library()[0]
    for n, d, dtype in TWO_PASS_SHAPES:
        X, y, m, W = _softmax_case(gen, cuda, n, d, k)
        X = X.to(dtype)
        sms = fk._device_sms(X.device.index)
        plan = fk.softmax_plan_for(lib, n, d, k, X.element_size(), sms,
                                   two_pass=True)
        assert plan.mode == "two_pass"
        for mask in (None, m):
            staged = fk.stage_softmax(X, y, k, mask)
            loss, grad = fk.softmax_launch(lib, k, W, staged, plan)
            loss2, grad2 = fk.softmax_launch(lib, k, W, staged, plan)
            torch.cuda.synchronize()
            assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
            _assert_softmax_close(
                loss, grad,
                *fk.fused_softmax_loss_grad_reference(k, W, staged))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_two_pass_over_chunks_of_rows(cuda, dtype):
    """K = 1,000 at N = 20,000: the residual scratch takes the rows in
    two chunks, whose pass-2 partials add up in stream order; masked
    rows; the plan's own mode, a launch counted a call, the same bits on
    repeat."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1000)
    n, d, k = 20_000, 129, 1000
    X, y, m, W = _softmax_case(gen, cuda, n, d, k)
    staged = fk.stage_softmax(X.to(dtype), y, k, m)
    plan = fk.softmax_launch_shape(staged.X, k)
    assert plan.mode == "two_pass" and plan.chunk < n < 2 * plan.chunk + 1
    before = fk.softmax_mode_launches["two_pass"]
    loss, grad = fk.fused_softmax_loss_grad(k, W, staged)
    loss2, grad2 = fk.fused_softmax_loss_grad(k, W, staged)
    torch.cuda.synchronize()
    assert fk.softmax_mode_launches["two_pass"] == before + 2
    assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
    _assert_softmax_close(loss, grad,
                          *fk.fused_softmax_loss_grad_reference(k, W, staged))


@pytest.mark.cuda
def test_softmax_kernel_rejects_what_it_does_not_take(cuda):
    X = torch.randn((8, 4), device=cuda)
    staged = fk.stage_softmax(X, torch.zeros(8, device=cuda), 3)
    with pytest.raises(ValueError, match="W must be"):
        fk.fused_softmax_loss_grad(3, torch.zeros((4, 2), device=cuda),
                                   staged)
    bad = fk.StagedDense(X.T, staged.y, staged.m, staged.n_valid)
    with pytest.raises(ValueError, match="contiguous"):
        fk.fused_softmax_loss_grad(3, torch.zeros((8, 3), device=cuda), bad)


@pytest.mark.cuda
def test_fused_softmax_fit_on_the_card_matches_the_plain_fit(cuda):
    rng = np.random.default_rng(4)
    n, d, k = 20_000, 64, 5
    X = rng.standard_normal((n, d)).astype(np.float32)
    W = rng.standard_normal((d, k)) / np.sqrt(d)
    y = np.argmax(X @ W + rng.gumbel(size=(n, k)), axis=1).astype(np.int32)
    w0 = np.zeros((d, k), np.float32)
    g = fk.FusedSoftmaxGradient(losses.SoftmaxGradient(k))
    before = fk.softmax_launch_count
    w, hist = port.run((X, y), g, port.SquaredL2Updater(), reg_param=1e-3,
                       num_iterations=8, convergence_tol=0.0,
                       initial_weights=w0)
    assert w.device.type == "cuda" and w.shape == (d, k)
    assert fk.softmax_launch_count > before
    _, hist_plain = port.run((X, y), losses.SoftmaxGradient(k),
                             port.SquaredL2Updater(), reg_param=1e-3,
                             num_iterations=8, convergence_tol=0.0,
                             initial_weights=w0)
    np.testing.assert_allclose(hist, hist_plain, rtol=1e-4)


@pytest.mark.cuda
def test_models_on_the_card_predict_and_stream_with_device_masks(cuda,
                                                                 tmp_path):
    """A model saved from the card loads back there; a GLM model's
    ``predict_stream`` takes batches whose X and mask lie on the card."""
    from spark_agd_tpu_torch.models import glm

    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    X = torch.randn((30, 6), generator=gen, device=cuda)
    mask = (torch.arange(30, device=cuda) % 3 > 0).float()
    for model in (glm.LogisticRegressionModel(
                      torch.randn(6, generator=gen, device=cuda), 0.2),
                  glm.SoftmaxRegressionModel(
                      torch.randn((6, 4), generator=gen, device=cuda),
                      torch.randn(4, generator=gen, device=cuda))):
        model.save(str(tmp_path / "m.npz"))
        loaded = glm.load_model(str(tmp_path / "m.npz"))
        assert loaded.weights.device.type == "cuda"
        pred = loaded.predict(X).cpu().numpy()
        np.testing.assert_array_equal(pred, model.predict(X).cpu().numpy())
        if not hasattr(loaded, "predict_stream"):  # softmax has none
            continue
        streamed = np.concatenate(list(loaded.predict_stream(
            [(X[:10], None, None), (X[10:], None, mask[10:])])))
        keep = np.concatenate([np.ones(10, bool),
                               mask[10:].cpu().numpy() > 0])
        np.testing.assert_array_equal(streamed, pred[keep])


# --- the sparse data plane --------------------------------------------------

def _card_csr(dev, n=5_003, d=1_021, mean=9, seed=6):
    """A CSR made on the card with varied counts (zero-value padding),
    empty rows (every 13th row loses its entries) and empty columns (ids
    below d - 5), with its twin."""
    from spark_agd_tpu_torch.data import device_synth
    from spark_agd_tpu_torch.ops import sparse

    rid, cid, val, y = device_synth.planted_sparse_parts_varied(
        n, d - 5, mean, seed=seed, device=dev)
    keep = rid % 13 != 0
    X = sparse.CSRMatrix(rid[keep], cid[keep], val[keep], (n, d),
                         rows_sorted=True).with_csc()
    X64 = sparse.CSRMatrix(
        X.row_ids, X.col_ids, X.values.double(), X.shape, rows_sorted=True,
        csc_row_ids=X.csc_row_ids, csc_col_ids=X.csc_col_ids,
        csc_values=X.csc_values.double())
    return X, X64, y


@pytest.mark.cuda
@pytest.mark.parametrize("product", ["matvec", "rmatvec", "matmat",
                                     "rmatmat"])
def test_sparse_products_repeat_bit_identical_and_match_f64(cuda, product):
    X, X64, _ = _card_csr(cuda)
    n, d = X.shape
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    shape = {"matvec": (d,), "rmatvec": (n,), "matmat": (d, 6),
             "rmatmat": (n, 6)}[product]
    a = torch.randn(shape, generator=gen, device=cuda)
    out, again = getattr(X, product)(a), getattr(X, product)(a)
    torch.cuda.synchronize()
    assert out.device.type == "cuda" and out.dtype == torch.float32
    assert torch.equal(out, again)
    ref = getattr(X64, product)(a.double())
    torch.testing.assert_close(out.double(), ref, rtol=0.0,
                               atol=1e-5 * float(ref.abs().max()))
    # the same entries on the CPU: the same function
    cpu = getattr(X.to("cpu"), product)(a.cpu())
    torch.testing.assert_close(out.cpu(), cpu, rtol=1e-5,
                               atol=1e-6 * float(ref.abs().max()))


@pytest.mark.cuda
def test_csr_on_the_card_launches_no_dense_kernel(cuda):
    X, _, y = _card_csr(cuda)
    before = (fk.launch_count, fk.softmax_launch_count)
    w, hist = port.run((X, y), port.FusedLogisticGradient(), port.L2Prox(),
                       reg_param=1e-3, num_iterations=5,
                       initial_weights=np.zeros(X.shape[1], np.float32))
    torch.cuda.synchronize()
    assert (fk.launch_count, fk.softmax_launch_count) == before
    assert w.device.type == "cuda" and np.isfinite(hist).all()


@pytest.mark.cuda
def test_libsvm_file_to_card_trainer(cuda, tmp_path):
    """``load_libsvm`` -> ``CSRMatrix.from_csr_arrays(device="cuda")`` ->
    one ``train`` step on the card, against the same step on the CPU."""
    from spark_agd_tpu_torch import native
    from spark_agd_tpu_torch.data import libsvm
    from spark_agd_tpu_torch.models import glm
    from spark_agd_tpu_torch.ops.sparse import CSRMatrix

    rng = np.random.default_rng(8)
    n, d = 3_000, 200
    X = (rng.standard_normal((n, d))
         * (rng.random((n, d)) < 0.05)).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    path = str(tmp_path / "train.libsvm")
    libsvm.save_libsvm(path, X, y)
    data = port.load_libsvm(path, n_features=d)
    assert native.pop_fallback_event("libsvm_parser.so") is None
    models = {}
    for dev in (cuda, "cpu"):
        Xs = CSRMatrix.from_csr_arrays(data.indptr, data.indices,
                                       data.values, d, device=dev)
        assert Xs.device.type == torch.device(dev).type
        t = glm.LogisticRegressionWithAGD(reg_param=1e-3)
        t.optimizer.setNumIterations(1).set_device(dev)
        models[str(dev)] = t.train(Xs, data.binarized_labels())
    card, host = models[str(cuda)], models["cpu"]
    assert card.weights.device.type == "cuda"
    assert torch.isfinite(card.weights).all()
    torch.testing.assert_close(card.weights.cpu(), host.weights, rtol=1e-5,
                               atol=1e-7)
    assert card.intercept == pytest.approx(host.intercept, rel=1e-5,
                                           abs=1e-7)


# --- the Optimizer family: GD, L-BFGS and OWL-QN, the MLP -------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sampler_on_the_card_equals_the_cpu_draw(cuda, dtype):
    from spark_agd_tpu_torch.core import prng

    for seed, it in ((0, 1), (42, 2), (2**31 - 1, 50)):
        card = prng.sample_mask(seed, it, 0.37, 100_003, dtype=dtype,
                                device=cuda)
        host = prng.sample_mask(seed, it, 0.37, 100_003, dtype=dtype,
                                device="cpu")
        assert card.device.type == "cuda" and card.dtype == dtype
        assert torch.equal(card.cpu(), host)


def _logistic_card_data(n=20_000, d=64, seed=9):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-X[:, 0] + X[:, 1]))) \
        .astype(np.float32)
    return X, y


@pytest.mark.cuda
@pytest.mark.parametrize("frac", [1.0, 0.3], ids=["full", "sampled"])
def test_fused_gd_on_the_card_matches_the_plain_gd(cuda, frac):
    """One launch an iteration, the sample folded into the staged mask;
    the history within rtol 1e-4 of the plain gradient's."""
    X, y = _logistic_card_data()
    w0 = np.zeros(X.shape[1], np.float32)
    kw = dict(step_size=1.0, num_iterations=20, reg_param=0.1,
              minibatch_fraction=frac, initial_weights=w0, seed=5)
    before = fk.launch_count
    w, hist = port.run_minibatch_sgd((X, y), port.FusedLogisticGradient(),
                                     port.SquaredL2Updater(), **kw)
    assert fk.launch_count - before == 20
    assert w.device.type == "cuda"
    w_plain, hist_plain = port.run_minibatch_sgd(
        (X, y), port.LogisticGradient(), port.SquaredL2Updater(), **kw)
    np.testing.assert_allclose(hist, hist_plain, rtol=1e-4)
    torch.testing.assert_close(w, w_plain, rtol=1e-3, atol=1e-5)


def _common(a, b):
    k = min(int(a.num_iters), int(b.num_iters))
    return a.loss_history[:k + 1].numpy(), b.loss_history[:k + 1].numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("updater", ["l2", "l1"])
def test_fused_lbfgs_on_the_card_matches_the_plain_fit(cuda, updater):
    """L-BFGS (L2) and OWL-QN (L1) through the margin kernel: one launch
    per objective evaluation; loss histories within rtol 1e-4 of the
    plain fit over their common iterations."""
    X, y = _logistic_card_data(seed=10)
    upd, reg = ((port.SquaredL2Updater(), 0.05) if updater == "l2"
                else (port.L1Prox(), 5e-3))
    kw = dict(reg_param=reg, num_iterations=10, convergence_tol=0.0,
              initial_weights=np.zeros(X.shape[1], np.float32))
    before = fk.launch_count
    res = port.run_lbfgs((X, y), port.FusedLogisticGradient(), upd, **kw)
    assert fk.launch_count - before == int(res.num_fn_evals) > 0
    plain = port.run_lbfgs((X, y), port.LogisticGradient(), upd, **kw)
    assert res.weights.device.type == "cuda"
    h, hp = _common(res, plain)
    assert len(h) >= 4
    np.testing.assert_allclose(h, hp, rtol=1e-4)
    if updater == "l1":
        assert int((res.weights == 0).sum()) > 0


@pytest.mark.cuda
def test_fused_softmax_lbfgs_on_the_card_matches_the_plain_fit(cuda):
    rng = np.random.default_rng(11)
    n, d, k = 20_000, 64, 5
    X = rng.standard_normal((n, d)).astype(np.float32)
    W = rng.standard_normal((d, k)) / np.sqrt(d)
    y = np.argmax(X @ W + rng.gumbel(size=(n, k)), axis=1).astype(np.int32)
    kw = dict(reg_param=1e-3, num_iterations=10, convergence_tol=0.0,
              initial_weights=np.zeros((d, k), np.float32))
    before = fk.softmax_launch_count
    res = port.run_lbfgs((X, y), fk.FusedSoftmaxGradient(
        losses.SoftmaxGradient(k)), port.SquaredL2Updater(), **kw)
    assert fk.softmax_launch_count - before == int(res.num_fn_evals) > 0
    plain = port.run_lbfgs((X, y), losses.SoftmaxGradient(k),
                           port.SquaredL2Updater(), **kw)
    h, hp = _common(res, plain)
    assert len(h) >= 4
    np.testing.assert_allclose(h, hp, rtol=1e-4)


@pytest.mark.cuda
def test_mlp_gradient_on_the_card_matches_the_cpu(cuda):
    from spark_agd_tpu_torch.data import device_synth
    from spark_agd_tpu_torch.models import mlp

    X, y = device_synth.planted_mlp(4_096, 64, 8, seed=3, device=cuda)
    assert X.device.type == "cuda" and y.dtype == torch.int32
    params = mlp.init_mlp_params(64, 8, 2, seed=1, device=cuda)
    for act in ("tanh", "relu", "gelu"):
        g = mlp.mlp_gradient(act)
        loss, grad, n = g.batch_loss_and_grad(params, X, y)
        loss_c, grad_c, _ = g.batch_loss_and_grad(
            {k: v.cpu() for k, v in params.items()}, X.cpu(), y.cpu())
        assert int(n) == 4_096
        assert float(loss) == pytest.approx(float(loss_c), rel=1e-5)
        for k in grad:
            torch.testing.assert_close(
                grad[k].cpu(), grad_c[k], rtol=1e-4,
                atol=1e-4 * float(grad_c[k].abs().max()))
    t = mlp.MLPClassifierWithAGD(8, 2, reg_param=1e-5)
    t.optimizer.setNumIterations(10)
    model = t.train(X, y)
    assert model.params["W1"].device.type == "cuda"
    assert float((model.predict(X) == y).float().mean()) > 0.5


# the lanes kernel: lane buckets (1, 2, 4, 8, 16) and their edges, one
# chunk past the largest bucket, and widths across its modes ("max": the
# widest X read once for those lanes, resolved on the card)
LANES = [1, 2, 3, 8, 16, 17, 20]
LANE_WIDTHS = [1, 33, 1000, "max", "max+1"]


def _lanes_modes_at(d, k, dtype):
    """The modes the plan may give k lanes (at most one launch's) over X
    of width d: the cluster mode from ``lanes_cluster_min_width`` to
    ``lanes_max_width`` (which ends where the plan hands over to the
    two-pass mode, at the cluster mode's reach or, where the two-pass
    mode was timed faster, before it), the two-pass mode past it, one
    block a row below."""
    if d > fk.lanes_max_width(k, dtype):
        return ("lanes_two_pass",)
    if d >= fk.lanes_cluster_min_width(k, dtype):
        return ("lanes_cluster",)
    return ("lanes_mma", "lanes_tile")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k", LANES)
def test_lanes_kernel_matches_plain_version(cuda, k, dtype):
    """Each mode and bucket edge against the plain version, the same bits
    on repeat, one launch a chunk of ``max_lanes`` lanes; each lane also
    within the tolerances of the solo kernel's result."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(k)
    chunk = fk.max_lanes()
    for width in LANE_WIDTHS:
        limit = fk.lanes_max_width(min(k, chunk), dtype)
        d = {"max": limit, "max+1": limit + 1}.get(width, width)
        n = 3001 if d > 1000 else 20_011
        X = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
        y = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
        m = (torch.rand(n, generator=gen, device=cuda) < 0.7).float()
        W = torch.randn((k, d), generator=gen, device=cuda) / d ** 0.5
        staged = fk.stage_dense(X, y, m)
        inner = losses.LogisticGradient()
        plan = fk.lanes_launch_shape(X, min(k, chunk))
        assert plan.mode in _lanes_modes_at(d, min(k, chunk), dtype), \
            (d, limit, plan)
        before = fk.lanes_launch_count
        loss, grad = fk.fused_margin_lanes_loss_grad(inner, W, staged)
        loss2, grad2 = fk.fused_margin_lanes_loss_grad(inner, W, staged)
        torch.cuda.synchronize()
        assert fk.lanes_launch_count == before + 2 * -(-k // chunk)
        assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
        ref_loss, ref_grad = fk.fused_margin_lanes_loss_grad_reference(
            inner, W, staged)
        torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=0.0)
        torch.testing.assert_close(
            grad, ref_grad, rtol=1e-4,
            atol=1e-4 * float(ref_grad.abs().max()))
        for lane in (0, k - 1):
            s_loss, s_grad = fk.fused_margin_loss_grad(inner, W[lane], staged)
            torch.testing.assert_close(loss[lane], s_loss, rtol=1e-5,
                                       atol=0.0)
            torch.testing.assert_close(
                grad[lane], s_grad, rtol=1e-4,
                atol=1e-4 * float(s_grad.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 3, 8, 9, 16, 17])
def test_lanes_kernel_at_fragment_edges(cuda, k, dtype):
    """The lanes kernel where its tensor-core fragments end: widths of
    one 8-column step, a multiple of 8 and 16 and one either side (999,
    1000, 1001) and one of 32 (1024); row counts that are not a multiple
    of the 16-row tile (5, 20,011); lane counts inside an n8 tile, at its
    edge, past it and past one launch (17); masked and unmasked.  Each
    call agrees with the plain version and repeats give the same bits."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(100 + k)
    inner = losses.LogisticGradient()
    for d in (8, 999, 1000, 1001, 1024):
        for n in (5, 20_011):
            X = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
            y = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
            m = (torch.rand(n, generator=gen, device=cuda) < 0.7).float()
            W = torch.randn((k, d), generator=gen, device=cuda) / d ** 0.5
            for mask in (None, m):
                staged = fk.stage_dense(X, y, mask)
                loss, grad = fk.fused_margin_lanes_loss_grad(inner, W,
                                                             staged)
                loss2, grad2 = fk.fused_margin_lanes_loss_grad(inner, W,
                                                               staged)
                torch.cuda.synchronize()
                assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
                ref_loss, ref_grad = \
                    fk.fused_margin_lanes_loss_grad_reference(inner, W,
                                                              staged)
                torch.testing.assert_close(loss, ref_loss, rtol=1e-5,
                                           atol=0.0)
                for lane in range(k):
                    torch.testing.assert_close(
                        grad[lane], ref_grad[lane], rtol=1e-4,
                        atol=1e-4 * float(ref_grad[lane].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 2, 3, 8, 9, 16])
def test_lanes_cluster_mode_edges(cuda, k, dtype):
    """The cluster mode at its edges for each lane bucket: lanes_mma's
    reach and one column past it, the narrowest width the plan gives the
    cluster mode and one column narrower, and the mode's reach and one
    past it (the two-pass mode); rows none, one, ragged to the 16-row tile, and enough that
    each cluster walks several tiles; X one element into its buffer (no
    row slice 16-byte aligned) at one width; masked and unmasked; all
    three losses at the first width past lanes_mma's reach.  Each plan's
    mode is the rule's, each call agrees with the plain version and
    repeats give the same bits.  Where the plan gives the cluster mode no
    width (16 lanes of bf16, timed slower there than the two-pass mode),
    its first width is one past the widest X read once, and the plan
    there is the two-pass mode's."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(200 + k)
    reach = fk.lanes_mma_max_width(k, dtype)
    start = fk.lanes_cluster_min_width(k, dtype)
    limit = fk.lanes_max_width(k, dtype)
    assert 1 < start <= limit + 1
    widths = sorted({reach, reach + 1, start - 1, start, limit, limit + 1})
    for d in widths:
        for n in ((0, 1, 37, 4_001) if d < 4_000 else (1, 37, 1_003)):
            offset = 1 if d == reach + 1 and n == 37 else 0
            buf = torch.randn(n * d + offset, generator=gen,
                              device=cuda).to(dtype)
            X = buf[offset:].view(n, d)
            y = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
            m = (torch.rand(n, generator=gen, device=cuda) < 0.7).float()
            W = torch.randn((k, d), generator=gen, device=cuda) / d ** 0.5
            names = (["logistic", "least_squares", "hinge"]
                     if d == reach + 1 and n == 37 else ["logistic"])
            for name, mask in [(nm, mk) for nm in names for mk in (None, m)]:
                inner = losses.GRADIENTS[name]()
                staged = fk.stage_dense(X, y, mask)
                plan = fk.lanes_launch_shape(staged.X, k)
                assert plan.mode in _lanes_modes_at(d, k, dtype), (d, plan)
                if plan.mode == "lanes_cluster":
                    assert plan.cluster > 1
                    assert plan.grid == plan.partials * plan.cluster
                before = fk.lanes_mode_launches[plan.mode]
                loss, grad = fk.fused_margin_lanes_loss_grad(inner, W, staged)
                loss2, grad2 = fk.fused_margin_lanes_loss_grad(inner, W,
                                                               staged)
                torch.cuda.synchronize()
                assert fk.lanes_mode_launches[plan.mode] == before + 2
                assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
                ref_loss, ref_grad = \
                    fk.fused_margin_lanes_loss_grad_reference(inner, W,
                                                              staged)
                if n == 0:
                    assert not loss.any() and not grad.any()
                    continue
                torch.testing.assert_close(loss, ref_loss, rtol=1e-5,
                                           atol=0.0)
                for lane in range(k):
                    torch.testing.assert_close(
                        grad[lane], ref_grad[lane], rtol=1e-4,
                        atol=1e-4 * float(ref_grad[lane].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 2, 3, 8, 9, 16])
def test_lanes_two_pass_mode_edges(cuda, k, dtype):
    """The two-pass mode at each lane bucket: one column past the widest
    X read once (the plan's first two-pass width), a width whose last
    stage of D is ragged (40 columns past it) and an odd one (77 past);
    rows none, one, one past a row tile and enough for several tiles
    (where pass 1 splits D across blocks for fewer); X one element into
    its buffer (no row 16-byte aligned) at one shape; masked and
    unmasked.  Each plan is the two-pass mode's, each call adds one
    launch of that mode, agrees with the plain version and repeats give
    the same bits."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(300 + k)
    limit = fk.lanes_max_width(k, dtype)
    inner = losses.LogisticGradient()
    for d in (limit + 1, limit + 40, limit + 77):
        for n in (0, 1, 129, 3_001):
            offset = 1 if (d, n) == (limit + 40, 129) else 0
            buf = torch.randn(n * d + offset, generator=gen,
                              device=cuda).to(dtype)
            X = buf[offset:].view(n, d)
            y = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
            m = (torch.rand(n, generator=gen, device=cuda) < 0.7).float()
            W = torch.randn((k, d), generator=gen, device=cuda) / d ** 0.5
            for mask in (None, m):
                staged = fk.stage_dense(X, y, mask)
                plan = fk.lanes_launch_shape(staged.X, k)
                assert plan.mode == "lanes_two_pass", (d, plan)
                assert plan.tile_rows >= 1  # pass 1's D splits
                before = fk.lanes_mode_launches["lanes_two_pass"]
                loss, grad = fk.fused_margin_lanes_loss_grad(inner, W, staged)
                loss2, grad2 = fk.fused_margin_lanes_loss_grad(inner, W,
                                                               staged)
                torch.cuda.synchronize()
                assert fk.lanes_mode_launches["lanes_two_pass"] == before + 2
                assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
                ref_loss, ref_grad = \
                    fk.fused_margin_lanes_loss_grad_reference(inner, W,
                                                              staged)
                if n == 0:
                    assert not loss.any() and not grad.any()
                    continue
                torch.testing.assert_close(loss, ref_loss, rtol=1e-5,
                                           atol=0.0)
                for lane in range(k):
                    torch.testing.assert_close(
                        grad[lane], ref_grad[lane], rtol=1e-4,
                        atol=1e-4 * float(ref_grad[lane].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["logistic", "least_squares", "hinge"])
def test_forced_lanes_two_pass_inside_the_cluster_range(cuda, name, dtype):
    """``lanes_mode_plan`` forces the two-pass mode at widths the plan
    gives to the other modes (lanes_mma's range, the cluster mode's first
    width and 3,001 columns, those up to ``lanes_max_width``): each launch
    agrees with the plain version and with the plan's own mode there, and
    repeats give the same bits.  The hinge loss runs at 37 rows, as in
    ``test_lanes_cluster_mode_edges``: its multiplier jumps where a
    row's margin is 0, and two correct orders of summation can put a row
    either side of it (at 20,011 rows one row did, moving the gradient by
    that row of X while the loss agreed)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(400)
    lib = fk.lanes_library()[0]
    sms = fk._device_sms(cuda.index or 0)
    inner = losses.GRADIENTS[name]()
    code = fk._LOSS_CODES[type(inner)]
    for k in (3, 8, 16):
        widths = {1_000, fk.lanes_cluster_min_width(k, dtype), 3_001}
        for d in sorted(w for w in widths
                        if w <= fk.lanes_max_width(k, dtype)):
            n = 37 if name == "hinge" else 20_011
            X = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
            y = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
            m = (torch.rand(n, generator=gen, device=cuda) < 0.7).float()
            W = torch.randn((k, d), generator=gen, device=cuda) / d ** 0.5
            staged = fk.stage_dense(X, y, m)
            forced = fk.lanes_mode_plan_for(lib, n, d, k, X.element_size(),
                                            sms, "lanes_two_pass")
            assert forced.mode == "lanes_two_pass"
            assert fk.lanes_launch_shape(X, k).mode != "lanes_two_pass"
            loss, grad = fk.lanes_launch(lib, code, W, staged, forced)
            loss2, grad2 = fk.lanes_launch(lib, code, W, staged, forced)
            torch.cuda.synchronize()
            assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
            for ref_loss, ref_grad in (
                    fk.fused_margin_lanes_loss_grad_reference(inner, W,
                                                              staged),
                    fk.fused_margin_lanes_loss_grad(inner, W, staged)):
                torch.testing.assert_close(loss, ref_loss, rtol=1e-5,
                                           atol=0.0)
                for lane in range(k):
                    torch.testing.assert_close(
                        grad[lane], ref_grad[lane], rtol=1e-4,
                        atol=1e-4 * float(ref_grad[lane].abs().max()))


@pytest.mark.cuda
def test_forced_lanes_plan_the_mode_does_not_take_raises(cuda,
                                                         monkeypatch):
    """``lanes_mode_plan`` refuses a mode at a width it does not take (the
    cluster mode in a cluster size that is none of 2, 4, 8 and 16, or
    where the last block would own no column; lanes_mma past its block;
    the tile past one row), and a cluster plan that fails the kernel's
    check of its arguments (a grid that is not whole clusters) comes back
    as a CUDA error: the wrapper raises, counts nothing and launches no
    other mode in its place."""
    lib = fk.lanes_library()[0]
    sms = fk._device_sms(cuda.index or 0)
    for mode, d, c in (("lanes_cluster", 3_000, 3), ("lanes_cluster", 40, 4),
                       ("lanes_mma", 40_000, 0), ("lanes_tile", 40_000, 0)):
        with pytest.raises(ValueError, match="takes no"):
            fk.lanes_mode_plan_for(lib, 64, d, 8, 4, sms, mode, c)
    d = 3_000
    X = torch.randn((64, d), device=cuda)
    staged = fk.stage_dense(X, torch.zeros(64, device=cuda))
    plan = fk.lanes_launch_shape(X, 8)
    assert plan.mode == "lanes_cluster"
    forced = fk.lanes_mode_plan_for(lib, 64, d, 8, 4, sms, "lanes_cluster",
                                    plan.cluster)
    assert forced == plan
    raw = list(plan.raw)
    raw[3] += 1
    monkeypatch.setattr(fk, "lanes_launch_shape", lambda X, k: plan._replace(
        grid=raw[3], raw=tuple(raw)))
    before = fk.lanes_launch_count, dict(fk.lanes_mode_launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        fk.fused_margin_lanes_loss_grad(losses.LogisticGradient(),
                                        torch.zeros(8, d, device=cuda),
                                        staged)
    assert (fk.lanes_launch_count, dict(fk.lanes_mode_launches)) == before


@pytest.mark.cuda
def test_lanes_kernel_rejects_what_it_does_not_take(cuda):
    X = torch.randn((8, 4), device=cuda)
    staged = fk.stage_dense(X, torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="W must be"):
        fk.fused_margin_lanes_loss_grad(losses.LogisticGradient(),
                                        torch.zeros(2, 5, device=cuda),
                                        staged)
    with pytest.raises(ValueError, match="per-lane masks"):
        port.FusedLogisticGradient().lanes_loss_and_grad(
            torch.zeros(2, 4, device=cuda), staged, None,
            torch.ones(8, 2, device=cuda))


@pytest.mark.cuda
def test_fused_sweep_on_the_card_runs_the_lanes_kernel(cuda):
    """A sweep through ``FusedLogisticGradient`` launches only the lanes
    kernel, one launch per evaluation round, and follows the plain
    sweep (loss rtol 1e-4 over the 8 iterations)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    n, d = 50_000, 100
    X = torch.randn((n, d), generator=gen, device=cuda)
    y = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
    regs = [1.0, 0.1, 0.01]
    kw = dict(num_iterations=8, convergence_tol=0.0,
              initial_weights=torch.zeros(d, device=cuda))
    g = port.FusedLogisticGradient()
    rounds = g.lanes_loss_and_grad
    count = {"rounds": 0}

    def counted(*a):
        count["rounds"] += 1
        return rounds(*a)

    g.lanes_loss_and_grad = counted
    fk.reset_launch_counts()
    fused = port.sweep((X, y), g, port.SquaredL2Updater(), regs, **kw)
    assert fk.launch_count == 0 and fk.softmax_launch_count == 0
    assert fk.lanes_launch_count == count["rounds"] >= 8
    plain = port.sweep((X, y), port.LogisticGradient(),
                       port.SquaredL2Updater(), regs, **kw)
    torch.testing.assert_close(fused.loss_history, plain.loss_history,
                               rtol=1e-4, atol=0.0)
    # and at a width in the cluster mode: every launch there
    n, d = 20_000, 3_000
    X = torch.randn((n, d), generator=gen, device=cuda)
    y = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
    kw["initial_weights"] = torch.zeros(d, device=cuda)
    count["rounds"] = 0
    fk.reset_launch_counts()
    fused = port.sweep((X, y), g, port.SquaredL2Updater(), regs, **kw)
    assert fk.launch_count == 0 and fk.softmax_launch_count == 0
    assert dict(fk.lanes_mode_launches) == {
        "lanes_cluster": count["rounds"]} and count["rounds"] >= 8
    plain = port.sweep((X, y), port.LogisticGradient(),
                       port.SquaredL2Updater(), regs, **kw)
    torch.testing.assert_close(fused.loss_history, plain.loss_history,
                               rtol=1e-4, atol=0.0)


@pytest.mark.cuda
def test_fused_sweep_past_the_reach_runs_the_two_pass_mode(cuda):
    """A sweep at a width past the widest X read once for its lanes
    launches the lanes kernel's two-pass mode in every round, and follows
    the plain sweep (loss rtol 1e-4 over the 8 iterations)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    regs = [1.0, 0.1, 0.01]
    n, d = 3_001, fk.lanes_max_width(len(regs), torch.float32) + 1
    X = torch.randn((n, d), generator=gen, device=cuda)
    y = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
    kw = dict(num_iterations=8, convergence_tol=0.0,
              initial_weights=torch.zeros(d, device=cuda))
    g = port.FusedLogisticGradient()
    rounds = g.lanes_loss_and_grad
    count = {"rounds": 0}

    def counted(*a):
        count["rounds"] += 1
        return rounds(*a)

    g.lanes_loss_and_grad = counted
    fk.reset_launch_counts()
    fused = port.sweep((X, y), g, port.SquaredL2Updater(), regs, **kw)
    assert fk.launch_count == 0 and fk.softmax_launch_count == 0
    assert dict(fk.lanes_mode_launches) == {
        "lanes_two_pass": count["rounds"]} and count["rounds"] >= 8
    plain = port.sweep((X, y), port.LogisticGradient(),
                       port.SquaredL2Updater(), regs, **kw)
    torch.testing.assert_close(fused.loss_history, plain.loss_history,
                               rtol=1e-4, atol=0.0)


@pytest.mark.cuda
def test_fused_lbfgs_sweep_on_the_card_runs_the_lanes_kernel(cuda):
    """An L-BFGS path through ``FusedLogisticGradient`` launches only the
    lanes kernel, one launch a round (rounds = the most evaluations of
    any lane), and each lane follows the plain path over the iterations
    before their line searches part."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(6)
    n, d = 50_000, 100
    X = torch.randn((n, d), generator=gen, device=cuda)
    y = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
    regs = [1.0, 0.1, 0.01]
    w0 = torch.zeros(d, device=cuda)
    fk.reset_launch_counts()
    fused = port.LBFGS(port.FusedLogisticGradient(),
                       port.SquaredL2Updater()).setNumIterations(10) \
        .sweep((X, y), regs, w0)
    assert fk.launch_count == 0 and fk.softmax_launch_count == 0
    assert fk.lanes_launch_count == fused.eval_rounds \
        == int(fused.num_fn_evals.max()) > 0
    plain = port.LBFGS(port.LogisticGradient(),
                       port.SquaredL2Updater()).setNumIterations(10) \
        .sweep((X, y), regs, w0)
    for k in range(len(regs)):
        same = (fused.diag_evals[k] == plain.diag_evals[k]) & (
            fused.diag_step[k] == plain.diag_step[k])
        common = int(same.int().cumprod(0).sum())
        torch.testing.assert_close(fused.loss_history[k, :common + 1],
                                   plain.loss_history[k, :common + 1],
                                   rtol=1e-4, atol=0.0)


@pytest.mark.cuda
def test_cv_fold_ids_on_the_card_equal_the_cpu_draw(cuda):
    from spark_agd_tpu_torch import api

    for n in (1_000, 5_000, 3_000_000):
        got = api.fold_assignment(n, 5, 0, cuda)
        assert torch.equal(got.cpu(), api.fold_assignment(n, 5, 0, "cpu"))


# ---------------------------------------------------------------------------
# the streamed data plane: pinned staging, a side stream, prefetch threads


def _stream_data(n=10_003, d=300, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    return X, y


def _streamed(ds, prefetch=0, gradient=None, stats=None):
    from spark_agd_tpu_torch.data import streaming

    return streaming.make_streaming_smooth(
        gradient or port.FusedLogisticGradient(), ds, prefetch=prefetch,
        pass_stats=stats)


@pytest.mark.cuda
def test_streamed_pass_same_bits_20_times_with_the_ring_reused(cuda):
    from spark_agd_tpu_torch.data import streaming

    X, y = _stream_data()
    ds = streaming.StreamingDataset.from_arrays(X, y, batch_rows=2048)
    stats = []
    sm, sl = _streamed(ds, prefetch=2, stats=stats)
    w = torch.randn(300, device=cuda) / 20
    f0, g0 = sm(w)
    for _ in range(19):
        f, g = sm(w)
        assert torch.equal(f, f0) and torch.equal(g, g0)
    assert all(s["batches"] == 5 and s["rows"] == 10_003 for s in stats)
    assert all(s["h2d_bytes"] >= X.nbytes for s in stats)


@pytest.mark.cuda
def test_streamed_prefetch_depths_give_equal_bits(cuda):
    from spark_agd_tpu_torch.data import streaming

    X, y = _stream_data(seed=1)
    ds = streaming.StreamingDataset.from_arrays(X, y, batch_rows=1500)
    w = torch.randn(300, device=cuda) / 20
    outs = [_streamed(ds, prefetch=p)[0](w) for p in (0, 1, 3)]
    for f, g in outs[1:]:
        assert torch.equal(f, outs[0][0]) and torch.equal(g, outs[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [54, 300, 1000])
def test_streamed_smooth_equals_the_in_memory_fused_smooth(cuda, d):
    """A ragged tail, every launch in the mode margin_plan gives the
    width, one launch a batch."""
    from spark_agd_tpu_torch.core import smooth as smooth_lib
    from spark_agd_tpu_torch.data import streaming

    X, y = _stream_data(n=20_001, d=d, seed=2)
    w = torch.randn(d, device=cuda) / d ** 0.5
    Xd, yd = torch.from_numpy(X).to(cuda), torch.from_numpy(y).to(cuda)
    ref_f, ref_g = smooth_lib.make_smooth(port.FusedLogisticGradient(),
                                          Xd, yd)(w)
    ds = streaming.StreamingDataset.from_arrays(X, y, batch_rows=4096)
    sm, sl = _streamed(ds, prefetch=2)
    fk.reset_launch_counts()
    f, g = sm(w)
    torch.cuda.synchronize()
    mode = fk.launch_shape(Xd[:4096]).mode
    assert fk.launch_count == 5
    assert dict(fk.margin_mode_launches) == {mode: 5}
    assert float(f) == pytest.approx(float(ref_f), rel=1e-5)
    torch.testing.assert_close(g, ref_g, rtol=1e-4,
                               atol=1e-4 * float(ref_g.abs().max()))
    assert float(sl(w)) == pytest.approx(float(ref_f), rel=1e-5)


@pytest.mark.cuda
def test_a_kernel_that_raises_mid_pass_leaves_no_thread(cuda):
    import threading
    import time

    from spark_agd_tpu_torch.data import streaming

    X, y = _stream_data(seed=3)
    ds = streaming.StreamingDataset.from_arrays(X, y, batch_rows=1024)

    class Raising(port.FusedLogisticGradient):
        calls = 0

        def batch_loss_and_grad(self, weights, X, y, mask=None):
            Raising.calls += 1
            if Raising.calls == 3:
                raise RuntimeError("kernel blew up")
            return super().batch_loss_and_grad(weights, X, y, mask)

    w = torch.randn(300, device=cuda) / 20
    sm, _ = _streamed(ds, prefetch=2, gradient=Raising())
    with pytest.raises(RuntimeError, match="kernel blew up"):
        sm(w)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and any(
            t.name == "fold-stream-prefetch" and t.is_alive()
            for t in threading.enumerate()):
        time.sleep(0.01)
    assert not [t for t in threading.enumerate()
                if t.name == "fold-stream-prefetch" and t.is_alive()]
    f, g = sm(w)  # the next pass is right
    ref_f, ref_g = _streamed(ds)[0](w)
    assert torch.equal(f, ref_f) and torch.equal(g, ref_g)


@pytest.mark.cuda
def test_a_pinned_tensor_and_a_numpy_array_stream_the_same_bits(cuda):
    from spark_agd_tpu_torch.data import streaming

    X, y = _stream_data(seed=4)
    Xt = streaming.pin_host(torch.from_numpy(X.copy()))
    yt = streaming.pin_host(torch.from_numpy(y.copy()))
    try:
        assert Xt.is_pinned() and yt.is_pinned()
        w = torch.randn(300, device=cuda) / 20
        placer_direct = streaming._make_placer(cuda, None, 2)
        ds_pinned = streaming.StreamingDataset.from_arrays(Xt, yt, 2048)
        ds_numpy = streaming.StreamingDataset.from_arrays(X, y, 2048)
        a = _streamed(ds_pinned, prefetch=2)[0](w)
        b = _streamed(ds_numpy, prefetch=2)[0](w)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        # the pinned source is copied directly: no staging slot is filled
        acc, n = streaming.fold_stream(
            lambda w_, X_, y_, m_: (X_.sum(), torch.tensor(X_.shape[0])),
            lambda u, v: [u[0] + v[0]], placer_direct, ds_pinned, None)
        assert n == 10_003
        assert placer_direct.copies["direct"] == 10
        assert placer_direct.copies["staged"] == 0
        assert float(acc[0]) == pytest.approx(float(X.sum(dtype=np.float64)),
                                              rel=1e-4)
    finally:
        streaming.unpin_host(Xt)
        streaming.unpin_host(yt)


@pytest.mark.cuda
def test_the_card_holds_at_most_prefetch_plus_two_batches(cuda):
    from spark_agd_tpu_torch.data import streaming

    rng = np.random.default_rng(5)
    X = rng.standard_normal((64 * 8192, 256)).astype(np.float32)
    y = (rng.random(X.shape[0]) < 0.5).astype(np.float32)
    batch_bytes = 8192 * 256 * 4
    ds = streaming.StreamingDataset.from_arrays(X, y, batch_rows=8192)
    sm, _ = _streamed(ds, prefetch=2)
    w = torch.zeros(256, device=cuda)
    sm(w)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sm(w)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= (2 + 2) * batch_bytes + (16 << 20), peak


@pytest.mark.cuda
@pytest.mark.parametrize("with_csc", ["lazy", True])
def test_a_csr_stream_on_the_card_equals_the_cpu_stream(cuda, with_csc):
    from spark_agd_tpu_torch.data import streaming

    rng = np.random.default_rng(6)
    n, d = 30_011, 5_000
    counts = rng.integers(1, 40, n)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    indices = rng.integers(0, d, int(indptr[-1])).astype(np.int32)
    values = rng.standard_normal(int(indptr[-1])).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    ds = streaming.StreamingDataset.from_csr(
        indptr, indices, values, d, y, batch_rows=4096, with_csc=with_csc)
    w = torch.from_numpy(rng.standard_normal(d).astype(np.float32) / 10)
    fk.reset_launch_counts()
    f, g = streaming.make_streaming_smooth(losses.LogisticGradient(), ds,
                                           prefetch=2)[0](w.to(cuda))
    assert fk.launch_count == 0  # CSR goes through the sparse products
    f_cpu, g_cpu = streaming.make_streaming_smooth(
        losses.LogisticGradient(), ds, device="cpu")[0](w)
    assert float(f) == pytest.approx(float(f_cpu), rel=1e-5)
    torch.testing.assert_close(g.cpu(), g_cpu, rtol=1e-4,
                               atol=1e-4 * float(g_cpu.abs().max()))


@pytest.mark.cuda
def test_streaming_sweep_on_the_card_runs_the_lanes_kernel(cuda):
    from spark_agd_tpu_torch.data import streaming

    X, y = _stream_data(seed=7)
    ds = streaming.StreamingDataset.from_arrays(X, y, batch_rows=4096)
    regs = [0.1, 0.01, 0.001, 1e-4]
    stats = []
    fk.reset_launch_counts()
    res = port.streaming_sweep(ds, port.FusedLogisticGradient(),
                               port.SquaredL2Updater(), regs,
                               num_iterations=5, convergence_tol=0.0,
                               initial_weights=torch.zeros(300),
                               pass_stats=stats)
    assert fk.launch_count == 0
    assert fk.lanes_launch_count == 3 * len(stats) > 0
    plain = port.streaming_sweep(ds, losses.LogisticGradient(),
                                 port.SquaredL2Updater(), regs,
                                 num_iterations=5, convergence_tol=0.0,
                                 initial_weights=torch.zeros(300))
    np.testing.assert_allclose(res.loss_history, plain.loss_history,
                               rtol=1e-4)


@pytest.mark.cuda
def test_staging_ring_under_fast_thread_switching(cuda):
    """The producer fills pinned slots while the consumer copies from
    them: with the interpreter switching threads every microsecond, many
    small batches and several depths, every pass gives the bits of the
    single-threaded pass (a slot refilled before its copy finished would
    change them)."""
    import sys

    from spark_agd_tpu_torch.data import streaming

    X, y = _stream_data(n=6_001, d=64, seed=8)
    ds = streaming.StreamingDataset.from_arrays(X, y, batch_rows=64)
    w = torch.randn(64, device=cuda) / 8
    ref_f, ref_g = _streamed(ds)[0](w)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for depth in (1, 3, 6):
            stats = []
            sm = _streamed(ds, prefetch=depth, stats=stats)[0]
            for _ in range(5):
                f, g = sm(w)
                assert torch.equal(f, ref_f) and torch.equal(g, ref_g)
            assert all(s["staged_copies"] == 2 * s["batches"]
                       for s in stats)
    finally:
        sys.setswitchinterval(old)


@pytest.mark.cuda
def test_a_streaming_sweep_over_numpy_pins_one_ring(cuda, monkeypatch):
    """The sweep's two evaluators (with and without the gradient) share
    one placer, so a source that is not pinned registers one ring of
    staging slots (2 at the sweeps' depth 0), not one a evaluator."""
    from spark_agd_tpu_torch.data import streaming

    registered = []
    real = streaming.pin_host

    def counting(t):
        registered.append(t.numel())
        return real(t)

    monkeypatch.setattr(streaming, "pin_host", counting)
    X, y = _stream_data(seed=9)
    ds = streaming.StreamingDataset.from_arrays(X, y, batch_rows=4096)
    stats = []
    port.streaming_sweep(ds, port.FusedLogisticGradient(),
                         port.SquaredL2Updater(), [0.1, 0.01],
                         num_iterations=3, convergence_tol=0.0, beta=1.0,
                         initial_weights=torch.zeros(300), pass_stats=stats)
    assert stats and all(s["staged_copies"] > 0 for s in stats)
    assert len(registered) == 2, registered


# ---------------------------------------------------------------------------
# single-device resilience on the card: supervised fits, checkpoints,
# rollback, the watchdog and a preempted process

# (mode, rows, width) a margin mode each; widths past the stream mode's
# reach are resolved on the card
SUPERVISED_MODES = [("narrow", 20_003, 8), ("warp_rows", 20_003, 54),
                    ("tile", 4_003, "tile"), ("stream", 4_003, 1_000),
                    ("cluster", 1_003, 40_000), ("grid", 203, "cmax+1"),
                    ("two_pass", 37, "gmax+1")]


def _resolve_width(width):
    f32 = torch.float32
    return {"tile": fk.tile_max_width(f32),
            "cmax+1": fk.cluster_max_width(f32) + 1,
            "gmax+1": fk.grid_max_width(f32) + 1}.get(width, width)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,rows,width", SUPERVISED_MODES,
                         ids=[m[0] for m in SUPERVISED_MODES])
def test_a_supervised_fit_in_segments_gives_the_straight_bits(
        cuda, mode, rows, width):
    from spark_agd_tpu_torch.data import device_synth

    d = _resolve_width(width)
    X, y = device_synth.class_logistic(rows, d, seed=11)
    assert fk.launch_shape(X).mode == mode
    kw = dict(reg_param=0.1, num_iterations=8, convergence_tol=0.0,
              initial_weights=torch.zeros(d, device=cuda))
    w, h = port.run((X, y), port.FusedLogisticGradient(),
                    port.SquaredL2Updater(), **kw)
    fk.reset_launch_counts()
    ws, hs, sres = port.run(
        (X, y), port.FusedLogisticGradient(), port.SquaredL2Updater(),
        resilience=port.ResiliencePolicy(segment_iters=3, jitter=0.0,
                                         seed=0),
        return_result=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ws, w) and np.array_equal(hs, h)
    assert [a["start_iter"] for a in sres.attempts] == [0, 3, 6]
    assert fk.launch_count > 0
    assert {m for m, c in fk.margin_mode_launches.items() if c} == {mode}


@pytest.mark.cuda
def test_a_checkpoint_of_card_tensors_loads_onto_the_templates_device(
        cuda, tmp_path):
    from spark_agd_tpu_torch.utils import checkpoint as ckpt

    x = torch.randn(1_000, device=cuda)
    tree = {"W": torch.randn((3, 4), device=cuda), "b": x[:4] * 2}
    warm = port.AGDWarmState(x=tree, z=tree, theta=0.25, big_l=3.0,
                             bts=False, prior_iters=7)
    path = str(tmp_path / "card.npz")
    ckpt.save_checkpoint(path, warm, [0.5, 0.25])
    on_card = ckpt.load_checkpoint(path, tree)
    assert on_card.warm.x["W"].device.type == "cuda"
    assert torch.equal(on_card.warm.x["W"], tree["W"])
    assert torch.equal(on_card.warm.z["b"], tree["b"])
    on_cpu = ckpt.load_checkpoint(path, {k: v.cpu()
                                         for k, v in tree.items()})
    assert on_cpu.warm.x["W"].device.type == "cpu"
    assert torch.equal(on_cpu.warm.x["W"], tree["W"].cpu())
    assert (on_card.warm.theta, on_card.warm.big_l, on_card.warm.bts,
            on_card.warm.prior_iters) == (0.25, 3.0, False, 7)


def _card_problem(cuda, n=20_003, d=300, seed=12):
    from spark_agd_tpu_torch.core import smooth as smooth_lib
    from spark_agd_tpu_torch.data import device_synth

    X, y = device_synth.class_logistic(n, d, seed=seed)
    staged = smooth_lib.make_smooth_staged(port.FusedLogisticGradient(),
                                           X, y)
    px, rv = smooth_lib.make_prox(port.SquaredL2Updater(), 0.1)
    return staged, px, rv, torch.zeros(d, device=cuda)


@pytest.mark.cuda
def test_a_poisoned_segment_rolls_back_and_leaves_its_anchor(cuda):
    from spark_agd_tpu_torch.resilience import faults

    staged, px, rv, w0 = _card_problem(cuda)
    sm, sl = staged[0](*staged[1])
    cfg = port.AGDConfig(convergence_tol=0.0, num_iterations=4)
    first = port.run_agd_host(sm, px, rv, w0, cfg, smooth_loss=sl)
    warm = port.AGDWarmState(
        x=first.weights, z=first.final_z, theta=first.final_theta,
        big_l=first.final_l, bts=first.final_bts, prior_iters=4)
    anchor = (warm.x.clone(), warm.z.clone())
    bad = port.run_agd_host(faults.poison_smooth(sm), px, rv, w0, cfg,
                            smooth_loss=sl, warm=warm)
    assert bad.aborted_non_finite
    assert torch.equal(warm.x, anchor[0]) and torch.equal(warm.z, anchor[1])
    policy = port.ResiliencePolicy(segment_iters=4, backoff_base=0.0,
                                   jitter=0.0, seed=0)
    res = port.run_agd_supervised(
        prox=px, reg_value=rv, w0=w0, staged=staged, policy=policy,
        config=port.AGDConfig(convergence_tol=0.0, num_iterations=16),
        faults=port.FaultScript(nan_at_iter=4))
    assert res.rollbacks == 1 and res.num_iters == 16
    assert np.isfinite(res.loss_history).all()
    assert [a["outcome"] for a in res.attempts][1] == "aborted_non_finite"


@pytest.mark.cuda
def test_an_attempt_past_its_timeout_is_retried_to_the_same_bits(cuda):
    import threading
    import time

    staged, px, rv, w0 = _card_problem(cuda, seed=13)
    build, dargs = staged
    cfg = port.AGDConfig(convergence_tol=0.0, num_iterations=10)
    sm, sl = build(*dargs)
    straight = port.run_agd_host(sm, px, rv, w0, cfg, smooth_loss=sl)
    calls = []

    def slow_first(*da):
        inner, inner_loss = build(*da)

        def smooth(w):
            calls.append(1)
            if len(calls) == 1:
                time.sleep(1.5)  # the watchdog fires; this attempt runs on
            return inner(w)
        return smooth, inner_loss

    res = port.run_agd_supervised(
        prox=px, reg_value=rv, w0=w0, config=cfg,
        staged=(slow_first, dargs),
        policy=port.ResiliencePolicy(segment_iters=10, attempt_timeout=0.5,
                                     backoff_base=0.0, jitter=0.0, seed=0))
    for t in threading.enumerate():
        if t.name.startswith("attempt:"):
            t.join(timeout=60)
            assert not t.is_alive()
    torch.cuda.synchronize()
    assert res.retries == 1 and "AttemptTimeout" in res.attempts[0]["error"]
    assert torch.equal(res.weights, straight.weights)
    np.testing.assert_array_equal(res.loss_history, straight.loss_history)



@pytest.mark.cuda
def test_a_pass_opened_while_another_is_open_stages_on_its_own_ring(cuda):
    """Two live passes of one placer (an attempt the watchdog gave up on
    and its retry) never share staging slots; once no pass is open, the
    next one reuses the newest ring."""
    from spark_agd_tpu_torch.data import streaming

    placer = streaming._DevicePlacer(cuda, None, prefetch=1)
    p1 = placer.open_pass()
    p2 = placer.open_pass()
    assert p2.slots is not p1.slots
    p1.close()
    p3 = placer.open_pass()  # p2 is still open
    assert p3.slots is not p2.slots and p3.slots is not p1.slots
    p2.close()
    p3.close()
    p3.close()  # closing twice counts once
    rings = len(placer.rings)
    p4 = placer.open_pass()
    assert p4.slots is placer.rings[-1] and len(placer.rings) == rings
    p4.close()
    assert placer.open == 0

@pytest.mark.cuda
@pytest.mark.parametrize("with_cursor", [False, True],
                         ids=["no_cursor", "stream_checkpoint"])
def test_a_timed_out_streamed_attempt_leaves_the_retry_its_bits(
        cuda, tmp_path, with_cursor):
    """A streamed fit (numpy batches through the pinned ring, a prefetch
    thread) whose first attempt blocks inside its second pass past
    ``attempt_timeout``; the retry releases it from inside its own second
    pass, so both stream at once.  The retry's passes stage through a
    ring of their own (and, with a ``StreamCheckpoint``, the abandoned
    attempt stops at its next commit): the fit has the straight streamed
    fit's bits."""
    import threading

    from spark_agd_tpu_torch.core import smooth as smooth_lib
    from spark_agd_tpu_torch.data import streaming
    from spark_agd_tpu_torch.resilience import AutoCheckpointer

    X, y = _stream_data(seed=21)
    px, rv = smooth_lib.make_prox(port.SquaredL2Updater(), 0.1)
    cfg = port.AGDConfig(convergence_tol=0.0, num_iterations=6)
    w0 = torch.zeros(300, device=cuda)
    plain = streaming.StreamingDataset.from_arrays(X, y, batch_rows=1500)
    sm, sl = _streamed(plain, prefetch=1)
    straight = port.run_agd_host(sm, px, rv, w0, cfg, smooth_loss=sl)

    go, woke = threading.Event(), []
    passes = []

    def factory():
        passes.append(1)
        p = len(passes)
        for i, b in enumerate(plain):
            if (p, i) == (2, 3):  # the first attempt's second pass
                woke.append(go.wait(timeout=20))
            if (p, i) == (4, 1):  # the retry's second pass
                go.set()
                threading.Event().wait(0.3)  # both attempts stream now
            yield b

    ds = streaming.StreamingDataset(factory, 1500)
    ck = AutoCheckpointer(str(tmp_path / "ck.npz"), every_iters=3)
    stream_ckpt = (streaming.StreamCheckpoint(ck, every_batches=1)
                   if with_cursor else None)
    sm2, sl2 = streaming.make_streaming_smooth(
        port.FusedLogisticGradient(), ds, prefetch=1,
        stream_ckpt=stream_ckpt)
    res = port.run_agd_supervised(
        smooth=sm2, smooth_loss=sl2, prox=px, reg_value=rv, w0=w0,
        config=cfg, driver="host", checkpointer=ck,
        policy=port.ResiliencePolicy(segment_iters=3, attempt_timeout=1.0,
                                     backoff_base=0.0, jitter=0.0, seed=0))
    for t in threading.enumerate():
        if t.name.startswith("attempt:"):
            t.join(timeout=60)
            assert not t.is_alive()
    torch.cuda.synchronize()
    assert woke == [True]
    assert res.retries == 1 and "AttemptTimeout" in res.attempts[0]["error"]
    assert torch.equal(res.weights, straight.weights)
    np.testing.assert_array_equal(res.loss_history, straight.loss_history)

_CHILD = """
import sys
import torch
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch.core import smooth as smooth_lib
from spark_agd_tpu_torch.data import device_synth

X, y = device_synth.class_logistic(20_003, 300, seed=14)
staged = smooth_lib.make_smooth_staged(port.FusedLogisticGradient(), X, y)
px, rv = smooth_lib.make_prox(port.SquaredL2Updater(), 0.1)
try:
    port.run_agd_supervised(
        prox=px, reg_value=rv, w0=torch.zeros(300, device="cuda"),
        staged=staged,
        config=port.AGDConfig(convergence_tol=0.0, num_iterations=12),
        policy=port.ResiliencePolicy(segment_iters=2, backoff_base=0.0,
                                     jitter=0.0, seed=0),
        checkpointer=port.AutoCheckpointer(sys.argv[1], every_iters=2),
        faults=port.FaultScript(sigterm_at_iter=6))
except port.resilience.Preempted:
    sys.exit(75)
"""


@pytest.mark.cuda
def test_a_preempted_child_is_resumed_to_the_uninterrupted_bits(
        cuda, tmp_path):
    import os
    import subprocess
    import sys

    from spark_agd_tpu_torch.core import smooth as smooth_lib
    from spark_agd_tpu_torch.data import device_synth

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = str(tmp_path / "child.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    child = subprocess.run([sys.executable, "-c", _CHILD, path], env=env,
                           cwd=root, capture_output=True, text=True,
                           timeout=600)
    assert child.returncode == 75, child.stderr[-2000:]
    X, y = device_synth.class_logistic(20_003, 300, seed=14)
    staged = smooth_lib.make_smooth_staged(port.FusedLogisticGradient(),
                                           X, y)
    px, rv = smooth_lib.make_prox(port.SquaredL2Updater(), 0.1)
    kw = dict(prox=px, reg_value=rv, w0=torch.zeros(300, device=cuda),
              staged=staged,
              config=port.AGDConfig(convergence_tol=0.0, num_iterations=12),
              policy=port.ResiliencePolicy(segment_iters=2, backoff_base=0.0,
                                           jitter=0.0, seed=0))
    resumed = port.run_agd_supervised(
        checkpointer=port.AutoCheckpointer(path, every_iters=2), **kw)
    straight = port.run_agd_supervised(**kw)
    assert resumed.resumed_from == 6
    assert torch.equal(resumed.weights, straight.weights)
    np.testing.assert_array_equal(resumed.loss_history,
                                  straight.loss_history)


# ---------------------------------------------------------------------------
# data parallelism on the card: meshes whose slots repeat the one card


def _card_mesh(k):
    from spark_agd_tpu_torch.parallel import mesh as mesh_lib

    dev = torch.device("cuda", torch.cuda.current_device())
    return mesh_lib.make_mesh({"data": k}, devices=[dev] * k)


def _plain_sharded(inner, w, shards, softmax_k=None):
    """The plain versions of the slots' kernels on the same staged
    shards, added in slot order, then the means."""
    loss = grad = None
    n = 0
    for ops in shards:
        staged = ops[0]
        if softmax_k is None:
            ls, gs = fk.fused_margin_loss_grad_reference(inner, w, staged)
        else:
            ls, gs = fk.fused_softmax_loss_grad_reference(softmax_k, w,
                                                          staged)
        loss = ls if loss is None else loss + ls
        grad = gs if grad is None else grad + gs
        n += int(staged.n_valid)
    return loss / n, grad / n


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [2, 4])
@pytest.mark.parametrize("mode", ["narrow", "stream", "cluster"])
def test_mesh_on_the_card_matches_the_plain_sharded_version(cuda, slots,
                                                            mode):
    """Each slot launches the margin kernel on its shard (a view of X) in
    the width's mode, once an evaluation; the same bits on repeat; held
    to the plain versions on the same shards."""
    from spark_agd_tpu_torch.parallel import dist_smooth

    d = {"narrow": 8, "stream": 1000,
         "cluster": fk.max_width(torch.float32) + 1}[mode]
    n = {"narrow": 100_003, "stream": 20_003, "cluster": 2_003}[mode]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(slots)
    X = torch.randn((n, d), generator=gen, device=cuda)
    y = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
    m = (torch.rand(n, generator=gen, device=cuda) < 0.9).float()
    w = torch.randn(d, generator=gen, device=cuda) / d ** 0.5
    mesh = _card_mesh(slots)
    gradient = port.FusedLogisticGradient()
    build, shards = dist_smooth.make_dist_smooth_staged(gradient, X, y, m,
                                                        mesh=mesh)
    rps = -(-n // slots)
    for i, ops in enumerate(shards):
        assert ops[0].X.data_ptr() == X[i * rps:].data_ptr()
        assert fk.launch_shape(ops[0].X).mode == mode
    smooth = build(*shards)[0]
    before = fk.launch_count
    before_mode = fk.margin_mode_launches[mode]
    f, g = smooth(w)
    f2, g2 = smooth(w)
    torch.cuda.synchronize()
    assert fk.launch_count == before + 2 * slots
    assert fk.margin_mode_launches[mode] == before_mode + 2 * slots
    assert torch.equal(f, f2) and torch.equal(g, g2)
    ref_f, ref_g = _plain_sharded(gradient.inner, w, shards)
    assert float(f) == pytest.approx(float(ref_f), rel=1e-5)
    torch.testing.assert_close(g, ref_g, rtol=1e-4,
                               atol=1e-4 * float(ref_g.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [0, 2])
def test_mesh_stream_on_the_card_copies_each_batch_once(cuda, prefetch):
    """A dense stream over 4 slots of the card through the pinned ring
    and side stream: each batch staged and copied once (the slots' shards
    are views of it), a margin launch a slot a batch, the same bits on
    repeat and at every prefetch depth, held to the single-device stream
    and to the same mesh stream on CPU slots."""
    from spark_agd_tpu_torch.data import streaming
    from spark_agd_tpu_torch.parallel import mesh as mesh_lib

    X, y = _stream_data(n=10_003, d=300, seed=12)
    ds = streaming.StreamingDataset.from_arrays(X, y, batch_rows=2048)
    batches = -(-X.shape[0] // 2048)
    w = torch.randn(300, device=cuda) / 20
    stats = []
    sm = streaming.make_streaming_smooth(
        port.FusedLogisticGradient(), ds, mesh=_card_mesh(4),
        prefetch=prefetch, pass_stats=stats)[0]
    before = fk.launch_count
    f, g = sm(w)
    f2, g2 = sm(w)
    torch.cuda.synchronize()
    assert fk.launch_count == before + 2 * 4 * batches
    assert torch.equal(f, f2) and torch.equal(g, g2)
    for st in stats:
        assert st["batches"] == batches
        assert st["h2d_bytes"] == X.nbytes + y.nbytes
        assert st["staged_copies"] == 2 * batches  # X and y, one run each
    ref_f, ref_g = _streamed(ds)[0](w)
    assert float(f) == pytest.approx(float(ref_f), rel=1e-5)
    torch.testing.assert_close(g, ref_g, rtol=1e-4,
                               atol=1e-4 * float(ref_g.abs().max()))
    cpu_mesh = mesh_lib.make_mesh({"data": 4}, devices=["cpu"] * 4)
    cf, cg = streaming.make_streaming_smooth(
        port.LogisticGradient(), ds, mesh=cpu_mesh, device="cpu")[0](
        w.cpu().double())
    assert float(f) == pytest.approx(float(cf), rel=1e-5)
    torch.testing.assert_close(g.cpu().double(), cg, rtol=1e-4,
                               atol=1e-4 * float(cg.abs().max()))


@pytest.mark.cuda
def test_csr_mesh_stream_on_the_card_places_stacked_shards(cuda):
    """A CSR stream over 3 slots of the card: each batch's nnz-balanced
    layout staged and copied as one run of stacked shards, each slot's
    local CSR a view of it; held to the same mesh stream on CPU slots at
    f64."""
    from spark_agd_tpu_torch.data import streaming
    from spark_agd_tpu_torch.parallel import mesh as mesh_lib

    rng = np.random.default_rng(13)
    n, d = 5_001, 400
    counts = rng.integers(1, 30, n)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    nnz = int(indptr[-1])
    indices = rng.integers(0, d, nnz).astype(np.int32)
    values = rng.standard_normal(nnz).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    ds = streaming.StreamingDataset.from_csr(indptr, indices, values, d, y,
                                             1024, with_csc="lazy")
    w = torch.randn(d, device=cuda) / 20
    stats = []
    sm = streaming.make_streaming_smooth(
        port.LogisticGradient(), ds, mesh=_card_mesh(3), pass_stats=stats,
        csr_nnz_per_shard=8192)[0]
    f, g = sm(w)
    f2, g2 = sm(w)
    assert torch.equal(f, f2) and torch.equal(g, g2)
    assert all(st["staged_copies"] > 0 for st in stats)
    cpu_mesh = mesh_lib.make_mesh({"data": 3}, devices=["cpu"] * 3)
    cf, cg = streaming.make_streaming_smooth(
        port.LogisticGradient(), ds, mesh=cpu_mesh, device="cpu",
        csr_nnz_per_shard=8192)[0](w.cpu().double())
    assert float(f) == pytest.approx(float(cf), rel=1e-5)
    torch.testing.assert_close(g.cpu().double(), cg, rtol=1e-4,
                               atol=1e-4 * float(cg.abs().max()))


@pytest.mark.cuda
def test_softmax_mesh_on_the_card(cuda):
    from spark_agd_tpu_torch.parallel import dist_smooth

    n, d, k, slots = 30_001, 785, 10, 3
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    X = torch.randn((n, d), generator=gen, device=cuda)
    y = torch.randint(0, k, (n,), generator=gen, device=cuda)
    W = torch.randn((d, k), generator=gen, device=cuda) / d ** 0.5
    gradient = port.FusedSoftmaxGradient(port.SoftmaxGradient(k))
    build, shards = dist_smooth.make_dist_smooth_staged(
        gradient, X, y, mesh=_card_mesh(slots))
    smooth = build(*shards)[0]
    before = fk.softmax_launch_count
    f, g = smooth(W)
    f2, g2 = smooth(W)
    torch.cuda.synchronize()
    assert fk.softmax_launch_count == before + 2 * slots
    assert torch.equal(f, f2) and torch.equal(g, g2)
    ref_f, ref_g = _plain_sharded(None, W, shards, softmax_k=k)
    assert float(f) == pytest.approx(float(ref_f), rel=1e-5)
    torch.testing.assert_close(g, ref_g, rtol=1e-4,
                               atol=1e-4 * float(ref_g.abs().max()))


@pytest.mark.cuda
def test_two_process_gloo_group_on_the_card(cuda, tmp_path):
    """Two ranks on the one card (gloo: NCCL refuses two ranks on one
    device) read their halves of 8 part files onto a 4-slot mesh and fit
    AGD at f64: both ranks hold the same bits, and the one-process fit on
    all files agrees."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from spark_agd_tpu_torch.data import ingest, libsvm
    from spark_agd_tpu_torch.parallel import mesh as mesh_lib

    rng = np.random.default_rng(11)
    for k, rows in enumerate((13, 7, 10, 5, 9, 6, 11, 8)):
        Xp = (rng.random((rows, 9)) * (rng.random((rows, 9)) < 0.5)).astype(
            np.float32)
        Xp[0, -1] = 0.3
        libsvm.save_libsvm(str(tmp_path / f"part-{k}.libsvm"), Xp,
                           np.where(rng.random(rows) < 0.5, 1.0, -1.0))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port_no = s.getsockname()[1]
    child = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "torch_multihost_child.py")
    procs = [subprocess.Popen(
        [sys.executable, child, f"localhost:{port_no}", "2", str(r),
         str(tmp_path), "cuda:0"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append((*p.communicate(timeout=300), p.returncode))
    finally:
        for p in procs:
            p.kill()
    results = []
    for out, err, rc in outs:
        assert rc == 0, err[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        results.append(json.loads(line[0][len("RESULT "):]))
    for kind in ("dense", "csr"):
        assert results[0][kind] == results[1][kind], kind
    paths = sorted(str(p) for p in tmp_path.glob("part-*.libsvm"))
    mesh = mesh_lib.make_mesh({"data": 4},
                              devices=[torch.device("cuda", 0)] * 4)
    _, hist = port.run(ingest.from_partitioned_files(paths, mesh,
                                                     n_features=9),
                       port.LogisticGradient(), port.L2Prox(),
                       reg_param=0.05, num_iterations=10,
                       convergence_tol=1e-12, initial_weights=np.zeros(9))
    np.testing.assert_allclose(
        [float.fromhex(v) for v in results[0]["dense"]["hist"]], hist,
        rtol=1e-9)


# --- model parallelism on the card (the model-parallel slice) -------------

@pytest.mark.cuda
def test_mesh_sweep_launches_the_lanes_kernel_a_slot_a_round(cuda):
    """``sweep(mesh=)`` over 4 slots of the card with
    ``FusedLogisticGradient``: one lanes launch a slot a round, every
    lane held to the plain mesh sweep at the mesh tolerances."""
    from spark_agd_tpu_torch.parallel import dist_smooth

    gen = torch.Generator(device=cuda)
    gen.manual_seed(46)
    n, d = 50_003, 300
    X = torch.randn((n, d), generator=gen, device=cuda)
    y = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
    w0 = torch.zeros(d, device=cuda)
    regs = [1e-4, 1e-3, 1e-2, 1e-1]
    kw = dict(num_iterations=8, convergence_tol=0.0, initial_weights=w0,
              mesh=_card_mesh(4))
    lanes_before = fk.lanes_launch_count
    dist_smooth.reset_counts()
    fused = port.sweep((X, y), port.FusedLogisticGradient(), port.L2Prox(),
                       regs, **kw)
    torch.cuda.synchronize()
    rounds = dist_smooth.mesh_evaluations
    assert fk.lanes_launch_count - lanes_before == 4 * rounds
    plain = port.sweep((X, y), port.LogisticGradient(), port.L2Prox(),
                       regs, **kw)
    assert torch.equal(fused.num_iters, plain.num_iters)
    np.testing.assert_allclose(fused.loss_history.numpy(),
                               plain.loss_history.numpy(), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.cuda
def test_fused_softmax_on_a_model_axis_launches_once_a_data_slot(cuda):
    """``FusedSoftmaxGradient`` on a {data: 2, model: 2} mesh of the card
    (``mode="auto"``): W's classes gathered onto each data slot, one
    softmax launch a data slot an evaluation, held to the plain
    class-sharded evaluation in f64 at the kernel's own tolerance
    (``_assert_softmax_close``: the loss at rel 1e-5, the gradient at
    rtol 1e-4 and atol 1e-4 of its largest entry)."""
    from spark_agd_tpu_torch.parallel import dist_smooth
    from spark_agd_tpu_torch.parallel import mesh as mesh_lib

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_lib.make_mesh({"data": 2, "model": 2}, devices=[dev] * 4)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(48)
    n, d, k = 40_003, 785, 10
    X = torch.randn((n, d), generator=gen, device=cuda)
    y = torch.randint(0, k, (n,), generator=gen, device=cuda)
    W = torch.randn((d, k), generator=gen, device=cuda) / 30
    before = fk.softmax_launch_count
    sm = dist_smooth.make_dist_smooth(
        port.FusedSoftmaxGradient(losses.SoftmaxGradient(k)), X, y,
        mesh=mesh, mode="auto")[0]
    f, g = sm(W)
    torch.cuda.synchronize()
    assert fk.softmax_launch_count - before == 2
    pf, pg = dist_smooth.make_dist_smooth(
        losses.SoftmaxGradient(k), X.double(), y, mesh=mesh,
        mode="auto")[0](W.double())
    _assert_softmax_close(f, g, pf.float(), pg.float())


@pytest.mark.cuda
def test_sharded_update_on_the_card_matches_the_replicated_fit(cuda):
    """``run(sharded_update=True)`` over 4 slots of the card with the
    plain gradient, held to the replicated mesh fit; the fused margin
    kernel is refused as the JAX package refuses its own."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(47)
    n, d = 20_003, 257
    X = torch.randn((n, d), generator=gen, device=cuda, dtype=torch.float64)
    y = (torch.rand(n, generator=gen, device=cuda) < 0.5).double()
    kw = dict(reg_param=0.05, num_iterations=15, convergence_tol=0.0,
              initial_weights=torch.zeros(d, dtype=torch.float64,
                                          device=cuda),
              mesh=_card_mesh(4), return_result=True)
    _, hr, rr = port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                         **kw)
    _, hs, rs = port.run((X, y), port.LogisticGradient(), port.L2Prox(),
                         sharded_update=True, **kw)
    assert int(rs.num_iters) == int(rr.num_iters)
    assert abs(float(hs[-1]) - float(hr[-1])) <= 1e-9
    np.testing.assert_allclose(rs.weights.cpu().numpy(),
                               rr.weights.cpu().numpy(), rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="fused"):
        port.run((X.float(), y.float()), port.FusedLogisticGradient(),
                 port.L2Prox(), sharded_update=True, **kw)


def _serve_models(device, d=40):
    """A logistic, a softmax and an MLP model on ``device``, their arrays
    made with numpy from one seed."""
    from spark_agd_tpu_torch.models import glm, mlp

    r = np.random.default_rng(5)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    params = mlp.init_mlp_params(d, 16, 3, seed=2, device="cpu")
    return {
        "logistic": glm.LogisticRegressionModel(t(r.normal(size=d)), 0.2),
        "softmax": glm.SoftmaxRegressionModel(t(r.normal(size=(d, 10))),
                                              t(r.normal(size=10))),
        "mlp": mlp.MLPModel({k: v.to(device) for k, v in params.items()}),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["logistic", "softmax", "mlp"])
def test_serve_engine_on_the_card_matches_its_cpu_result(cuda, kind):
    """Every op at every bucket and at the edge sizes: the card's answers
    within f32 rtol 1e-5 of the same engine on the CPU (labels equal);
    a repeated call gives the same bits; the census never changes."""
    from spark_agd_tpu_torch.serve import ServeEngine

    card = ServeEngine(_serve_models(cuda)[kind], max_batch=64)
    host = ServeEngine(_serve_models("cpu")[kind], max_batch=64,
                       device="cpu")
    assert card.ladder.buckets == (8, 16, 32, 64)
    assert all(p.inbuf.device.type == "cuda"
               for p in card._programs.values())
    census = card.compile_census()
    r = np.random.default_rng(0)
    for op in card.ops:
        for n in (1, 7, 8, 9, 16, 32, 63, 64, 65, 200):
            X = r.normal(size=(n, 40)).astype(np.float32)
            got, want = card.predict(X, op), host.predict(X, op)
            assert got.dtype == want.dtype and got.shape == want.shape
            if op == "predict_proba" or kind == "logistic":
                np.testing.assert_allclose(got, want, rtol=1e-5,
                                           atol=1e-6)
            else:
                assert np.array_equal(got, want), (op, n)
            assert np.array_equal(card.predict(X, op), got)
    assert card.compile_census() == census


@pytest.mark.cuda
def test_serve_queue_on_the_card_hot_swaps_mid_stream(cuda):
    from spark_agd_tpu_torch.models import glm
    from spark_agd_tpu_torch.serve import MicroBatchQueue, ServeEngine

    models = {g: glm.LogisticRegressionModel(
        torch.randn(40, generator=torch.Generator().manual_seed(g))
        .to(cuda), 0.0) for g in (1, 2)}
    eng = ServeEngine(models[1], generation=1, max_batch=16)
    census = eng.compile_census()
    r = np.random.default_rng(1)
    results = []
    with MicroBatchQueue(eng, max_wait_us=0) as q:
        for i in range(40):
            if i == 20:
                eng.bind(models[2], 2)
            X = r.normal(size=(3, 40)).astype(np.float32)
            res = q.submit(X, "predict_proba").result(timeout=30)
            want = models[res.generation].predict_proba(
                torch.from_numpy(X).to(cuda)).cpu().numpy()
            np.testing.assert_allclose(res.value, want, rtol=1e-5)
            results.append(res.generation)
    assert results == [1] * 20 + [2] * 20
    assert eng.compile_census() == census and eng.hot_swaps == 1


@pytest.mark.cuda
def test_serving_and_pipeline_refuse_telemetry_on_the_card(cuda, tmp_path):
    """telemetry= is ported: the engine, the queue, the registry and the
    promoter take an ``obs.Telemetry`` on the card, and every record
    names the card and passes the schema validator."""
    from spark_agd_tpu_torch import pipeline, serve
    from spark_agd_tpu_torch.obs import Telemetry, schema

    tel = Telemetry()
    model = _serve_models(cuda)["logistic"]
    reg = serve.ModelRegistry(str(tmp_path), telemetry=tel)
    reg.publish(model)
    eng = serve.ServeEngine(model, generation=1, telemetry=tel)
    with serve.MicroBatchQueue(eng, telemetry=tel, replica=0,
                               max_wait_us=0) as q:
        q.submit(np.ones((3, 40), np.float32), tenant="a").result(30)
    assert pipeline.Promoter(reg, eng, telemetry=tel).telemetry is tel
    kinds = [r["kind"] for r in tel.records]
    assert {"span", "recovery", "serve_request", "serve_latency"} <= \
        set(kinds)
    name = torch.cuda.get_device_name(torch.cuda.current_device())
    for rec in tel.records:
        assert rec["device_kind"] == name and rec["cuda_version"]
        assert schema.validate_record(rec) == [], rec


@pytest.mark.cuda
def test_a_one_replica_fleet_answers_on_the_card_through_the_wire(
        cuda, tmp_path):
    """A ``ReplicaServer`` over an engine on the card, reached through
    ``discover_replicas`` and a ``FleetRouter``: every answer equals the
    model's own ``predict_proba`` on the card at f32 rtol 1e-5, the f32
    rows crossing the JSON wire exactly; a hot swap through the registry
    reaches the replica."""
    from spark_agd_tpu_torch.models import glm
    from spark_agd_tpu_torch.obs import Telemetry
    from spark_agd_tpu_torch.serve import (FleetRouter, ModelRegistry,
                                           ReplicaServer, ServeEngine,
                                           discover_replicas)

    gen = torch.Generator(device=cuda).manual_seed(3)
    models = {g: glm.LogisticRegressionModel(
        torch.randn(1_000, generator=gen, device=cuda) / 30.0, 0.1 * g)
        for g in (1, 2)}
    reg = ModelRegistry(str(tmp_path / "registry"))
    reg.publish(models[1])
    eng = ServeEngine(reg.load_newest().model, generation=1, max_batch=16)
    tel = Telemetry()
    fleet_dir = str(tmp_path / "fleet")
    r = np.random.default_rng(0)
    with ReplicaServer(fleet_dir, 0, eng, registry=reg, telemetry=tel,
                       poll_every_s=0.05) as server:
        handles = discover_replicas(fleet_dir)
        assert list(handles) == [0] and handles[0].port == server.port
        with FleetRouter(handles, telemetry=tel) as router:
            seen = set()
            for i in range(40):
                if i == 20:
                    reg.publish(models[2])
                X = r.normal(size=(1 + i % 16, 1_000)).astype(np.float32)
                res = router.request(X, op="predict_proba")
                want = models[res.generation].predict_proba(
                    torch.from_numpy(X).to(cuda)).cpu().numpy()
                np.testing.assert_allclose(res.values, want, rtol=1e-5,
                                           atol=1e-7)
                seen.add(res.generation)
                if i >= 20 and res.generation == 1:
                    time.sleep(0.05)  # the poll loop's next look
            assert seen == {1, 2} and router.stats.requests == 40
    assert eng.generation == 2 and eng.hot_swaps >= 1
    assert [r["replica"] for r in tel.records
            if r["kind"] == "serve_request"] == [0] * 40


@pytest.mark.cuda
def test_telemetry_on_a_supervised_flagship_shape_fit(cuda):
    """The flagship's 1,000 columns through ``FusedLogisticGradient`` in
    segments, with a ``Telemetry`` streaming the iterations: the
    iteration records' losses are the fit's history, bit for bit, and
    the fit is the bits of the same fit without telemetry."""
    from spark_agd_tpu_torch.core import smooth
    from spark_agd_tpu_torch.data import device_synth
    from spark_agd_tpu_torch.obs import Telemetry, schema
    from spark_agd_tpu_torch.resilience import (ResiliencePolicy,
                                                run_agd_supervised)

    X, y = device_synth.class_logistic(200_003, 1_000, seed=13)
    px, rv = smooth.make_prox(port.SquaredL2Updater(), 0.1)
    w0 = torch.zeros(1_000, device=cuda)

    def fit(**kw):
        staged = smooth.make_smooth_staged(port.FusedLogisticGradient(),
                                           X, y)
        return run_agd_supervised(
            prox=px, reg_value=rv, w0=w0,
            config=port.AGDConfig(num_iterations=12, convergence_tol=0.0),
            policy=ResiliencePolicy(segment_iters=4, jitter=0.0, seed=0),
            staged=staged, **kw)

    bare = fit()
    tel = Telemetry()
    fk.reset_launch_counts()
    res = fit(telemetry=tel, stream_iterations=True)
    torch.cuda.synchronize()
    assert fk.launch_count > 0
    assert set(m for m, c in fk.margin_mode_launches.items() if c) == {
        fk.launch_shape(X).mode}
    assert torch.equal(res.weights, bare.weights)
    assert np.array_equal(res.loss_history, bare.loss_history)
    # in emission order: each segment counts its iterations from 1
    its = [r for r in tel.records if r["kind"] == "iteration"]
    assert [r["loss"] for r in its] == list(res.loss_history)
    assert [r["iter"] for r in its] == [1, 2, 3, 4] * 3
    assert [r["kind"] for r in tel.records].count("attempt") == 3
    for rec in tel.records:
        assert schema.validate_record(rec) == [], rec
