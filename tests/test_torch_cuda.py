"""The port's CUDA kernel on the card (``-m cuda``; skips without one).

This file imports only torch and the port, so that it runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)
Tolerances are those of ``tests/test_pallas.py``: loss rtol 1e-5,
gradient rtol 1e-4 with an absolute floor of 1e-4 of its largest entry."""

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_width_rule_and_tile_budget(cuda, dtype):
    """At the widest X the kernel takes, its one-row tile fits shared
    memory (the launch succeeds and agrees); one column more raises when
    staged and when handed to the wrapper, and launches nothing."""
    d = fk.max_width(dtype)
    assert d > 1000
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    X = torch.randn((64, d + 1), generator=gen, device=cuda).to(dtype)
    y = (torch.rand(64, generator=gen, device=cuda) < 0.5).float()
    w = torch.randn(d, generator=gen, device=cuda) / d ** 0.5
    staged = fk.stage_dense(X[:, :d].contiguous(), y)
    rows, grid = fk.launch_shape(staged.X)
    assert 1 <= rows < 8 and grid >= 1
    inner = losses.LogisticGradient()
    loss, grad = fk.fused_margin_loss_grad(inner, w, staged)
    ref_loss, ref_grad = fk.fused_margin_loss_grad_reference(inner, w,
                                                             staged)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-4,
                               atol=1e-4 * float(ref_grad.abs().max()))
    # narrow X: whole warps per tile
    assert fk.launch_shape(X[:, :1000].contiguous())[0] % 8 == 0
    before = fk.launch_count
    with pytest.raises(ValueError, match="shared-memory tile"):
        fk.FusedLogisticGradient().prepare(X, y)
    wide = fk.StagedDense(X, staged.y, staged.m, staged.n_valid)
    with pytest.raises(ValueError, match="shared-memory tile"):
        fk.fused_margin_loss_grad(inner, torch.zeros(d + 1, device=cuda),
                                  wide)
    assert fk.launch_count == before


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
