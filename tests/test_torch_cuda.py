"""The port's CUDA kernels and models on the card (``-m cuda``; skips
without one).

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_class_limit(cuda, dtype):
    """At D = 785 the kernel takes every K up to its limit (at least 32);
    one class more raises when staged and in the wrapper, launching
    nothing."""
    d = 785
    k = fk.max_classes(d, dtype)
    assert k >= 32
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    X, y, m, W = _softmax_case(gen, cuda, 2000, d, k)
    staged = fk.stage_softmax(X.to(dtype), y, k, m)
    _assert_softmax_close(*fk.fused_softmax_loss_grad(k, W, staged),
                          *fk.fused_softmax_loss_grad_reference(k, W,
                                                                staged))
    before = fk.softmax_launch_count
    g = fk.FusedSoftmaxGradient(losses.SoftmaxGradient(k + 1))
    with pytest.raises(ValueError, match="classes"):
        g.prepare(X.to(dtype), y)
    with pytest.raises(ValueError, match="classes"):
        fk.fused_softmax_loss_grad(
            k + 1, torch.zeros((d, k + 1), device=cuda), staged)
    assert fk.softmax_launch_count == before


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
