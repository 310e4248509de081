"""The port's fused margin kernel module against the JAX package.

On the CPU the wrapper runs the kernel's plain version; these tests hold
it, through ``FusedMarginGradient.prepare`` + ``batch_loss_and_grad``, to
the Pallas kernel in interpret mode and to ``MarginGradient`` at the
tolerances of ``tests/test_pallas.py`` (loss rtol 1e-5, gradient
rtol/atol 1e-4), and check the staging and what takes the plain
version.  The CUDA kernel itself, its launch shape and its width limit
run only on the card: ``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_agd_tpu.ops import losses as jlosses
from spark_agd_tpu.ops.pallas_kernels import (
    fused_margin_loss_grad as pallas_margin_loss_grad,
    pad_dense,
)
from spark_agd_tpu_torch.ops import fused_kernels as fk, losses
from spark_agd_tpu_torch.ops.sparse import CSRMatrix

LOSSES = ["logistic", "least_squares", "hinge"]


def _data(n=37, d=13, seed=0):
    """Unaligned on purpose: Pallas pads 37 x 13 to tiles, the CUDA
    kernel masks the ragged edges itself."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal(d) / np.sqrt(d)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    return X, w, y, mask


def _port(name, X, w, y, mask):
    g = fk.FusedMarginGradient(losses.GRADIENTS[name]())
    staged, y_out, m_out = g.prepare(torch.from_numpy(X),
                                     torch.from_numpy(y),
                                     None if mask is None
                                     else torch.from_numpy(mask))
    assert isinstance(staged, fk.StagedDense)
    assert y_out is None and m_out is None
    return g.batch_loss_and_grad(torch.from_numpy(w), staged, None, None)


def _pallas(name, X, w, y, mask):
    inner = jlosses.GRADIENTS[name]()
    padded = pad_dense(jnp.asarray(X), jnp.asarray(y),
                       None if mask is None else jnp.asarray(mask))
    return pallas_margin_loss_grad(inner, jnp.asarray(w), padded,
                                   interpret=True)


def _assert_kernel_close(loss, grad, ref_loss, ref_grad):
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    np.testing.assert_allclose(np.asarray(grad), np.asarray(ref_grad),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("name", LOSSES)
def test_matches_pallas_interpret_and_margin_gradient(name, masked):
    X, w, y, mask = _data()
    m = mask if masked else None
    loss, grad, n = _port(name, X, w, y, m)
    assert loss.dtype == torch.float32 and grad.shape == (X.shape[1],)
    p_loss, p_grad = _pallas(name, X, w, y, m)
    _assert_kernel_close(loss, grad, p_loss, p_grad)
    j_loss, j_grad, j_n = jlosses.GRADIENTS[name]().batch_loss_and_grad(
        jnp.asarray(w), jnp.asarray(X), jnp.asarray(y),
        None if m is None else jnp.asarray(m))
    _assert_kernel_close(loss, grad, j_loss, j_grad)
    assert int(n) == int(j_n)


@pytest.mark.parametrize("name", LOSSES)
def test_wider_multi_block_shape(name):
    """N = 512, D = 48: several Pallas row blocks, several kernel tiles."""
    X, w, y, mask = _data(n=512, d=48, seed=4)
    loss, grad, _ = _port(name, X, w, y, mask)
    j_loss, j_grad, _ = jlosses.GRADIENTS[name]().batch_loss_and_grad(
        jnp.asarray(w), jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask))
    _assert_kernel_close(loss, grad, j_loss, j_grad)


@pytest.mark.parametrize("name", ["logistic", "hinge"])
def test_bf16_input(name):
    """bf16 X widened to f32 in the kernel: held to the Pallas kernel on
    the same bf16 X at the f32 tolerances, and to the f32 loss with
    test_pallas.py's loose bf16 bound."""
    X, w, y, mask = _data(seed=2)
    X16 = torch.from_numpy(X).to(torch.bfloat16)
    g = fk.FusedMarginGradient(losses.GRADIENTS[name]())
    staged, _, _ = g.prepare(X16, torch.from_numpy(y),
                             torch.from_numpy(mask))
    assert staged.X.dtype == torch.bfloat16
    assert staged.X.data_ptr() == X16.data_ptr()
    loss, grad, _ = g.batch_loss_and_grad(torch.from_numpy(w), staged,
                                          None, None)
    Xj = jnp.asarray(X16.to(torch.float32).numpy()).astype(jnp.bfloat16)
    padded = pad_dense(Xj, jnp.asarray(y), jnp.asarray(mask))
    p_loss, p_grad = pallas_margin_loss_grad(
        jlosses.GRADIENTS[name](), jnp.asarray(w), padded, interpret=True)
    _assert_kernel_close(loss, grad, p_loss, p_grad)
    ref_loss, ref_grad, _ = jlosses.GRADIENTS[name]().batch_loss_and_grad(
        jnp.asarray(w), jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask))
    assert float(loss) == pytest.approx(float(ref_loss), rel=0.05)
    ref_grad = np.asarray(ref_grad)
    cos = float(np.dot(grad.numpy(), ref_grad)
                / (np.linalg.norm(grad.numpy()) * np.linalg.norm(ref_grad)))
    assert cos > 0.99


def test_prepare_does_not_copy_contiguous_x():
    X, w, y, mask = _data()
    Xt = torch.from_numpy(X)
    staged = fk.stage_dense(Xt, torch.from_numpy(y))
    assert staged.X.data_ptr() == Xt.data_ptr()
    assert staged.X is Xt
    assert staged.m.dtype == torch.float32 and bool((staged.m == 1).all())
    assert int(staged.n_valid) == X.shape[0]
    # other dtypes become f32; a strided view becomes contiguous
    s64 = fk.stage_dense(torch.from_numpy(X.astype(np.float64)),
                         torch.from_numpy(y))
    assert s64.X.dtype == torch.float32
    sT = fk.stage_dense(torch.from_numpy(X).T.contiguous().T,
                        torch.from_numpy(y))
    assert sT.X.is_contiguous()
    sm = fk.stage_dense(Xt, torch.from_numpy(y), torch.from_numpy(mask))
    assert int(sm.n_valid) == int((mask > 0).sum())


def test_f64_weights_get_f64_results():
    X, w, y, _ = _data()
    g = fk.FusedLogisticGradient()
    staged, _, _ = g.prepare(torch.from_numpy(X), torch.from_numpy(y))
    loss, grad, _ = g.batch_loss_and_grad(
        torch.from_numpy(w.astype(np.float64)), staged, None, None)
    assert loss.dtype == torch.float64 and grad.dtype == torch.float64


def test_prepare_rejects_a_non_matrix_x():
    g = fk.FusedLogisticGradient()
    with pytest.raises(ValueError, match="2-D X"):
        g.prepare(torch.zeros(8), torch.zeros(8))
    with pytest.raises(ValueError, match="2-D X"):
        g.batch_loss_and_grad(torch.zeros(2), torch.zeros((2, 2, 2)),
                              torch.zeros(2))


def test_overwide_falls_back_and_counts():
    """A CPU X wider than the CUDA kernel's tile is staged like any other
    and takes the plain version, with no launch counted; on the card the
    same X raises (``test_torch_cuda.py``)."""
    rng = np.random.default_rng(5)
    d = 25_000  # past the kernel's width limit in f32 and in bf16
    X = rng.standard_normal((4, d)).astype(np.float32)
    w = (rng.standard_normal(d) / np.sqrt(d)).astype(np.float32)
    y = np.array([0, 1, 1, 0], np.float32)
    g = fk.FusedLogisticGradient()
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    before = fk.launch_count
    staged, yp, mp = g.prepare(Xt, yt)
    assert isinstance(staged, fk.StagedDense) and staged.X is Xt
    assert yp is None and mp is None
    loss, grad, n = g.batch_loss_and_grad(torch.from_numpy(w), staged, None)
    assert fk.launch_count == before
    ref = losses.LogisticGradient().batch_loss_and_grad(
        torch.from_numpy(w), Xt, yt)
    _assert_kernel_close(loss, grad, ref[0], ref[1])
    assert int(n) == 4


def test_unprepared_dense_call_uses_the_kernel_path():
    X, w, y, mask = _data(seed=6)
    g = fk.FusedMarginGradient(losses.HingeGradient())
    loss, grad, n = g.batch_loss_and_grad(
        torch.from_numpy(w), torch.from_numpy(X), torch.from_numpy(y),
        torch.from_numpy(mask))
    ref = losses.HingeGradient().batch_loss_and_grad(
        torch.from_numpy(w), torch.from_numpy(X), torch.from_numpy(y),
        torch.from_numpy(mask))
    _assert_kernel_close(loss, grad, ref[0], ref[1])
    assert int(n) == int(ref[2])


def test_rejects_losses_without_a_kernel_middle():
    class Shifted(losses.LogisticGradient):
        def dots_loss_and_mult(self, dots, y):
            return super().dots_loss_and_mult(dots + 1.0, y)

    with pytest.raises(TypeError, match="FusedMarginGradient wraps"):
        fk.FusedMarginGradient(Shifted())
    with pytest.raises(TypeError, match="FusedMarginGradient wraps"):
        fk.FusedMarginGradient(losses.SoftmaxGradient(3))


def test_cpu_calls_do_not_count_as_launches():
    X, w, y, _ = _data()
    before = fk.launch_count
    _port("logistic", X, w, y, None)
    assert fk.launch_count == before


def test_sparse_input_raises():
    """A torch sparse layout raises, naming CSRMatrix; a CSRMatrix takes
    the sparse products and launches no kernel."""
    g = fk.FusedLogisticGradient()
    with pytest.raises(TypeError, match="CSRMatrix"):
        g.prepare(torch.eye(4).to_sparse(), torch.zeros(4))
    csr = CSRMatrix.from_csr_arrays([0, 2, 3], [0, 3, 1],
                                    np.ones(3, np.float32), 4, device="cpu")
    with pytest.raises(TypeError, match="sparse products"):
        fk.stage_dense(csr, torch.zeros(2))
    before = fk.launch_count
    Xp, y, _ = g.prepare(csr, torch.ones(2))
    assert isinstance(Xp, CSRMatrix) and Xp.has_csc
    loss, grad, n = g.batch_loss_and_grad(torch.zeros(4), Xp, y)
    assert fk.launch_count == before and int(n) == 2
    assert torch.allclose(loss, torch.tensor(2 * np.log(2.0),
                                             dtype=torch.float32))
    assert grad.shape == (4,)


# --- the softmax kernel module ---------------------------------------------

def _softmax_data(n, d, k, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    W = (rng.standard_normal((d, k)) / np.sqrt(d)).astype(np.float32)
    y = rng.integers(0, k, n).astype(np.float32)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    return X, W, y, mask


def _port_softmax(k, X, W, y, mask):
    g = fk.FusedSoftmaxGradient(losses.SoftmaxGradient(k))
    staged, y_out, m_out = g.prepare(
        torch.from_numpy(X) if isinstance(X, np.ndarray) else X,
        torch.from_numpy(y), None if mask is None else torch.from_numpy(mask))
    assert isinstance(staged, fk.StagedDense)
    assert y_out is None and m_out is None
    return g.batch_loss_and_grad(torch.from_numpy(W), staged, None, None)


def _pallas_softmax(k, X, W, y, mask):
    from spark_agd_tpu.ops.pallas_kernels import PallasSoftmaxGradient

    g = PallasSoftmaxGradient(jlosses.SoftmaxGradient(k), interpret=True)
    args = g.prepare(jnp.asarray(X), jnp.asarray(y),
                     None if mask is None else jnp.asarray(mask))
    return g.batch_loss_and_grad(jnp.asarray(W), *args)


def _assert_softmax_close(loss, grad, ref_loss, ref_grad):
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    np.testing.assert_allclose(np.asarray(grad), np.asarray(ref_grad),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,d,k,masked", [
    (37, 13, 3, False), (37, 13, 3, True), (37, 13, 1, True),
    (700, 130, 10, False)], ids=["37x13x3", "37x13x3-masked",
                                 "37x13x1-masked", "700x130x10"])
def test_softmax_matches_pallas_interpret_and_softmax_gradient(n, d, k,
                                                              masked):
    """Unaligned shapes: Pallas pads rows, columns and classes (Kp = 128);
    the CUDA kernel masks the ragged edges itself."""
    X, W, y, mask = _softmax_data(n, d, k, seed=n + k)
    m = mask if masked else None
    loss, grad, count = _port_softmax(k, X, W, y, m)
    assert loss.dtype == torch.float32 and grad.shape == (d, k)
    p_loss, p_grad, p_n = _pallas_softmax(k, X, W, y, m)
    _assert_softmax_close(loss, grad, p_loss, p_grad)
    j_loss, j_grad, j_n = jlosses.SoftmaxGradient(k).batch_loss_and_grad(
        jnp.asarray(W), jnp.asarray(X), jnp.asarray(y),
        None if m is None else jnp.asarray(m))
    _assert_softmax_close(loss, grad, j_loss, j_grad)
    assert int(count) == int(j_n) == int(p_n)


def test_softmax_bf16_input():
    """bf16 X stays bf16 when staged (no copy) and is widened to f32 in
    the kernel: held to the Pallas kernel on the same bf16 X."""
    X, W, y, mask = _softmax_data(96, 24, 5, seed=3)
    X16 = torch.from_numpy(X).to(torch.bfloat16)
    g = fk.FusedSoftmaxGradient(losses.SoftmaxGradient(5))
    staged, _, _ = g.prepare(X16, torch.from_numpy(y),
                             torch.from_numpy(mask))
    assert staged.X.dtype == torch.bfloat16
    assert staged.X.data_ptr() == X16.data_ptr()
    loss, grad, _ = g.batch_loss_and_grad(torch.from_numpy(W), staged, None)
    Xj = jnp.asarray(X16.to(torch.float32).numpy()).astype(jnp.bfloat16)
    p_loss, p_grad, _ = _pallas_softmax(5, Xj, W, y, mask)
    _assert_softmax_close(loss, grad, p_loss, p_grad)


def test_softmax_prepare_does_not_copy_contiguous_x():
    X, W, y, _ = _softmax_data(40, 7, 4, seed=5)
    Xt = torch.from_numpy(X)
    labels = torch.from_numpy(y.astype(np.int32))
    staged = fk.stage_softmax(Xt, labels, 4)
    assert staged.X is Xt
    assert staged.y.dtype == torch.float32
    assert torch.equal(staged.y, torch.from_numpy(y))
    assert bool((staged.m == 1).all()) and int(staged.n_valid) == 40


def test_softmax_wrapper_rejects_other_gradients():
    with pytest.raises(TypeError, match="FusedSoftmaxGradient wraps"):
        fk.FusedSoftmaxGradient(losses.LogisticGradient())
    with pytest.raises(TypeError, match="CSRMatrix"):
        fk.FusedSoftmaxGradient(losses.SoftmaxGradient(3)).prepare(
            torch.eye(4).to_sparse(), torch.zeros(4))
    with pytest.raises(ValueError, match="2-D X"):
        fk.stage_softmax(torch.zeros(8), torch.zeros(8), 3)


def test_softmax_unprepared_call_and_cpu_launch_count():
    X, W, y, mask = _softmax_data(50, 9, 4, seed=6)
    before = fk.softmax_launch_count
    g = fk.FusedSoftmaxGradient(losses.SoftmaxGradient(4))
    loss, grad, n = g.batch_loss_and_grad(
        torch.from_numpy(W).double(), torch.from_numpy(X),
        torch.from_numpy(y), torch.from_numpy(mask))
    assert loss.dtype == torch.float64 and grad.dtype == torch.float64
    ref = losses.SoftmaxGradient(4).batch_loss_and_grad(
        torch.from_numpy(W), torch.from_numpy(X), torch.from_numpy(y),
        torch.from_numpy(mask))
    _assert_softmax_close(loss, grad, ref[0], ref[1])
    assert int(n) == int(ref[2])
    assert fk.softmax_launch_count == before


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_fused_logistic_loss_grad_matches_jax_back_compat_wrapper(masked):
    from spark_agd_tpu.ops.pallas_kernels import (
        fused_logistic_loss_grad as pallas_logistic_loss_grad)

    X, w, y, mask = _data(seed=7)
    m = mask if masked else None
    loss, grad = fk.fused_logistic_loss_grad(
        torch.from_numpy(w), torch.from_numpy(X), torch.from_numpy(y),
        None if m is None else torch.from_numpy(m))
    p_loss, p_grad = pallas_logistic_loss_grad(
        jnp.asarray(w), jnp.asarray(X), jnp.asarray(y),
        None if m is None else jnp.asarray(m), interpret=True)
    _assert_kernel_close(loss, grad, p_loss, p_grad)
