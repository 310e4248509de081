"""Model layer — the ``GeneralizedLinearAlgorithm``-style callers.

Counterpart of ``spark_agd_tpu/models/glm.py``.  The reference's optimizer
implements MLlib's ``Optimizer`` trait so that it can sit in the optimizer
seat of MLlib's ``GeneralizedLinearAlgorithm`` trainers; this module
gives the same workflow on the port:

- a trainer holding a configurable ``.optimizer`` (the MLlib pattern:
  ``lr.optimizer.setNumIterations(...)``; ``set_device("cpu")`` picks the
  CPU, the default being the current CUDA device);
- ``train(X, y)`` returns a typed model with ``predict``;
- ``add_intercept=True`` prepends the all-ones column (the intercept is
  weight 0, the reference suite's convention).

``predict``, ``margin`` and ``logits`` are plain ``torch`` products, as
the JAX package leaves them to XLA.  Models save to one npz in the JAX
package's layout (``class``, ``weights``, ``intercept``, ``threshold``,
``__crc32__``), so a model saved by either package loads in the other.

The ``*WithLBFGS`` trainers put ``api.LBFGS`` in the seat (L1 and
elastic-net updaters go to OWL-QN).  ``train_path`` fits a
regularization path through the optimizer seat's ``sweep``
(``api.sweep`` for AGD, ``api.make_lbfgs_sweep_runner`` for L-BFGS,
smooth penalties only) and ``cross_validate`` runs K-fold CV over a
grid, then refits the winner (``api.cross_validate``; AGD seats only,
as in the JAX package).  X is a dense tensor (or anything numpy takes)
or an ``ops.sparse.CSRMatrix``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .. import api
from .._device import resolve_device
from ..ops.losses import (
    Gradient,
    HingeGradient,
    LeastSquaresGradient,
    LogisticGradient,
    SoftmaxGradient,
    _mm,
    check_layout,
)
from ..ops.prox import IdentityProx, L1Prox, L2Prox, Prox
from ..ops.sparse import CSRMatrix

def _as_tensor(a, device=None):
    """A dense tensor or a CSRMatrix: tensors and CSR matrices are used as
    they are (a CSRMatrix is moved to ``device`` when given), anything
    numpy takes becomes a tensor (on ``device`` when given)."""
    if isinstance(a, (np.ndarray, list, tuple, float, int)):
        t = torch.as_tensor(np.asarray(a))
        return t if device is None else t.to(device)
    check_layout(a)  # anything else but a dense tensor or CSR: TypeError
    if isinstance(a, CSRMatrix) and device is not None:
        return a.to(device)
    return a


def _add_intercept_csr(X: CSRMatrix) -> CSRMatrix:
    """The intercept column of a CSRMatrix, in row order: row i's entry
    at column 0 comes first in row i, the row's own entries follow with
    their columns moved up by one, and the row offsets become ``indptr +
    arange(n + 1)``.  (The JAX package puts all intercept entries first,
    which leaves its rows unsorted; the port's products need them in
    order.)  The twin, when there is one, stays column-sorted: the
    intercept column first, then the old twin's entries; it equals the
    twin ``with_csc`` would build from the new entries."""
    n, d = X.shape
    dev, nnz = X.device, X.nnz
    # row i's intercept entry sits where row i starts, i entries later
    first = X.indptr[:-1] + torch.arange(n, dtype=torch.int64, device=dev)
    own = torch.ones(nnz + n, dtype=torch.bool, device=dev)
    own[first] = False
    counts = X.indptr[1:] - X.indptr[:-1] + 1
    row_ids = torch.arange(n, dtype=X.row_ids.dtype, device=dev) \
        .repeat_interleave(counts, output_size=nnz + n)
    col_ids = torch.zeros(nnz + n, dtype=X.col_ids.dtype, device=dev) \
        .masked_scatter_(own, X.col_ids + 1)
    values = torch.ones(nnz + n, dtype=X.dtype, device=dev) \
        .masked_scatter_(own, X.values)
    del own
    csc = {}
    if X.has_csc:
        csc = dict(
            csc_row_ids=torch.cat([
                torch.arange(n, dtype=X.csc_row_ids.dtype, device=dev),
                X.csc_row_ids]),
            csc_col_ids=torch.cat([
                torch.zeros(n, dtype=X.csc_col_ids.dtype, device=dev),
                X.csc_col_ids + 1]),
            csc_values=torch.cat([
                torch.ones(n, dtype=X.csc_values.dtype, device=dev),
                X.csc_values]))
    return CSRMatrix(row_ids, col_ids, values, (n, d + 1), rows_sorted=True,
                     want_csc=X.want_csc, **csc)


def _add_intercept(X):
    """Prepend the all-ones column (reference Suite:47-49 convention: the
    intercept is weight 0).  The result lies where X lies."""
    X = _as_tensor(X)
    if isinstance(X, CSRMatrix):
        return _add_intercept_csr(X)
    ones = torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)
    return torch.cat([ones, X], dim=1)


class GLMModel:
    """Trained linear model: ``margin(x) = w·x + intercept``.

    The MLlib ``GeneralizedLinearModel`` analogue; ``weights`` is a
    tensor, on the device the fit ran on."""

    def __init__(self, weights, intercept: float = 0.0):
        self.weights = _as_tensor(weights)
        self.intercept = float(intercept)

    def margin(self, X):
        return _mm(_as_tensor(X, self.weights.device), self.weights) \
            + self.intercept

    def predict(self, X):
        raise NotImplementedError

    def predict_stream(self, dataset):
        """Iterate predictions over batches ``(X, y, mask)`` (a streamed
        dataset yields these).  Yields one numpy array per batch, padding
        rows (mask 0) dropped."""
        for X, _, mask in dataset:
            pred = _numpy(self.predict(X))
            if mask is not None:
                pred = pred[_numpy(mask) > 0]
            yield pred

    def __repr__(self):
        return (f"{type(self).__name__}(d={self.weights.shape[0]}, "
                f"intercept={self.intercept:.4g})")

    def save(self, path: str):
        """Atomic npz snapshot (class name + arrays + scalars); reload
        with :func:`load_model`."""
        save_model(self, path)

    def _to_payload(self) -> dict:
        return _glm_payload(self)

    @classmethod
    def _from_npz(cls, z, device):
        return _decode_glm_npz(cls, z, device)

    @classmethod
    def _from_arrays(cls, weights, intercept, threshold):
        """Restore hook for :func:`load_model`; classes whose constructor
        differs (no threshold, vector intercept) override it."""
        return cls(weights, float(intercept), threshold=threshold)


class LogisticRegressionModel(GLMModel):
    """Binary logistic model.  With a threshold, ``predict`` returns
    {0, 1}; after ``clear_threshold`` it returns probabilities (MLlib's
    ``clearThreshold``)."""

    def __init__(self, weights, intercept: float = 0.0,
                 threshold: Optional[float] = 0.5):
        super().__init__(weights, intercept)
        self.threshold = threshold

    def clear_threshold(self):
        self.threshold = None
        return self

    def predict_proba(self, X):
        return torch.sigmoid(self.margin(X))

    def predict(self, X):
        p = self.predict_proba(X)
        if self.threshold is None:
            return p
        return (p > self.threshold).to(torch.float32)


class SVMModel(GLMModel):
    """Linear SVM: class = [margin > threshold] (default 0, as MLlib)."""

    def __init__(self, weights, intercept: float = 0.0,
                 threshold: Optional[float] = 0.0):
        super().__init__(weights, intercept)
        self.threshold = threshold

    def clear_threshold(self):
        self.threshold = None
        return self

    def predict(self, X):
        m = self.margin(X)
        if self.threshold is None:
            return m
        return (m > self.threshold).to(torch.float32)


class LinearRegressionModel(GLMModel):
    def predict(self, X):
        return self.margin(X)

    @classmethod
    def _from_arrays(cls, weights, intercept, threshold):
        del threshold  # regression has none
        return cls(weights, float(intercept))


class SoftmaxRegressionModel:
    """Multinomial model with weight matrix ``(D, K)`` (BASELINE config
    4).  ``intercept`` is a ``(K,)`` vector when the trainer added one,
    else zeros."""

    def __init__(self, weights, intercept=None):
        self.weights = _as_tensor(weights)
        k = self.weights.shape[1]
        self.intercept = (
            torch.zeros(k, dtype=self.weights.dtype,
                        device=self.weights.device)
            if intercept is None
            else _as_tensor(intercept, self.weights.device))

    @property
    def num_classes(self) -> int:
        return int(self.weights.shape[1])

    def logits(self, X):
        return _mm(_as_tensor(X, self.weights.device), self.weights) \
            + self.intercept

    def predict_proba(self, X):
        return torch.softmax(self.logits(X), dim=-1)

    def predict(self, X):
        return torch.argmax(self.logits(X), dim=-1)

    def __repr__(self):
        d, k = self.weights.shape
        return f"SoftmaxRegressionModel(d={d}, k={k})"

    def save(self, path: str):
        save_model(self, path)

    def _to_payload(self) -> dict:
        return _glm_payload(self)

    @classmethod
    def _from_npz(cls, z, device):
        return _decode_glm_npz(cls, z, device)

    @classmethod
    def _from_arrays(cls, weights, intercept, threshold):
        del threshold  # softmax predicts by argmax
        return cls(weights, intercept)


def _numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _glm_payload(model) -> dict:
    """The npz payload (class name, weights, intercept, NaN-encoded
    optional threshold), as the JAX package writes it."""
    thr = getattr(model, "threshold", None)
    return {"class": np.asarray(type(model).__name__),
            "weights": _numpy(model.weights),
            "intercept": _numpy(model.intercept),
            "threshold": np.asarray(np.nan if thr is None else float(thr))}


def _decode_glm_npz(cls, z, device):
    thr = float(z["threshold"])
    return cls._from_arrays(
        torch.from_numpy(z["weights"]).to(device),
        torch.from_numpy(np.asarray(z["intercept"])).to(device),
        None if np.isnan(thr) else thr)


def save_model(model, path: str):
    """Persist a model as one npz (atomic write via
    ``utils.checkpoint.atomic_savez``, with its ``__crc32__`` entry),
    through the model's own ``_to_payload`` (the MLP's payload is not
    the GLM one)."""
    from ..utils.checkpoint import atomic_savez

    atomic_savez(path, model._to_payload())


_MODEL_CLASSES = {}


def load_model(path: str, device=None):
    """Reload a model saved by either package's ``save``; its arrays go
    to ``device`` (default: the current CUDA device, raising when there
    is none; pass ``"cpu"`` for the CPU)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        cls_name = str(z["class"])
        cls = _MODEL_CLASSES.get(cls_name)
        if cls is None:
            raise ValueError(
                f"unknown model class {cls_name!r} in {path}; known: "
                f"{sorted(_MODEL_CLASSES)}")
        return cls._from_npz(z, dev)


class GeneralizedLinearAlgorithm:
    """Base trainer: holds a public ``.optimizer`` the user configures
    with the fluent setters (``algo.optimizer.setNumIterations(20)``),
    with AGD in the optimizer seat."""

    def __init__(self, gradient: Gradient, updater: Prox, *,
                 add_intercept: bool = False, mesh=None, optimizer=None):
        """``optimizer``: the object in the optimizer seat — default a
        fresh ``AcceleratedGradientDescent(gradient, updater)``; anything
        with the Optimizer trait's ``optimize`` may take its place, and
        then carries its own gradient and updater.  ``mesh`` takes
        ``None``/``False`` only in this slice."""
        self.optimizer = (api.AcceleratedGradientDescent(gradient, updater)
                          if optimizer is None else optimizer)
        if mesh is not None:
            self.optimizer.set_mesh(mesh)
        self.add_intercept = bool(add_intercept)

    def _create_model(self, weights, intercept) -> Any:
        raise NotImplementedError

    def _zero_weights(self, X):
        d = X.shape[1] + (1 if self.add_intercept else 0)
        return np.zeros(d, np.float32)

    def _split_intercept(self, w):
        if self.add_intercept:
            return w[1:], float(w[0])
        return w, 0.0

    def _prepare_fit(self, X, initial_weights):
        """The (possibly intercept-augmented) design matrix and starting
        weights.  ``initial_weights`` is in augmented space when
        ``add_intercept`` (intercept first)."""
        data_X = _add_intercept(X) if self.add_intercept else X
        w0 = (self._zero_weights(X) if initial_weights is None
              else initial_weights)
        return data_X, w0

    def train(self, X, y, initial_weights=None):
        """Fit and return the typed model (see ``_prepare_fit`` for the
        ``initial_weights`` convention)."""
        data_X, w0 = self._prepare_fit(X, initial_weights)
        weights = self.optimizer.optimize((data_X, y), w0)
        return self._create_model(*self._split_intercept(weights))

    def _require_grid_optimizer(self, op_name: str):
        """Grid fits need the matching method on the optimizer seat (AGD
        has ``sweep`` and ``cross_validate``; LBFGS has ``sweep``): a
        seat without it gets a named error, not an AttributeError."""
        if not hasattr(self.optimizer, op_name):
            raise ValueError(
                f"{op_name} requires an optimizer seat providing it "
                f"(AcceleratedGradientDescent: sweep + cross_validate; "
                f"LBFGS: sweep only); "
                f"{type(self.optimizer).__name__} does not")

    def train_path(self, X, y, reg_params, initial_weights=None):
        """Fit the regularization path: one typed model per strength, K
        fits in lock-step (``optimizer.sweep``).  The trainer's own
        ``reg_param`` is ignored; ``reg_params`` supplies the grid.
        Returns ``(models, result)``: the models in ``reg_params`` order
        and the batched ``AGDResult`` (``LBFGSResult`` from an LBFGS
        seat)."""
        self._require_grid_optimizer("sweep")
        data_X, w0 = self._prepare_fit(X, initial_weights)
        res = self.optimizer.sweep((data_X, y), reg_params, w0)
        w_all = res.weights
        models = [self._create_model(*self._split_intercept(w_all[k]))
                  for k in range(w_all.shape[0])]
        return models, res

    def cross_validate(self, X, y, reg_params, n_folds: int = 5,
                       seed: int = 0, refit: bool = True):
        """K-fold CV over ``reg_params`` (``optimizer.cross_validate``),
        then (``refit=True``) one fit of the winning strength on all
        rows.  Returns ``(model, cv)``, ``model`` None when
        ``refit=False``."""
        self._require_grid_optimizer("cross_validate")
        reg_params = list(reg_params)  # consumed more than once below
        data_X, w0 = self._prepare_fit(X, None)
        cv = self.optimizer.cross_validate((data_X, y), reg_params, w0,
                                           n_folds=n_folds, seed=seed)
        model = None
        if refit:
            best_score = float(cv.mean_val_loss[int(cv.best_index)])
            if not np.isfinite(best_score):
                raise ValueError(
                    "cross-validation produced no finite validation "
                    "score (every fold/strength was empty or aborted); "
                    "refusing to refit an arbitrary strength")
            best = float(reg_params[int(cv.best_index)])
            old = self.optimizer._reg_param
            try:
                self.optimizer.set_reg_param(best)
                model = self.train(X, y)
            finally:
                self.optimizer.set_reg_param(old)
        return model, cv


class LogisticRegressionWithAGD(GeneralizedLinearAlgorithm):
    """BASELINE config 1: LogisticGradient + SquaredL2Updater-style prox."""

    def __init__(self, reg_param: float = 0.0, updater: Prox = None,
                 add_intercept: bool = True, mesh=None):
        super().__init__(
            LogisticGradient(),
            updater if updater is not None else L2Prox(),
            add_intercept=add_intercept, mesh=mesh)
        self.optimizer.set_reg_param(reg_param)

    def _create_model(self, weights, intercept):
        return LogisticRegressionModel(weights, intercept)


class LogisticRegressionWithLBFGS(GeneralizedLinearAlgorithm):
    """MLlib's ``LogisticRegressionWithLBFGS``: the same model and
    workflow with ``api.LBFGS`` in the optimizer seat; an L1 or
    elastic-net updater dispatches to OWL-QN."""

    def __init__(self, reg_param: float = 0.0,
                 num_corrections: int = 10, updater: Prox = None,
                 add_intercept: bool = True, mesh=None):
        updater = updater if updater is not None else L2Prox()
        gradient = LogisticGradient()
        super().__init__(
            gradient, updater, add_intercept=add_intercept, mesh=mesh,
            optimizer=api.LBFGS(gradient, updater))
        self.optimizer.set_reg_param(reg_param)
        self.optimizer.set_num_corrections(num_corrections)

    def _create_model(self, weights, intercept):
        return LogisticRegressionModel(weights, intercept)


class LinearRegressionWithAGD(GeneralizedLinearAlgorithm):
    """BASELINE config 2: LeastSquaresGradient.  Unregularized by default;
    a nonzero ``reg_param`` with no explicit updater selects the L2 prox
    (ridge)."""

    def __init__(self, reg_param: float = 0.0, updater: Prox = None,
                 add_intercept: bool = True, mesh=None):
        if updater is None:
            updater = L2Prox() if reg_param else IdentityProx()
        super().__init__(
            LeastSquaresGradient(), updater,
            add_intercept=add_intercept, mesh=mesh)
        self.optimizer.set_reg_param(reg_param)

    def _create_model(self, weights, intercept):
        return LinearRegressionModel(weights, intercept)


class SVMWithAGD(GeneralizedLinearAlgorithm):
    """BASELINE config 3: HingeGradient + L1Updater (sparse-model SVM)."""

    def __init__(self, reg_param: float = 0.0, updater: Prox = None,
                 add_intercept: bool = True, mesh=None):
        super().__init__(
            HingeGradient(),
            updater if updater is not None else L1Prox(),
            add_intercept=add_intercept, mesh=mesh)
        self.optimizer.set_reg_param(reg_param)

    def _create_model(self, weights, intercept):
        return SVMModel(weights, intercept)


class SoftmaxRegressionWithAGD(GeneralizedLinearAlgorithm):
    """BASELINE config 4 (MNIST-8M shape): multinomial softmax, weight
    matrix ``(D, K)``.  Put ``FusedSoftmaxGradient`` in the seat
    (``.optimizer.set_gradient``) to fit through the CUDA kernel."""

    def __init__(self, num_classes: int, reg_param: float = 0.0,
                 updater: Prox = None, add_intercept: bool = True,
                 mesh=None, optimizer=None):
        super().__init__(
            SoftmaxGradient(num_classes),
            updater if updater is not None else L2Prox(),
            add_intercept=add_intercept, mesh=mesh, optimizer=optimizer)
        self.num_classes = int(num_classes)
        self.optimizer.set_reg_param(reg_param)

    def _zero_weights(self, X):
        d = X.shape[1] + (1 if self.add_intercept else 0)
        return np.zeros((d, self.num_classes), np.float32)

    def _split_intercept(self, w):
        if self.add_intercept:
            return w[1:, :], w[0, :]
        return w, None

    def _create_model(self, weights, intercept):
        return SoftmaxRegressionModel(weights, intercept)


class SoftmaxRegressionWithLBFGS(SoftmaxRegressionWithAGD):
    """Multinomial classification with ``api.LBFGS`` in the seat (MLlib
    1.3's ``LogisticRegressionWithLBFGS.setNumClasses(K)``); put
    ``FusedSoftmaxGradient`` in the seat (``.optimizer.set_gradient``)
    to fit through the CUDA kernel."""

    def __init__(self, num_classes: int, reg_param: float = 0.0,
                 num_corrections: int = 10, updater: Prox = None,
                 add_intercept: bool = True, mesh=None):
        updater = updater if updater is not None else L2Prox()
        super().__init__(
            num_classes, reg_param=reg_param, updater=updater,
            add_intercept=add_intercept, mesh=mesh,
            optimizer=api.LBFGS(SoftmaxGradient(num_classes), updater))
        self.optimizer.set_num_corrections(num_corrections)


_MODEL_CLASSES.update({
    "LogisticRegressionModel": LogisticRegressionModel,
    "SVMModel": SVMModel,
    "LinearRegressionModel": LinearRegressionModel,
    "SoftmaxRegressionModel": SoftmaxRegressionModel,
})
