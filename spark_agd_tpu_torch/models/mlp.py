"""Two-layer MLP trained with AGD through a custom Gradient (BASELINE
config 5).

Counterpart of ``spark_agd_tpu/models/mlp.py``.  The reference's
extension story for non-GLM models is "subclass MLlib's ``Gradient``";
here that seam is ``ops.losses.CustomGradient``: a batch loss over a dict
of parameter tensors, differentiated by ``torch.autograd``, in the
unchanged AGD core (which maps over dicts through ``core.tvec``).

The two products are plain ``torch.matmul`` (a CSR X takes
``ops.sparse``'s products), as the JAX package leaves them to XLA: no
kernel of the port is on this path.  ``jax.nn.gelu`` defaults to its
tanh approximation, so ``"gelu"`` here is ``gelu(approximate="tanh")``.
``MLPModel`` saves to the JAX package's npz layout (``class``,
``activation``, ``param_<name>``), so a model saved by either package
loads in the other.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from .. import api
from .._device import resolve_device
from ..ops.losses import CustomGradient, _mm
from ..ops.prox import IdentityProx, L2Prox, Prox

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "gelu": functools.partial(torch.nn.functional.gelu, approximate="tanh"),
}


def _activation(activation):
    return (_ACTIVATIONS[activation] if isinstance(activation, str)
            else activation)


def init_mlp_params(n_features: int, hidden_units: int, num_classes: int,
                    seed: int = 0, dtype=torch.float32, device=None):
    """Glorot-scaled random init as a dict of tensors, drawn with numpy
    as the JAX package draws it (the same values for the same seed).
    AGD cannot start an MLP at zeros (a symmetric saddle)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    s1 = np.sqrt(2.0 / (n_features + hidden_units))
    s2 = np.sqrt(2.0 / (hidden_units + num_classes))

    def t(a):
        return torch.as_tensor(a).to(device=dev, dtype=dtype)

    return {
        "W1": t(rng.normal(0.0, s1, (n_features, hidden_units))),
        "b1": t(np.zeros(hidden_units)),
        "W2": t(rng.normal(0.0, s2, (hidden_units, num_classes))),
        "b2": t(np.zeros(num_classes)),
    }


def mlp_forward(params, X, activation: Callable = torch.tanh):
    """Logits ``(N, K)``.  The products go through ``losses._mm``, which
    promotes dtypes as ``jnp.matmul`` does, so a CSRMatrix X feeds the
    same model."""
    h = activation(_mm(X, params["W1"]) + params["b1"])
    return _mm(h, params["W2"]) + params["b2"]


def make_mlp_loss_sum(activation: Callable = torch.tanh):
    """Batch softmax cross-entropy *sum*, with the signature of
    ``CustomGradient(supports_mask=True)``: the mask zeroes rows out of
    the loss and, through autograd, out of the gradient."""

    def loss_sum(params, X, y, mask=None):
        logits = mlp_forward(params, X, activation)
        logz = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, 1, y.to(torch.int64)[:, None])[:, 0]
        per = logz - picked
        if mask is not None:
            per = per * mask.to(per.dtype)
        return per.sum()

    return loss_sum


def mlp_gradient(activation="tanh") -> CustomGradient:
    """The config-5 ``Gradient`` for the AGD core."""
    return CustomGradient(make_mlp_loss_sum(_activation(activation)),
                          supports_mask=True)


class MLPModel:
    """A trained MLP: ``params`` (a dict of tensors) and its
    activation."""

    def __init__(self, params, activation: Callable = torch.tanh):
        self.params = params
        self.activation = activation

    def logits(self, X):
        return mlp_forward(self.params, X, self.activation)

    def predict_proba(self, X):
        return torch.softmax(self.logits(X), dim=-1)

    def predict(self, X):
        return torch.argmax(self.logits(X), dim=-1)

    def __repr__(self):
        d, h = self.params["W1"].shape
        k = self.params["W2"].shape[1]
        return f"MLPModel(d={d}, hidden={h}, k={k})"

    def save(self, path: str):
        from .glm import save_model

        save_model(self, path)

    def _to_payload(self) -> dict:
        name = next((n for n, f in _ACTIVATIONS.items()
                     if f is self.activation), None)
        if name is None:
            raise ValueError(
                "cannot persist a custom activation callable; use one "
                f"of the registered names {sorted(_ACTIVATIONS)}")
        payload = {"class": np.asarray("MLPModel"),
                   "activation": np.asarray(name)}
        payload.update({f"param_{k}": v.detach().cpu().numpy()
                        for k, v in self.params.items()})
        return payload

    @classmethod
    def _from_npz(cls, z, device):
        name = str(z["activation"])
        act = _ACTIVATIONS.get(name)
        if act is None:
            raise ValueError(
                f"unknown activation {name!r} in saved MLP; known: "
                f"{sorted(_ACTIVATIONS)}")
        params = {k[len("param_"):]: torch.from_numpy(z[k]).to(device)
                  for k in z.files if k.startswith("param_")}
        return cls(params, act)


class MLPClassifierWithAGD:
    """Trainer in the GLM trainers' shape: a public ``.optimizer``
    (``set_device("cpu")`` for the CPU) and ``train(X, y) ->
    MLPModel``."""

    def __init__(self, hidden_units: int, num_classes: int = 2,
                 reg_param: float = 0.0, updater: Optional[Prox] = None,
                 activation="tanh", seed: int = 0, mesh=None):
        self.hidden_units = int(hidden_units)
        self.num_classes = int(num_classes)
        self.seed = int(seed)
        self._act = _activation(activation)
        if updater is None:
            # a requested penalty selects a penalizing prox; IdentityProx
            # would silently ignore reg_param
            updater = L2Prox() if reg_param else IdentityProx()
        self.optimizer = api.AcceleratedGradientDescent(
            mlp_gradient(self._act), updater)
        self.optimizer.set_reg_param(reg_param)
        if mesh is not None:
            self.optimizer.set_mesh(mesh)  # raises: one device only

    def train(self, X, y, initial_params=None) -> MLPModel:
        """Fit from ``initial_params`` (default: :func:`init_mlp_params`
        with this trainer's seed), on the optimizer's device."""
        if initial_params is None:
            initial_params = init_mlp_params(
                X.shape[1], self.hidden_units, self.num_classes, self.seed,
                device="cpu")
        params = self.optimizer.optimize((X, y), initial_params)
        return MLPModel(params, self._act)


from .glm import _MODEL_CLASSES  # noqa: E402  (registration, no cycle)

_MODEL_CLASSES["MLPModel"] = MLPModel
