"""Carry weights and optimizer state between numpy and the port.

The JAX package's parameters convert to numpy with ``np.asarray``; these
helpers take such arrays (or anything ``np.asarray`` accepts) to torch
tensors on a device and back, for a single array or a dict/list/tuple of
them.  ``warm_state_from_numpy`` turns a JAX ``AGDWarmState`` (or one
rebuilt from its numpy fields) into the port's, so that a run started in
the JAX package continues here.  ``csr_from_numpy`` and ``csr_to_numpy``
carry a JAX ``CSRMatrix`` (its leaves as numpy arrays) into the port and
back, its column-sorted twin included.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import tvec
from .core.agd import AGDWarmState
from .ops.sparse import CSRMatrix, _values_tensor


def weights_from_numpy(tree, device, dtype=None):
    """Tensors on ``device`` (copies), optionally cast to ``dtype``."""
    def one(a):
        t = torch.tensor(np.asarray(a), device=device)
        return t if dtype is None else t.to(dtype)

    return tvec.tmap(one, tree)


def weights_to_numpy(tree):
    """Numpy copies of a tensor or a dict/list/tuple of tensors."""
    return tvec.tmap(lambda t: t.detach().cpu().numpy(), tree)


def warm_state_from_numpy(warm, device, dtype=None) -> AGDWarmState:
    """The port's ``AGDWarmState`` from any object with the six fields
    (``x``, ``z`` arrays; ``theta``, ``big_l``, ``bts``,
    ``prior_iters`` scalars)."""
    return AGDWarmState(
        x=weights_from_numpy(warm.x, device, dtype),
        z=weights_from_numpy(warm.z, device, dtype),
        theta=float(np.asarray(warm.theta)),
        big_l=float(np.asarray(warm.big_l)),
        bts=bool(np.asarray(warm.bts)),
        prior_iters=int(np.asarray(warm.prior_iters)))


def warm_state_to_numpy(warm: AGDWarmState) -> AGDWarmState:
    """The same carry with numpy arrays and Python scalars, which the JAX
    package's ``run_agd(warm=...)`` accepts."""
    def scalar(v):
        return np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)

    return AGDWarmState(
        x=weights_to_numpy(warm.x), z=weights_to_numpy(warm.z),
        theta=float(scalar(warm.theta)), big_l=float(scalar(warm.big_l)),
        bts=bool(scalar(warm.bts)),
        prior_iters=int(scalar(warm.prior_iters)))


def warm_from_result(res, prior_iters: int) -> AGDWarmState:
    """Continuation carry out of an ``AGDResult`` (counterpart of
    ``spark_agd_tpu/utils/checkpoint.py:warm_from_result``)."""
    return AGDWarmState(
        x=res.weights, z=res.final_z, theta=float(res.final_theta),
        big_l=float(res.final_l), bts=bool(res.final_bts),
        prior_iters=int(prior_iters))


def csr_from_numpy(row_ids, col_ids, values, shape, *, csc=None,
                   device) -> CSRMatrix:
    """The port's CSRMatrix on ``device`` from COO arrays (the leaves of
    a JAX ``CSRMatrix``, ``np.asarray`` of each).  ``csc``, when given,
    is its twin ``(csc_row_ids, csc_col_ids, csc_values)``, column-sorted
    as the JAX package builds it.  Rows in any order are accepted (the
    port sorts them once, stably)."""
    def t(a):
        return _values_tensor(np.array(a)).to(device)  # a writable copy

    twin = {}
    if csc is not None:
        twin = dict(zip(("csc_row_ids", "csc_col_ids", "csc_values"),
                        map(t, csc)))
    return CSRMatrix(t(row_ids), t(col_ids), t(values), shape, **twin)


def csr_to_numpy(X: CSRMatrix) -> dict:
    """The leaves of ``X`` as numpy arrays under the JAX ``CSRMatrix``'s
    constructor names (``row_ids``, ``col_ids``, ``values``, ``shape``,
    and the ``csc_*`` twin when ``X`` has one), so that
    ``spark_agd_tpu.ops.sparse.CSRMatrix(**csr_to_numpy(X))`` rebuilds
    it in the JAX package."""
    out = {"row_ids": X.row_ids.cpu().numpy(),
           "col_ids": X.col_ids.cpu().numpy(),
           "values": X.values.cpu().numpy(), "shape": X.shape,
           "rows_sorted": True}
    if X.has_csc:
        out.update(csc_row_ids=X.csc_row_ids.cpu().numpy(),
                   csc_col_ids=X.csc_col_ids.cpu().numpy(),
                   csc_values=X.csc_values.cpu().numpy())
    return out
