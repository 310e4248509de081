"""CSR sparse matrix with deterministic products.

Counterpart of ``spark_agd_tpu/ops/sparse.py:44-191,278-291``.  rcv1.binary
(47,236 features) and url_combined (3,231,961 features) are far too
sparse to densify, so the sparse path is a gather and a sorted segment
sum, as in the JAX package:

- ``matvec`` / ``matmat``: ``values * w[col_ids]`` summed over each row's
  entries (``torch.segment_reduce`` over the row offsets ``indptr``);
- ``rmatvec`` / ``rmatmat``: ``csc_values * v[csc_row_ids]`` summed over
  each column's entries of the column-sorted twin (over ``colptr``).

``CSRMatrix`` keeps the JAX layout and names: COO entries with row ids
(``row_ids``, ``col_ids``, ``values``, ``shape``) and an optional
column-sorted twin of the same entries (``csc_row_ids``, ``csc_col_ids``,
``csc_values``), plus the offsets the reductions need.  On the TPU the
twin avoids a slow unsorted scatter; here it makes the transpose product
a sorted reduction instead of an ``index_add_``, whose float atomics on
CUDA sum in an order that changes from run to run.  Every product reduces
each segment in a fixed order, so repeated calls give the same bits; a
segment longer than ``CHUNK`` entries (the intercept's column) is summed
in fixed chunks first, then over its chunks.  A transpose product on a
matrix without its twin builds the twin first (``Gradient.prepare``
builds it once, at data placement).

The forward arrays are kept in row order: a matrix built with
``rows_sorted=False`` is sorted by row (stably) when it is made, so
``rows_sorted`` is always true afterwards and ``indptr`` always exists.

Padding contract (``spark_agd_tpu/ops/sparse.py:28-31``): ``nnz`` may
count padding entries of value 0; they add nothing to either product,
whatever row or column they point at.

Values are f32, f64 or bf16; ids are int32 (or int64) and offsets int64,
so a url-sized matrix (277.9M entries) fits int32 ids without
overflowing its offsets.  The products run in the promoted dtype of the
values and the dense operand, so bf16 values meet f32 weights in f32
(widened once per entry, summed in f32), and a loss and gradient over
bf16 values come back in f32, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_VALUE_TYPES = (torch.float32, torch.float64, torch.bfloat16)
_ID_TYPES = (torch.int32, torch.int64)


def _offsets(sorted_ids: torch.Tensor, n_segments: int) -> torch.Tensor:
    """int64 offsets (n_segments + 1,) of the runs of equal ids in the
    nondecreasing ``sorted_ids``: segment s is ``[off[s], off[s+1])``."""
    bounds = torch.arange(n_segments + 1, dtype=sorted_ids.dtype,
                          device=sorted_ids.device)
    return torch.searchsorted(sorted_ids, bounds)


# Entries one thread adds in order; a longer segment (the intercept's
# column holds every row) is cut into chunks of this many, summed in a
# second pass, so no thread walks a whole column.
CHUNK = 256


def _plan(offsets: torch.Tensor):
    """How to reduce over ``offsets``: None when no segment holds more
    than ``CHUNK`` entries (one pass), else ``(chunk_offsets,
    chunks_of_segment)``: chunk j of segment s starts ``(j -
    chunks_of_segment[s]) * CHUNK`` entries after ``offsets[s]``.  It
    depends on the offsets alone, so the sums' order is fixed."""
    lengths = offsets[1:] - offsets[:-1]
    if lengths.numel() == 0 or int(lengths.max()) <= CHUNK:
        return None
    counts = (lengths + CHUNK - 1) // CHUNK
    seg_chunks = torch.zeros(len(counts) + 1, dtype=torch.int64,
                             device=offsets.device)
    torch.cumsum(counts, 0, out=seg_chunks[1:])
    total = int(seg_chunks[-1])
    segment = torch.arange(len(counts), device=offsets.device) \
        .repeat_interleave(counts, output_size=total)
    local = torch.arange(total, device=offsets.device) - seg_chunks[segment]
    starts = offsets[segment] + local * CHUNK
    return torch.cat([starts, offsets[-1:]]), seg_chunks


def _gather_reduce(values, ids, x, offsets, plan):
    """``out[s] = sum over entries e of segment s of values[e] *
    x[ids[e]]`` (a row of x when x is 2-D), in the promoted dtype.

    The products are reduced as an (nnz, K) array, K = 1 for a vector:
    on CUDA ``segment_reduce`` then runs one thread per (segment, column)
    that adds the segment's entries in order, the order the CPU uses
    too.  (A 1-D input goes to a CUB segmented reduction instead: an
    evaluation, both products, is slower that way at both BASELINE
    sparse shapes on the H100, PERF.md §6.)
    With a ``plan`` (:func:`_plan`), chunks are summed first, then each
    segment's chunk sums."""
    dt = torch.promote_types(values.dtype, x.dtype)
    x2 = x.to(dt) if x.dim() == 2 else x.to(dt)[:, None]
    prods = torch.index_select(x2, 0, ids) * values.to(dt)[:, None]
    if plan is None:
        out = torch.segment_reduce(prods, "sum", offsets=offsets, axis=0)
    else:
        chunk_offsets, seg_chunks = plan
        sums = torch.segment_reduce(prods, "sum", offsets=chunk_offsets,
                                    axis=0)
        out = torch.segment_reduce(sums, "sum", offsets=seg_chunks, axis=0)
    return out if x.dim() == 2 else out[:, 0]


def _check_values(values: torch.Tensor):
    if values.dtype not in _VALUE_TYPES:
        raise TypeError(f"CSRMatrix values must be f32, f64 or bf16; got "
                        f"{values.dtype}")


def _values_tensor(values) -> torch.Tensor:
    """CSR values as a tensor: a tensor as it is, a numpy array copied
    over, and a bf16 array (the ``ml_dtypes`` type JAX hands out) by its
    bits."""
    if isinstance(values, torch.Tensor):
        return values
    values = np.asarray(values)
    if values.dtype.name == "bfloat16":
        return torch.from_numpy(values.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(values)


def _as_ids(a, device) -> torch.Tensor:
    t = torch.as_tensor(a, device=device)
    return t if t.dtype in _ID_TYPES else t.to(torch.int64)


class CSRMatrix:
    """Row-sparse matrix in COO-with-row-ids form (see module docstring).

    ``row_ids``/``col_ids``/``values`` are (nnz,) tensors on one device;
    ``shape`` is ``(n_rows, n_features)``.  ``indptr`` (n_rows + 1,) and,
    with the twin, ``colptr`` (n_features + 1,) are the int64 offsets of
    each row's and each column's entries, computed here.  ``want_csc``
    marks a matrix whose twin is to be built at data placement
    (``with_csc(lazy=True)``)."""

    def __init__(self, row_ids, col_ids, values, shape: Tuple[int, int],
                 *, csc_row_ids=None, csc_col_ids=None, csc_values=None,
                 rows_sorted: bool = False, want_csc: bool = False):
        values = torch.as_tensor(values)
        _check_values(values)
        dev = values.device
        row_ids, col_ids = _as_ids(row_ids, dev), _as_ids(col_ids, dev)
        self.shape = (int(shape[0]), int(shape[1]))
        nnz = values.shape[0]
        if not (values.dim() == row_ids.dim() == col_ids.dim() == 1
                and row_ids.shape[0] == col_ids.shape[0] == nnz):
            raise ValueError(
                f"row_ids, col_ids and values must be 1-D of one length; "
                f"got {tuple(row_ids.shape)}, {tuple(col_ids.shape)}, "
                f"{tuple(values.shape)}")
        if not rows_sorted:
            # the forward product needs row order: sort once, stably
            row_ids, order = torch.sort(row_ids, stable=True)
            col_ids, values = col_ids[order], values[order]
        self.row_ids, self.col_ids, self.values = row_ids, col_ids, values
        self.indptr = _offsets(row_ids, self.shape[0])
        self.rows_sorted = True
        self.want_csc = bool(want_csc)
        # reduction plans (_plan) of the offsets, made at first use
        self._plans = {}
        self.csc_row_ids = self.csc_col_ids = self.csc_values = None
        self.colptr = None
        if csc_values is not None:
            csc_values = torch.as_tensor(csc_values, device=dev)
            _check_values(csc_values)
            self.csc_row_ids = _as_ids(csc_row_ids, dev)
            self.csc_col_ids = _as_ids(csc_col_ids, dev)
            self.csc_values = csc_values
            self.colptr = _offsets(self.csc_col_ids, self.shape[1])

    # -- construction ------------------------------------------------------
    @classmethod
    def from_csr_arrays(cls, indptr, indices, values, n_features: int,
                        with_csc: bool = False, *,
                        device=None) -> "CSRMatrix":
        """From scipy-style CSR arrays (a ``CSRData`` from
        ``load_libsvm``, for example), as tensors on ``device`` (default:
        the current CUDA device, raising when there is none; pass
        ``"cpu"`` for the CPU).  Indices outside ``[0, n_features)``
        raise ``ValueError`` before anything is copied."""
        from .._device import resolve_device

        dev = resolve_device(device)
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices)
        if indices.size and (indices.min() < 0
                             or indices.max() >= n_features):
            raise ValueError(
                f"CSR indices must lie in [0, {n_features}); got "
                f"[{indices.min()}, {indices.max()}]")
        n_rows = len(indptr) - 1
        counts = torch.from_numpy(np.diff(indptr)).to(dev)
        row_ids = torch.arange(n_rows, dtype=torch.int32,
                               device=dev).repeat_interleave(counts)
        X = cls(row_ids,
                torch.from_numpy(indices.astype(np.int32, copy=False)).to(dev),
                _values_tensor(values).to(dev),
                (n_rows, int(n_features)), rows_sorted=True)
        return X.with_csc() if with_csc else X

    def with_csc(self, lazy: bool = False) -> "CSRMatrix":
        """A matrix carrying the column-sorted twin of the entries (itself
        when it has one).  ``lazy=True`` only marks it as wanting the twin
        (``want_csc``); ``Gradient.prepare`` builds it at data placement.
        The twin is built where the entries lie, by a stable sort of the
        column ids, so the same entries always give the same twin."""
        if self.has_csc or (lazy and self.want_csc):
            return self
        if lazy:
            return CSRMatrix(self.row_ids, self.col_ids, self.values,
                             self.shape, rows_sorted=True, want_csc=True)
        csc_col_ids, order = torch.sort(self.col_ids, stable=True)
        return CSRMatrix(
            self.row_ids, self.col_ids, self.values, self.shape,
            csc_row_ids=self.row_ids[order], csc_col_ids=csc_col_ids,
            csc_values=self.values[order], rows_sorted=True,
            want_csc=self.want_csc)

    def to(self, device) -> "CSRMatrix":
        """The same matrix on ``device`` (itself when it lies there)."""
        dev = torch.device(device)
        if self.values.device == dev:
            return self

        def move(t):
            return None if t is None else t.to(dev)

        return CSRMatrix(
            move(self.row_ids), move(self.col_ids), move(self.values),
            self.shape, csc_row_ids=move(self.csc_row_ids),
            csc_col_ids=move(self.csc_col_ids),
            csc_values=move(self.csc_values), rows_sorted=True,
            want_csc=self.want_csc)

    @property
    def has_csc(self) -> bool:
        return self.csc_values is not None

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    def __repr__(self):
        return (f"CSRMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"dtype={self.dtype}, device={self.device}, "
                f"has_csc={self.has_csc})")

    # -- products ----------------------------------------------------------
    def _rows(self, x):
        if "rows" not in self._plans:
            self._plans["rows"] = _plan(self.indptr)
        return _gather_reduce(self.values, self.col_ids, x, self.indptr,
                              self._plans["rows"])

    def _columns(self, x):
        t = self if self.has_csc else self.with_csc()
        if "columns" not in t._plans:
            t._plans["columns"] = _plan(t.colptr)
        return _gather_reduce(t.csc_values, t.csc_row_ids, x, t.colptr,
                              t._plans["columns"])

    def matvec(self, w):
        """``X @ w`` -> (n_rows,)."""
        return self._rows(w)

    def rmatvec(self, v):
        """``X.T @ v`` -> (n_features,), over the twin (built first when
        missing)."""
        return self._columns(v)

    def matmat(self, W):
        """``X @ W`` for (D, K) dense W -> (n_rows, K)."""
        return self._rows(W)

    def rmatmat(self, V):
        """``X.T @ V`` for (n_rows, K) dense V -> (n_features, K)."""
        return self._columns(V)


def matvec(X, w):
    """Polymorphic ``X @ w`` (dense tensor or CSRMatrix); 2-D ``w``
    routes to matmat."""
    if isinstance(X, CSRMatrix):
        return X.matmat(w) if w.dim() == 2 else X.matvec(w)
    return X @ w


def rmatvec(X, v):
    """Polymorphic ``X.T @ v``."""
    if isinstance(X, CSRMatrix):
        return X.rmatmat(v) if v.dim() == 2 else X.rmatvec(v)
    return X.T @ v
