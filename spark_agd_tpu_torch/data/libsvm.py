"""LIBSVM reader: ingest for the sparse BASELINE configs.

Counterpart (a copy) of ``spark_agd_tpu/data/libsvm.py``.  The
reference's users read data through Spark's ``MLUtils.loadLibSVMFile``;
BASELINE configs 1 and 3 (rcv1.binary, url_combined) are LIBSVM files.
This reader uses the native C++ parser (``native/libsvm_parser.cpp``)
when it builds and a pure-Python tokenizer otherwise: the same output
either way, a CSR triple plus labels as numpy arrays on the host.
``ops.sparse.CSRMatrix.from_csr_arrays(data.indptr, data.indices,
data.values, data.n_features, device=...)`` takes a :class:`CSRData` to
the card.
"""

from __future__ import annotations

import io
from typing import NamedTuple, Optional

import numpy as np

from .. import native


class DataValidationError(ValueError):
    """The dataset itself is bad — a non-finite feature/label or an
    out-of-range feature index.  ``ValueError`` parent on purpose: the
    resilience classifier (``resilience.errors.classify_failure``) maps
    it FATAL — re-reading garbage yields the same garbage, so retry/
    backoff would only delay the failure.  Raised by ``validate="raise"``
    ingest; ``validate="drop"`` discards the offending rows instead and
    counts them (``data.invalid_records``)."""

    def __init__(self, where: str, problems):
        problems = list(problems)
        shown = "; ".join(problems[:5])
        more = f" (+{len(problems) - 5} more)" if len(problems) > 5 else ""
        super().__init__(f"{where}: invalid data: {shown}{more}")
        self.where = where
        self.problems = problems


class CSRData(NamedTuple):
    """Labels + CSR features; the LabeledPoint collection analogue."""

    labels: np.ndarray  # (n,) float64
    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (nnz,) int32, 0-based
    values: np.ndarray  # (nnz,) float32
    n_features: int

    @property
    def n_rows(self) -> int:
        return len(self.labels)

    def to_dense(self, n_features: Optional[int] = None,
                 dtype=np.float32) -> np.ndarray:
        d = n_features or self.n_features
        X = np.zeros((self.n_rows, d), dtype=dtype)
        for i in range(self.n_rows):
            s, e = self.indptr[i], self.indptr[i + 1]
            X[i, self.indices[s:e]] = self.values[s:e]
        return X

    def binarized_labels(self) -> np.ndarray:
        """Map {-1,+1} or {0,1} labels to {0,1} (the kernels' convention;
        MLlib requires the same)."""
        y = np.asarray(self.labels)
        return (y > 0).astype(np.float64)


def invalid_row_mask(data: CSRData,
                     n_features: Optional[int] = None) -> np.ndarray:
    """Boolean (n_rows,) mask of rows that must not reach training: a
    non-finite label, a non-finite feature value, or a feature index
    outside ``[0, n_features)``.  Index checks need a width — pass
    ``n_features`` or rely on ``data.n_features``."""
    d = int(n_features or data.n_features)
    bad = ~np.isfinite(np.asarray(data.labels, np.float64))
    values = np.asarray(data.values)
    indices = np.asarray(data.indices)
    bad_nnz = ~np.isfinite(values)
    if d > 0:
        bad_nnz |= (indices < 0) | (indices >= d)
    if bad_nnz.any():
        counts = np.diff(np.asarray(data.indptr))
        rows = np.repeat(np.arange(len(counts)), counts)
        bad |= np.isin(np.arange(len(counts)), rows[bad_nnz])
    return bad


def describe_invalid(data: CSRData, mask: np.ndarray) -> list:
    """Human-readable problems for the masked rows (first few; the
    DataValidationError payload)."""
    problems = []
    for i in np.nonzero(mask)[0][:8]:
        s, e = int(data.indptr[i]), int(data.indptr[i + 1])
        label = data.labels[i]
        if not np.isfinite(label):
            problems.append(f"row {i}: non-finite label {label!r}")
            continue
        vals = np.asarray(data.values[s:e])
        idxs = np.asarray(data.indices[s:e])
        nf = np.nonzero(~np.isfinite(vals))[0]
        if len(nf):
            problems.append(
                f"row {i}: non-finite value at feature "
                f"{int(idxs[nf[0]])}")
            continue
        oob = np.nonzero((idxs < 0) | (idxs >= data.n_features))[0]
        if len(oob):
            problems.append(
                f"row {i}: feature index {int(idxs[oob[0]])} outside "
                f"[0, {data.n_features})")
        else:
            problems.append(f"row {i}: invalid")
    return problems


def drop_rows(data: CSRData, mask: np.ndarray) -> CSRData:
    """``data`` without the masked rows (CSR re-packed; width kept)."""
    keep = ~np.asarray(mask, bool)
    counts = np.diff(np.asarray(data.indptr))
    nnz_keep = np.repeat(keep, counts)
    return CSRData(
        labels=np.asarray(data.labels)[keep],
        indptr=np.concatenate([[0], np.cumsum(counts[keep])]).astype(
            np.int64),
        indices=np.asarray(data.indices)[nnz_keep],
        values=np.asarray(data.values)[nnz_keep],
        n_features=data.n_features)


def validate_csr(data: CSRData, *, n_features: Optional[int] = None,
                 where: str = "data") -> None:
    """Raise :class:`DataValidationError` when any row is invalid."""
    mask = invalid_row_mask(data, n_features)
    if mask.any():
        raise DataValidationError(where, describe_invalid(data, mask))


def load_libsvm(path: str, n_features: Optional[int] = None,
                force_python: bool = False,
                validate: bool = False) -> CSRData:
    """Parse a LIBSVM file.  ``n_features`` overrides the inferred feature
    count (pass it when a test split lacks the train split's tail
    features).  ``validate=True`` additionally rejects non-finite
    features/labels and out-of-range indices with a typed
    :class:`DataValidationError` — LIBSVM text happily encodes ``nan``
    and the parser happily reads it, so an unvalidated bad file would
    otherwise train to garbage silently."""
    parsed = None if force_python else native.parse_libsvm_native(path)
    if parsed is None:
        parsed = _parse_python(path)
    labels, indptr, indices, values, inferred = parsed
    data = CSRData(labels, indptr, indices, values,
                   int(n_features or inferred))
    if validate:
        validate_csr(data, where=path)
    return data


def _parse_python(path: str):
    """Pure-Python fallback tokenizer (slow but dependency-free)."""
    labels, indptr, indices, values = [], [0], [], []
    max_idx = -1
    with io.open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            for tok in parts[1:]:
                idx_s, val_s = tok.split(":", 1)
                idx = int(idx_s) - 1
                if idx < 0:
                    raise ValueError(f"bad 1-based index in {tok!r}")
                max_idx = max(max_idx, idx)
                indices.append(idx)
                values.append(float(val_s))
            indptr.append(len(indices))
    return (np.asarray(labels, np.float64),
            np.asarray(indptr, np.int64),
            np.asarray(indices, np.int32),
            np.asarray(values, np.float32),
            max_idx + 1)


def save_libsvm(path: str, X, y) -> None:
    """Write dense (X, y) as LIBSVM text (test/bench fixture helper)."""
    X = np.asarray(X)
    y = np.asarray(y)
    with io.open(path, "w", encoding="utf-8") as f:
        for i in range(X.shape[0]):
            row = X[i]
            nz = np.nonzero(row)[0]
            toks = " ".join(f"{j + 1}:{row[j]:.9g}" for j in nz)
            f.write(f"{y[i]:.9g} {toks}\n")
