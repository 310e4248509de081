"""The port's LIBSVM reader (``data/libsvm.py``) and its native parser
(``native/``) against the JAX package's, on the CPU.

Both parsers of the port (C++ and Python) give exactly the arrays the JAX
reader gives on the same files; bad files raise the same errors; the
validation helpers agree; the parser source is a byte-for-byte copy; and
a parsed file goes through ``CSRMatrix.from_csr_arrays`` into a trainer
that matches the JAX trainer at f64 (weights within 3e-7,
``tests/test_agd_core.py:75-88``)."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_agd_tpu.data import libsvm as jlibsvm
from spark_agd_tpu.models import glm as jglm
from spark_agd_tpu.ops import sparse as jsparse
import spark_agd_tpu_torch as port
from spark_agd_tpu_torch import native
from spark_agd_tpu_torch.data import libsvm
from spark_agd_tpu_torch.models import glm as tglm
from spark_agd_tpu_torch.ops.sparse import CSRMatrix

ROOT = Path(__file__).resolve().parents[1]

SAMPLE = """\
# comment line
1 1:0.5 3:1.25
-1 2:2.0
+1 1:-1 4:3.5  # trailing comment

0 3:0.75
"""

PARSERS = pytest.mark.parametrize("force_python", [True, False],
                                  ids=["python", "native"])


def _write(tmp_path, text, name="f.libsvm"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _assert_same(a, b):
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.values, b.values)
    assert a.labels.dtype == b.labels.dtype
    assert a.indptr.dtype == b.indptr.dtype
    assert a.indices.dtype == b.indices.dtype
    assert a.values.dtype == b.values.dtype
    assert a.n_features == b.n_features


def test_parser_source_is_a_copy():
    ours = (ROOT / "spark_agd_tpu_torch/native/libsvm_parser.cpp").read_bytes()
    theirs = (ROOT / "spark_agd_tpu/native/libsvm_parser.cpp").read_bytes()
    assert ours == theirs


def test_native_parser_builds_here():
    """The C++ parser must build where the tests run; the Python
    tokenizer is for hosts without a toolchain."""
    assert native.load_parser() is not None
    assert native.pop_fallback_event("libsvm_parser.so") is None
    assert os.path.dirname(native.__file__) == str(
        ROOT / "spark_agd_tpu_torch" / "native")


@PARSERS
def test_parse_sample_matches_jax(tmp_path, force_python):
    path = _write(tmp_path, SAMPLE)
    d = libsvm.load_libsvm(path, force_python=force_python)
    _assert_same(d, jlibsvm.load_libsvm(path, force_python=force_python))
    assert d.n_rows == 4 and d.n_features == 4
    np.testing.assert_array_equal(d.indptr, [0, 2, 3, 5, 6])
    np.testing.assert_array_equal(d.binarized_labels(), [1, 0, 1, 0])
    np.testing.assert_array_equal(
        d.to_dense(), jlibsvm.load_libsvm(path).to_dense())


@PARSERS
def test_roundtrip_matches_jax(tmp_path, force_python):
    rng = np.random.default_rng(3)
    X = (rng.standard_normal((60, 25))
         * (rng.random((60, 25)) < 0.3)).astype(np.float32)
    y = (rng.random(60) > 0.5).astype(np.float64)
    path = str(tmp_path / "rt.libsvm")
    libsvm.save_libsvm(path, X, y)
    jpath = str(tmp_path / "rt_jax.libsvm")
    jlibsvm.save_libsvm(jpath, X, y)
    assert Path(path).read_bytes() == Path(jpath).read_bytes()
    d = libsvm.load_libsvm(path, n_features=25, force_python=force_python)
    _assert_same(d, jlibsvm.load_libsvm(path, n_features=25,
                                        force_python=not force_python))
    np.testing.assert_array_equal(d.to_dense(), X)


@PARSERS
@pytest.mark.parametrize("text", ["1 nonsense:x\n", "1 0:1.5\n",
                                  "1 -3:1.5\n", "x 1:1\n",
                                  "1 1:0.5 3:1.25\n-1 2:2.0 4"],
                         ids=["token", "zero-index", "negative-index",
                              "label", "truncated"])
def test_bad_files_raise_as_in_jax(tmp_path, force_python, text):
    path = _write(tmp_path, text)
    with pytest.raises(ValueError):
        libsvm.load_libsvm(path, force_python=force_python)
    with pytest.raises(ValueError):
        jlibsvm.load_libsvm(path, force_python=force_python)


@PARSERS
def test_empty_first_row_and_no_trailing_newline(tmp_path, force_python):
    """A row with a label and no features is a row of the CSR (an empty
    one), first or not; a complete last line needs no newline."""
    text = "1\n-1 2:2.0 4:0.75\n0\n1 1:0.5"
    path = _write(tmp_path, text)
    d = libsvm.load_libsvm(path, force_python=force_python)
    _assert_same(d, jlibsvm.load_libsvm(path, force_python=force_python))
    np.testing.assert_array_equal(d.indptr, [0, 0, 2, 2, 3])
    X = CSRMatrix.from_csr_arrays(d.indptr, d.indices, d.values,
                                  d.n_features, device="cpu")
    np.testing.assert_array_equal(
        X.matvec(torch.ones(4)).numpy(), [0.0, 2.75, 0.0, 0.5])


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        libsvm.load_libsvm(str(tmp_path / "absent.libsvm"))


def _bad_data():
    """Rows 1 (nan value), 3 (index past the width) and 4 (inf label)
    are invalid."""
    return libsvm.CSRData(
        labels=np.array([1.0, 0.0, 1.0, 0.0, np.inf]),
        indptr=np.array([0, 2, 3, 4, 6, 7], np.int64),
        indices=np.array([0, 2, 1, 3, 0, 9, 1], np.int32),
        values=np.array([1.0, 2.0, np.nan, 0.5, 1.0, 3.0, 1.0], np.float32),
        n_features=4)


def test_validation_helpers_match_jax():
    data = _bad_data()
    jdata = jlibsvm.CSRData(*data)
    mask = libsvm.invalid_row_mask(data)
    np.testing.assert_array_equal(mask, jlibsvm.invalid_row_mask(jdata))
    np.testing.assert_array_equal(mask, [False, True, False, True, True])
    assert libsvm.describe_invalid(data, mask) == \
        jlibsvm.describe_invalid(jdata, mask)
    kept = libsvm.drop_rows(data, mask)
    jkept = jlibsvm.drop_rows(jdata, mask)
    for a, b in zip(kept, jkept):
        np.testing.assert_array_equal(a, b)
    assert kept.n_rows == 2 and not libsvm.invalid_row_mask(kept).any()
    with pytest.raises(libsvm.DataValidationError, match="row 1") as err:
        libsvm.validate_csr(data, where="bad")
    assert isinstance(err.value, ValueError)
    assert len(err.value.problems) == 3 and err.value.where == "bad"
    libsvm.validate_csr(kept)


@PARSERS
def test_load_validate_rejects_bad_values(tmp_path, force_python):
    path = _write(tmp_path, "1 1:0.5\n0 2:nan\n1 3:1\n")
    d = libsvm.load_libsvm(path, force_python=force_python)
    assert d.n_rows == 3 and np.isnan(d.values[1])
    with pytest.raises(libsvm.DataValidationError, match="non-finite"):
        libsvm.load_libsvm(path, force_python=force_python, validate=True)
    with pytest.raises(libsvm.DataValidationError, match="outside"):
        libsvm.load_libsvm(_write(tmp_path, "1 1:0.5\n0 7:1\n", "w.libsvm"),
                           n_features=3, force_python=force_python,
                           validate=True)


def test_file_to_trainer_matches_jax_at_f64(tmp_path):
    """LIBSVM file -> CSRData -> CSRMatrix -> LogisticRegressionWithAGD,
    the path the reference's users take, against the JAX package."""
    rng = np.random.default_rng(12)
    n, d = 400, 60
    X = (rng.standard_normal((n, d))
         * (rng.random((n, d)) < 0.15)).astype(np.float32)
    w = rng.standard_normal(d)
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-X @ w)), 1.0, -1.0)
    path = str(tmp_path / "train.libsvm")
    libsvm.save_libsvm(path, X, y)
    data = libsvm.load_libsvm(path, n_features=d)
    values = data.values.astype(np.float64)
    tx = CSRMatrix.from_csr_arrays(data.indptr, data.indices, values,
                                   data.n_features, device="cpu")
    jx = jsparse.CSRMatrix.from_csr_arrays(data.indptr, data.indices,
                                           values, data.n_features)
    labels = data.binarized_labels()
    np.testing.assert_array_equal(labels, (y > 0).astype(np.float64))
    w0 = np.zeros(d + 1)
    t = tglm.LogisticRegressionWithAGD(reg_param=1e-3)
    t.optimizer.setNumIterations(20).set_device("cpu")
    j = jglm.LogisticRegressionWithAGD(reg_param=1e-3, mesh=False)
    j.optimizer.setNumIterations(20)
    tm = t.train(tx, labels, initial_weights=w0)
    jm = j.train(jx, labels, initial_weights=w0)
    np.testing.assert_allclose(tm.weights.numpy(), np.asarray(jm.weights),
                               rtol=3e-7, atol=1e-12)
    assert tm.intercept == pytest.approx(float(jm.intercept), rel=3e-7)
    acc = float((tm.predict(tx).numpy() == labels).mean())
    assert acc > 0.75


def test_package_exports():
    assert port.load_libsvm is libsvm.load_libsvm
    assert port.CSRData is libsvm.CSRData
    assert port.CSRMatrix is CSRMatrix
