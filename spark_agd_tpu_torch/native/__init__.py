"""Native (C++) host-runtime component, loaded over ctypes: the LIBSVM
parser.

Counterpart of ``spark_agd_tpu/native/__init__.py:34-113,185-220`` (the
parser half; the shard balancer comes with the multi-GPU slice).  Bulk
text ingest runs on the host in C++ (``libsvm_parser.cpp``, a byte-for-
byte copy of the JAX package's), compiled on first use with the in-tree
``Makefile`` into this directory.  Without a toolchain the caller falls
back to the pure-Python tokenizer of ``data/libsvm.py``, which gives the
same arrays; ``pop_fallback_event`` reports, once, why that happened.
This is host ingest, not a device path: the parsed arrays are the same
either way.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
# so_name -> CDLL | None (None = failed, latched so a missing toolchain is
# probed once per process)
_LIBS: dict = {}
# so_name -> the reason a library load fell back to the Python path,
# recorded once and consumed (once) by pop_fallback_event
_FALLBACK: dict = {}


def pop_fallback_event(so_name: str) -> Optional[str]:
    """One-shot fallback report: the reason the named library is
    unavailable, returned exactly once per process (None afterwards, and
    None when the library loaded fine)."""
    with _LOCK:
        return _FALLBACK.pop(so_name, None)


class _ParseResult(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("max_index", ctypes.c_int32),
        ("labels", ctypes.POINTER(ctypes.c_double)),
        ("indptr", ctypes.POINTER(ctypes.c_int64)),
        ("indices", ctypes.POINTER(ctypes.c_int32)),
        ("values", ctypes.POINTER(ctypes.c_float)),
    ]


def _build(target: str) -> bool:
    try:
        subprocess.run(
            ["make", "-s", target], cwd=_DIR, check=True,
            capture_output=True, timeout=120)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load_lib(so_name: str, configure) -> Optional[ctypes.CDLL]:
    """Build (or accept a pre-built binary when the toolchain is gone),
    dlopen, run ``configure(lib)`` to set the prototypes.  Failure,
    including a stale binary missing a symbol (AttributeError from
    configure), is latched and returns None so callers fall back to
    their Python paths."""
    with _LOCK:
        if so_name in _LIBS:
            return _LIBS[so_name]
        so = os.path.join(_DIR, so_name)
        # Always invoke make: its .cpp dependency makes this a no-op when
        # the binary is fresh, and it rebuilds stale binaries after source
        # edits.  A pre-existing .so still serves if the toolchain is gone.
        if not _build(so_name) and not os.path.exists(so):
            _LIBS[so_name] = None
            _FALLBACK[so_name] = (
                f"{so_name}: build failed and no pre-built binary; "
                f"using the Python fallback")
            return None
        try:
            lib = ctypes.CDLL(so)
            configure(lib)
        except OSError as e:
            lib = None
            _FALLBACK[so_name] = (
                f"{so_name}: dlopen failed ({e}); using the Python "
                f"fallback")
        except AttributeError as e:
            lib = None
            _FALLBACK[so_name] = (
                f"{so_name}: ABI mismatch — stale binary missing a "
                f"symbol ({e}); rebuild with `make -C "
                f"spark_agd_tpu_torch/native`; using the Python fallback")
        _LIBS[so_name] = lib
        return lib


def _configure_parser(lib):
    lib.parse_libsvm.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(_ParseResult)]
    lib.parse_libsvm.restype = ctypes.c_int
    lib.free_parse_result.argtypes = [ctypes.POINTER(_ParseResult)]
    lib.free_parse_result.restype = None


def load_parser() -> Optional[ctypes.CDLL]:
    """Return the native parser library, building it if needed; None if the
    native path is unavailable (callers must fall back)."""
    return _load_lib("libsvm_parser.so", _configure_parser)


def parse_libsvm_native(path: str):
    """Parse with the C++ core.  Returns ``(labels, indptr, indices,
    values, n_features)`` as NumPy arrays (copies: the C buffers are freed
    before returning), or None when the native library is unavailable.
    Raises ValueError on malformed input."""
    import numpy as np

    lib = load_parser()
    if lib is None:
        return None
    res = _ParseResult()
    rc = lib.parse_libsvm(os.fsencode(path), ctypes.byref(res))
    if rc == -1:  # fopen failed
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        raise OSError(f"cannot open {path!r}")
    if rc == -5:
        raise MemoryError(f"native LIBSVM parser out of memory on {path!r}")
    if rc == -6:
        raise OSError(f"I/O error reading {path!r}")
    if rc < 0:
        raise ValueError(
            f"malformed LIBSVM file {path!r} (native parser code {rc})")
    try:
        n, nnz = res.n_rows, res.nnz
        n_features = int(res.max_index) + 1  # read before the free clears it
        labels = np.ctypeslib.as_array(res.labels, (n,)).copy() if n else \
            np.zeros(0)
        indptr = np.ctypeslib.as_array(res.indptr, (n + 1,)).copy()
        indices = (np.ctypeslib.as_array(res.indices, (nnz,)).copy()
                   if nnz else np.zeros(0, np.int32))
        values = (np.ctypeslib.as_array(res.values, (nnz,)).copy()
                  if nnz else np.zeros(0, np.float32))
    finally:
        lib.free_parse_result(ctypes.byref(res))
    return labels, indptr, indices, values, n_features
