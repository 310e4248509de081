"""Native (C++) host-runtime components, loaded over ctypes: the LIBSVM
parser and the shard balancer.

Counterpart of ``spark_agd_tpu/native/__init__.py``.  Bulk text ingest
(``libsvm_parser.cpp``) and the greedy nnz balancer behind the
row-sharded CSR layout (``shard_balance.cpp``) run on the host in C++,
byte-for-byte copies of the JAX package's sources, compiled on first use
with the in-tree ``Makefile`` into this directory.  Without a toolchain
the callers fall back to their pure-Python paths, which give the same
arrays (the parser: the tokenizer of ``data/libsvm.py``; the balancer:
the heap loop in :func:`greedy_balance`); ``pop_fallback_event``
reports, once, why that happened.  This is host work, not a device path.
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


def _configure_balancer(lib):
    lib.greedy_balance.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.greedy_balance.restype = ctypes.c_int


def load_balancer() -> Optional[ctypes.CDLL]:
    """Return the native shard balancer, building it if needed; None if
    unavailable (``greedy_balance`` then runs its Python loop)."""
    return _load_lib("shard_balance.so", _configure_balancer)


def greedy_balance(counts, n_shards: int, capacity: int):
    """Greedy heaviest-first balanced shard assignment.

    Each item goes onto the currently lightest shard with remaining
    capacity (load ties -> lowest shard id), local slots in placement
    order.  Returns ``(shard_of, local_of)`` int64 arrays.  Raises
    ValueError when ``n_shards * capacity`` cannot hold the items, before
    dispatch, so the error is the same with or without the toolchain.
    C++ core (``shard_balance.cpp``); the Python loop below is the
    bit-identical specification it is tested against."""
    import numpy as np

    counts = np.ascontiguousarray(counts, np.int64)
    n = len(counts)
    if n_shards * capacity < n:
        raise ValueError(
            f"{n} items exceed {n_shards} shards x capacity {capacity}")
    lib = load_balancer()
    if lib is not None:
        shard_of = np.empty(n, np.int32)
        local_of = np.empty(n, np.int32)
        rc = lib.greedy_balance(
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(n), ctypes.c_int32(int(n_shards)),
            ctypes.c_int64(int(capacity)),
            shard_of.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            local_of.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise ValueError(f"greedy_balance failed (code {rc})")
        return shard_of.astype(np.int64), local_of.astype(np.int64)
    return greedy_balance_python(counts, n_shards, capacity)


def greedy_balance_python(counts, n_shards: int, capacity: int):
    """The Python loop of :func:`greedy_balance` (its fallback and its
    specification)."""
    import heapq

    import numpy as np

    counts = np.ascontiguousarray(counts, np.int64)
    n = len(counts)
    order = np.argsort(-counts, kind="stable")
    shard_of = np.empty(n, np.int64)
    local_of = np.empty(n, np.int64)
    heap = [(0, s) for s in range(n_shards)]
    cap = [capacity] * n_shards
    next_local = [0] * n_shards
    nnz_list = counts[order].tolist()
    for rank, r in enumerate(order.tolist()):
        while True:
            load, s = heapq.heappop(heap)
            if cap[s]:
                break
        shard_of[r] = s
        local_of[r] = next_local[s]
        next_local[s] += 1
        cap[s] -= 1
        heapq.heappush(heap, (load + nnz_list[rank], s))
    return shard_of, local_of


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
