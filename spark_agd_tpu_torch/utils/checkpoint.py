"""Atomic npz writes with per-entry CRC32s.

A copy of ``atomic_savez`` from ``spark_agd_tpu/utils/checkpoint.py``
(numpy only), so that a model saved by either package carries the same
``__crc32__`` entry and loads in the other.  The checkpoint format and its
loaders arrive with the resilience slice.
"""

from __future__ import annotations

import json
import os
import tempfile
import zlib

import numpy as np

# the npz entry holding the per-entry CRC32 map (JSON: name -> crc)
CRC_ENTRY = "__crc32__"


def _entry_crc32(value: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(value).tobytes())


def atomic_savez(path: str, payload: dict):
    """Write an npz atomically (tempfile in the target dir + rename), so
    a kill mid-write can never leave a torn file.  Creates the directory
    if needed.

    Every write carries a ``__crc32__`` entry mapping each payload entry
    to the CRC32 of its bytes."""
    payload = dict(payload)
    payload[CRC_ENTRY] = np.asarray(json.dumps(
        {k: _entry_crc32(np.asarray(v)) for k, v in payload.items()}))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
