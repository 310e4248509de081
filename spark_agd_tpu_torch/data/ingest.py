"""Partitioned-file ingest: the single-host helpers.

Counterpart of the single-host part of ``spark_agd_tpu/data/ingest.py``
(``DEFAULT_READ_RETRIES``, ``_retrying_loader``, ``_validated_parts``,
``:56-114``), which ``data.streaming.StreamingDataset.from_libsvm_parts``
shares: a partition read runs under the shared retry engine
(``resilience.retry``), and freshly read partitions go through the
``validate=`` policy.  The assemblers ``from_partitioned_files`` and
``from_partitioned_files_csr`` return a mesh-sharded batch and come with
the mesh slice.
"""

from __future__ import annotations

import logging
from typing import Callable

from ..resilience import retry as retry_lib
from . import libsvm

logger = logging.getLogger("spark_agd_tpu")

# transient IO mid-ingest costs a short backoff, not the whole job;
# bounded so a genuinely dead source still fails fast
DEFAULT_READ_RETRIES = retry_lib.RetryPolicy(
    max_attempts=3, backoff_base=0.05, backoff_max=2.0, jitter=0.1)


def _retrying_loader(loader: Callable, retries, telemetry) -> Callable:
    """``loader`` under the shared retrying helper (``resilience.
    retry``): transient IO errors back off and re-read; each retry is
    logged and, when a ``telemetry`` is attached, emitted as a
    ``recovery`` record."""
    policy = retries if retries is not None else DEFAULT_READ_RETRIES

    def on_retry(n_failures, exc, delay):
        logger.warning(
            "ingest read failed (%s: %s); retry %d/%d in %.2fs",
            type(exc).__name__, exc, n_failures,
            policy.max_attempts - 1, delay)

    return retry_lib.retrying(policy, label="ingest_read",
                              telemetry=telemetry,
                              on_retry=on_retry)(loader)


def _validated_parts(paths_used, parts, d, validate, telemetry):
    """Apply the ``validate=`` policy to freshly read partitions:
    ``False`` = trust the writer, ``"raise"`` = typed
    :class:`~spark_agd_tpu_torch.data.libsvm.DataValidationError` on the
    first bad partition (FATAL to the retry engine: re-reading garbage
    yields garbage), ``"drop"`` = discard invalid rows, log, and count
    them on the ``data.invalid_records`` telemetry counter."""
    if not validate:
        return parts
    if validate not in ("raise", "drop"):
        raise ValueError(
            f"validate must be False, 'raise', or 'drop'; "
            f"got {validate!r}")
    out = []
    for path, part in zip(paths_used, parts):
        mask = libsvm.invalid_row_mask(part, d)
        n_bad = int(mask.sum())
        if not n_bad:
            out.append(part)
            continue
        if validate == "raise":
            raise libsvm.DataValidationError(
                path, libsvm.describe_invalid(part, mask))
        logger.warning(
            "%s: dropping %d invalid row(s) (non-finite features/"
            "labels or out-of-range indices)", path, n_bad)
        if telemetry is not None:
            telemetry.registry.counter("data.invalid_records").inc(n_bad)
        out.append(libsvm.drop_rows(part, mask))
    return out
