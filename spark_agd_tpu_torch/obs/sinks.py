"""Pluggable event sinks: where telemetry records go.

A copy of ``spark_agd_tpu/obs/sinks.py``, which needs only
the standard library;
``tests/test_torch_obs.py`` holds everything after this docstring
to the original, line for line.

Every sink consumes plain-dict records (the ``obs.schema`` shapes) via
``emit(record)`` and supports ``flush()`` / ``close()``.  Sinks must be
cheap and never throw into the hot path — a telemetry failure must not
kill the run it observes (the same isolation rule the bench applies to
its ride-alongs).

Built-ins: in-memory (tests, programmatic access), JSONL file (the
canonical machine-readable channel — one ``obs.schema`` record per
line), CSV (spreadsheet-friendly iteration streams), stdlib logging
(human-readable lines on the ``spark_agd_tpu`` logger), and TensorBoard
behind an import guard (the container does not bake TF in; constructing
the sink without it raises a clear error, importing this module never
does).
"""

from __future__ import annotations

import csv
import io
import json
import logging
from typing import Dict, List, Optional

logger = logging.getLogger("spark_agd_tpu")


class Sink:
    """Base class; subclasses override ``emit`` (required) and
    ``flush``/``close`` (optional)."""

    def emit(self, record: dict) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()


class InMemorySink(Sink):
    """Collects records in ``self.records`` — the programmatic channel
    (tests, notebooks, the ``Telemetry`` convenience accessors)."""

    def __init__(self):
        self.records: List[dict] = []

    def emit(self, record: dict) -> None:
        self.records.append(record)


class JSONLSink(Sink):
    """One JSON object per line — the canonical run-record channel
    (``obs.schema``).  ``append=True`` (default) composes with the
    artifact convention of ``benchmarks/run.py --out``."""

    def __init__(self, path: str, append: bool = True):
        self.path = path
        self._f = open(path, "a" if append else "w")

    def emit(self, record: dict) -> None:
        self._f.write(json.dumps(record, default=_jsonable) + "\n")

    def flush(self) -> None:
        if not self._f.closed:
            self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class CSVSink(Sink):
    """CSV with the header taken from the FIRST accepted record's keys;
    later records are projected onto those columns (missing -> empty,
    extra keys dropped) so the stream stays a loadable table.

    ``kinds`` filters by record ``kind`` — a full telemetry stream
    interleaves span/run records with the iteration stream, so the
    default keeps iteration rows only (the spreadsheet-shaped part);
    pass ``kinds=None`` to accept everything.
    """

    def __init__(self, path: str, kinds=("iteration",)):
        self.path = path
        self.kinds = None if kinds is None else frozenset(kinds)
        self._f = open(path, "w", newline="")
        self._writer: Optional[csv.DictWriter] = None

    def emit(self, record: dict) -> None:
        if self.kinds is not None and record.get("kind") not in self.kinds:
            return
        if self._writer is None:
            self._writer = csv.DictWriter(
                self._f, fieldnames=list(record.keys()),
                extrasaction="ignore")
            self._writer.writeheader()
        self._writer.writerow({k: record.get(k, "")
                               for k in self._writer.fieldnames})

    def flush(self) -> None:
        if not self._f.closed:
            self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class LoggingSink(Sink):
    """Human-readable key=value lines on a stdlib logger — the channel
    ``utils.logging`` already established for post-hoc records."""

    def __init__(self, log: Optional[logging.Logger] = None,
                 level: int = logging.INFO):
        self._log = log or logger
        self._level = level

    def emit(self, record: dict) -> None:
        kind = record.get("kind", "event")
        body = " ".join(f"{k}={_fmt(v)}" for k, v in record.items()
                        if k not in ("kind", "schema_version"))
        self._log.log(self._level, "[%s] %s", kind, body)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _jsonable(v):
    """Fallback serializer: numpy scalars/arrays from debug callbacks."""
    try:
        import numpy as np

        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, np.ndarray):
            return v.tolist()
    except ImportError:  # pragma: no cover
        pass
    return str(v)


class TensorBoardSink(Sink):  # pragma: no cover - optional dependency
    """Scalar events into a TensorBoard logdir.  Optional: constructing
    this without a TensorBoard writer implementation installed raises
    ImportError with the remedy; merely importing ``obs.sinks`` never
    requires TF."""

    def __init__(self, logdir: str):
        writer = None
        for mod, attr in (("torch.utils.tensorboard", "SummaryWriter"),
                          ("tensorboardX", "SummaryWriter")):
            try:
                writer = getattr(__import__(mod, fromlist=[attr]), attr)
                break
            except ImportError:
                continue
        if writer is None:
            raise ImportError(
                "TensorBoardSink needs torch.utils.tensorboard or "
                "tensorboardX; neither is installed (this dependency is "
                "deliberately optional)")
        self._w = writer(logdir)

    def emit(self, record: dict) -> None:
        step = int(record.get("iter", 0))
        tag_prefix = record.get("algorithm") or record.get("kind", "run")
        for k, v in record.items():
            if isinstance(v, (int, float)) and k not in ("iter",
                                                         "schema_version",
                                                         "timestamp_unix"):
                self._w.add_scalar(f"{tag_prefix}/{k}", v, step)

    def flush(self) -> None:
        self._w.flush()

    def close(self) -> None:
        self._w.close()


class _StringIOSink(Sink):
    """JSONL into a StringIO — used by the selfcheck round-trip."""

    def __init__(self):
        self.buf = io.StringIO()

    def emit(self, record: dict) -> None:
        self.buf.write(json.dumps(record, default=_jsonable) + "\n")
