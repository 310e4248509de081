"""Event bus: fan records out to sinks, multihost-aware.

A copy of ``spark_agd_tpu/obs/events.py``, which needs only
the standard library and the port's ``parallel.multihost`` (imported at
the first emit, for the primary-host gate);
``tests/test_torch_obs.py`` holds everything after this docstring
to the original, line for line.

One ``EventBus`` owns an ordered list of sinks (``obs.sinks``) and a
host-gating mode.  On a multi-host SPMD job every process executes the
same code, so an ungated bus would write N copies of every replicated
record.  Modes:

- ``"all"`` (default): every host emits.  On a single host this is the
  no-op gate; on multihost pair it with per-host-suffixed sink paths
  (``parallel.multihost.host_suffixed``) so hosts never write the same
  file.
- ``"primary"``: only process 0 emits (rank-0-only logging, the common
  production choice for replicated scalars).

The gate resolves lazily on first emit (the process group's rank, read
through ``parallel.multihost``, need not exist at construction) and is a
no-op on a single host by construction.  Sink failures are counted and
logged once, never raised — telemetry must not kill the run it
observes.
"""

from __future__ import annotations

import logging
import threading
from typing import Iterable, List

from .sinks import Sink

logger = logging.getLogger("spark_agd_tpu")


class EventBus:
    def __init__(self, sinks: Iterable[Sink] = (),
                 host_mode: str = "all"):
        if host_mode not in ("all", "primary"):
            raise ValueError(
                f"host_mode must be 'all' or 'primary', got {host_mode!r}")
        self.sinks: List[Sink] = list(sinks)
        self.host_mode = host_mode
        self._emit_here = None  # lazily resolved host gate
        self.sink_errors = 0
        self._warned = False
        # the serving plane emits from many threads at once (client
        # spans, router decisions, queue latencies); a raw file write
        # interleaves under that load, so one bus-level lock keeps
        # every sink's record boundaries intact
        self._lock = threading.Lock()

    def _host_ok(self) -> bool:
        if self.host_mode == "all":
            return True
        if self._emit_here is None:
            try:
                from ..parallel import multihost

                self._emit_here = multihost.is_primary_host()
            except Exception:  # noqa: BLE001 — no backend yet / no jax:
                # gating open is the single-host-correct default
                self._emit_here = True
        return self._emit_here

    def emit(self, record: dict) -> None:
        if not self._host_ok():
            return
        with self._lock:
            for sink in self.sinks:
                try:
                    sink.emit(record)
                except Exception as e:  # noqa: BLE001 — observability
                    # must never kill the observed run
                    self.sink_errors += 1
                    if not self._warned:
                        self._warned = True
                        logger.warning(
                            "telemetry sink %s failed (%s: %s); "
                            "further sink errors are counted "
                            "silently (bus.sink_errors)",
                            type(sink).__name__, type(e).__name__, e)

    def flush(self) -> None:
        for sink in self.sinks:
            try:
                sink.flush()
            except Exception:  # noqa: BLE001
                self.sink_errors += 1

    def close(self) -> None:
        for sink in self.sinks:
            try:
                sink.close()
            except Exception:  # noqa: BLE001
                self.sink_errors += 1
