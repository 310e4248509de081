"""Replica fleet plumbing: the process-level serving replica and the
client handle the router talks through.

A copy of ``spark_agd_tpu/serve/fleet.py``, which needs only
the standard library, numpy and the port's own ``obs/trace``,
``resilience`` and ``serve/queue`` (the replica serves through the
port's ``ServeEngine`` on its device; the engine copies each batch's
answers to the host before they are written to the wire);
``tests/test_torch_router.py`` holds everything after this docstring
to the original, line for line.

One replica = one real OS process running :class:`ReplicaServer`:

- a ``ServeEngine`` + ``MicroBatchQueue`` (constructed with
  ``replica=`` so every ``serve_request`` record is attributed),
- a ``HeartbeatWriter`` beating ``phase="serve"`` into the shared
  fleet directory — the SAME heartbeat machinery the training drills
  use, so ``HostMonitor.verdicts()`` works unchanged over replicas,
- a ``ModelRegistry`` poller so a ``publish()``/``repoint()`` from the
  continuous-learning pipeline fans out fleet-wide: every replica's
  next poll sees the new HEAD and hot-swaps (weights are program
  arguments — zero dropped requests),
- a localhost TCP JSON-line endpoint (one line in, one line out),
  announced through an atomically-written ``replica.hNNN.json``
  membership file next to the heartbeats.

Membership is file-based on purpose: joins/leaves are a file
appearing/vanishing, discovery (:func:`discover_replicas`) is a
directory listing, and the gloo process group is only needed ONCE —
at fleet start, to barrier replicas before clients arrive (the drill
does that with ``parallel.multihost``); the request path never runs a
collective.

Transport protocol (versioned by field presence, all JSON):

    -> {"op": "predict", "rows": [[...]], "tenant": "acme",
        "trace": {...SpanContext.to_wire()...}}
    <- {"status": "ok", "values": [...], "generation": 5,
        "replica": 2, "latency_ms": 1.8}
    <- {"status": "rejected", "error": "ServeOverloaded",
        "queued_rows": 64, "limit_rows": 64}
    <- {"status": "error", "error": "ValueError: ..."}

The trace context rides the wire so a request span in the replica
parents under the CLIENT's span — the whole fleet story reconstructs
as one tree.  Chaos hooks: a ``ChaosSchedule`` bound via ``chaos=``
fires ``before_request`` per admitted request (``slow_replica`` sleeps
inline while the bound heartbeat beats ``phase="slow"``;
``kill_replica`` SIGKILLs the process mid-soak — the drill's
zero-dropped-requests proof).
"""

from __future__ import annotations

import json
import os
import re
import socket
import threading
import time
from typing import Dict, Optional

import numpy as np

from ..obs import trace as trace_lib
from ..resilience import manifest as manifest_lib
from ..resilience.distributed import HeartbeatWriter
from ..resilience.errors import ServeOverloaded
from .queue import MicroBatchQueue

_REPLICA_RE = re.compile(r"^replica\.h(\d{3})\.json$")
DEFAULT_BEAT_EVERY_S = 0.25
DEFAULT_POLL_EVERY_S = 0.25
_RECV_CHUNK = 65536


def replica_file_name(replica: int) -> str:
    return f"replica.h{int(replica):03d}.json"


# -- client side ------------------------------------------------------------
class ReplicaHandle:
    """The router's backend for one replica: connection-per-request
    over localhost TCP (simple, and a dead replica fails fast as
    ``ConnectionError`` instead of poisoning a pooled socket).  Typed
    surfaces: ``ServeOverloaded`` for a replica-side shed,
    ``ConnectionError``/``TimeoutError`` for death/stall — exactly
    what ``FleetRouter`` retries, hedges, and evicts on."""

    def __init__(self, replica: int, port: int, *,
                 host: str = "127.0.0.1", pid: Optional[int] = None):
        self.replica = int(replica)
        self.port = int(port)
        self.host = host
        self.pid = pid

    def __repr__(self) -> str:
        return (f"ReplicaHandle(replica={self.replica}, "
                f"port={self.port})")

    def predict(self, rows, op: str = "predict",
                tenant: Optional[str] = None,
                timeout: float = 30.0) -> dict:
        payload: dict = {"op": op,
                         "rows": np.asarray(rows, dtype=np.float32)
                         .tolist()}
        if tenant is not None:
            payload["tenant"] = str(tenant)
        ctx = trace_lib.current_context()
        if ctx is not None:
            payload["trace"] = ctx.to_wire()
        line = (json.dumps(payload) + "\n").encode()
        with socket.create_connection((self.host, self.port),
                                      timeout=timeout) as sock:
            sock.settimeout(timeout)
            sock.sendall(line)
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = sock.recv(_RECV_CHUNK)
                if not chunk:
                    raise ConnectionError(
                        f"replica {self.replica} closed the "
                        "connection mid-request")
                buf += chunk
        resp = json.loads(buf.decode())
        status = resp.get("status")
        if status == "ok":
            return resp
        if status == "rejected":
            raise ServeOverloaded(
                int(resp.get("queued_rows", 0)),
                int(resp.get("limit_rows", 0)),
                detail=f"replica {self.replica} shed: "
                       f"{resp.get('error', 'overloaded')}")
        raise RuntimeError(
            f"replica {self.replica} error: "
            f"{resp.get('error', 'unknown')}")


def discover_replicas(fleet_dir: str) -> Dict[int, ReplicaHandle]:
    """Parse every ``replica.hNNN.json`` membership file into a
    handle map — the router's ``refresh_membership`` input.  Torn or
    garbled files (a join mid-write) are skipped, not fatal; the next
    discovery sees them whole."""
    out: Dict[int, ReplicaHandle] = {}
    if not os.path.isdir(fleet_dir):
        return out
    for name in sorted(os.listdir(fleet_dir)):
        m = _REPLICA_RE.match(name)
        if not m:
            continue
        try:
            with open(os.path.join(fleet_dir, name)) as f:
                rec = json.load(f)
            out[int(m.group(1))] = ReplicaHandle(
                int(m.group(1)), int(rec["port"]),
                pid=rec.get("pid"))
        except (ValueError, KeyError, OSError):
            continue
    return out


# -- server side ------------------------------------------------------------
class ReplicaServer:
    """See module docstring.  ``start()`` binds the socket, announces
    membership, and spawns the accept/heartbeat/registry-poll threads;
    ``stop()`` leaves cleanly (membership + heartbeat files removed —
    a *leave*, distinct from a crash the monitor flags LOST).  Context
    manager form does both."""

    def __init__(self, fleet_dir: str, replica: int, engine, *,
                 registry=None, telemetry=None, chaos=None,
                 process_count: Optional[int] = None,
                 max_wait_us: int = 2000,
                 max_queue_rows: Optional[int] = None,
                 beat_every_s: float = DEFAULT_BEAT_EVERY_S,
                 poll_every_s: float = DEFAULT_POLL_EVERY_S):
        self.fleet_dir = fleet_dir
        self.replica = int(replica)
        self.engine = engine
        self.registry = registry
        self.telemetry = telemetry
        self.chaos = chaos
        self.beat_every_s = float(beat_every_s)
        self.poll_every_s = float(poll_every_s)
        self.queue = MicroBatchQueue(
            engine, telemetry=telemetry, replica=self.replica,
            max_wait_us=max_wait_us, max_queue_rows=max_queue_rows)
        self.heartbeat = HeartbeatWriter(
            fleet_dir, process_index=self.replica,
            # membership is elastic: without an explicit count, claim
            # just enough room for our own index (a late joiner must
            # not be rejected by a single-process inference)
            process_count=(process_count if process_count is not None
                           else self.replica + 1),
            telemetry=telemetry)
        if chaos is not None:
            # chaos slow-sleeps beat phase="slow" through the injected
            # stall -> HostMonitor verdicts the replica SLOW, and the
            # router measurably shifts traffic (the gate_fleet proof)
            chaos.bind_heartbeat(self.heartbeat)
        self.port: Optional[int] = None
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._threads: list = []
        self._requests_seen = 0
        self._req_lock = threading.Lock()

    @property
    def membership_path(self) -> str:
        return os.path.join(self.fleet_dir,
                            replica_file_name(self.replica))

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ReplicaServer":
        os.makedirs(self.fleet_dir, exist_ok=True)
        self._sock = socket.create_server(("127.0.0.1", 0))
        self._sock.settimeout(0.2)
        self.port = self._sock.getsockname()[1]
        self.queue.start()
        # beat BEFORE announcing: a discovered replica always has a
        # heartbeat on disk, so it can never be born "lost"
        self.heartbeat.beat(phase="serve")
        manifest_lib._atomic_write_text(
            self.membership_path,
            json.dumps({"replica": self.replica, "port": self.port,
                        "pid": os.getpid(),
                        "time": round(time.time(), 3)}))
        for name, fn in (("accept", self._accept_loop),
                         ("beat", self._beat_loop),
                         ("poll", self._poll_loop)):
            t = threading.Thread(
                target=fn, name=f"replica{self.replica}-{name}",
                daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def request_stop(self) -> None:
        """Async-signal-safe stop flag (a SIGTERM handler calls this;
        the owning thread then runs :meth:`stop` for the real
        teardown — joining threads from a handler would deadlock)."""
        self._stop.set()

    @property
    def requests_seen(self) -> int:
        """Requests accepted off the wire so far (chaos boundary
        counter — the drill's summaries report it)."""
        with self._req_lock:
            return self._requests_seen

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        self.queue.stop()
        # a clean LEAVE removes both announcements; a crash leaves
        # them and the monitor says "lost" — that asymmetry is the
        # whole verdict story
        for path in (self.membership_path, self.heartbeat.path):
            try:
                os.remove(path)
            except OSError:
                pass

    def __enter__(self) -> "ReplicaServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block the caller (a drill child's main thread) until
        ``stop()`` — or forever, which for a kill_replica leg means
        until SIGKILL."""
        self._stop.wait(timeout)

    # -- background loops --------------------------------------------------
    def _beat_loop(self) -> None:
        while not self._stop.wait(self.beat_every_s):
            self.heartbeat.beat(phase="serve")

    def _poll_loop(self) -> None:
        if self.registry is None:
            return
        while not self._stop.wait(self.poll_every_s):
            try:
                self.registry.refresh(self.engine)
            except Exception:  # noqa: BLE001 — a torn publish mid-
                # write must not kill the replica; next poll retries
                # (the registry's own fallback walk records the skip)
                continue

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()

    # -- the request path --------------------------------------------------
    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            conn.settimeout(60.0)
            buf = b""
            while not self._stop.is_set():
                while b"\n" not in buf:
                    try:
                        chunk = conn.recv(_RECV_CHUNK)
                    except (socket.timeout, OSError):
                        return
                    if not chunk:
                        return
                    buf += chunk
                line, buf = buf.split(b"\n", 1)
                try:
                    reply = self._handle(json.loads(line.decode()))
                except Exception as e:  # noqa: BLE001 — typed reply,
                    # the connection must outlive one bad request
                    reply = {"status": "error",
                             "error": f"{type(e).__name__}: {e}"}
                try:
                    conn.sendall((json.dumps(reply) + "\n").encode())
                except OSError:
                    return

    def _handle(self, req: dict) -> dict:
        with self._req_lock:
            self._requests_seen += 1
            index = self._requests_seen
        if self.chaos is not None:
            # slow_replica sleeps here (heartbeat says "slow");
            # kill_replica SIGKILLs — the client sees a reset and the
            # router retries on a survivor
            self.chaos.before_request(index)
        ctx = None
        if isinstance(req.get("trace"), dict):
            try:
                ctx = trace_lib.SpanContext.from_wire(req["trace"])
            except (KeyError, ValueError, TypeError):
                ctx = None  # garbled caller trace: serve untraced
        rows = np.asarray(req["rows"], dtype=np.float32)
        op = str(req.get("op", "predict"))
        tenant = req.get("tenant")
        try:
            with trace_lib.activate(ctx):
                fut = self.queue.submit(rows, op, tenant=tenant)
            res = fut.result(timeout=30.0)
        except ServeOverloaded as e:
            return {"status": "rejected", "error": "ServeOverloaded",
                    "queued_rows": e.queued_rows,
                    "limit_rows": e.limit_rows}
        return {"status": "ok",
                "values": np.asarray(res.value).tolist(),
                "generation": int(res.generation),
                "replica": self.replica,
                "latency_ms": round(float(res.latency_ms), 3)}
