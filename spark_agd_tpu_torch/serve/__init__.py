"""serve/ — batched low-latency inference for the trained models.

Counterpart of ``spark_agd_tpu/serve/``, one process on one device:

- :class:`~spark_agd_tpu_torch.serve.engine.ServeEngine` builds one
  program per (op, bucket) pair of a small ladder of padded batch
  shapes, each with its own input and output buffers on the device, and
  runs each once at construction, so every request size maps to a
  program that exists;
- :class:`~spark_agd_tpu_torch.serve.registry.ModelRegistry` publishes
  and loads model generations through ``resilience.manifest``'s
  CRC-verified manifests, refusing torn or corrupt generations, and
  hot-swaps weights without dropping in-flight requests;
- :class:`~spark_agd_tpu_torch.serve.queue.MicroBatchQueue` sits in
  front: dynamic micro-batching (max-batch + max-wait admission), padding
  to the nearest bucket, per-request slicing, and backpressure with a
  typed ``ServeOverloaded`` rejection classified TRANSIENT;
- :class:`~spark_agd_tpu_torch.serve.fleet.ReplicaServer` runs one
  replica process (engine, queue, heartbeat, registry poller, a
  localhost JSON-line endpoint announced by a membership file), and
  :class:`~spark_agd_tpu_torch.serve.router.FleetRouter` spreads
  requests over the replicas' handles by latency, fails over on the
  heartbeat verdicts, hedges the tail and sheds flooding tenants.  Both
  are copies of the JAX package's, so either package's handle talks to
  the other's server.

``telemetry=`` emits the JAX package's records (``obs.Telemetry``).
"""

from ..resilience.errors import ServeOverloaded  # noqa: F401
from .engine import (BucketLadder, ModelSpec, ServeEngine,  # noqa: F401
                     params_of, spec_of)
from .fleet import (ReplicaHandle, ReplicaServer,  # noqa: F401
                    discover_replicas)
from .queue import MicroBatchQueue, ServeResult  # noqa: F401
from .registry import LoadedModel, ModelRegistry  # noqa: F401
from .router import (FleetRouter, NoReplicasLeft,  # noqa: F401
                     ReplicaLatencyTracker, RouteResult)

__all__ = [
    "BucketLadder", "FleetRouter", "LoadedModel", "MicroBatchQueue",
    "ModelRegistry", "ModelSpec", "NoReplicasLeft", "ReplicaHandle",
    "ReplicaLatencyTracker", "ReplicaServer", "RouteResult",
    "ServeEngine", "ServeOverloaded", "ServeResult",
    "discover_replicas", "params_of", "spec_of",
]
