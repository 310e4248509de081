"""The options of the JAX API that the port does not carry yet.

An entry point that meets one of them raises ``NotImplementedError``
naming the slice that brings it, so a call site written for the JAX
package fails loudly instead of silently running something else.
"""

from __future__ import annotations

NOT_PORTED = ("is not ported yet: the PyTorch port runs on one device, "
              "with the data in memory or streamed")

# option -> the later slice that carries it
_SLICES = {
    "mesh": "the mesh slice, parallel/",
    "csr_nnz_per_shard": "the mesh slice, parallel/",
    "sharded_update": "the mesh slice, parallel/sharded_update.py",
    "heartbeat": "the multi-host resilience slice after the mesh "
                 "slice, resilience/distributed.py",
    "monitor": "the multi-host resilience slice after the mesh slice, "
               "resilience/distributed.py",
    "scheduler": "the multi-host resilience slice after the mesh slice, "
                 "resilience/scheduler.py",
    "journal": "the observability slice, resilience/journal.py with obs/",
    "telemetry": "the observability slice, obs/",
}


def reject_later(**options):
    """Raise for an option this slice does not carry (any value but
    ``None`` or ``False``)."""
    for name, value in options.items():
        if value is None or value is False:
            continue
        where = _SLICES.get(name, "a later slice")
        if name == "mesh":
            raise NotImplementedError(
                f"mesh= {NOT_PORTED} (the mesh path arrives in a later "
                f"slice: {where}); pass mesh=None or mesh=False")
        raise NotImplementedError(
            f"{name}= {NOT_PORTED} (it arrives in a later slice: "
            f"{where}); pass {name}=None")
