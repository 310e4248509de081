"""The options of the JAX API that the port does not carry yet.

An entry point that meets one of them raises ``NotImplementedError``
naming the slice that brings it, so a call site written for the JAX
package fails loudly instead of silently running something else.
"""

from __future__ import annotations

NOT_PORTED = ("is not ported yet: the PyTorch port runs data and model "
              "parallelism over a mesh, with the data in memory or "
              "streamed")

# option -> the later slice that carries it
# (the bus itself, obs/telemetry.py, and resilience/journal.py are
# ported; what still refuses them: api.run / make_runner and the L-BFGS
# runners, data/streaming.py's smooths, data/ingest.py,
# resilience/scheduler.py, resilience/degrade.py and
# resilience/distributed.py's load_for_topology with its
# DistributedCheckpointer, whose records need the instrumented spans of
# utils/profiling.py and obs/introspect.py)
_SLICES = {
    "journal": ("the profiling and analysis slice, the last of the "
                "observability work: utils/profiling.py, "
                "obs/introspect.py, analysis/"),
    "telemetry": ("the profiling and analysis slice, the last of the "
                  "observability work: utils/profiling.py, "
                  "obs/introspect.py, analysis/"),
}


def reject_later(**options):
    """Raise for an option this slice does not carry (any value but
    ``None`` or ``False``)."""
    for name, value in options.items():
        if value is None or value is False:
            continue
        where = _SLICES.get(name, "a later slice")
        raise NotImplementedError(
            f"{name}= {NOT_PORTED} (it arrives in a later slice: "
            f"{where}); pass {name}=None")
