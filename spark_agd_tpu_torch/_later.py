"""The options of the JAX API that the port does not carry yet.

An entry point that meets one of them raises ``NotImplementedError``
naming the slice that brings it, so a call site written for the JAX
package fails loudly instead of silently running something else.
"""

from __future__ import annotations

NOT_PORTED = ("is not ported yet: the PyTorch port runs data parallelism "
              "over a mesh's data axis, with the data in memory or "
              "streamed")

_A8 = "the model-parallel slice after the mesh slice (ROADMAP A.8)"

# option -> the later slice that carries it
_SLICES = {
    "sharded_update": f"{_A8}, parallel/sharded_update.py",
    "model_axis": f"{_A8}: a mesh's model axis and the auto mode's "
                  f"tensor-parallel softmax",
    "feature_sharding": f"{_A8}: feature sharding, "
                        f"parallel/feature_sharded.py",
    "grid_mesh": f"{_A8}: the mesh sweeps and cross-validation of "
                 f"parallel/grid.py, and the streamed sweeps' mesh=",
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
        raise NotImplementedError(
            f"{name}= {NOT_PORTED} (it arrives in a later slice: "
            f"{where}); pass {name}=None")


def reject_a8(kind: str, what: str):
    """Raise for a use of a mesh that the model-parallel slice brings:
    ``kind`` keys :data:`_SLICES`, ``what`` says what was asked."""
    raise NotImplementedError(
        f"{what}: {NOT_PORTED} (it arrives in a later slice: "
        f"{_SLICES[kind]}); pass a mesh with a data axis alone, or "
        f"mesh=None or mesh=False")


def reject_grid_mesh(mesh, what: str):
    """The grid fits (sweeps, cross-validation, the streamed sweeps) run
    on one device in this slice: any mesh raises."""
    if mesh is None or mesh is False:
        return
    reject_a8("grid_mesh", f"{what} with mesh=")
