"""``spark_agd_tpu_torch.obs`` — observability.  This slice carries the
JAX package's stdlib-only modules as copies: ``schema`` (the canonical
run-record schema, which ``utils.logging`` and the pipeline's canary and
promotion records are stamped with), ``sinks``, ``flight`` (the flight
recorder), ``trace`` (span contexts; a near-copy whose ``process_index``
reads ``torch.distributed``), ``timeline``, ``scaling`` and ``perfgate``
(``gate_promotion`` grades the pipeline's canary).  The telemetry bus
comes with the observability slice."""

from . import (  # noqa: F401
    flight,
    perfgate,
    scaling,
    schema,
    sinks,
    timeline,
    trace,
)
