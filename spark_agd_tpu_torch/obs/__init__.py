"""``spark_agd_tpu_torch.obs`` — observability (this slice: ``schema``,
a copy of the JAX package's canonical run-record schema, which
``utils.logging`` stamps its records with).  The telemetry bus, sinks
and tracing come with the observability slice."""

from . import schema  # noqa: F401
