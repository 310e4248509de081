"""``spark_agd_tpu_torch.obs`` — observability.

Counterpart of ``spark_agd_tpu/obs/``.  The stdlib-only modules are
copies of the JAX package's: the metrics registry (``registry``), the
event bus (``events``), the sinks, the canonical run-record schema
(``schema``), the flight recorder (``flight``), ``timeline``,
``scaling`` and ``perfgate``; ``trace`` (span contexts) and
``telemetry`` are near-copies whose process index reads
``torch.distributed``, and ``telemetry``'s bus stamps every record with
the device and the torch and CUDA versions.

Pass ``telemetry=Telemetry(...)`` to the serving plane
(``ServeEngine``, ``MicroBatchQueue``, ``ModelRegistry``,
``ReplicaServer``, ``FleetRouter``), the pipeline
(``ContinuousTrainer``, ``CanaryController``, ``Promoter``) and the
supervised fit (``run_agd_supervised``, ``AutoCheckpointer``,
``ChaosSchedule``, ``HeartbeatWriter``, ``HostMonitor``,
``DistributedCheckpointer``, ``StragglerScheduler``, ``load_degraded``),
the fit entry points (``api.run``, ``make_runner``, ``run_lbfgs``,
``make_lbfgs_runner``) and the data plane (``make_streaming_smooth``,
``StreamingDataset.from_libsvm_parts``, ``ingest.from_partitioned_files``):
they emit the JAX package's records.  ``python -m spark_agd_tpu_torch.obs
--selfcheck`` checks the schema.  The compiled-program introspection
(``introspect``, ``program_cost`` records) comes with a later slice.
"""

from .registry import (  # noqa: F401
    Counter,
    Gauge,
    MetricsRegistry,
    SpanTimer,
    default_registry,
)
from .events import EventBus  # noqa: F401
from .sinks import (  # noqa: F401
    CSVSink,
    InMemorySink,
    JSONLSink,
    LoggingSink,
    Sink,
    TensorBoardSink,
)
from .telemetry import Telemetry  # noqa: F401
from . import (  # noqa: F401
    flight,
    perfgate,
    scaling,
    schema,
    timeline,
    trace,
)
from .flight import FlightRecorder, dump_on_failure, load_dump  # noqa: F401
from .trace import SpanContext, TracedSpan  # noqa: F401
from .scaling import (  # noqa: F401
    ContentionPolicy,
    ContentionSentinel,
    CurvePolicy,
    CurveVerdict,
    SpinProbe,
    check_curve,
    environment_key,
    fit_serial_fraction,
    host_fingerprint,
    weak_scaling_efficiency,
)
from .schema import (  # noqa: F401
    SCHEMA_VERSION,
    attempt_record,
    iteration_record,
    new_run_id,
    numerics_failure_record,
    program_cost_record,
    read_jsonl,
    recovery_record,
    run_record,
    span_record,
    stamp,
    validate_record,
)
