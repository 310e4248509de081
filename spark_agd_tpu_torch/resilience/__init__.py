"""``spark_agd_tpu_torch.resilience`` — the failure taxonomy and the
retry engine (this slice: ``errors`` and ``retry``, copies of the JAX
package's stdlib-only modules, which the streamed data plane's shard
reads run under).  The supervisor, checkpointers, chaos and journal
come with the resilience slice."""

from .errors import (  # noqa: F401
    FATAL,
    FAILURE_KINDS,
    NUMERIC,
    PREEMPTED,
    TRANSIENT,
    AttemptTimeout,
    HostLost,
    NumericsFailureError,
    Preempted,
    QuorumLost,
    ServeOverloaded,
    SimulatedDeviceLoss,
    StreamDataLoss,
    SupervisorGivingUp,
    classify_failure,
)
from .retry import (  # noqa: F401
    BackoffSchedule,
    RetryPolicy,
    call_with_retry,
    retrying,
)
