"""``spark_agd_tpu_torch.resilience``: single-device fault tolerance.

The failure taxonomy and the retry engine (``errors`` and ``retry``,
copies of the JAX package's stdlib-only modules), fault injection
(``faults``), the preemption-safe ``AutoCheckpointer`` (``autockpt``),
the fault-aware supervisor (``supervisor``: retries, rollbacks,
checkpoints) and seeded chaos campaigns (``chaos``).
``api.run(..., resilience=ResiliencePolicy(...))`` is the one-argument
entry point.  The multi-host members (``distributed``, ``degrade``,
``scheduler``, ``manifest``) come after the mesh slice, and ``journal``
with the observability slice."""

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
from .autockpt import AutoCheckpointer, generation_paths  # noqa: F401
from .supervisor import (  # noqa: F401
    ResiliencePolicy,
    SupervisedResult,
    run_agd_supervised,
    supervised_call,
)
from . import faults  # noqa: F401
from .faults import FaultScript  # noqa: F401
from . import chaos  # noqa: F401
from .chaos import (  # noqa: F401
    ChaosCampaign,
    ChaosSchedule,
    ScheduledFault,
    run_campaign,
)
