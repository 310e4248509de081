"""``spark_agd_tpu_torch.resilience``: fault tolerance on one device and
across the processes of a ``torch.distributed`` group.

The failure taxonomy and the retry engine (``errors`` and ``retry``,
copies of the JAX package's stdlib-only modules), fault injection
(``faults``), the preemption-safe ``AutoCheckpointer`` (``autockpt``),
the fault-aware supervisor (``supervisor``: retries, rollbacks,
checkpoints, heartbeats, host monitoring, straggler scheduling) and
seeded chaos campaigns (``chaos``, the replica kinds of the serving
fleet among them), and the crash-safe recovery journal (``journal``, a
copy).  Across processes: checksummed
generation manifests (``manifest``, a copy), the barrier-committed
``DistributedCheckpointer`` with elastic resume, ``HeartbeatWriter``
and ``HostMonitor`` (``distributed``), quorum degradation (``degrade``)
and the straggler scheduler with speculative segments (``scheduler``).
``api.run(..., resilience=ResiliencePolicy(...))`` is the one-argument
entry point; its ``journal=`` comes with the profiling and analysis
slice."""

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
from . import manifest  # noqa: F401
from .distributed import (  # noqa: F401
    DistributedCheckpointer,
    HeartbeatWriter,
    HostMonitor,
    LoadedDistCheckpoint,
    load_for_topology,
)
from . import journal  # noqa: F401
from .journal import Journal, JournalSink  # noqa: F401
from . import chaos  # noqa: F401
from .chaos import (  # noqa: F401
    ChaosCampaign,
    ChaosSchedule,
    ScheduledFault,
    run_campaign,
)
from . import degrade  # noqa: F401
from .degrade import (  # noqa: F401
    DegradePolicy,
    DegradedCheckpointer,
    load_degraded,
)
from . import scheduler  # noqa: F401
from .scheduler import (  # noqa: F401
    RebalanceDecision,
    ReschedulePolicy,
    SkewTracker,
    StragglerScheduler,
    assign_weighted,
    resolve_speculation,
    run_speculative_segment,
    speculation_due,
)
