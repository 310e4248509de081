"""Utilities: checkpoints and the checkpointed fits (``checkpoint``),
the structured per-iteration log lines and records (``logging``) and the
profiler hooks and honest wall timers (``profiling``); the names the JAX
package's ``utils`` exports."""

from .checkpoint import (  # noqa: F401
    CheckpointedLBFGSResult,
    CheckpointedResult,
    fresh_warm_state,
    load_checkpoint,
    load_lbfgs_checkpoint,
    run_agd_checkpointed,
    run_lbfgs_checkpointed,
    save_checkpoint,
    save_lbfgs_checkpoint,
    warm_from_result,
)
from .logging import (  # noqa: F401
    iteration_records,
    log_result,
    make_host_logger,
    result_run_record,
    write_result_jsonl,
)
from .profiling import TimedStats, annotate, timed, timed_stats, trace  # noqa: F401
