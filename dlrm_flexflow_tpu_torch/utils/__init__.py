"""Utilities: per-op profiling and observability (utils/profiling.py)."""
from .profiling import (  # noqa: F401
    check_numerics,
    export_task_graph,
    log_shardings,
    op_timing_report,
    print_op_timings,
    trace,
)
