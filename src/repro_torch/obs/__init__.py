"""repro_torch.obs — observability of the port: per-node trace spans
(`trace`: `executor.run(..., trace=True)`, a QueryTrace exportable as JSON
and as Chrome trace events, and the shared `timed_call`/`median_wall`
timing primitive), the counter and histogram registry (`metrics`),
measured-vs-modeled residuals with the regret check (`residuals`) and the
calibration store keyed by backend fingerprint (`calibration`).

`python -m repro_torch.obs` runs a standard traced workload, writes
TRACE.json and TRACE.perfetto.json, updates the calibration store, and
prints the predicted-vs-measured table."""
from . import metrics
from .calibration import (DEFAULT_PATH, CalibrationStore, backend_fingerprint,
                          calibration_path, load_residuals)
from .residuals import (EWMA_ALPHA, REGRET_FACTOR, NodeResidual, ResidualStore, regret_check,
                        residuals_of)
from .trace import QueryTrace, Span, median_wall, sync_floor, timed_call, trace_execute

__all__ = [
    "QueryTrace", "Span", "trace_execute", "timed_call", "median_wall", "sync_floor",
    "NodeResidual", "ResidualStore", "residuals_of", "regret_check", "EWMA_ALPHA",
    "REGRET_FACTOR",
    "CalibrationStore", "backend_fingerprint", "calibration_path", "load_residuals",
    "DEFAULT_PATH",
    "metrics",
]
