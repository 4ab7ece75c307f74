"""repro_torch.obs — observability of the port: the counter and histogram
registry (`metrics`), measured-vs-modeled residuals with the regret check
(`residuals`) and the calibration store keyed by backend fingerprint
(`calibration`). Trace spans are still to port."""
from . import metrics
from .calibration import (DEFAULT_PATH, CalibrationStore, backend_fingerprint,
                          calibration_path, load_residuals)
from .residuals import EWMA_ALPHA, REGRET_FACTOR, NodeResidual, ResidualStore, regret_check

__all__ = [
    "NodeResidual", "ResidualStore", "regret_check", "EWMA_ALPHA", "REGRET_FACTOR",
    "CalibrationStore", "backend_fingerprint", "calibration_path", "load_residuals",
    "DEFAULT_PATH",
    "metrics",
]
