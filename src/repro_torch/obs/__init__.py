"""repro_torch.obs — observability of the port: the counter and histogram
registry (`metrics`). Trace spans, residuals and calibration are still to
port."""
from . import metrics

__all__ = ["metrics"]
