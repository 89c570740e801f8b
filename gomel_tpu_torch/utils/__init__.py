"""Observability: throughput metrics, profiling, structured logging.

Counterpart of ``gomel_tpu/utils`` on PyTorch: the metrics time calls that
end with a synchronise of the tensors' device, the profiler wraps
``torch.profiler`` (and NVTX ranges on the card), and the logger tags each
record with the ``torch.distributed`` rank.
"""
from .logging import get_logger, log_event
from .metrics import (ThroughputResult, measure_throughput,
                      scaling_efficiency, spectral_convergence)
from .profiling import StageTimer, annotate, device_trace

__all__ = [
    "get_logger", "log_event",
    "ThroughputResult", "measure_throughput", "scaling_efficiency",
    "spectral_convergence",
    "StageTimer", "annotate", "device_trace",
]
