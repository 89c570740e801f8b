"""Observability: throughput metrics, profiling, structured logging.

Counterpart of ``gomel_tpu/utils`` on PyTorch: the metrics time calls that
end with a synchronise of the tensors' device, the profiler wraps
``torch.profiler`` (the program's spans and counters record while a
profiler does: ``annotate``, ``recorded``), and the logger tags each record
with the ``torch.distributed`` rank.
"""
from .logging import get_logger, log_event
from .metrics import (ThroughputResult, measure_throughput,
                      scaling_efficiency, spectral_convergence)
from .profiling import annotate, device_trace, recorded, reset

__all__ = [
    "get_logger", "log_event",
    "ThroughputResult", "measure_throughput", "scaling_efficiency",
    "spectral_convergence",
    "annotate", "device_trace", "recorded", "reset",
]
