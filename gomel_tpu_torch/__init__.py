"""gomel_tpu_torch — the mel and phase audio codecs on PyTorch and CUDA.

The port of ``gomel_tpu`` (JAX on a TPU, kept beside it as the reference) to
PyTorch, with its device kernels written by hand in CUDA C++ for Hopper
(``csrc/``). This package imports neither JAX nor ``gomel_tpu``. It covers
the mel-encode path (WAV -> log-mel -> quantized PNG, ``tomel``) and the
phase codec round trip (WAV -> phase PNG -> WAV, ``tophase`` and
``fromphase``) so far.
"""

from .core.config import ConfigError, GomelError, MelConfig, PhaseConfig
from .pipelines.mel import Mel
from .pipelines.phase import Phase

__version__ = "0.1.0"

__all__ = ["Mel", "MelConfig", "Phase", "PhaseConfig", "GomelError",
           "ConfigError", "__version__"]
