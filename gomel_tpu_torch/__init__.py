"""gomel_tpu_torch — the mel and phase audio codecs on PyTorch and CUDA.

The port of ``gomel_tpu`` (JAX on a TPU, kept beside it as the reference) to
PyTorch, with its device kernels written by hand in CUDA C++ for Hopper
(``csrc/``). This package imports neither JAX nor ``gomel_tpu``. It covers
the mel codec (WAV or FLAC -> log-mel -> quantized PNG, ``tomel``, and back
by Griffin-Lim, ``towav``), the phase codec round trip (WAV or FLAC -> phase
PNG -> WAV, ``tophase`` and ``fromphase``), their batched forms on one
device (``parallel/``, the ``batch-*`` tools of ``cli/batch.py``), the
long-form frame-sharded codecs on one controller (``LongFormMel``,
``LongFormPhase`` over a ``make_mesh`` grid of devices), the streaming
codecs for one device in bounded memory (``StreamingPhase``,
``StreamingMel``), and the codecs as ``torch.export`` serving artifacts
(``serving``, with the ``export`` and ``info`` tools) so far.
"""

from .core.config import (ConfigError, FileNotLoadedError, GomelError,
                          MelConfig, PhaseConfig, UnsupportedSampleRateError,
                          num_freqs_for_sample_rate, pad_shift)
from .parallel.mesh import Mesh, make_mesh
from .pipelines.longform import LongFormMel, LongFormPhase
from .pipelines.mel import Mel
from .pipelines.phase import Phase
from .pipelines.streaming import StreamingMel, StreamingPhase

__version__ = "0.1.0"

__all__ = ["Mel", "Phase", "LongFormMel", "LongFormPhase", "StreamingPhase",
           "StreamingMel", "Mesh", "make_mesh", "MelConfig", "PhaseConfig", "GomelError",
           "FileNotLoadedError", "UnsupportedSampleRateError", "ConfigError",
           "num_freqs_for_sample_rate", "pad_shift", "__version__"]
