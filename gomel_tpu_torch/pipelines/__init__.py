"""The codec pipelines (counterpart of ``gomel_tpu/pipelines``): ``Mel`` and
``Phase`` on one device, the frame-sharded long-form codecs with their
Griffin-Lim checkpoints, and the streaming codecs."""
from .longform import (LongFormMel, LongFormPhase, load_gl_checkpoint,
                       load_gl_checkpoint_sharded, prune_gl_checkpoints,
                       save_gl_checkpoint, save_gl_checkpoint_sharded)
from .mel import Mel
from .phase import Phase
from .streaming import StreamingMel, StreamingPhase

__all__ = ["Mel", "Phase", "LongFormMel", "LongFormPhase",
           "StreamingMel", "StreamingPhase",
           "save_gl_checkpoint", "load_gl_checkpoint",
           "save_gl_checkpoint_sharded", "load_gl_checkpoint_sharded",
           "prune_gl_checkpoints"]
