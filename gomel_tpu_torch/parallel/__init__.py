"""Batched codec pipelines (parallel/batch.py), the ('data', 'frame') mesh
on one controller or across processes (parallel/mesh.py) and the
frame-sharded programs (parallel/sharded.py)."""
from .batch import (BatchedMel, BatchedPhase, Bucket, local_rows,
                    make_buckets, pad_batch_to_multiple)
from .mesh import (DATA_AXIS, FRAME_AXIS, Mesh, Sharded,
                   data_group_for_process, host_to_global,
                   initialize_multihost, is_multihost, local_device_count,
                   local_rows_to_global, make_mesh,
                   process_local_batch_multiple, shard_array,
                   single_device_mesh)
from .sharded import (FrameShardPlan, pad_frames_for_plan,
                      pad_signal_for_plan, plan_frame_sharding,
                      sharded_gl_noise_fn, sharded_griffin_lim_fn,
                      sharded_istft_fn, sharded_mel_decode_fn,
                      sharded_mel_encode_fn, sharded_phase_decode_fn,
                      sharded_phase_encode_fn, sharded_stft_fn)

__all__ = ["BatchedMel", "BatchedPhase", "Bucket", "local_rows",
           "make_buckets", "pad_batch_to_multiple", "DATA_AXIS", "FRAME_AXIS",
           "Mesh", "Sharded", "make_mesh", "shard_array",
           "single_device_mesh", "initialize_multihost", "is_multihost",
           "local_device_count", "data_group_for_process", "host_to_global",
           "local_rows_to_global", "process_local_batch_multiple",
           "FrameShardPlan", "plan_frame_sharding", "pad_signal_for_plan",
           "pad_frames_for_plan", "sharded_stft_fn", "sharded_istft_fn",
           "sharded_gl_noise_fn", "sharded_griffin_lim_fn",
           "sharded_mel_encode_fn", "sharded_mel_decode_fn",
           "sharded_phase_encode_fn", "sharded_phase_decode_fn"]
