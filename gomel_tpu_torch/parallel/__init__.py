"""Batched codec pipelines (parallel/batch.py), the ('data', 'frame') mesh
(parallel/mesh.py) and the frame-sharded programs (parallel/sharded.py)."""
from .batch import (BatchedMel, BatchedPhase, Bucket, make_buckets,
                    pad_batch_to_multiple)
from .mesh import (DATA_AXIS, FRAME_AXIS, Mesh, Sharded, make_mesh,
                   shard_array, single_device_mesh)

__all__ = ["BatchedMel", "BatchedPhase", "Bucket", "make_buckets",
           "pad_batch_to_multiple", "DATA_AXIS", "FRAME_AXIS", "Mesh",
           "Sharded", "make_mesh", "shard_array", "single_device_mesh"]
