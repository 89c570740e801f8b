"""Batched codec pipelines (parallel/batch.py)."""
from .batch import (BatchedMel, BatchedPhase, Bucket, make_buckets,
                    pad_batch_to_multiple)

__all__ = ["BatchedMel", "BatchedPhase", "Bucket", "make_buckets",
           "pad_batch_to_multiple"]
