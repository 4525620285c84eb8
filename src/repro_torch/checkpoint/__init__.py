"""Checkpoint storage: the storage cluster and its batched client-side EC.

``CheckpointManager`` (pytree flattening) is not ported yet.
"""

from repro_torch.checkpoint.storage import ObjectLayout, StorageCluster

__all__ = ["ObjectLayout", "StorageCluster"]
