"""Checkpoint plane: the storage cluster, its batched client-side EC, and
the manager that writes training state through it."""

from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
from repro_torch.checkpoint.storage import ObjectLayout, StorageCluster

__all__ = ["CheckpointManager", "CheckpointPolicy", "ObjectLayout", "StorageCluster"]
