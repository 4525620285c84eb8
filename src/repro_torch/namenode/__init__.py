"""Metadata plane: the block placement policies the storage cluster uses."""

from .placement import (
    FailureDomainPlacement,
    LoadBalancedPlacement,
    PlacementPolicy,
    RoundRobinPlacement,
)

__all__ = [
    "FailureDomainPlacement",
    "LoadBalancedPlacement",
    "PlacementPolicy",
    "RoundRobinPlacement",
]
