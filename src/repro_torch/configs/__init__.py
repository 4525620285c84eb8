"""Assigned architecture registry: ``get_arch(name)`` / ``cells()``."""

from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES
from repro_torch.configs.registry import ARCHS, arch_names, cells, get_arch
