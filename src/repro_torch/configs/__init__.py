"""Architecture & shape registry.  ``get_arch("qwen2.5-32b")`` etc."""
from repro_torch.configs.base import (
    ARCH_IDS, PAPER_IDS, SHAPES, ArchConfig, MoEConfig, SSMConfig,
    ShapeConfig, all_archs, all_cells, cells_for, get_arch, reduced, register,
)

__all__ = [
    "ARCH_IDS", "PAPER_IDS", "SHAPES", "ArchConfig", "MoEConfig", "SSMConfig",
    "ShapeConfig", "all_archs", "all_cells", "cells_for", "get_arch",
    "reduced", "register",
]
