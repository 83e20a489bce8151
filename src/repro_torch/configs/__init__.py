"""Architecture + shape configs (assignment table)."""
from repro_torch.configs.base import ArchConfig, INPUT_SHAPES, InputShape, shape_applicable
from repro_torch.configs.registry import ARCHS, all_cells, get_arch

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "ARCHS",
           "get_arch", "all_cells", "shape_applicable"]
