"""Config registry: assigned architectures + the paper's paradigm models."""
from repro_torch.configs.registry import (
    ASSIGNED_ARCHS,
    get_config,
    list_archs,
    reduced_config,
)
from repro_torch.configs.shapes import (
    ALL_SHAPES,
    ShapeSpec,
    get_shape,
    shape_applicable,
)

__all__ = [
    "ASSIGNED_ARCHS",
    "get_config",
    "list_archs",
    "reduced_config",
    "ALL_SHAPES",
    "ShapeSpec",
    "get_shape",
    "shape_applicable",
]
