# Copy of src/repro/configs/__init__.py, kept numpy-only; change both copies together.
from .base import (ArchConfig, EncDecConfig, HybridConfig, MoEConfig,  # noqa: F401
                   SHAPES, SSMConfig, ShapeConfig, VLMConfig, shape_applicable)
from .registry import ARCH_IDS, all_cells, get_config, get_shape  # noqa: F401
