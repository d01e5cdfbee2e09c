"""Per-architecture configuration files (the model pool and the paper's own
networks), copies of the JAX package's ``configs``."""

from repro_torch.configs.base import (ArchConfig, ShapeSpec, SHAPES, ARCH_IDS,
                                      EXTRA_IDS, get_config, cells,
                                      supports_long_context)

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "ARCH_IDS", "EXTRA_IDS",
           "get_config", "cells", "supports_long_context"]
