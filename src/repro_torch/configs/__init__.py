from repro_torch.configs.base import (ModelConfig, SHAPES, ShapeConfig,  # noqa: F401
                                     shape_applicable)
