from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: F401
