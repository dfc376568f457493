from repro_torch.configs.base import (SHAPES, ModelConfig, RunConfig,
                                      ShapeConfig, reduced)

__all__ = ["ModelConfig", "RunConfig", "ShapeConfig", "SHAPES", "reduced"]
