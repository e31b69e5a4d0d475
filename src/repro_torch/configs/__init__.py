# Copied from src/repro/configs/__init__.py with repro. renamed to repro_torch.; keep its logic in step with that file.
from repro_torch.configs.base import (  # noqa: F401
    LM_SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    get_shape,
    reduced_config,
)
from repro_torch.configs.registry import ARCHS, get_config  # noqa: F401
