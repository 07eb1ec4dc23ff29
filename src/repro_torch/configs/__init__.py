from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    ShapeConfig,
    SHAPES,
    reduced,
    shape_applicable,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS,
    all_cells,
    get_config,
    get_shape,
    get_smoke_config,
)
