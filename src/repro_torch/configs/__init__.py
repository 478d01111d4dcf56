"""repro_torch.configs — one module per architecture the port builds.
Use :func:`repro_torch.configs.registry.get_config` with an arch id."""

from repro_torch.configs.registry import (
    ARCH_IDS,
    SHAPES,
    ShapeSpec,
    get_config,
    get_smoke_config,
)

__all__ = ["ARCH_IDS", "SHAPES", "ShapeSpec", "get_config", "get_smoke_config"]
