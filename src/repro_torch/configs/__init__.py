"""Config registry: ``--arch <id>`` resolution for every assigned arch."""

from __future__ import annotations

from repro_torch.configs.base import (
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SHAPES,
    reduce_config,
)
from repro_torch.configs import (
    qwen3_32b,
    granite_34b,
    phi3_medium_14b,
    qwen2_7b,
    qwen2_vl_72b,
    deepseek_v2_236b,
    llama4_scout_17b_a16e,
    zamba2_1p2b,
    seamless_m4t_large_v2,
    xlstm_1p3b,
)

ARCHITECTURES: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen3_32b,
        granite_34b,
        phi3_medium_14b,
        qwen2_7b,
        qwen2_vl_72b,
        deepseek_v2_236b,
        llama4_scout_17b_a16e,
        zamba2_1p2b,
        seamless_m4t_large_v2,
        xlstm_1p3b,
    )
}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHITECTURES[name]
    except KeyError:
        raise KeyError(
            f"unknown architecture {name!r}; available: {sorted(ARCHITECTURES)}"
        ) from None


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}") from None


def valid_cells() -> list[tuple[str, str]]:
    """All runnable (arch × shape) dry-run cells.

    ``long_500k`` needs sub-quadratic sequence mixing and is skipped for
    pure full-attention archs (recorded in DESIGN.md §Arch-applicability).
    No assigned arch is encoder-only, so decode shapes run everywhere.
    """
    cells = []
    for arch, cfg in ARCHITECTURES.items():
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.supports_long_context:
                continue
            cells.append((arch, shape.name))
    return cells


__all__ = [
    "ARCHITECTURES",
    "SHAPES",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "ShapeConfig",
    "get_config",
    "get_shape",
    "reduce_config",
    "valid_cells",
]
