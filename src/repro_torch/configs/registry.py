"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config``."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, shape_applicable

# arch id -> module name
_ARCHS = {
    "granite-8b": "granite_8b",
    "glm4-9b": "glm4_9b",
    "deepseek-67b": "deepseek_67b",
    "starcoder2-3b": "starcoder2_3b",
    "pixtral-12b": "pixtral_12b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "xlstm-350m": "xlstm_350m",
    "zamba2-2.7b": "zamba2_2_7b",
    "musicgen-medium": "musicgen_medium",
}

ARCH_IDS: List[str] = list(_ARCHS)


def _module(arch_id: str):
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def get_shape(shape_id: str) -> ShapeConfig:
    return SHAPES[shape_id]


def all_cells(include_skipped: bool = False):
    """All (arch, shape) cells; skipped=long_500k on quadratic archs."""
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape_id, shape in SHAPES.items():
            ok = shape_applicable(cfg, shape)
            if ok or include_skipped:
                yield arch_id, shape_id, ok


def describe() -> Dict[str, dict]:
    out = {}
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        out[arch_id] = dict(
            family=cfg.family,
            layers=cfg.num_layers,
            d_model=cfg.d_model,
            params=cfg.param_count(),
            active_params=cfg.active_param_count(),
        )
    return out
