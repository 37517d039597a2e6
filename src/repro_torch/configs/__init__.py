"""Architecture registry: public ``--arch`` id -> ModelConfig."""
from repro_torch.configs.base import (
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig,
    SHAPES, cells_for, skipped_cells_for, reduced,
)
from repro_torch.configs import (
    llava_next_34b, granite_34b, qwen1_5_4b, yi_34b, llama3_2_3b,
    phi3_5_moe, dbrx_132b, zamba2_2_7b, mamba2_130m, hubert_xlarge,
)

_MODULES = [
    llava_next_34b, granite_34b, qwen1_5_4b, yi_34b, llama3_2_3b,
    phi3_5_moe, dbrx_132b, zamba2_2_7b, mamba2_130m, hubert_xlarge,
]

REGISTRY: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

# short aliases (module-style ids)
ALIASES = {
    "llava-next-34b": "llava-next-34b",
    "granite-34b": "granite-34b",
    "qwen1.5-4b": "qwen1.5-4b",
    "yi-34b": "yi-34b",
    "llama3.2-3b": "llama3.2-3b",
    "phi3.5-moe-42b-a6.6b": "phi3.5-moe-42b-a6.6b",
    "phi3.5-moe": "phi3.5-moe-42b-a6.6b",
    "dbrx-132b": "dbrx-132b",
    "zamba2-2.7b": "zamba2-2.7b",
    "mamba2-130m": "mamba2-130m",
    "hubert-xlarge": "hubert-xlarge",
}


def get_config(arch: str) -> ModelConfig:
    key = ALIASES.get(arch, arch)
    if key not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[key]


def list_archs() -> list[str]:
    return sorted(REGISTRY)


__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "SHAPES",
    "cells_for", "skipped_cells_for", "reduced", "get_config", "list_archs",
    "REGISTRY",
]
