"""Architecture registry: ``get``/``get_smoke`` by arch id, for every arch
of the JAX package's registry."""

from __future__ import annotations

import importlib

from repro_torch.models.transformer import ArchConfig

ARCH_IDS = (
    "musicgen-medium",
    "recurrentgemma-9b",
    "llama-3.2-vision-90b",
    "gemma-7b",
    "granite-moe-3b-a800m",
    "kimi-k2-1t-a32b",
    "llama3-405b",
    "qwen3-1.7b",
    "mamba2-2.7b",
    "gemma2-27b",
)

_MODULES = {
    "musicgen-medium": "musicgen_medium",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "gemma-7b": "gemma_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llama3-405b": "llama3_405b",
    "qwen3-1.7b": "qwen3_1_7b",
    "mamba2-2.7b": "mamba2_2_7b",
    "gemma2-27b": "gemma2_27b",
}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; options: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get(arch_id: str) -> ArchConfig:
    return _module(arch_id).arch()


def get_smoke(arch_id: str) -> ArchConfig:
    return _module(arch_id).smoke()
