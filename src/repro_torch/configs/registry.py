"""Architecture registry: ``get``/``get_smoke`` by arch id.

Lists every arch of the JAX package's registry. The ones whose layer kinds
the port does not run yet raise with the part of slice G that brings them.
"""

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
    "gemma-7b": "gemma_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llama3-405b": "llama3_405b",
    "qwen3-1.7b": "qwen3_1_7b",
    "mamba2-2.7b": "mamba2_2_7b",
    "gemma2-27b": "gemma2_27b",
}

_LATER = {
    "recurrentgemma-9b": "the RG-LRU mixer (nn/rglru.py)",
    "llama-3.2-vision-90b": "cross-attention and the VLM config",
}

PORTED = tuple(a for a in ARCH_IDS if a in _MODULES)


def _module(arch_id: str):
    if arch_id in _LATER:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: it comes with {_LATER[arch_id]}, "
            f"a later part of slice G (ROADMAP.md)")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; options: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get(arch_id: str) -> ArchConfig:
    return _module(arch_id).arch()


def get_smoke(arch_id: str) -> ArchConfig:
    return _module(arch_id).smoke()
