"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config``.

Mirrors `repro.configs`. The port serves the dense family (qwen2.5-3b),
the Mamba1 ssm family (falcon-mamba-7b) and MoE with MLA attention
(deepseek-v2-lite-16b) so far; the other ids of the
JAX registry raise a clear error until their family is ported (ROADMAP.md
Queue 1).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
}

# ids the JAX registry knows whose model family is not ported yet
NOT_YET_PORTED = [
    "whisper-medium", "nemotron-4-15b", "qwen3-32b", "deepseek-67b",
    "zamba2-2.7b", "grok-1-314b", "llava-next-mistral-7b",
]

ARCH_IDS = list(_MODULES)


def _module(arch_id: str):
    if arch_id in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not yet ported, see ROADMAP.md Queue 1 "
            f"(ported: {ARCH_IDS})")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
