"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config``.

Mirrors `repro.configs`. The port serves the dense family (qwen2.5-3b,
qwen3-32b, nemotron-4-15b, deepseek-67b), the image-prefix vlm family
(llava-next-mistral-7b), the Mamba1 ssm family (falcon-mamba-7b), MoE with
MLA attention (deepseek-v2-lite-16b) and with standard attention
(grok-1-314b), the hybrid family (zamba2-2.7b) and the encoder-decoder
family (whisper-medium): every id of the JAX registry. An id whose family
is not ported would be listed in NOT_YET_PORTED and raise a clear error.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen3-32b": "qwen3_32b",
    "nemotron-4-15b": "nemotron_4_15b",
    "deepseek-67b": "deepseek_67b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "grok-1-314b": "grok_1_314b",
    "zamba2-2.7b": "zamba2_2_7b",
    "whisper-medium": "whisper_medium",
}

# ids the JAX registry knows whose model family is not ported yet
NOT_YET_PORTED: list = []

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
