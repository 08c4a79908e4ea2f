"""Architecture registry: --arch <id> resolves here.

The port serves every architecture of the reference registry
(``repro/configs``).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, MoEConfig

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "glm4-9b": "glm4_9b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "gemma3-4b": "gemma3_4b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "whisper-tiny": "whisper_tiny",
    "internvl2-2b": "internvl2_2b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-350m": "xlstm_350m",
}

ARCH_IDS = tuple(_MODULES)

__all__ = ["ARCH_IDS", "ModelConfig", "MoEConfig", "get_config"]


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG
