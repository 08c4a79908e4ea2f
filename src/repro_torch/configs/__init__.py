"""Architecture registry: --arch <id> resolves here.

The port serves every architecture of the reference registry
(``repro/configs``).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ModelConfig,
    MoEConfig,
    ShapeSpec,
)

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

# archs with a sub-quadratic decode path: the only ones that run long_500k
SUBQUADRATIC = ("xlstm-350m", "recurrentgemma-2b", "gemma3-4b")

__all__ = ["ALL_SHAPES", "ARCH_IDS", "DECODE_32K", "LONG_500K", "ModelConfig", "MoEConfig",
           "PREFILL_32K", "SUBQUADRATIC", "ShapeSpec", "TRAIN_4K", "all_cells", "get_config",
           "shapes_for"]


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def shapes_for(arch: str) -> tuple:
    """The shape cells that apply to ``arch`` (the reference's rule):
    train_4k, prefill_32k and decode_32k for every arch, and long_500k only
    for the archs with a sub-quadratic decode path (``SUBQUADRATIC``)."""
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch in SUBQUADRATIC:
        shapes.append(LONG_500K)
    return tuple(shapes)


def all_cells() -> list:
    """Every (arch, shape, runs) triple of ``ARCH_IDS`` x ``ALL_SHAPES``:
    the long_500k cells of the other archs stay in the list as skips."""
    return [(a, s, s in shapes_for(a)) for a in ARCH_IDS for s in ALL_SHAPES]
