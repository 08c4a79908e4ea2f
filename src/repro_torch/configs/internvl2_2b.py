"""internvl2-2b [vlm] — InternViT frontend (STUB: precomputed patch
embeddings) + InternLM2-1.8B backbone: 24L d_model=2048 16H (GQA kv=8)
d_ff=8192 vocab=92553.  [arXiv:2404.16821]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    activation="silu",
    norm="rmsnorm",
    rope_base=1000000.0,
    tie_embeddings=False,
    n_patches=256,
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    activation="silu",
    compute_dtype="float32",
    tie_embeddings=False,
    n_patches=8,
)
