"""tinyllama-1.1b [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000.  llama2-architecture small model.  [arXiv:2401.02385]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    activation="silu",
    norm="rmsnorm",
    rope_base=10000.0,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="tinyllama-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab=256,
    activation="silu",
    compute_dtype="float32",
    tie_embeddings=False,
)
