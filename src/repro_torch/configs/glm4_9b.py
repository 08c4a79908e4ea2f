"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552.  RoPE, deep-narrow GQA.  [hf:THUDM/glm-4-9b]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
    activation="silu",
    norm="rmsnorm",
    rope_base=10000.0,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="glm4-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=192,
    vocab=256,
    activation="silu",
    compute_dtype="float32",
    tie_embeddings=False,
)
