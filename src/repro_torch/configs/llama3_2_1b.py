"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256.  [hf:meta-llama/Llama-3.2-1B]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    activation="silu",
    norm="rmsnorm",
    rope_base=500000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="llama3.2-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab=256,
    activation="silu",
    compute_dtype="float32",
)
