"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144.  5:1 local:global attention, sliding window 1024, separate
RoPE bases for local (10k) and global (1M) layers, 128k context.
[hf:google/gemma-3-4b-pt family]
"""

from repro_torch.configs.base import ModelConfig

_PATTERN = tuple((["local"] * 5 + ["global"]) * 5 + ["local"] * 4)  # 34 layers

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab=262144,
    head_dim=256,
    activation="gelu_glu",
    norm="rmsnorm",
    rope_base=10000.0,
    rope_base_global=1000000.0,
    tie_embeddings=True,
    scale_embed=True,
    pattern=_PATTERN,
    local_window=1024,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    activation="gelu_glu",
    compute_dtype="float32",
    scale_embed=True,
    pattern=("local",) * 5 + ("global",) + ("local",) * 2,
    local_window=8,
    rope_base_global=1000000.0,
)
