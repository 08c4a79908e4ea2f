"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000.  RG-LRU recurrence + local attention, 2:1 (two recurrent
blocks per local-attention block), window 2048.  [arXiv:2402.19427]
"""

from repro_torch.configs.base import ModelConfig

_PATTERN = tuple(["rec", "rec", "local"] * 8 + ["rec", "rec"])  # 26 layers

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    activation="gelu_glu",
    norm="rmsnorm",
    tie_embeddings=True,
    scale_embed=True,
    pattern=_PATTERN,
    local_window=2048,
    lru_dim=2560,
    conv_width=4,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab=256,
    head_dim=16,
    activation="gelu_glu",
    compute_dtype="float32",
    scale_embed=True,
    pattern=("rec", "rec", "local", "rec", "rec"),
    local_window=8,
    lru_dim=64,
)
