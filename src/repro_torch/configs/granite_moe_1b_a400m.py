"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=0,  # all FFN capacity lives in the experts
    vocab=49155,
    activation="silu",
    norm="rmsnorm",
    rope_base=10000.0,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, expert_d_ff=512),
)

SMOKE = ModelConfig(
    name="granite-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=0,
    vocab=256,
    activation="silu",
    compute_dtype="float32",
    moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=32),
)
