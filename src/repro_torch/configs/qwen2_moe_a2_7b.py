"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab=151936,
    activation="silu",
    norm="rmsnorm",
    rope_base=1000000.0,
    tie_embeddings=False,
    moe=MoEConfig(
        n_experts=60, top_k=4, expert_d_ff=1408,
        n_shared_experts=4, shared_d_ff=1408,
        # §Perf cell 2: 60 experts don't divide the 16-way model axis; padding
        # to 64 dead experts enables true expert parallelism (2.48x lower
        # collective roofline vs intra-expert TP).  Baseline reproducible
        # with pad_to=0 (benchmarks/perf_cells.py).
        pad_to=64,
    ),
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=256,
    activation="silu",
    compute_dtype="float32",
    tie_embeddings=False,
    moe=MoEConfig(n_experts=6, top_k=2, expert_d_ff=32, n_shared_experts=2, shared_d_ff=32),
)
