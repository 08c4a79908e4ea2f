"""whisper-tiny [audio] — encoder-decoder, 4L each, d_model=384 6H
d_ff=1536 vocab=51865.  Conv/log-mel frontend is a STUB: input_specs
provides precomputed frame embeddings (B, 1500, 384).  [arXiv:2212.04356]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,  # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    activation="gelu",
    norm="layernorm",
    tie_embeddings=True,
    enc_layers=4,
    n_frames=1500,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    d_model=48,
    n_heads=6,
    n_kv_heads=6,
    d_ff=96,
    vocab=256,
    activation="gelu",
    norm="layernorm",
    compute_dtype="float32",
    enc_layers=2,
    n_frames=16,
    max_pos=64,
)
