"""xlstm-350m [ssm] — 24L d_model=1024 4H vocab=50304, alternating
sLSTM + mLSTM blocks (d_ff=0: capacity lives inside the blocks).
[arXiv:2405.04517]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    activation="gelu",
    norm="rmsnorm",
    tie_embeddings=False,
    pattern=("mlstm", "slstm") * 12,
    conv_width=4,
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=256,
    activation="gelu",
    compute_dtype="float32",
    tie_embeddings=False,
    pattern=("mlstm", "slstm") * 2,
)
