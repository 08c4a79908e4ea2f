"""Model/shape configuration dataclasses shared by all architectures."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # pad the expert dimension to this size (0 = off) so expert parallelism
    # divides the model axis (e.g. 60 -> 64 on a 16-way mesh); padded experts
    # have weights but can never receive tokens (router covers real experts
    # only), costing  (pad_to - n_experts)/n_experts extra streamed bytes.
    pad_to: int = 0

    @property
    def n_experts_padded(self) -> int:
        return max(self.n_experts, self.pad_to or 0)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Exact assigned values live in configs/<id>.py."""

    name: str
    family: str  # dense | moe | vlm | audio | ssm | hybrid | fc
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0  # 0 -> d_model // n_heads
    activation: str = "silu"
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_base: float = 10000.0
    rope_base_global: float = 0.0  # gemma3: separate base for global layers
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    scale_embed: bool = False  # gemma convention: embeddings * sqrt(d_model)

    # Per-layer attention pattern. None -> all-global full attention.
    # 'local'/'global' for transformers (gemma3 5:1), 'rec'/'attn' for
    # hybrid (recurrentgemma 1:2), 'slstm'/'mlstm' for xLSTM.
    pattern: Optional[Sequence[str]] = None
    local_window: int = 4096

    moe: Optional[MoEConfig] = None

    # encoder-decoder (whisper)
    enc_layers: int = 0
    n_frames: int = 1500  # encoder input length (precomputed frame embeddings)
    max_pos: int = 32768  # learned-position table size (decoder side)

    # vlm (internvl2): number of prepended patch embeddings
    n_patches: int = 0

    # ssm / hybrid cell sizes
    conv_width: int = 4
    lru_dim: int = 0  # RG-LRU width (recurrentgemma: ~d_model)

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # memory: rematerialize each layer in backward (activation checkpointing)
    remat: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def layer_kinds(self) -> tuple:
        if self.pattern is None:
            return tuple(["global"] * self.n_layers)
        assert len(self.pattern) == self.n_layers, (
            len(self.pattern),
            self.n_layers,
        )
        return tuple(self.pattern)

    def n_params(self) -> int:
        """Total parameter count (analytic; embeddings included once if tied)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d
        head = 0 if self.tie_embeddings else self.vocab * d
        per_attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        per_dense_ffn = 3 * d * self.d_ff if self.activation in ("silu", "swiglu", "geglu") else 2 * d * self.d_ff
        total = emb + head
        kinds = self.layer_kinds
        for k in kinds:
            if k in ("global", "local", "attn"):
                total += per_attn + 2 * d  # + norms
                if self.moe is not None:
                    m = self.moe
                    total += d * m.n_experts  # router
                    total += m.n_experts * 3 * d * m.expert_d_ff
                    total += m.n_shared_experts * 3 * d * (m.shared_d_ff or m.expert_d_ff)
                elif self.d_ff:
                    total += per_dense_ffn
            elif k == "rec":
                w = self.lru_dim or d
                total += 2 * d * w + w * d + 3 * w + w * self.conv_width + 2 * d
                total += per_dense_ffn
            elif k == "mlstm":
                up = 2 * d
                total += d * 2 * up + up * d + 3 * (up // 1) + 2 * d
            elif k == "slstm":
                nh, dh = self.n_heads, d // self.n_heads
                total += 4 * d * d + 4 * nh * dh * dh + (4 * d * d * 4) // 3 + 2 * d
        if self.enc_layers:
            total += self.enc_layers * (per_attn + per_dense_ffn + 2 * d)
            total += self.n_layers * (per_attn + d)  # decoder cross-attn
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k + shared experts)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        d = self.d_model
        inactive = (m.n_experts - m.top_k) * 3 * d * m.expert_d_ff
        return int(self.n_params() - self.n_layers * inactive)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell: (name, seq_len, global_batch, kind)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
