"""The work a served step needs, from shapes alone, and its least time.

The counts are of what the algorithm needs, whatever kernel does it:
every input byte read once -- a projection's kept int8 blocks with their
block row indices and its column scales, an int8 table's rows and scales,
the int8 KV cache of each sequence at its context, the activations in and
out -- and two operations a multiply-add, for the kept blocks only, the
attention over each sequence's actual context and the head's rows that are
sampled.  A MoE layer reads the experts that its tokens are expected to
reach (uniform routing: E * (1 - (1 - k / E) ** tokens) of the E real
experts; the padded experts receive no token) and multiplies each token by
its top-k experts, every assignment counted: a prefill's dropped
assignments are not subtracted, so its count is an upper one.

``bound`` is the H100 roofline of the port's ``chip_smoke.bound`` (bytes
over the HBM rate against operations over the bf16 tensor rate, the
larger), in seconds; ``least_s`` sums it over the step's operations, each
bound by its own side.
"""

from __future__ import annotations

import math

from portbench import weights as W
from portbench.reference.model import leaf_kind

# H100 SXM data sheet, dense, at a 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
ACT_BYTES = 2  # activations in bf16
KV_SCALE_BYTES = 4  # one fp32 scale a (token, KV head) of an int8 cache


def bound(nbytes: float, ops: float, rate: float = BF16_FLOPS) -> tuple:
    """(least seconds, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class Work:
    """Operation and byte counts of one configuration's served steps."""

    def __init__(self, config: dict):
        self.port = port = config["port"]
        self.serving = config["serving"]
        self.hd = W.head_dim(port)
        self.L = port["n_layers"]
        self.leaves = {name: shape for name, shape, _ in W.layer_spec(port)}
        self.kv_bytes_token_layer = 2 * port["n_kv_heads"] * (self.hd + KV_SCALE_BYTES)

    # -- one weight -------------------------------------------------------------

    def weight(self, name: str, shape: tuple, n_stack: int) -> tuple:
        """(bytes read, multiply-adds a token) of one (K, N) matrix."""
        K, N = shape[-2], shape[-1]
        kind = leaf_kind(name, shape, n_stack, self.serving)
        wbytes = 1 if kind in ("quant", "quant_sparse") else ACT_BYTES
        if kind in ("block_sparse", "quant_sparse"):
            b = self.serving["block"]
            nb = (K // b) * (N // b)
            kept = nb - int(round(self.serving.get("q_prune", 0.0) * nb))
            nbytes = kept * (b * b * wbytes + 4)
            macs = kept * b * b
        else:
            nbytes, macs = K * N * wbytes, K * N
        if kind in ("quant", "quant_sparse"):
            nbytes += N * 4
        return nbytes, macs

    def _matmul(self, name: str, tokens: int) -> tuple:
        shape = self.leaves[name]
        nbytes, macs = self.weight(name, shape[-2:], self.L * math.prod(shape[:-2]))
        nbytes += tokens * (shape[-2] + shape[-1]) * ACT_BYTES
        return bound(nbytes, 2.0 * tokens * macs)[0], 2.0 * tokens * macs

    # -- a layer's parts ----------------------------------------------------------

    def _projections(self, tokens: int) -> tuple:
        least = flops = 0.0
        for name in ("attn/wq", "attn/wk", "attn/wv", "attn/wo"):
            t, f = self._matmul(name, tokens)
            least, flops = least + t, flops + f
        return least, flops

    def _ffn(self, tokens: int) -> tuple:
        least = flops = 0.0
        moe = self.port.get("moe")
        if not moe:
            for name in ("mlp/w_gate", "mlp/w_up", "mlp/w_down"):
                t, f = self._matmul(name, tokens)
                least, flops = least + t, flops + f
            return least, flops
        E, K = moe["n_experts"], moe["top_k"]
        t, f = self._matmul("moe/router", tokens)
        least, flops = least + t, flops + f
        reached = E * (1.0 - (1.0 - K / E) ** tokens)
        for name in ("moe/w_gate", "moe/w_up", "moe/w_down"):
            shape = self.leaves[name]
            nbytes, macs = self.weight(name, shape[-2:], self.L * shape[0])
            ops = 2.0 * tokens * K * macs
            nbytes = reached * nbytes + tokens * K * (shape[-2] + shape[-1]) * ACT_BYTES
            least, flops = least + bound(nbytes, ops)[0], flops + ops
        if moe.get("n_shared_experts"):
            for name in ("moe/shared/w_gate", "moe/shared/w_up", "moe/shared/w_down"):
                t, f = self._matmul(name, tokens)
                least, flops = least + t, flops + f
        return least, flops

    def _head(self, rows: int) -> tuple:
        d, V = self.port["d_model"], self.port["vocab"]
        name = "embed/tok" if self.port.get("tie_embeddings", True) else "embed/head"
        nbytes, macs = self.weight(name, (d, V), 1)
        nbytes += rows * (d + V) * ACT_BYTES
        return bound(nbytes, 2.0 * rows * macs)[0], 2.0 * rows * macs

    # -- whole calls ----------------------------------------------------------------

    def decode(self, contexts: list) -> tuple:
        """(least seconds, operations) of one decode step of len(contexts)
        sequences, each attending over its context (its new token
        included)."""
        B = len(contexts)
        H, hd = self.port["n_heads"], self.hd
        ctx = float(sum(contexts))
        p_t, p_f = self._projections(B)
        f_t, f_f = self._ffn(B)
        a_bytes = ctx * self.kv_bytes_token_layer + 2 * B * H * hd * ACT_BYTES
        a_ops = 4.0 * ctx * H * hd
        a_t = bound(a_bytes, a_ops)[0]
        h_t, h_f = self._head(B)
        least = self.L * (p_t + f_t + a_t) + h_t
        return least, self.L * (p_f + f_f + a_ops) + h_f

    def prefill(self, S: int) -> tuple:
        """(least seconds, operations) of one request's prefill of S tokens
        (causal attention, the last position's logits)."""
        H, KVH, hd = self.port["n_heads"], self.port["n_kv_heads"], self.hd
        p_t, p_f = self._projections(S)
        f_t, f_f = self._ffn(S)
        a_ops = 4.0 * H * hd * S * (S + 1) / 2
        a_bytes = S * (2 * H + 2 * KVH) * hd * ACT_BYTES + S * self.kv_bytes_token_layer
        a_t = bound(a_bytes, a_ops)[0]
        h_t, h_f = self._head(1)
        least = self.L * (p_t + f_t + a_t) + h_t
        return least, self.L * (p_f + f_f + a_ops) + h_f
