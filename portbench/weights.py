"""Seeded weights of a configuration, drawn on the device.

Both sides of the benchmark take their weights from here: the harness
assembles them into the port's stacked params tree, and the plain
reference draws the same layer again when it needs it, so that it never
holds the port's tensors.  Layer ``i`` is ONE normal draw of all its
leaves, from a generator seeded by (seed, 1, i); the token table, the head
and the final norm are one draw each.  Matrices are rounded to the
configuration's compute dtype, the type they are served in before the
plan compresses them; norm scales stay float32.

Inits: LeCun-normal matrices (std 1 / sqrt of the contraction axis, -2),
an N(0, 0.02) token table and N(0, 0.1) norm scales (RMSNorm multiplies
by 1 + scale), so that the norms' gains take part in the comparison.
This module imports nothing of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EMBED_STD = 0.02
NORM_STD = 0.1

# tags of the seed streams: a layer's draw, the token table, the head, the
# final norm, the prompts' tokens, the check's sample
TAG_LAYER, TAG_TOK, TAG_HEAD, TAG_FINAL = 1, 2, 3, 4
TAG_PROMPTS, TAG_SAMPLE = 5, 6


def derive_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def head_dim(port: dict) -> int:
    return int(port.get("head_dim") or port["d_model"] // port["n_heads"])


def layer_spec(port: dict) -> list:
    """[(name, shape, init)] of one attention layer, in draw order; names
    are the port's paths within a layer."""
    d, H, KVH, hd = port["d_model"], port["n_heads"], port["n_kv_heads"], head_dim(port)
    spec = [("ln1/scale", (d,), "norm"),
            ("attn/wq", (d, H * hd), "dense"), ("attn/wk", (d, KVH * hd), "dense"),
            ("attn/wv", (d, KVH * hd), "dense"), ("attn/wo", (H * hd, d), "dense"),
            ("ln2/scale", (d,), "norm")]
    moe = port.get("moe")
    if moe:
        E, f = moe["n_experts"], moe["expert_d_ff"]
        Ep = max(E, moe.get("pad_to") or 0)
        spec += [("moe/router", (d, E), "dense"), ("moe/w_gate", (Ep, d, f), "dense"),
                 ("moe/w_up", (Ep, d, f), "dense"), ("moe/w_down", (Ep, f, d), "dense")]
        if moe.get("n_shared_experts"):
            sf = (moe.get("shared_d_ff") or f) * moe["n_shared_experts"]
            spec += [("moe/shared/w_gate", (d, sf), "dense"), ("moe/shared/w_up", (d, sf), "dense"),
                     ("moe/shared/w_down", (sf, d), "dense")]
    else:
        ff = port["d_ff"]
        spec += [("mlp/w_gate", (d, ff), "dense"), ("mlp/w_up", (d, ff), "dense"),
                 ("mlp/w_down", (ff, d), "dense")]
    return spec


def global_spec(port: dict) -> list:
    """[(name, shape, init, tag)] of the leaves outside the layers."""
    d, V = port["d_model"], port["vocab"]
    spec = [("embed/tok", (V, d), "embed", TAG_TOK)]
    if not port.get("tie_embeddings", True):
        spec.append(("embed/head", (d, V), "dense", TAG_HEAD))
    spec.append(("final_norm/scale", (d,), "norm", TAG_FINAL))
    return spec


def _finish(flat: torch.Tensor, shape: tuple, init: str, dtype) -> torch.Tensor:
    t = flat.view(shape)
    if init == "norm":
        return t.mul(NORM_STD)
    std = EMBED_STD if init == "embed" else 1.0 / math.sqrt(shape[-2])
    return t.mul(std).to(dtype)


def _draw(spec: list, seed_int: int, device, dtype) -> dict:
    n = sum(math.prod(s) for _, s, _ in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_int)
    flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, init in spec:
        k = math.prod(shape)
        out[name] = _finish(flat[at:at + k], shape, init, dtype)
        at += k
    return out


def compute_dtype(port: dict) -> torch.dtype:
    return getattr(torch, port.get("compute_dtype", "bfloat16"))


def draw_layer(port: dict, seed: int, i: int, device) -> dict:
    """Layer ``i``'s leaves {name: tensor}, one draw."""
    return _draw(layer_spec(port), derive_seed(seed, TAG_LAYER, i), device, compute_dtype(port))


def draw_global(port: dict, seed: int, name: str, device) -> torch.Tensor:
    """One leaf of ``global_spec`` (its own draw)."""
    for n, shape, init, tag in global_spec(port):
        if n == name:
            return _draw([(n, shape, init)], derive_seed(seed, tag), device,
                         compute_dtype(port))[n]
    raise KeyError(name)
