"""Uniform model API (port of ``repro/models/api.py``): the transformer
entry, the cache capability probes and ``kv_bytes_per_token``.  Other
families (VLM, enc-dec, recurrent) are ROADMAP A9/A10."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init_params: Callable
    prefill: Callable  # (cfg, params, batch, cache) -> (logits, cache)
    decode_step: Callable  # (cfg, params, cache, tokens, pos) -> (logits, cache)
    init_cache: Callable
    n_params_exact: Callable
    unstack: Callable  # (cfg, params) -> the per-layer view prefill/decode_step take


def _t_prefill(cfg, params, batch, cache):
    return T.prefill(cfg, params, batch["tokens"], cache)


_TRANSFORMER_API = ModelAPI(
    init_params=T.init_params, prefill=_t_prefill, decode_step=T.decode_step,
    init_cache=T.init_cache, n_params_exact=T.n_params_exact, unstack=T.unstack,
)


def get_api(cfg) -> ModelAPI:
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(f"{cfg.family} models are not ported yet (ROADMAP A9)")
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(f"{cfg.family} models are not ported yet (ROADMAP A10)")
    return _TRANSFORMER_API


def supports_int8_kv(cfg) -> bool:
    """Transformer caches materialize int8 KV leaves when asked."""
    return get_api(cfg) is _TRANSFORMER_API


def supports_paged_kv(cfg) -> bool:
    """Decoder-only stacks with global attention layers serve paged."""
    return "global" in (getattr(cfg, "layer_kinds", ()) or ())


def supports_spec_decode(cfg) -> bool:
    """Whether this family can be the target or the draft of speculative
    decode (and serve chunked prefill): every piece of per-sequence state
    must be positionally addressed, so that rejected speculative writes
    stay masked until the next verify step overwrites them.  Attention KV
    caches qualify; recurrent / xLSTM states (ROADMAP A10) do not."""
    if get_api(cfg) is not _TRANSFORMER_API:
        return False
    kinds = getattr(cfg, "layer_kinds", ()) or ()
    return bool(kinds) and all(k in ("global", "local") for k in kinds)


def is_int8(kv_dtype) -> bool:
    return kv_dtype in ("int8", torch.int8)


def kv_bytes_per_token(cfg, kv_dtype=None) -> float:
    """Cache bytes read per decoded token per unit of context: K and V of
    every global attention layer, 1-byte payloads plus one fp32 scale per
    (token, head) for an int8 cache."""
    per_kv = cfg.n_kv_heads * cfg.hd
    if is_int8(kv_dtype):
        per_layer = 2.0 * (per_kv * 1 + cfg.n_kv_heads * 4)
    else:
        per_layer = 2.0 * per_kv * getattr(torch, cfg.compute_dtype).itemsize
    return float(per_layer * cfg.layer_kinds.count("global"))
