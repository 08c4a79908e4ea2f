"""Uniform model API (port of ``repro/models/api.py``): one namespace of
functions per family -- the transformer (dense and MoE), the VLM and the
enc-dec -- the cache capability probes and ``kv_bytes_per_token``.  The
recurrent and SSM families are ROADMAP A10."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models import vlm as V


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init_params: Callable
    # (cfg, params, batch, cache, use_kernel=True) -> (logits, cache); False
    # runs the flash attention's plain version on the card
    prefill: Callable
    decode_step: Callable  # (cfg, params, cache, tokens, pos) -> (logits, cache)
    init_cache: Callable
    n_params_exact: Callable
    unstack: Callable  # (cfg, params) -> the per-layer view prefill/decode_step take
    extra_keys: tuple = ()  # frontend-stub inputs of a request, besides its tokens
    # absolute decode positions = prefix_len(cfg) + text position: a VLM
    # prepends its patches, so its KV positions are offset by n_patches
    prefix_len: Callable = staticmethod(lambda cfg: 0)


def _t_prefill(cfg, params, batch, cache, *, use_kernel: bool = True):
    return T.prefill(cfg, params, batch["tokens"], cache, use_kernel=use_kernel)


def _v_prefill(cfg, params, batch, cache, *, use_kernel: bool = True):
    return V.prefill(cfg, params, batch["tokens"], batch["patches"], cache,
                     use_kernel=use_kernel)


def _e_prefill(cfg, params, batch, cache, *, use_kernel: bool = True):
    return E.prefill(cfg, params, batch["tokens"], batch["frames"], cache,
                     use_kernel=use_kernel)


_TRANSFORMER_API = ModelAPI(
    init_params=T.init_params, prefill=_t_prefill, decode_step=T.decode_step,
    init_cache=T.init_cache, n_params_exact=T.n_params_exact, unstack=T.unstack,
)

_VLM_API = ModelAPI(
    init_params=V.init_params, prefill=_v_prefill, decode_step=V.decode_step,
    init_cache=V.init_cache, n_params_exact=V.n_params_exact, unstack=V.unstack,
    extra_keys=("patches",), prefix_len=staticmethod(lambda cfg: cfg.n_patches),
)

_ENCDEC_API = ModelAPI(
    init_params=E.init_params, prefill=_e_prefill, decode_step=E.decode_step,
    init_cache=E.init_cache, n_params_exact=E.n_params_exact, unstack=E.unstack,
    extra_keys=("frames",),
)


def get_api(cfg) -> ModelAPI:
    if cfg.family == "audio":
        return _ENCDEC_API
    if cfg.family == "vlm":
        return _VLM_API
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(f"{cfg.family} models are not ported yet (ROADMAP A10)")
    return _TRANSFORMER_API


def supports_int8_kv(cfg) -> bool:
    """Whether the family's cache holds int8 KV when asked: the transformer
    and VLM caches do; the enc-dec cache ignores kv_dtype."""
    return get_api(cfg) is not _ENCDEC_API


def supports_paged_kv(cfg) -> bool:
    """Decoder-only stacks with global attention layers serve paged, and so
    does the enc-dec decoder (self-attention pages plus its frame pages)."""
    if get_api(cfg) is _ENCDEC_API:
        return True
    return "global" in (getattr(cfg, "layer_kinds", ()) or ())


def supports_spec_decode(cfg) -> bool:
    """Whether this family can be the target or the draft of speculative
    decode (and serve chunked prefill): every piece of per-sequence state
    must be positionally addressed, so that rejected speculative writes
    stay masked until the next verify step overwrites them.  Attention KV
    caches qualify; recurrent / xLSTM states (ROADMAP A10) do not, and
    the VLM and enc-dec stay out as in the reference: the engine's draft
    prefill carries tokens only, no patches or frames."""
    if get_api(cfg) is not _TRANSFORMER_API:
        return False
    kinds = getattr(cfg, "layer_kinds", ()) or ()
    return bool(kinds) and all(k in ("global", "local") for k in kinds)


def is_int8(kv_dtype) -> bool:
    return kv_dtype in ("int8", torch.int8)


def state_bytes_per_step(cfg) -> float:
    """Cache bytes a decode step reads per sequence whatever its context:
    the enc-dec's cross-attention frames (K and V of n_frames positions in
    every decoder layer, in the compute dtype), 0 for the other families --
    the leaves of the reference's cache probe that have no sequence axis."""
    if get_api(cfg) is not _ENCDEC_API:
        return 0.0
    item = getattr(torch, cfg.compute_dtype).itemsize
    return float(2 * cfg.n_layers * cfg.n_frames * cfg.n_kv_heads * cfg.hd * item)


def kv_bytes_per_token(cfg, kv_dtype=None, context_len=None) -> float:
    """Cache bytes read per decoded token per unit of context: K and V of
    every global attention layer, 1-byte payloads plus one fp32 scale per
    (token, head) for an int8 cache; with ``context_len``, plus the
    per-step state (``state_bytes_per_step``) spread over it, so that rate
    x context_len is the bytes a step reads."""
    per_kv = cfg.n_kv_heads * cfg.hd
    if is_int8(kv_dtype):
        per_layer = 2.0 * (per_kv * 1 + cfg.n_kv_heads * 4)
    else:
        per_layer = 2.0 * per_kv * getattr(torch, cfg.compute_dtype).itemsize
    total = float(per_layer * cfg.layer_kinds.count("global"))
    if context_len:
        total += state_bytes_per_step(cfg) / context_len
    return float(total)
