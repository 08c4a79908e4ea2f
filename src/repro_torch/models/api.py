"""Uniform model API (port of ``repro/models/api.py``): one namespace of
functions per family -- the transformer (dense, MoE, and the recurrent
``hybrid`` and xLSTM ``ssm`` stacks), the VLM and the enc-dec -- the cache
capability probes, ``state_bytes_per_step`` and ``kv_bytes_per_token``.

``loss_fn`` trains every family: the transformer stacks (dense, MoE with
its aux loss, recurrent and xLSTM), the VLM after its projected patches
and the enc-dec over its frames."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import weight_plan as WP
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models import vlm as V


def _compress(cfg, params, plan_cfg: WP.PlanConfig) -> WP.WeightPlan:
    """Compression with the family's dense param axes riding along, as the
    reference's (``api.py:40``): every LeafPlan records its logical axes,
    which place the packed tree on a mesh (``weight_plan.param_specs``)."""
    return WP.compress(params, plan_cfg, axes=get_api(cfg).param_axes(cfg))


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init_params: Callable
    # (cfg) -> init_params' tree with (shape, init) leaves, nothing allocated
    param_shapes: Callable
    param_axes: Callable  # (cfg) -> init_params' tree of logical-axis tuples
    loss_fn: Callable  # (cfg, params, batch) -> (loss, metrics)
    # (cfg, params, batch, cache, use_kernel=True) -> (logits, cache); False
    # runs the flash attention's plain version on the card
    prefill: Callable
    decode_step: Callable  # (cfg, params, cache, tokens, pos) -> (logits, cache)
    init_cache: Callable
    n_params_exact: Callable
    unstack: Callable  # (cfg, params) -> the per-layer view prefill/decode_step take
    # (cfg, quantized_kv, paged) -> init_cache's tree of logical-axis tuples
    cache_axes: Callable
    extra_keys: tuple = ()  # frontend-stub inputs of a request, besides its tokens
    # absolute decode positions = prefix_len(cfg) + text position: a VLM
    # prepends its patches, so its KV positions are offset by n_patches
    prefix_len: Callable = staticmethod(lambda cfg: 0)
    # (cfg, params, PlanConfig) -> WeightPlan with the axes recorded
    compress: Callable = staticmethod(_compress)


def _t_prefill(cfg, params, batch, cache, *, use_kernel: bool = True):
    return T.prefill(cfg, params, batch["tokens"], cache, use_kernel=use_kernel)


def _v_prefill(cfg, params, batch, cache, *, use_kernel: bool = True):
    return V.prefill(cfg, params, batch["tokens"], batch["patches"], cache,
                     use_kernel=use_kernel)


def _e_prefill(cfg, params, batch, cache, *, use_kernel: bool = True):
    return E.prefill(cfg, params, batch["tokens"], batch["frames"], cache,
                     use_kernel=use_kernel)


_TRANSFORMER_API = ModelAPI(
    init_params=T.init_params, param_shapes=T.param_shapes, param_axes=T.param_axes,
    loss_fn=T.loss_fn, prefill=_t_prefill, decode_step=T.decode_step,
    init_cache=T.init_cache, n_params_exact=T.n_params_exact, unstack=T.unstack,
    cache_axes=T.cache_axes,
)

_VLM_API = ModelAPI(
    init_params=V.init_params, param_shapes=V.param_shapes, param_axes=V.param_axes,
    loss_fn=V.loss_fn, prefill=_v_prefill, decode_step=V.decode_step,
    init_cache=V.init_cache, n_params_exact=V.n_params_exact, unstack=V.unstack,
    cache_axes=T.cache_axes,
    extra_keys=("patches",), prefix_len=staticmethod(lambda cfg: cfg.n_patches),
)

_ENCDEC_API = ModelAPI(
    init_params=E.init_params, param_shapes=E.param_shapes, param_axes=E.param_axes,
    loss_fn=E.loss_fn, prefill=_e_prefill, decode_step=E.decode_step,
    init_cache=E.init_cache, n_params_exact=E.n_params_exact, unstack=E.unstack,
    cache_axes=E.cache_axes,
    extra_keys=("frames",),
)


def get_api(cfg) -> ModelAPI:
    if cfg.family == "audio":
        return _ENCDEC_API
    if cfg.family == "vlm":
        return _VLM_API
    return _TRANSFORMER_API  # dense / moe / ssm / hybrid


def supports_int8_kv(cfg) -> bool:
    """Whether the family's cache holds int8 KV when asked: a transformer or
    VLM stack with attention layers does; the enc-dec cache ignores
    kv_dtype, and an attention-free stack (xLSTM) has no KV at all -- its
    states keep the compute dtype."""
    if get_api(cfg) is _ENCDEC_API:
        return False
    return any(k in T.ATTN_KINDS for k in cfg.layer_kinds)


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
    caches qualify; recurrent / xLSTM states, which a step rewrites whole,
    do not, and the VLM and enc-dec stay out as in the reference: the
    engine's draft prefill carries tokens only, no patches or frames."""
    if get_api(cfg) is not _TRANSFORMER_API:
        return False
    kinds = getattr(cfg, "layer_kinds", ()) or ()
    return bool(kinds) and all(k in ("global", "local") for k in kinds)


def is_int8(kv_dtype) -> bool:
    return kv_dtype in ("int8", torch.int8)


def state_bytes_per_step(cfg) -> float:
    """Cache bytes a decode step reads per sequence whatever its context --
    the leaves of the reference's cache probe that have no sequence axis:
    the enc-dec's cross-attention frames (K and V of n_frames positions in
    every decoder layer, in the compute dtype), and every leaf of a
    recurrent or xLSTM layer's state (RG-LRU h and conv; mLSTM C, n, m and
    conv; sLSTM c, n, h, m), probed on the meta device.  0 for a stack of
    attention layers only."""
    dtype = getattr(torch, cfg.compute_dtype)
    if get_api(cfg) is _ENCDEC_API:
        return float(2 * cfg.n_layers * cfg.n_frames * cfg.n_kv_heads * cfg.hd * dtype.itemsize)
    total = 0
    for kind in cfg.layer_kinds:
        if kind not in T.ATTN_KINDS:
            state = T.init_layer_cache(cfg, kind, 1, 2, dtype, device="meta")
            total += sum(t.numel() * t.element_size() for t in state.values())
    return float(total)


def kv_bytes_per_token(cfg, kv_dtype=None, context_len=None) -> float:
    """Cache bytes read per decoded token per unit of context: K and V of
    every attention layer, 1-byte payloads plus one fp32 scale per (token,
    head) for an int8 cache.  With ``context_len``, a sliding-window layer
    counts min(context_len, local_window) / context_len of its rate (its
    ring holds at most the window) and the per-step state
    (``state_bytes_per_step``) is spread over the context, so that rate x
    context_len is the bytes a step reads."""
    per_kv = cfg.n_kv_heads * cfg.hd
    if is_int8(kv_dtype):
        per_layer = 2.0 * (per_kv * 1 + cfg.n_kv_heads * 4)
    else:
        per_layer = 2.0 * per_kv * getattr(torch, cfg.compute_dtype).itemsize
    total = 0.0
    for kind in cfg.layer_kinds:
        if kind == "global":
            total += per_layer
        elif kind == "local":
            frac = min(context_len, cfg.local_window) / context_len if context_len else 1.0
            total += per_layer * frac
    if context_len:
        total += state_bytes_per_step(cfg) / context_len
    return float(total)


# ---------------------------------------------------------------------------
# meta-tensor input specs (the dry run)
# ---------------------------------------------------------------------------


def _extras_specs(cfg, api: ModelAPI, batch: int) -> dict:
    """A batch's frontend-stub inputs as fp32 meta tensors: a VLM's patches
    (batch, n_patches, d), an enc-dec's frames (batch, n_frames, d)."""
    out = {}
    if "patches" in api.extra_keys:
        out["patches"] = torch.empty((batch, cfg.n_patches, cfg.d_model), device="meta")
    if "frames" in api.extra_keys:
        out["frames"] = torch.empty((batch, cfg.n_frames, cfg.d_model), device="meta")
    return out


def input_specs(cfg, shape, mode: str | None = None) -> dict:
    """Meta-tensor stand-ins (shapes and dtypes, nothing allocated) for the
    inputs of the step a shape cell runs, the reference's ``input_specs``:
    mode (the cell's kind by default) train -> {"batch": {"tokens",
    "labels", extras}}; prefill -> {"batch": {"tokens", extras}, "cache"};
    decode -> {"tokens" (B, 1), "pos" (B,), "cache"}.  Tokens are int32;
    the cache is ``init_cache`` of the cell's batch and length in the
    compute dtype, on the meta device (one dict per layer, where the
    reference stacks its layers)."""
    api = get_api(cfg)
    mode = mode or shape.kind
    B, S = shape.global_batch, shape.seq_len
    tok = torch.empty((B, S), dtype=torch.int32, device="meta")
    if mode == "train":
        return {"batch": {"tokens": tok, "labels": tok.clone(), **_extras_specs(cfg, api, B)}}
    cache = api.init_cache(cfg, B, S, getattr(torch, cfg.compute_dtype), device="meta")
    if mode == "prefill":
        return {"batch": {"tokens": tok, **_extras_specs(cfg, api, B)}, "cache": cache}
    if mode == "decode":
        return {"tokens": torch.empty((B, 1), dtype=torch.int32, device="meta"),
                "pos": torch.empty((B,), dtype=torch.int32, device="meta"), "cache": cache}
    raise ValueError(mode)
