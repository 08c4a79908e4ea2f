"""Whisper-style encoder-decoder (port of ``repro/models/encdec.py``).

The conv / log-mel frontend is a stub in the reference too: the encoder
takes precomputed frame embeddings (B, n_frames, d).  The encoder is a
bidirectional transformer over the frames; the decoder a causal one with
learned positions (``pos_dec``, no RoPE) and cross-attention into the
encoder's output.  Every norm is a LayerNorm.

The params tree keeps the reference's layout -- ``enc`` and ``dec`` stacked
over their layers -- so reference params convert and compress leaf for
leaf; ``unstack`` turns it into per-layer lists once, when a model is set
up (``enc`` and ``layers``), and the caches hold one dict per decoder layer.

Kernels on the card: every projection through the plan (B1 for the
quant_sparse leaves; the gelu MLP is two B1 launches, not gated);
the encoder's self-attention and the prefill's cross-attention are
non-causal flash attention (B6) past the dense threshold (the encoder's
1500 frames); the paged decoder's self-attention is B3, and its
cross-attention B3 with ``causal=False`` read in place from the slot's
frame pages through ``xpage_table`` at pos = n_frames - 1.  The
reference's paged step gathers the frame pages, slices them to n_frames
and runs its kernel over an identity table; B3's plain version (gather,
then non-causal decode attention) is that path.

On a mesh (``distributed/shardlib``) every attention -- the encoder's,
the decoder's self- and cross-attention -- runs on the rank's heads
(``layers.head_plan``, as ``transformer.py`` does): each projection on the
rank's shard of its weight, ``wo`` and the MLP's down-projection
all-reduced where their contraction splits, and where the model axis does
not divide the heads they stay whole (the kv fallback).  The self and
frame pools hold the rank's KV heads (``_XKV_PAGES_AXES``), the frame
table and the allocator stay on the host, equal on every rank, and a
decode step runs the data replica's rows.

Training (``forward``, ``loss_fn``) is the reference's teacher-forced
pass on the stacked tree, with per-layer ``unbind`` views taken anew each
step (``transformer.unbind_stack``), on the rank's heads and its data
replica's rows on a mesh: every attention goes through
``layers.train_attention`` -- the encoder's non-causal self-attention and
the non-causal cross-attention are the ``FlashAttention`` Function past
1024 frames, never kernel B6, which has no backward.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.weight_plan import sharded_linear
from repro_torch.distributed import shardlib as sl
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

NORM = "layernorm"


def _block_shapes(cfg, cross: bool) -> dict:
    d = cfg.d_model
    p = {"ln1": L.norm_shapes(d, NORM), "attn": T.attn_shapes(cfg),
         "ln2": L.norm_shapes(d, NORM), "mlp": T.mlp_shapes(cfg)}
    if cross:
        p["lnx"] = L.norm_shapes(d, NORM)
        p["xattn"] = T.attn_shapes(cfg)
    return p


def param_shapes(cfg) -> dict:
    """The params tree of ``init_params`` as (shape, init) leaves, keyed as
    the reference's ``init_params``."""
    embed = {"tok": ((cfg.vocab, cfg.d_model), "embed")}
    if not cfg.tie_embeddings:
        embed["head"] = ((cfg.d_model, cfg.vocab), "dense")
    return {
        "embed": embed,
        "pos_dec": ((cfg.max_pos, cfg.d_model), "embed"),
        "enc": T.stack_shapes(_block_shapes(cfg, cross=False), cfg.enc_layers),
        "enc_norm": L.norm_shapes(cfg.d_model, NORM),
        "dec": T.stack_shapes(_block_shapes(cfg, cross=True), cfg.n_layers),
        "final_norm": L.norm_shapes(cfg.d_model, NORM),
    }


def _block_axes(cfg, cross: bool) -> dict:
    na = L.norm_axes(NORM)
    a = {"ln1": na, "attn": L.attn_axes(), "ln2": na, "mlp": L.mlp_axes(cfg)}
    if cross:
        a["lnx"] = na
        a["xattn"] = L.attn_axes()
    return a


def param_axes(cfg) -> dict:
    """Logical axes of ``init_params``' tree, the reference's."""
    na = L.norm_axes(NORM)
    return {
        "embed": L.embed_axes(cfg),
        "pos_dec": (None, "d"),
        "enc": T._stack_axes(_block_axes(cfg, cross=False)),
        "enc_norm": na,
        "dec": T._stack_axes(_block_axes(cfg, cross=True)),
        "final_norm": na,
    }


def init_params(cfg, seed: int = 0, *, device=None):
    """Random params with the reference's shapes and scales
    (``transformer.make_params``)."""
    return T.make_params(param_shapes(cfg), seed, device)


def n_params_exact(cfg) -> int:
    return T.count_params(param_shapes(cfg))


def unstack(cfg, params) -> dict:
    """The per-layer view ``prefill`` and ``decode_step`` take: the stacked
    ``enc`` and ``dec`` trees become lists of per-layer views, ``enc`` and
    ``layers``.  A tree that is already unstacked is returned as it is."""
    if "layers" in params:
        return params
    out = {k: v for k, v in params.items() if k not in ("enc", "dec")}
    out["enc"] = [T.layer_view(params["enc"], i) for i in range(cfg.enc_layers)]
    out["layers"] = [T.layer_view(params["dec"], i) for i in range(cfg.n_layers)]
    return out


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _read(t: torch.Tensor, hp: L.HeadPlan) -> torch.Tensor:
    """The KV heads the rank's q heads read of t (B, S, npool, hd), packed
    where they are a part of the pool's."""
    r = L.read_heads(t, hp)
    return r.contiguous() if r.shape[2] != t.shape[2] else r


def _self_block(cfg, p, x, *, causal: bool, attend, seq: bool = False):
    """Self-attention over all of x (encoder: non-causal; decoder: causal)
    through ``attend(q, k, v, causal=)`` on the rank's heads; returns (x +
    attention, k, v), k and v of the rank's pool heads.  ``seq`` (sequence
    parallelism): x is the rank's piece of the sequence, the block's input
    gathered whole and its output cut (``layers.block_input``)."""
    hp = L.head_plan(cfg)
    h = L.block_input(p["ln1"], x, NORM, seq)
    q, k, v = L.qkv_heads(cfg, p["attn"], h, hp)
    o = attend(q, _read(k, hp), _read(v, hp), causal=causal)
    return x + L.out_proj(cfg, p["attn"], o, hp, seq), k, v


def _mlp_block(cfg, p, x, seq: bool = False):
    return x + L.apply_mlp(cfg, p["mlp"], L.block_input(p["ln2"], x, NORM, seq), seq)


def _cross_q(cfg, p, x, hp: L.HeadPlan, seq: bool = False):
    """The cross-attention's q (B, S, nq, hd) of the rank's q heads."""
    h = L.block_input(p["lnx"], x, NORM, seq)
    B, S, _ = h.shape
    q, qs = sharded_linear(h, p["xattn"]["wq"])
    q = sl.cols(q, qs, hp.q0 * cfg.hd, hp.nq * cfg.hd).contiguous()
    return q.reshape(B, S, hp.nq, cfg.hd)


def _encode(cfg, layers, enc_norm, frames, attend):
    """The encoder over the frames; its output whole on every rank (under
    sequence parallelism the frames' residual stream is the rank's piece
    between blocks, where the model axis divides the frames)."""
    x = frames.to(getattr(torch, cfg.compute_dtype))
    seq = sl.seq_split(x.shape[1])
    if seq:
        x = sl.split_seq(x)
    for p in layers:
        x, _, _ = _self_block(cfg, p, x, causal=False, attend=attend, seq=seq)
        x = _mlp_block(cfg, p, x, seq)
    return L.block_input(enc_norm, x, NORM, seq)


def encode(cfg, params, frames, *, use_kernel: bool = True):
    """frames (B, n_frames, d) precomputed frame embeddings (the frontend
    stub) -> the encoder's output (B, n_frames, d) in the compute dtype,
    whole on every rank of a mesh.  ``params`` is the ``unstack`` view."""
    return _encode(cfg, params["enc"], params["enc_norm"], frames,
                   functools.partial(L.attention, use_kernel=use_kernel))


def _enc_cross_kv(cfg, layers, enc_out) -> list:
    """Each decoder layer's cross-attention (k, v), (B, Sf, npool, hd) of
    the rank's pool heads, from the encoder's output."""
    B, Sf, _ = enc_out.shape
    hp, hd = L.head_plan(cfg), cfg.hd

    def heads(w):
        y, split = sharded_linear(enc_out, w)
        y = sl.cols(y, split, hp.pool0 * hd, hp.npool * hd).contiguous()
        return y.reshape(B, Sf, hp.npool, hd)

    return [(heads(p["xattn"]["wk"]), heads(p["xattn"]["wv"])) for p in layers]


# ---------------------------------------------------------------------------
# training: the teacher-forced forward and its loss
# ---------------------------------------------------------------------------


def decode_train(cfg, params, tokens, enc_out):
    """Teacher-forced decoder forward: tokens (B, S) -> (logits (B, S, V),
    start) against the encoder's output, every attention through
    ``layers.train_attention`` (causal self-attention, non-causal
    cross-attention).  ``params`` is the stacked tree.  The logits of a
    vocabulary that the model axis splits are the rank's columns from
    ``start`` (``layers.unembed_local``); under sequence parallelism the
    residual stream between blocks is the rank's piece of the sequence."""
    layers = T.unbind_stack(params["dec"], cfg.n_layers)
    S = tokens.shape[1]
    x = L.embed_tokens(cfg, params["embed"], tokens)
    x = x + params["pos_dec"][None, :S].to(x.dtype)
    seq = sl.seq_split(S)
    if seq:
        x = sl.split_seq(x)
    hp = L.head_plan(cfg)
    for p, (xk, xv) in zip(layers, _enc_cross_kv(cfg, layers, enc_out)):
        x, _, _ = _self_block(cfg, p, x, causal=True, attend=L.train_attention, seq=seq)
        o = L.train_attention(_cross_q(cfg, p, x, hp, seq), _read(xk, hp), _read(xv, hp),
                              causal=False)
        x = _mlp_block(cfg, p, x + L.out_proj(cfg, p["xattn"], o, hp, seq), seq)
    x = L.block_input(params["final_norm"], x, NORM, seq)
    return L.unembed_local(cfg, params["embed"], x)


def forward_local(cfg, params, tokens, frames) -> tuple:
    """Encode the frames, then ``decode_train``: (logits, start).
    ``params`` is the stacked tree of dense tensors (``init_params``)."""
    T.check_supported(cfg)
    T._check_dense(params)
    enc = T.unbind_stack(params["enc"], cfg.enc_layers)
    enc_out = _encode(cfg, enc, params["enc_norm"], frames, L.train_attention)
    return decode_train(cfg, params, tokens, enc_out)


def forward(cfg, params, tokens, frames):
    """Training/eval forward: the whole vocabulary's logits on every rank
    (``forward_local``, a split vocabulary's columns gathered)."""
    logits, start = forward_local(cfg, params, tokens, frames)
    return logits if start is None else sl.gather_pieces(logits, "model")


def loss_fn(cfg, params, batch):
    """Next-token cross entropy over the text positions (no aux, as the
    reference's).  batch: {"tokens", "labels": (B, S), "frames": (B,
    n_frames, d)}.  Returns (loss, {"loss"}).  On a mesh ``batch`` is the
    global batch: the rank runs its data replica's rows of all three
    (``transformer.replica_rows``), and the loss is the global one."""
    rows = T.replica_rows(batch)
    logits, start = forward_local(cfg, params, rows["tokens"], rows["frames"])
    loss = T.next_token_nll(logits, rows["labels"], start)
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


# cross-attention K/V are written once at prefill and read-only after:
# frames whole, heads tensor-parallel like the self-attention cache; the
# paged frame pools shard like the attention pools, and the frame table is
# host-owned per replica like the decoder's.
_XKV_AXES = sl.register_cache_kind(
    "encdec.xkv", ("batch", None, "kv_heads", None), positional=True, family="encdec")
_XKV_PAGES_AXES = sl.register_cache_kind(
    "encdec.xkv_pages", (None, None, "kv_heads", None), positional=True, paged=True,
    family="encdec")
_XPAGE_TABLE_AXES = sl.register_cache_kind(
    "encdec.xpage_table", ("batch", None), positional=True, paged=True, family="encdec")


def cache_axes(cfg, quantized_kv: bool = False, paged: bool = False) -> dict:
    """Logical axes of ``init_cache``'s tree (always the fp layout: the
    cache ignores kv_dtype)."""
    if paged:
        pools = [L.paged_attn_cache_axes() for _ in range(cfg.n_layers)]
        xpools = [{"k_pages": _XKV_PAGES_AXES, "v_pages": _XKV_PAGES_AXES}
                  for _ in range(cfg.n_layers)]
        return {"layers": pools, "x": xpools, "page_table": sl.axes_for("page_table"),
                "xpage_table": _XPAGE_TABLE_AXES}
    return {"layers": [{**L.attn_cache_axes(), "xk": _XKV_AXES, "xv": _XKV_AXES}
                       for _ in range(cfg.n_layers)]}


def init_cache(cfg, batch: int, length: int, dtype=torch.bfloat16, kv_dtype=None,
               page_size=None, num_pages=None, device="cpu", spec_k: int = 0):
    """{"layers": one dict per decoder layer}.  Contiguous: the
    self-attention k/v (batch, length, KVH, hd) and the cross-attention
    xk/xv (batch, n_frames, KVH, hd).  Paged: the self-attention pools
    (num_pages, page_size, KVH, hd) under "layers" and each layer's frame
    pools of the same shape under "x", a ``page_table`` (batch,
    ceil(length / page_size)) and an ``xpage_table`` (batch, ceil(n_frames
    / page_size)), both owned by the engine; a request's frames take pages
    of the same allocator as its decoder KV.  ``kv_dtype`` and ``spec_k``
    are taken for the API's sake and ignored, as the reference ignores
    kv_dtype: the cache is always in ``dtype``."""
    KVH, hd = cfg.n_kv_heads, cfg.hd
    if page_size is not None:
        def pools():
            return [L.init_paged_attn_cache(cfg, num_pages, page_size, dtype, device)
                    for _ in range(cfg.n_layers)]

        return {
            "layers": pools(),
            "x": pools(),
            "page_table": torch.zeros((batch, -(-length // page_size)), dtype=torch.int32,
                                      device=device),
            "xpage_table": torch.zeros((batch, -(-cfg.n_frames // page_size)),
                                       dtype=torch.int32, device=device),
        }
    xshape = (batch, cfg.n_frames, KVH, hd)
    return {"layers": [
        {**L.init_attn_cache(cfg, batch, length, dtype, device),
         "xk": torch.zeros(xshape, dtype=dtype, device=device),
         "xv": torch.zeros(xshape, dtype=dtype, device=device)}
        for _ in range(cfg.n_layers)]}


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------


def prefill(cfg, params, tokens, frames, cache, *, use_kernel: bool = True):
    """Encode the frames, then the teacher-forced decoder pass over the
    prompt, filling the contiguous cache in place (self-attention k/v at
    positions 0..S-1, the cross-attention xk/xv).  Returns (last-position
    logits (B, 1, V), cache).  ``use_kernel=False`` runs the flash
    attention's plain version on the card.  On a mesh the rank runs its
    heads and fills its cache's KV heads, for its data replica's rows where
    the data axis splits the batch (every rank returns the whole batch's
    logits)."""
    rows = sl.data_rows(tokens.shape[0])
    if rows is not None:
        tokens, frames = tokens[rows], frames[rows]
    hp = L.head_plan(cfg)
    enc_out = encode(cfg, params, frames, use_kernel=use_kernel)
    xkv = _enc_cross_kv(cfg, params["layers"], enc_out)
    B, S = tokens.shape
    x = L.embed_tokens(cfg, params["embed"], tokens)
    x = x + params["pos_dec"][None, :S].to(x.dtype)
    seq = sl.seq_split(S)
    if seq:
        x = sl.split_seq(x)
    for p, c, (xk, xv) in zip(params["layers"], cache["layers"], xkv):
        x, k, v = _self_block(cfg, p, x, causal=True, seq=seq,
                              attend=functools.partial(L.attention, use_kernel=use_kernel))
        piece = L.cache_seq_piece(c["k"], rows is not None)
        if piece is not None and k.shape[2] != c["k"].shape[2]:
            k, v = sl.all_gather(k, "model", dim=2), sl.all_gather(v, "model", dim=2)
        L.fill_cache(c["k"], k, piece)
        L.fill_cache(c["v"], v, piece)
        o = L.attention(_cross_q(cfg, p, x, hp, seq), _read(xk, hp), _read(xv, hp),
                        causal=False, use_kernel=use_kernel)
        x = _mlp_block(cfg, p, x + L.out_proj(cfg, p["xattn"], o, hp, seq), seq)
        c["xk"].copy_(xk.to(c["xk"].dtype))
        c["xv"].copy_(xv.to(c["xv"].dtype))
    if seq:
        x = sl.gather_seq(x)
    x = L.apply_norm(params["final_norm"], x[:, -1:], NORM)
    return sl.gather_batch(L.unembed(cfg, params["embed"], x), rows), cache


def _embed_decode(cfg, params, tokens, pos):
    """Token embeddings plus the learned positions pos..pos+T-1, clamped to
    the table's last row."""
    T_ = tokens.shape[1]
    x = L.embed_tokens(cfg, params["embed"], tokens)
    positions = pos[:, None].long() + torch.arange(T_, device=tokens.device)[None]
    table = params["pos_dec"]
    return x + table[positions.clamp(max=table.shape[0] - 1)].to(x.dtype)


def decode_step(cfg, params, cache, tokens, pos, *, use_kernel: bool = True):
    """One decoder step over T new tokens per sequence (tokens (B, T), pos
    (B,) int32 the position of tokens[:, 0]) against the self and cross
    caches, updated in place.  Returns (logits (B, T, V), cache).  The
    self-attention is ``layers.apply_attn`` without RoPE, contiguous or
    through ``page_table`` (B3, causal); the cross-attention reads the
    contiguous pool through ``layers.cross_decode_attention`` (B3 over an
    identity table on the card) or each slot's frame pages through
    ``xpage_table``, B3 with ``causal=False`` at pos = n_frames - 1, so
    every query sees the frames and none of the last page's stale tail
    (dead slots' rows point at the null page: row-local garbage nobody
    reads).  ``use_kernel=False`` runs B3's plain version on the card.  On
    a mesh the rank decodes its data replica's rows on its heads, as
    ``transformer.decode_step`` does, and every rank returns the whole
    batch's logits."""
    rows = sl.data_rows(tokens.shape[0])
    tokens, pos = sl.shard(tokens, "batch", None), sl.shard(pos, "batch")
    hp = L.head_plan(cfg)
    kv_heads = None if hp.nkv == hp.npool else hp.kv_in_pool
    table = cache.get("page_table")
    xtable = cache.get("xpage_table")
    if xtable is not None and rows is not None:
        xtable = xtable[rows]
    xpos = torch.full((tokens.shape[0],), cfg.n_frames - 1, dtype=torch.int32,
                      device=tokens.device)
    x = _embed_decode(cfg, params, tokens, pos)
    # the reference's enc-dec attends uncapped (repro/models/encdec.py:88,
    # :98): a logit softcap bends only its final logits
    self_cfg = dataclasses.replace(cfg, logit_softcap=0.0)
    xpools = cache.get("x", [None] * len(cache["layers"]))
    for p, c, cx in zip(params["layers"], cache["layers"], xpools):
        h = L.apply_norm(p["ln1"], x, NORM)
        x = x + L.apply_attn(self_cfg, p["attn"], h, cache=c, pos=pos, page_table=table,
                             use_kernel=use_kernel, rows=rows, rope=False)
        q = _cross_q(cfg, p, x, hp)
        if cx is None:
            o = L.cross_decode_attention(q, _read(c["xk"], hp).to(x.dtype),
                                         _read(c["xv"], hp).to(x.dtype), use_kernel=use_kernel)
        else:
            o = L.paged_decode_attention(q, cx["k_pages"], cx["v_pages"], xtable, xpos,
                                         causal=False, use_kernel=use_kernel,
                                         kv_heads=kv_heads)
        x = _mlp_block(cfg, p, x + L.out_proj(cfg, p["xattn"], o, hp))
    x = L.apply_norm(params["final_norm"], x, NORM)
    return sl.gather_batch(L.unembed(cfg, params["embed"], x), rows), cache
