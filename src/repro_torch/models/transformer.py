"""Decoder-only LM (port of ``repro/models/transformer.py``).

The params tree keeps the reference's layout: the layer-kind sequence is
factored into a repeating unit (``find_unit``), and every leaf of a unit
position is stacked over the units, so reference params convert and
compress leaf for leaf (``interop``, ``weight_plan.compress``).  Where the
reference scans over the stack, the port runs a Python loop over layers:
``unstack`` turns the tree into a list of per-layer views once, when a
model is set up, and ``init_cache`` makes one cache dict per layer.

Every layer kind of the reference is ported: ``global`` and
sliding-window ``local`` attention layers with the config's norm and a
dense gated MLP or a routed MoE FFN (``models/moe.py``), the RG-LRU ``rec``
block with its MLP (``models/recurrent.py``, recurrentgemma-2b) and the
xLSTM ``mlstm`` / ``slstm`` cells (``models/ssm.py``, xlstm-350m); tied or
untied heads, gemma's embedding scale and global RoPE base, and the VLM's
prepended patch embeddings (``prefill(extra_embeds=)``, ``models/vlm.py``).
A ``local`` layer keeps a contiguous ring of ``local_window (+ spec_k)``
slots, also when the global layers are paged; a recurrent or xLSTM layer
keeps a fixed-size state in the compute dtype (fp32 for its integrators),
whatever ``kv_dtype`` says.  A config's ``logit_softcap`` caps the
attention scores (kernel B6 on the card past the dense threshold, B3 at
decode) and the final logits, as the reference's gemma2-style softcap
does.

Training (``forward``, ``loss_fn``) runs the reference's ``train`` mode
for every layer kind: attention without a cache through
``layers.train_attention`` (never kernel B6, which has no backward), a MoE
FFN with its Switch aux loss (summed over the layers in fp32), and the
``rec`` / ``mlstm`` / ``slstm`` cells from a zero state; on a mesh the
loss is the vocab-parallel cross entropy of the rank's vocabulary columns
(``next_token_nll(start=)``), and under a ``seq_sp`` rule the residual
stream between blocks is the rank's piece of the sequence; on the stacked
tree itself -- each step takes its per-layer views anew
(``_unbind_layers``), so the gradients reach the stacked leaves that the
optimizer updates in place.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.utils.checkpoint

from repro_torch.core.weight_plan import (
    PackedLinear,
    QuantLinear,
    ShardedLeaf,
    flatten_leaves,
    map_tree,
    unflatten_leaves,
)
from repro_torch.device import resolve_device
from repro_torch.distributed import shardlib as sl
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import recurrent as R
from repro_torch.models import ssm as SSM


def find_unit(kinds: tuple) -> tuple:
    """Factor a kind sequence into (unit, n_units, remainder), maximizing
    scanned coverage (ties -> shortest unit), as the reference does."""
    Ln = len(kinds)

    def cost(unit, rem):
        return len(unit) + len(rem_runs(rem))

    best = (kinds, 1, ())
    best_cost = cost(kinds, ())
    for p in range(1, min(Ln, 12) + 1):
        unit = kinds[:p]
        k = 0
        while (k + 1) * p <= Ln and kinds[k * p:(k + 1) * p] == unit:
            k += 1
        if k < 1:
            continue
        rem = kinds[p * k:]
        c = cost(unit, rem)
        if c < best_cost or (c == best_cost and p * k > len(best[0]) * best[1]):
            best = (unit, k, rem)
            best_cost = c
    return best


def rem_runs(rem: tuple) -> list:
    """Group the remainder into (kind, count) runs."""
    runs = []
    for kind in rem:
        if runs and runs[-1][0] == kind:
            runs[-1][1] += 1
        else:
            runs.append([kind, 1])
    return [(k, c) for k, c in runs]


ATTN_KINDS = ("global", "local")
LAYER_KINDS = ATTN_KINDS + ("rec", "mlstm", "slstm")


def check_supported(cfg):
    """Raise NotImplementedError for a config the port does not serve: a
    layer kind outside ``LAYER_KINDS``.  Every config of the reference's
    registry passes, logit softcaps included."""
    unknown = sorted(set(cfg.layer_kinds) - set(LAYER_KINDS))
    if unknown:
        raise NotImplementedError(f"{cfg.name}: layer kinds {unknown} are not ported "
                                  f"(the port has {LAYER_KINDS})")


def attn_shapes(cfg) -> dict:
    """The q/k/v/o projections of one attention block as (shape, init)."""
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"wq": ((d, H * hd), "dense"), "wk": ((d, KVH * hd), "dense"),
            "wv": ((d, KVH * hd), "dense"), "wo": ((H * hd, d), "dense")}


def mlp_shapes(cfg) -> dict:
    """A dense MLP's up/down (and, gated, gate) projections as (shape, init)."""
    d, f = cfg.d_model, cfg.d_ff
    mlp = {"w_up": ((d, f), "dense"), "w_down": ((f, d), "dense")}
    if cfg.activation in L.GATED:
        mlp["w_gate"] = ((d, f), "dense")
    return mlp


def _layer_shapes(cfg, kind: str) -> dict:
    """{name: (shape, init)} of one layer of ``kind`` (``make_params`` lists
    the inits), named as the reference's ``init_layer`` names them: an
    attention layer's FFN is ``moe`` (``moe.moe_shapes``) for a MoE config,
    else ``mlp``; a ``rec`` layer is ln1 / rec / ln2 / mlp, an ``mlstm`` or
    ``slstm`` layer ln / cell."""
    norm = L.norm_shapes(cfg.d_model, cfg.norm)
    if kind in ATTN_KINDS:
        layer = {"ln1": norm, "attn": attn_shapes(cfg), "ln2": norm}
        if cfg.moe is not None:
            layer["moe"] = MOE.moe_shapes(cfg)
        else:
            layer["mlp"] = mlp_shapes(cfg)
        return layer
    if kind == "rec":
        return {"ln1": norm, "rec": R.rglru_shapes(cfg), "ln2": norm, "mlp": mlp_shapes(cfg)}
    if kind == "mlstm":
        return {"ln": norm, "cell": SSM.mlstm_shapes(cfg)}
    if kind == "slstm":
        return {"ln": norm, "cell": SSM.slstm_shapes(cfg)}
    raise ValueError(kind)


def stack_shapes(tree, n: int) -> dict:
    """A tree of (shape, init) leaves stacked over ``n`` layers."""
    return {k: stack_shapes(v, n) if isinstance(v, dict) else ((n,) + v[0], v[1])
            for k, v in tree.items()}


def param_shapes(cfg) -> dict:
    """The params tree of ``init_params`` as (shape, init) leaves."""
    check_supported(cfg)
    unit, n_units, rem = find_unit(cfg.layer_kinds)

    embed = {"tok": ((cfg.vocab, cfg.d_model), "embed")}
    if not cfg.tie_embeddings:  # a tied model unembeds through tok
        embed["head"] = ((cfg.d_model, cfg.vocab), "dense")
    return {
        "embed": embed,
        "final_norm": L.norm_shapes(cfg.d_model, cfg.norm),
        "unit": [stack_shapes(_layer_shapes(cfg, k), n_units) for k in unit],
        "rem": [stack_shapes(_layer_shapes(cfg, k), c) for k, c in rem_runs(rem)],
    }


def make_params(shapes, seed: int = 0, device=None, leaf_fn=None):
    """Random params of a tree of (shape, init) leaves, with the reference's
    scales: LeCun-normal matmul weights ("dense", fan-in = contraction
    axis), N(0, 0.02) embeddings ("embed"), "zeros" and "ones"; the
    recurrent cells' normal conv taps of std 0.1 ("conv"), gate vectors of
    std 0.5 ("gate") and recurrent matrices of std 1 / sqrt(hd)
    ("recurrent"), the RG-LRU's lambda ("lru_lambda") and forget-gate
    biases of 3 on part 1 of k of the last axis ("forget_bias/k").  Drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the CUDA
    device unless device="cpu"); this does not reproduce the reference's
    ``jax.random`` bits -- parity tests convert reference params through
    ``interop`` instead.  ``leaf_fn(path, leaf)``, where given, replaces
    each leaf as soon as it is drawn (``map_tree``'s paths): a caller that
    packs or moves each leaf never holds the whole tree (a full-width
    MoE's fp32 draw is 57 GB)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(node, path=""):
        join = (lambda k: f"{path}/{k}") if path else str
        if isinstance(node, dict):
            return {k: make(v, join(k)) for k, v in node.items()}
        if isinstance(node, list):
            return [make(v, join(i)) for i, v in enumerate(node)]
        leaf = draw(node)
        return leaf if leaf_fn is None else leaf_fn(path, leaf)

    def draw(node):
        shape, init = node
        if init in ("zeros", "ones"):
            fill = torch.zeros if init == "zeros" else torch.ones
            return fill(shape, dtype=torch.float32, device=dev)
        if init == "embed":
            return L.embed_init(shape, gen, dev)
        if init in _NORMAL_STD:
            std = _NORMAL_STD[init] or 1.0 / math.sqrt(shape[-1])
            return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * std
        if init == "lru_lambda":
            return R.lru_lambda(shape, gen, dev)
        if init.startswith("forget_bias/"):
            k = int(init.split("/")[1])
            b = torch.zeros(shape, dtype=torch.float32, device=dev)
            part = shape[-1] // k
            b[..., part:2 * part] = 3.0
            return b
        return L.dense_init(shape, gen, dev)

    return make(shapes)


# init -> the std of its normal draw (None: 1 / sqrt(last axis))
_NORMAL_STD = {"conv": 0.1, "gate": 0.5, "recurrent": None}


def count_params(shapes) -> int:
    """The number of parameters in a tree of (shape, init) leaves."""
    if isinstance(shapes, dict):
        return sum(count_params(v) for v in shapes.values())
    if isinstance(shapes, list):
        return sum(count_params(v) for v in shapes)
    return math.prod(shapes[0])


def init_params(cfg, seed: int = 0, *, device=None):
    """Random params of ``param_shapes(cfg)`` (``make_params``)."""
    return make_params(param_shapes(cfg), seed, device)


def n_params_exact(cfg) -> int:
    return count_params(param_shapes(cfg))


def layer_axes(cfg, kind: str) -> dict:
    """Logical axes of one layer of ``kind`` (``_layer_shapes``' tree)."""
    na = L.norm_axes(cfg.norm)
    if kind in ATTN_KINDS:
        a = {"ln1": na, "attn": L.attn_axes(), "ln2": na}
        if cfg.moe is not None:
            a["moe"] = MOE.moe_axes(cfg)
        else:
            a["mlp"] = L.mlp_axes(cfg)
        return a
    if kind == "rec":
        return {"ln1": na, "rec": R.rglru_axes(), "ln2": na, "mlp": L.mlp_axes(cfg)}
    if kind == "mlstm":
        return {"ln": na, "cell": SSM.mlstm_axes(cfg)}
    if kind == "slstm":
        return {"ln": na, "cell": SSM.slstm_axes(cfg)}
    raise ValueError(kind)


def _stack_axes(tree):
    """A layer's axes stacked over layers: a leading None (never sharded)."""
    if isinstance(tree, dict):
        return {k: _stack_axes(v) for k, v in tree.items()}
    return (None,) + tuple(tree)


def param_axes(cfg) -> dict:
    """Logical axes of ``init_params``' tree, the reference's: stacked
    leaves get a leading None."""
    unit, n_units, rem = find_unit(cfg.layer_kinds)
    return {
        "embed": L.embed_axes(cfg),
        "final_norm": L.norm_axes(cfg.norm),
        "unit": [_stack_axes(layer_axes(cfg, k)) for k in unit],
        "rem": [_stack_axes(layer_axes(cfg, k)) for k, _ in rem_runs(rem)],
    }


def _layer_leaf(node, i: int):
    """Layer ``i`` of a stacked leaf (views).  A packed leaf keeps row ``i``
    of its walk, on the host, as the reference's scan slices it: whether a
    leaf has a walk picks its kernel (B1 with, B4 without).  A rank's
    shard keeps its split."""
    if isinstance(node, ShardedLeaf):
        return dataclasses.replace(node, local=_layer_leaf(node.local, i))
    if isinstance(node, PackedLinear):
        return dataclasses.replace(
            node, blocks=node.blocks[i], block_rows=node.block_rows[i],
            counts=node.counts[i],
            scales=None if node.scales is None else node.scales[i],
            walk=None if node.walk is None else {k: v[i] for k, v in node.walk.items()})
    if isinstance(node, QuantLinear):
        return dataclasses.replace(node, q=node.q[i], s=node.s[i])
    return node[i]


def layer_view(tree, i: int) -> dict:
    """Layer ``i`` of a stacked params tree (views of its leaves)."""
    return map_tree(lambda _, n: _layer_leaf(n, i), tree)


def unstack(cfg, params) -> dict:
    """The per-layer view that ``prefill`` and ``decode_step`` take:
    {"embed", "final_norm", "layers": one params dict per layer in
    execution order (unit 0's positions, unit 1's, ..., then the remainder
    runs)}.  Built once when a model is set up; its leaves are views of the
    stacked tree's tensors.  A tree that is already unstacked is returned
    as it is."""
    if "layers" in params:
        return params
    unit, n_units, rem = find_unit(cfg.layer_kinds)
    layers = [layer_view(params["unit"][pi], u) for u in range(n_units) for pi in range(len(unit))]
    for ri, (_, count) in enumerate(rem_runs(rem)):
        layers += [layer_view(params["rem"][ri], i) for i in range(count)]
    return {"embed": params["embed"], "final_norm": params["final_norm"], "layers": layers}


def init_layer_cache(cfg, kind: str, batch: int, length: int, dtype=torch.bfloat16,
                     kv_dtype=None, page_size=None, num_pages=None, device="cpu",
                     spec_k: int = 0):
    """One layer's cache.  An attention layer's KV cache takes ``kv_dtype``
    where given (torch.int8: the quantized cache), else ``dtype``;
    ``page_size``/``num_pages`` page a ``global`` layer; a ``local`` layer
    keeps its contiguous ring of ``min(length, local_window + spec_k)``
    slots either way -- the window already bounds it, which is what paging
    would buy.  ``spec_k`` (speculative decode) widens the ring because a
    verify step writes k+1 positions before it attends: with exactly
    ``window`` slots the newest draft entries would overwrite positions the
    earliest verify query still reads.  A ``rec``, ``mlstm`` or ``slstm``
    layer's state is a numerical integrator: it keeps ``dtype`` (its conv
    taps) and fp32 (the rest), never ``kv_dtype``, as in the reference."""
    if kind == "rec":
        return R.init_rglru_state(cfg, batch, dtype, device)
    if kind == "mlstm":
        return SSM.init_mlstm_state(cfg, batch, dtype, device)
    if kind == "slstm":
        return SSM.init_slstm_state(cfg, batch, dtype, device)
    dt = kv_dtype if kv_dtype is not None else dtype
    if kind == "global" and page_size is not None:
        return L.init_paged_attn_cache(cfg, num_pages, page_size, dt, device)
    ln = min(length, cfg.local_window + spec_k) if kind == "local" else length
    return L.init_attn_cache(cfg, batch, ln, dt, device)


# the page table is host-owned per replica (serving/paged.py): batch rides
# the data axes, the logical-page axis is never sharded
_PAGE_TABLE_AXES = sl.register_cache_kind(
    "page_table", ("batch", None), positional=True, paged=True)


def layer_cache_axes(kind: str, quantized_kv: bool = False, paged: bool = False) -> dict:
    """Logical axes of one layer's cache (``init_layer_cache``): a
    ``local`` layer keeps its contiguous ring when the global ones page."""
    if kind in ATTN_KINDS:
        if paged and kind == "global":
            return L.paged_attn_cache_axes(quantized_kv)
        return L.attn_cache_axes(quantized_kv)
    if kind == "rec":
        return R.rglru_state_axes()
    if kind == "mlstm":
        return SSM.mlstm_state_axes()
    if kind == "slstm":
        return SSM.slstm_state_axes()
    raise ValueError(kind)


def cache_axes(cfg, quantized_kv: bool = False, paged: bool = False) -> dict:
    """Logical axes of ``init_cache``'s tree: one dict per layer (the
    reference's per-layer axes without its stacked leading None) and the
    page table's."""
    axes = {"layers": [layer_cache_axes(k, quantized_kv, paged) for k in cfg.layer_kinds]}
    if paged:
        axes["page_table"] = _PAGE_TABLE_AXES
    return axes


def init_cache(cfg, batch: int, length: int, dtype=torch.bfloat16, kv_dtype=None,
               page_size=None, num_pages=None, device="cpu", spec_k: int = 0):
    """{"layers": one cache dict per layer, in execution order}.
    ``page_size``/``num_pages`` select the paged cache for the global
    layers and add a ``page_table`` (batch, ceil(length / page_size)) int32
    leaf, owned by the engine.  ``kv_dtype`` reaches the attention layers
    only and ``spec_k`` widens the local layers' rings
    (``init_layer_cache``)."""
    check_supported(cfg)
    cache = {"layers": [init_layer_cache(cfg, kind, batch, length, dtype, kv_dtype, page_size,
                                         num_pages, device, spec_k)
                        for kind in cfg.layer_kinds]}
    if page_size is not None:
        cache["page_table"] = torch.zeros((batch, -(-length // page_size)),
                                          dtype=torch.int32, device=device)
    return cache


def apply_layer(cfg, kind: str, p, x, *, cache, pos=None, page_table=None,
                use_kernel: bool = True, rows=None, seq: bool = False):
    """One layer of ``kind``; returns x.  For an attention layer ("global"
    or "local") ``pos`` None is the prefill over x (filling the contiguous
    cache), else a decode step at ``pos``; the kind sets the window and the
    RoPE base (``layers.attn_window_and_base``).  A recurrent or xLSTM
    layer runs its cell over x from its state and writes the new state
    into ``cache`` in place (positions play no part).  ``rows``: a data
    replica's rows of the batch on a mesh (``layers.apply_attn``; at
    prefill, where a cache cut along its sequence takes them).
    ``seq`` (a prefill under sequence parallelism): x is the rank's piece
    of the sequence, each block's input gathered whole and its output cut
    (``layers.block_input``, ``weight_plan.residual_linear``)."""
    if kind not in ATTN_KINDS:
        return _apply_recurrent_layer(cfg, kind, p, x, cache, seq)
    h = L.block_input(p["ln1"], x, cfg.norm, seq)
    if pos is None:
        a = _attn_prefill(cfg, p["attn"], h, kind, cache, use_kernel=use_kernel, seq=seq,
                          batch_split=rows is not None)
    else:
        a = L.apply_attn(cfg, p["attn"], h, kind=kind, cache=cache, pos=pos,
                         page_table=page_table, use_kernel=use_kernel, rows=rows)
    x = x + a
    h = L.block_input(p["ln2"], x, cfg.norm, seq)
    if "moe" in p:  # routed over all of h's B * S tokens, as the reference's step does
        return x + MOE.apply_moe(cfg, p["moe"], h, seq=seq)
    return x + L.apply_mlp(cfg, p["mlp"], h, seq)


_CELLS = {"rec": R.apply_rglru, "mlstm": SSM.apply_mlstm, "slstm": SSM.apply_slstm}


def _apply_recurrent_layer(cfg, kind: str, p, x, state, seq: bool = False):
    """A ``rec`` layer (norm, RG-LRU, residual, norm, MLP, residual) or an
    ``mlstm`` / ``slstm`` one (norm, cell, residual); the cell's new state
    is copied into ``state``.  ``state`` None (training) runs the cell from
    a zero state and keeps nothing.  Under sequence parallelism (``seq``)
    the cell's input is gathered whole before its scan."""
    cell = "rec" if kind == "rec" else "cell"
    h = L.block_input(p["ln1" if kind == "rec" else "ln"], x, cfg.norm, seq)
    y, new = _CELLS[kind](cfg, p[cell], h, state, seq=seq)
    if state is not None:
        for k, v in new.items():
            state[k].copy_(v)
    x = x + y
    if kind != "rec":
        return x
    h = L.block_input(p["ln2"], x, cfg.norm, seq)
    return x + L.apply_mlp(cfg, p["mlp"], h, seq)


def _attn_seq(cfg, p, h, kind: str, attend, seq: bool = False) -> tuple:
    """Full-sequence causal attention of an attention block (windowed on a
    ``local`` layer) through ``attend(q, k, v, causal=, window=,
    softcap=)``.  Returns (the block's output -- with ``seq`` the rank's
    piece of the sequence --, the roped K and V) -- what a prefill writes
    into its cache; the training forward writes none.  On a mesh the rank
    attends with its q heads (``layers.head_plan``) and K/V are its
    cache's KV heads."""
    B, Sq, _ = h.shape
    hp = L.head_plan(cfg)
    window, base = L.attn_window_and_base(cfg, kind)
    q, k, v = L.qkv_heads(cfg, p, h, hp)
    positions = torch.arange(Sq, device=h.device)[None].expand(B, Sq)
    q = L.apply_rope(q, positions, base)
    k = L.apply_rope(k, positions, base)
    kr, vr = L.read_heads(k, hp), L.read_heads(v, hp)
    if kr.shape[2] != k.shape[2]:  # a rank's group of a cache of every KV head
        kr, vr = kr.contiguous(), vr.contiguous()
    o = attend(q, kr, vr, causal=True, window=window, softcap=cfg.logit_softcap)
    return L.out_proj(cfg, p, o, hp, seq), k, v


def _attn_prefill(cfg, p, h, kind: str, cache, use_kernel: bool = True, seq: bool = False,
                  batch_split: bool = False):
    """Full-sequence causal attention (windowed on a ``local`` layer) that
    also fills the contiguous KV cache, in place; int8 caches get the
    quantized K/V of every position.  A local layer's ring of Sc < Sq slots
    keeps the last Sc positions, rolled so that slot = pos % Sc
    (``layers.fill_cache``).  Past ``dense_threshold`` the attention is
    kernel B6 on the card unless ``use_kernel=False``.  A cache cut along
    its sequence (``cache_seq``; ``batch_split``: the rows are a data
    replica's) takes the rank's slots of every KV head, the rank's K/V
    heads gathered first."""
    out, k, v = _attn_seq(cfg, p, h, kind, functools.partial(L.attention, use_kernel=use_kernel),
                          seq)
    piece = L.cache_seq_piece(cache["k"], batch_split)
    if piece is not None and k.shape[2] != cache["k"].shape[2]:
        k, v = sl.all_gather(k, "model", dim=2), sl.all_gather(v, "model", dim=2)
    if "k_scale" in cache:
        k, ks = L.quantize_kv(k)
        v, vs = L.quantize_kv(v)
        L.fill_cache(cache["k_scale"], ks, piece)
        L.fill_cache(cache["v_scale"], vs, piece)
    L.fill_cache(cache["k"], k, piece)
    L.fill_cache(cache["v"], v, piece)
    return out


def _run_layers(cfg, params, x, cache, pos=None, use_kernel: bool = True, rows=None,
                seq: bool = False):
    for kind, p, c in zip(cfg.layer_kinds, params["layers"], cache["layers"]):
        x = apply_layer(cfg, kind, p, x, cache=c, pos=pos, page_table=cache.get("page_table"),
                        use_kernel=use_kernel, rows=rows, seq=seq)
    return x


def embed_inputs(cfg, embed, tokens, extra_embeds=None) -> tuple:
    """(x, seq): the tokens' embeddings after the ``extra_embeds`` (a VLM's
    projected patches), and whether the active rules cut the residual
    stream on its sequence (``shardlib.seq_split``); if so x is the rank's
    piece of it."""
    S = tokens.shape[1] + (0 if extra_embeds is None else extra_embeds.shape[1])
    seq = sl.seq_split(S)
    if extra_embeds is None:
        return L.embed_tokens(cfg, embed, tokens, seq), seq
    x = L.embed_tokens(cfg, embed, tokens)
    x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return (sl.split_seq(x) if seq else x), seq


def prefill(cfg, params, tokens, cache, *, extra_embeds=None, use_kernel: bool = True):
    """Serving prefill into a contiguous cache: (last-position logits
    (B, 1, V), the filled cache).  ``params`` is the ``unstack`` view.
    ``extra_embeds`` (B, P, d) (a VLM's projected patches) go before the
    tokens' embeddings, at positions 0..P-1.  ``use_kernel=False`` runs the
    flash attention's plain version on the card (the params' own
    ``use_kernel`` fields switch B1, B2 and B5).  On a mesh whose data
    axis splits the batch the rank prefills its replica's rows into its
    piece of the cache and every rank returns the whole batch's logits, as
    ``decode_step`` does."""
    rows = sl.data_rows(tokens.shape[0])
    if rows is not None:
        tokens = tokens[rows]
        extra_embeds = None if extra_embeds is None else extra_embeds[rows]
    x, seq = embed_inputs(cfg, params["embed"], tokens, extra_embeds)
    x = _run_layers(cfg, params, x, cache, use_kernel=use_kernel, rows=rows, seq=seq)
    if seq:
        x = sl.gather_seq(x)
    x = L.apply_norm(params["final_norm"], x[:, -1:], cfg.norm)
    return sl.gather_batch(L.unembed(cfg, params["embed"], x), rows), cache


def decode_step(cfg, params, cache, tokens, pos, *, use_kernel: bool = True):
    """One decode step over T new tokens per sequence.  ``params`` is the
    ``unstack`` view; tokens (B, T) int, pos (B,) int32 absolute position
    of tokens[:, 0].  Returns (logits (B, T, V), cache); the cache is
    updated in place.  ``use_kernel=False`` runs the paged attention's
    plain version on the card.  On a mesh whose data axis splits the batch
    the rank decodes its replica's rows (``shardlib.data_rows``) and the
    logits of every row are gathered: each rank returns the same (B, T,
    V)."""
    rows = sl.data_rows(tokens.shape[0])
    tokens, pos = sl.shard(tokens, "batch", None), sl.shard(pos, "batch")
    x = L.embed_tokens(cfg, params["embed"], tokens)
    x = _run_layers(cfg, params, x, cache, pos=pos, use_kernel=use_kernel, rows=rows)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return sl.gather_batch(L.unembed(cfg, params["embed"], x), rows), cache


# ---------------------------------------------------------------------------
# training: the full-sequence forward and the next-token loss
# ---------------------------------------------------------------------------


def _check_dense(params):
    """Training takes the stacked tree of dense tensors of ``init_params``
    (on a mesh, this rank's pieces of them, a split matmul piece in a
    ``ShardedLeaf`` view): a compressed tree (a plan node) or the
    ``unstack`` view is refused."""
    if "layers" in params:
        raise ValueError("training takes the stacked params tree, not the unstack view")

    def one(path, node):
        if isinstance(node, ShardedLeaf) and sl.current_mesh() is not None:
            node = node.local
        if not isinstance(node, torch.Tensor):
            raise ValueError(f"training takes dense weights: {path} is a {type(node).__name__}")
        return node

    map_tree(one, params)


def unbind_stack(tree, n: int) -> list:
    """``n`` dicts of ``unbind`` views of a tree stacked over ``n`` layers."""
    parts = [t.unbind(0) for t in flatten_leaves(tree)]
    return [unflatten_leaves(tree, [u[i] for u in parts]) for i in range(n)]


def _unbind_layers(cfg, params) -> list:
    """One params dict per layer, in execution order (``unstack``'s),
    made of ``unbind`` views of the stacked leaves.  Taken inside the
    recorded step, so each stacked leaf gets its layers' gradients through
    one backward node (a stack of them), and an in-place optimizer update
    between steps meets no stale view."""
    unit, n_units, rem = find_unit(cfg.layer_kinds)
    per_unit = [unbind_stack(t, n_units) for t in params["unit"]]
    layers = [per_unit[pi][u] for u in range(n_units) for pi in range(len(unit))]
    for ri, (_, count) in enumerate(rem_runs(rem)):
        layers += unbind_stack(params["rem"][ri], count)
    return layers


def _train_layer(cfg, kind: str, p, x, replicas: int = 1, seq: bool = False):
    """One layer without a cache, as the reference's ``apply_layer(mode=
    "train")``: returns (x, the MoE aux loss or None).  An attention layer
    is norm, attention (``layers.train_attention``), residual, norm, MLP or
    MoE FFN (routed over the ``replicas``' global batch), residual; a
    recurrent or xLSTM layer runs its cell from a zero state.  ``seq``:
    sequence parallelism (``apply_layer``)."""
    if kind not in ATTN_KINDS:
        return _apply_recurrent_layer(cfg, kind, p, x, None, seq), None
    h = L.block_input(p["ln1"], x, cfg.norm, seq)
    x = x + _attn_seq(cfg, p["attn"], h, kind, L.train_attention, seq)[0]
    h = L.block_input(p["ln2"], x, cfg.norm, seq)
    if "moe" in p:
        f, aux = MOE.apply_moe(cfg, p["moe"], h, return_aux=True, replicas=replicas, seq=seq)
        return x + f, aux
    return x + L.apply_mlp(cfg, p["mlp"], h, seq), None


def meta_tree(shapes):
    """A tree of (shape, init) leaves (``param_shapes``') as meta tensors:
    the whole leaves' shapes, nothing allocated."""
    if isinstance(shapes, dict):
        return {k: meta_tree(v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [meta_tree(v) for v in shapes]
    return torch.empty(shapes[0], device="meta")


def forward(cfg, params, tokens, extra_embeds=None):
    """Training/eval forward: (logits (B, S, V) over the full sequence, the
    layers' MoE aux losses summed in fp32 (0 without MoE)).  ``params`` is
    the stacked tree of dense tensors (``init_params``); ``extra_embeds``
    (B, P, d) go before the tokens' embeddings and their logits are
    dropped.  With ``cfg.remat`` each layer is rematerialized in the
    backward (``torch.utils.checkpoint``, the reference's per-layer
    ``jax.checkpoint``).

    Under an active mesh (``shardlib.use_mesh``) ``params`` holds this
    rank's pieces of the leaves, each split matmul piece in a
    ``ShardedLeaf`` view (``optimizer.Placement.views``), the rows are the
    data replica's, and the products run on the pieces through the model
    axis's collectives, which autograd goes through; the logits are whole
    on every model rank (``forward_local`` keeps a split vocabulary's
    columns).  A MoE FFN routes the global batch (all the replicas' rows,
    ``moe.apply_moe``).  Under a ``seq_sp`` rule the residual stream
    between blocks is the rank's piece of the sequence (Megatron's
    sequence parallelism, ``shardlib.seq_split``)."""
    logits, start, aux = forward_local(cfg, params, tokens, extra_embeds)
    return (logits if start is None else sl.gather_pieces(logits, "model")), aux


def forward_local(cfg, params, tokens, extra_embeds=None) -> tuple:
    """``forward``'s (logits, start, aux), the logits of a vocabulary that
    the model axis splits left as the rank's columns from ``start``
    (``layers.unembed_local``; start None: the whole vocabulary)."""
    check_supported(cfg)
    _check_dense(params)
    x, seq = embed_inputs(cfg, params["embed"], tokens, extra_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    replicas = sl.data_replicas()
    # a rematerialized layer reruns in the backward, on autograd's thread
    layer_fn = sl.carry_mesh(_train_layer)
    for kind, p in zip(cfg.layer_kinds, _unbind_layers(cfg, params)):
        if cfg.remat:
            x, a = torch.utils.checkpoint.checkpoint(layer_fn, cfg, kind, p, x, replicas, seq,
                                                     use_reentrant=False)
        else:
            x, a = _train_layer(cfg, kind, p, x, replicas, seq)
        if a is not None:
            aux = aux + a
    x = L.block_input(params["final_norm"], x, cfg.norm, seq)
    logits, start = L.unembed_local(cfg, params["embed"], x)
    if extra_embeds is not None:
        logits = logits[:, extra_embeds.shape[1]:]
    return logits, start, aux


def next_token_nll(logits, labels, start=None):
    """The mean next-token cross entropy: fp32 logsumexp minus the label's
    logit, averaged over the positions whose label is >= 0.  ``start`` not
    None: ``logits`` are this model rank's vocabulary columns from
    ``start`` (``forward_local``), and each position's term is the
    vocab-parallel cross entropy (``shardlib.vocab_nll``).  On a mesh the
    rows are a data replica's: the sum and the count are summed over the
    replicas before the division (``shardlib.reduce_batch``), so every rank
    holds the whole batch's mean, and its backward reaches the rank's own
    rows only."""
    labels = labels.long()
    mask = (labels >= 0).to(torch.float32)
    if start is not None:
        nll = sl.vocab_nll(logits, labels.clamp_min(0), start)
    else:
        lf = logits.to(torch.float32)
        label_logit = lf.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
        nll = torch.logsumexp(lf, dim=-1) - label_logit
    total, count = sl.reduce_batch(torch.sum(nll * mask)), sl.reduce_batch(torch.sum(mask))
    return total / torch.clamp(count, min=1.0)


def replica_rows(batch: dict) -> dict:
    """This data replica's rows of every leaf of a global ``batch`` on the
    active mesh -- tokens, labels and a family's frames or patches
    together -- (the batch as it is without one, or on a 1-wide data
    axis).  Raises ValueError for a batch the data replicas do not
    divide."""
    n = next(iter(batch.values())).shape[0]
    rows = sl.data_rows(n)
    if rows is None and sl.batch_axes():
        raise ValueError(f"a batch of {n} rows does not divide over the "
                         f"{sl.data_replicas()} data replicas")
    return batch if rows is None else {k: v[rows] for k, v in batch.items()}


def replica_loss(cfg, params, rows: dict, extra_embeds=None):
    """Next-token cross entropy (``next_token_nll``) plus the MoE aux loss
    of ``rows``, the replica's rows of the batch that ``replica_rows``
    cut (the whole batch without a mesh): {"tokens": (b, S), "labels":
    (b, S)}; ``extra_embeds`` (b, P, d) go before the tokens' embeddings
    (a VLM's, projected from the same rows' patches).  Returns (loss + aux,
    {"loss", "aux"}), the global batch's on every rank."""
    logits, start, aux = forward_local(cfg, params, rows["tokens"], extra_embeds)
    loss = next_token_nll(logits, rows["labels"], start)
    return loss + aux, {"loss": loss, "aux": aux}


def loss_fn(cfg, params, batch):
    """``replica_loss`` of the replica's rows of ``batch`` {"tokens": (B,
    S), "labels": (B, S)}: on a mesh ``batch`` is the global batch, cut
    once here."""
    return replica_loss(cfg, params, replica_rows(batch))
