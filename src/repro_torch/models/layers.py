"""Shared model layers (port of ``repro/models/layers.py``): RMSNorm and
LayerNorm, RoPE, GQA attention (dense and chunked flash prefill,
contiguous and paged decode, sliding windows, enc-dec cross-attention),
the int8 KV cache, the gated and ungated MLP, embedding
(with gemma's scale) and unembedding (tied or untied) -- what the
transformer, MoE, VLM and enc-dec families run, with gemma2-style logit
softcaps on the attention scores and the final logits where a config sets
``logit_softcap``.  Training attends through ``train_attention``: dense
attention under autograd, or past ``dense_threshold`` the
``FlashAttention`` Function (the reference's custom VJP: the chunked
forward, a backward that recomputes each tile from the saved log-sum-exp).

The reference's production layouts on a mesh: a contiguous cache cut
along its sequence (``cache_seq``: ``cache_seq_piece``, the owner's
writes, flash decoding's combine in ``decode_attention``), an fp8 (e4m3)
KV cache, the residual stream cut on its sequence (``seq_sp``:
``block_input``, ``weight_plan.residual_linear``) and the vocab-split
logits the training loss reads (``unembed_local``).

Functions take and return tensors in the reference's layouts: activations
(B, S, d), q (B, S, H, hd), KV caches (B, S, KVH, hd) and page pools
(num_pages, page_size, KVH, hd).  Where the reference returns an updated
cache (JAX donates the old buffer), the port writes into the cache in place
and says so.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import weight_plan as WP
from repro_torch.core.weight_plan import (
    GATE_ACTS,
    QuantLinear,
    ShardedLeaf,
    residual_linear,
    sharded_gate_up,
    sharded_linear,
)
from repro_torch.distributed import shardlib as sl
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def dense_init(shape, generator: torch.Generator, device, fan_in: Optional[int] = None):
    """LeCun-normal over the fan-in (the contraction axis, -2, by default)."""
    fan_in = shape[-2] if fan_in is None else fan_in
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return w.mul_(1.0 / math.sqrt(fan_in))  # in place: a stack of experts is GBs


def norm_shapes(d: int, kind: str = "rmsnorm") -> dict:
    """A norm's params as {name: (shape, init)}: RMSNorm's zero scale (it
    multiplies by 1 + scale), LayerNorm's unit scale and zero bias."""
    if kind == "rmsnorm":
        return {"scale": ((d,), "zeros")}
    return {"scale": ((d,), "ones"), "bias": ((d,), "zeros")}


def norm_axes(kind: str = "rmsnorm") -> dict:
    """A norm's logical axes (replicated: "d" maps to no mesh axis)."""
    if kind == "rmsnorm":
        return {"scale": ("d",)}
    return {"scale": ("d",), "bias": ("d",)}


def attn_axes() -> dict:
    """q/k/v shard their output features ("qkv"), o its input features."""
    return {"wq": ("d", "qkv"), "wk": ("d", "qkv"), "wv": ("d", "qkv"), "wo": ("qkv", "d")}


def mlp_axes(cfg) -> dict:
    a = {"w_up": ("d", "ff"), "w_down": ("ff", "d")}
    if cfg.activation in GATED:
        a["w_gate"] = ("d", "ff")
    return a


def embed_axes(cfg) -> dict:
    """The token table and the untied head shard on the vocabulary."""
    a = {"tok": ("vocab", "d")}
    if not cfg.tie_embeddings:
        a["head"] = ("d", "vocab")
    return a


def embed_init(shape, generator: torch.Generator, device):
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32) * 0.02


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------


def apply_norm(p, x, kind: str = "rmsnorm", eps: float = 1e-6):
    """RMSNorm ({"scale"}, scaled by 1 + scale) or LayerNorm ({"scale",
    "bias"}), in fp32, as the reference's ``apply_norm`` does."""
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"])
    else:
        c = xf - xf.mean(dim=-1, keepdim=True)
        var = (c * c).mean(dim=-1, keepdim=True)
        y = c * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def block_input(p, x, kind: str = "rmsnorm", seq: bool = False):
    """A block's normed input from the residual stream ``x``: ``apply_norm``
    of it, or with ``seq`` (sequence parallelism) the norm of the rank's
    piece of the sequence -- its params entering the piece's work through
    ``shardlib.fan_out`` -- gathered whole."""
    if not seq:
        return apply_norm(p, x, kind)
    return sl.gather_seq(apply_norm({k: sl.fan_out(v) for k, v in p.items()}, x, kind))


def rope_freqs(hd: int, base: float, device=None) -> torch.Tensor:
    return base ** (-torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S).  Each head is
    split in halves (not interleaved pairs), as in the reference."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, base, x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# int8 weights for serving
# ---------------------------------------------------------------------------


def quantize_for_serving(params, min_size: int = 16384):
    """int8-quantize the matmul weights into the ``QuantLinear`` form every
    dispatch takes: ``weight_plan.quantize_for_serving``, the
    quant-everywhere special case of ``weight_plan.compress`` (serving
    b_weight 4 -> 1, the paper's Section 4.1); a ``PlanConfig`` gives the
    pruning-composed representations."""
    return WP.quantize_for_serving(params, min_size=min_size)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _softcap(s, cap: float):
    return torch.tanh(s / cap) * cap if cap > 0.0 else s


def _chunk_mask(qpos, kpos, causal: bool, window: Optional[int]):
    """(n, c) bool mask from absolute positions: causal keeps k <= q, a
    window keeps k > q - window (layers.py:164-171 of the reference)."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > (qpos[:, None] - window)
    return m


def dense_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    softcap: float = 0.0, q_offset: int = 0):
    """Exact GQA attention with an (Sq, Sk) score tensor (small S); q (B,
    Sq, H, hd) at positions q_offset.., k/v (B, Sk, KVH, hd) at 0..Sk-1."""
    B, Sq, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KVH, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32), k.to(torch.float32)) * scale
    s = _softcap(s, softcap)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    mask = _chunk_mask(qpos, torch.arange(k.shape[1], device=q.device), causal, window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def flash_rows(qs, k, v, qpos, *, causal: bool, window: Optional[int], softcap: float,
               chunk_k: int, k_scale=None, v_scale=None, with_lse: bool = False):
    """Online softmax of pre-scaled fp32 queries ``qs`` (B, KVH, G, n, hd)
    at absolute positions ``qpos`` (n,) over k/v (B, Sk, KVH, hd) in key
    chunks of ``chunk_k``; (m, l, acc) stay in fp32.  Returns the
    normalized output (B, KVH, G, n, hd) in fp32.

    The last chunk is short: no key past Sk is read.  A masked score adds
    exactly nothing (p = 0), so a row that sees no key ends with l = 0,
    clamped at 1e-30, and writes 0.  P is rounded to V's dtype before PV
    (bf16 V: as the reference); int8 K/V (``k_scale``/``v_scale`` (B, Sk,
    KVH)) fold their scales into the scores and into P in fp32, as the
    Pallas kernel's fp32 dequantized tiles do.  ``with_lse`` also returns
    each row's log-sum-exp m + log(l) (B, KVH, G, n), which the backward
    of ``FlashAttention`` reads."""
    B, KVH, G, n, hd = qs.shape
    Sk = k.shape[1]
    dev = qs.device
    m = torch.full((B, KVH, G, n), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, G, n), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, G, n, hd), dtype=torch.float32, device=dev)
    def per_key(scale, j0):  # (B, c, KVH) scales -> (B, KVH, 1, 1, c)
        return scale[:, j0:j0 + chunk_k].to(torch.float32).permute(0, 2, 1)[:, :, None, None]

    for j0 in range(0, Sk, chunk_k):
        kj, vj = k[:, j0:j0 + chunk_k], v[:, j0:j0 + chunk_k]
        s = torch.einsum("bkgqd,bckd->bkgqc", qs, kj.to(torch.float32))
        if k_scale is not None:
            s = s * per_key(k_scale, j0)
        s = _softcap(s, softcap)
        mask = _chunk_mask(qpos, torch.arange(j0, j0 + kj.shape[1], device=dev), causal, window)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
        l = l * alpha + p.sum(dim=-1)
        pv = p.to(vj.dtype).to(torch.float32) if v_scale is None else p * per_key(v_scale, j0)
        acc = acc * alpha[..., None] + torch.einsum("bkgqc,bckd->bkgqd", pv, vj.to(torch.float32))
        m = m_new
    l = l.clamp_min(1e-30)
    o = acc / l[..., None]
    return (o, m + torch.log(l)) if with_lse else o


def flash_forward(q, k, v, causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0, softcap: float = 0.0, chunk_q: int = 512,
                  chunk_k: int = 512):
    """Exact attention in (chunk_q x chunk_k) tiles with an online softmax:
    the forward of the reference's ``layers.flash_attention`` (plain torch;
    what the CPU runs past ``dense_threshold``).  ``q_offset`` is the
    absolute position of q[:, 0].  q is scaled in its own dtype before QK^T,
    as the reference does.  Returns (o in q's dtype, the rows' log-sum-exp
    (B, KVH, G, Sq) in fp32)."""
    B, Sq, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qs = (q * (1.0 / math.sqrt(hd))).reshape(B, Sq, KVH, G, hd).permute(0, 2, 3, 1, 4)
    qs = qs.to(torch.float32)
    outs, lses = [], []
    for i0 in range(0, Sq, chunk_q):
        qpos = torch.arange(i0, min(i0 + chunk_q, Sq), device=q.device) + q_offset
        o, lse = flash_rows(qs[:, :, :, i0:i0 + chunk_q], k, v, qpos, causal=causal,
                            window=window, softcap=softcap, chunk_k=chunk_k, with_lse=True)
        outs.append(o)
        lses.append(lse)
    o = torch.cat(outs, dim=3)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype), torch.cat(lses, dim=3)


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, softcap: float = 0.0, chunk_q: int = 512,
                    chunk_k: int = 512):
    """The output of ``flash_forward`` (no autograd through its loops; the
    training path takes ``FlashAttention``)."""
    return flash_forward(q, k, v, causal, window, q_offset, softcap, chunk_q, chunk_k)[0]


def flash_backward(q, k, v, o, lse, do, causal: bool, window: Optional[int], q_offset: int,
                   softcap: float, chunk_q: int, chunk_k: int) -> tuple:
    """(dq, dk, dv) of ``flash_forward``, recomputing each (chunk_q x
    chunk_k) tile of probabilities from q, k and the saved log-sum-exp --
    the reference's ``_flash_bwd``: scores of the unscaled q times
    1/sqrt(hd) in fp32, P and dS rounded to K's dtype before their
    products (bf16 K: as the reference), the softcap's derivative 1 - t^2
    applied to dS, masked entries zero; dK and dV sum over the G query
    heads of their KV head.  Gradients are accumulated in fp32 and
    returned in the inputs' dtypes."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    dev = q.device

    def heads(x):  # (B, Sq, H, hd) -> (B, KVH, G, Sq, hd)
        return x.reshape(B, Sq, KVH, G, hd).permute(0, 2, 3, 1, 4)

    qh, doh = heads(q), heads(do.to(q.dtype))
    delta = (doh.to(f32) * heads(o).to(f32)).sum(dim=-1)  # rowsum(dO * O), (B, KVH, G, Sq)
    kf, vf = k.to(f32), v.to(f32)
    dq = torch.zeros((B, KVH, G, Sq, hd), dtype=f32, device=dev)
    dk = torch.zeros((B, Sk, KVH, hd), dtype=f32, device=dev)
    dv = torch.zeros((B, Sk, KVH, hd), dtype=f32, device=dev)
    for i0 in range(0, Sq, chunk_q):
        i1 = min(i0 + chunk_q, Sq)
        q_i, do_i = qh[:, :, :, i0:i1].to(f32), doh[:, :, :, i0:i1].to(f32)
        lse_i, delta_i = lse[..., i0:i1, None], delta[..., i0:i1, None]
        qpos = torch.arange(i0, i1, device=dev) + q_offset
        for j0 in range(0, Sk, chunk_k):
            j1 = min(j0 + chunk_k, Sk)
            k_j, v_j = kf[:, j0:j1], vf[:, j0:j1]
            s = torch.einsum("bkgqd,bckd->bkgqc", q_i, k_j) * scale
            dcap = None
            if softcap > 0.0:
                t = torch.tanh(s / softcap)
                s, dcap = t * softcap, 1.0 - t * t
            mask = _chunk_mask(qpos, torch.arange(j0, j1, device=dev), causal, window)
            s = torch.where(mask, s, torch.full_like(s, -1e30))
            p = torch.exp(s - lse_i)
            pc = p.to(k.dtype).to(f32)
            dv[:, j0:j1] += torch.einsum("bkgqc,bkgqd->bckd", pc, do_i)
            dp = torch.einsum("bkgqd,bckd->bkgqc", do_i, v_j)
            ds = p * (dp - delta_i)
            if dcap is not None:
                ds = ds * dcap
            ds = torch.where(mask, ds, torch.zeros_like(ds)).to(k.dtype).to(f32)
            dq[:, :, :, i0:i1] += torch.einsum("bkgqc,bckd->bkgqd", ds, k_j) * scale
            dk[:, j0:j1] += torch.einsum("bkgqc,bkgqd->bckd", ds, q_i) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """The reference's ``flash_attention`` custom VJP: ``flash_forward``
    forward, ``flash_backward`` backward.  It saves q, k, v, o and the
    log-sum-exp only -- no (S, S) residual.  ``forward_calls`` and
    ``backward_calls`` count its calls (a rematerialized layer runs its
    forward twice), as the kernel wrappers count ``.launches``."""

    forward_calls = 0
    backward_calls = 0

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, softcap, chunk_q, chunk_k):
        FlashAttention.forward_calls += 1
        o, lse = flash_forward(q, k, v, causal, window, q_offset, softcap, chunk_q, chunk_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, q_offset, softcap, chunk_q, chunk_k)
        return o

    @staticmethod
    def backward(ctx, do):
        FlashAttention.backward_calls += 1
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def _flash_chunks(Sq: int, Sk: int, chunk: int) -> tuple:
    """The reference's (chunk_q, chunk_k) for sequences past the dense
    threshold."""
    return min(chunk, max(128, Sq)), min(chunk, max(128, Sk))


def train_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    softcap: float = 0.0, dense_threshold: int = 1024, chunk: int = 512):
    """The training path's attention, differentiable on every device:
    ``dense_attention`` (autograd) while both q and k are at most
    ``dense_threshold`` long, else ``FlashAttention`` -- never kernel B6,
    which has no backward."""
    if q.shape[1] <= dense_threshold and k.shape[1] <= dense_threshold:
        return dense_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    cq, ck = _flash_chunks(q.shape[1], k.shape[1], chunk)
    return FlashAttention.apply(q, k, v, causal, window, 0, softcap, cq, ck)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, softcap: float = 0.0, dense_threshold: int = 1024,
              chunk: int = 512, use_kernel: bool = True):
    """Prefill attention: dense while both q and k are at most
    ``dense_threshold`` long, else flash -- kernel B6 for CUDA tensors
    (which caps the scores too, and raises for a ``q_offset``),
    the plain chunked ``flash_attention`` on the CPU or for
    ``use_kernel=False``."""
    if q.shape[1] <= dense_threshold and k.shape[1] <= dense_threshold:
        return dense_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                               q_offset=q_offset)
    if q.is_cuda and use_kernel:
        return ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                   softcap=softcap)
    cq, ck = _flash_chunks(q.shape[1], k.shape[1], chunk)
    return flash_attention(q, k, v, causal, window, q_offset, softcap, cq, ck)


@dataclasses.dataclass(frozen=True)
class SeqPiece:
    """A rank's piece of a contiguous cache cut along its sequence (the
    ``cache_seq`` rule): the global ring's slots [first, first + the
    piece's length) of ``ring``, combined over the mesh ``axes``."""

    first: int
    ring: int
    axes: tuple


def cache_seq_piece(cache: torch.Tensor, batch_split: bool) -> Optional[SeqPiece]:
    """How the active rules cut a contiguous cache leaf (B, slots, ...)
    along its sequence (None: whole).  The cache's axes are (batch,
    cache_seq, kv_heads, ...): ``cache_seq``'s mesh axes, less those the
    batch took (``batch_split``: the rank holds its data replica's rows),
    cut the ring into equal pieces in rank order, as ``shardlib._resolve``
    and ``local_piece`` do, so the global ring is the piece's length times
    their ranks.  ``shardlib.local_zeros`` refuses a ring those axes do not
    divide, which would otherwise be read here as a piece."""
    mesh = sl.current_mesh()
    mapped = sl.current_rules().get("cache_seq") if mesh is not None else None
    if mapped is None:
        return None
    sizes, coords = sl.axis_sizes(mesh), sl.mesh_coords(mesh)
    used = set(sl.batch_axes()) if batch_split else set()
    axes = tuple(a for a in ((mapped,) if isinstance(mapped, str) else mapped)
                 if a in sizes and a not in used)
    n, idx = 1, 0
    for a in axes:
        n, idx = n * sizes[a], idx * sizes[a] + coords[a]
    if n == 1:
        return None
    slots = cache.shape[1]
    return SeqPiece(idx * slots, slots * n, tuple(a for a in axes if sizes[a] > 1))


def decode_attention(q, k_cache, v_cache, pos, *, window: Optional[int] = None,
                     softcap: float = 0.0, k_scale=None, v_scale=None, causal: bool = True,
                     piece: Optional[SeqPiece] = None):
    """Attention of T new tokens per sequence against a ring-buffer cache of
    length S (slot i holds the newest position p with p % S == i).  Query t
    sits at pos + t and sees kv_pos <= pos + t; ``causal=False`` gives every
    query the view [0, pos] (enc-dec cross-attention over a static pool of
    pos + 1 frames).

    int8 caches (``k_scale``/``v_scale`` (B, S, KVH)) fold their scales into
    the score and probability tensors: (q . k*s) == (q . k) * s and
    p @ (v*s) == (p*s) @ v.  An fp8 cache (``torch.float8_e4m3fn``) rounds
    q and the probabilities to e4m3 as the reference's ``astype`` does, and
    contracts in fp32.

    ``piece`` (flash decoding): the cache is the rank's slots of a ring cut
    along its sequence (``cache_seq_piece``); the rank's scores take their
    global slots' positions, and the softmax and the output combine over
    ``piece.axes``: an all-reduce MAX of the rows' maxima, a SUM of the
    rescaled exponentials, then a SUM of the partial outputs of the
    normalized probabilities (rounded to V's dtype as the whole ring's
    are)."""
    B, S, KVH, hd = k_cache.shape
    T, H = q.shape[1], q.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qg = q.reshape(B, T, KVH, G, hd)
    if k_scale is None:
        s = torch.einsum("btkgd,bskd->bkgts", qg.to(k_cache.dtype).to(torch.float32),
                         k_cache.to(torch.float32)) * scale
    else:
        s = torch.einsum("btkgd,bskd->bkgts", qg.to(torch.float32),
                         k_cache.to(torch.float32)) * scale
        s = s * k_scale.to(torch.float32).permute(0, 2, 1)[:, :, None, None, :]
    s = _softcap(s, softcap)
    first, ring = (piece.first, piece.ring) if piece is not None else (0, S)
    newest = pos[:, None].long() + ((T - 1) if causal else 0)  # (B, 1)
    slot = torch.arange(first, first + S, device=dev)[None]
    kv_pos = newest - ((newest - slot) % ring)  # (B, S) absolute position per slot
    q_pos = pos[:, None].long() + (torch.arange(T, device=dev)[None] if causal else 0)
    q_pos = q_pos.expand(B, T)  # (B, T)
    mask = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        mask &= kv_pos[:, None, :] > (q_pos[:, :, None] - window)
    mask = mask[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    if piece is None:
        p = torch.softmax(s, dim=-1)
    else:
        m = sl.all_reduce_axes(s.amax(dim=-1), piece.axes, dist.ReduceOp.MAX)
        e = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
        p = e / sl.all_reduce_axes(e.sum(dim=-1), piece.axes)[..., None]
    if v_scale is None:
        o = torch.einsum("bkgts,bskd->btkgd", p.to(v_cache.dtype).to(torch.float32),
                         v_cache.to(torch.float32))
    else:
        pv = p * v_scale.to(torch.float32).permute(0, 2, 1)[:, :, None, None, :]
        o = torch.einsum("bkgts,bskd->btkgd", pv, v_cache.to(torch.float32))
    if piece is not None:
        o = sl.all_reduce_axes(o, piece.axes)
    return o.reshape(B, T, H, hd).to(q.dtype)


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) int8 quantization of K or V (..., hd): int8 values
    and fp32 scales without the hd axis.  torch.round rounds half to even,
    as jnp.round does."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _cache_update(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                  piece: Optional[SeqPiece] = None) -> torch.Tensor:
    """Write T new (B, T, ...) entries at positions pos..pos+T-1 (mod the
    ring length), IN PLACE (the reference donates the cache instead).  For
    a ``piece`` of a ring cut along its sequence only the owner of a
    position's global slot writes it: one token at a time, each row writing
    its slot's new value or, on another rank's slot, the value it holds."""
    S = cache.shape[1]
    B, T = new.shape[:2]
    b = torch.arange(B, device=pos.device)
    if piece is None:
        idx = (pos[:, None].long() + torch.arange(T, device=pos.device)[None]) % S
        cache[b[:, None], idx] = new.to(cache.dtype)
        return cache
    for t in range(T):
        g = (pos.long() + t) % piece.ring - piece.first
        mine = ((g >= 0) & (g < S)).view((B,) + (1,) * (new.dim() - 2))
        idx = g.clamp(0, S - 1)
        cache[b, idx] = torch.where(mine, new[:, t].to(cache.dtype), cache[b, idx])
    return cache


def fill_cache(cache: torch.Tensor, new: torch.Tensor, piece: Optional[SeqPiece] = None):
    """Write a prompt's (B, Sq, ...) entries at positions 0..Sq-1 into a
    ring, IN PLACE: a ring of Sc < Sq slots keeps the last Sc positions,
    rolled so that slot = pos % Sc.  A ``piece`` (the rank's slots of a
    ring cut along its sequence) takes its slots of the global ring."""
    Sq = new.shape[1]
    first, ring = (piece.first, piece.ring) if piece is not None else (0, cache.shape[1])
    n = cache.shape[1]
    if ring >= Sq:
        cnt = max(0, min(n, Sq - first))
        if cnt:
            cache[:, :cnt] = new[:, first:first + cnt].to(cache.dtype)
    else:
        rolled = torch.roll(new[:, -ring:], Sq % ring, dims=1)
        cache.copy_(rolled[:, first:first + n].to(cache.dtype))
    return cache


def init_attn_cache(cfg, batch: int, length: int, dtype=torch.bfloat16, device="cpu"):
    """Contiguous KV cache for one attention layer; ``dtype=torch.int8``
    selects int8 payloads + per-(slot, head) fp32 scales."""
    KVH, hd = cfg.n_kv_heads, cfg.hd
    shape = (batch, length, KVH, hd)
    if dtype == torch.int8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# cache-kind registry entries (distributed/shardlib): the KV layouts
# register their logical axes and their serving classification here, where
# they are defined; the engine's cache placement reads the same entries.
_KV_AXES = sl.register_cache_kind(
    "attn.kv", ("batch", "cache_seq", "kv_heads", None), positional=True)
_KV_SCALE_AXES = sl.register_cache_kind(
    "attn.kv_scale", ("batch", "cache_seq", "kv_heads"), positional=True)


def attn_cache_axes(quantized: bool = False) -> dict:
    axes = {"k": _KV_AXES, "v": _KV_AXES}
    if quantized:
        axes["k_scale"] = _KV_SCALE_AXES
        axes["v_scale"] = _KV_SCALE_AXES
    return axes


# ---------------------------------------------------------------------------
# paged KV cache: per-layer pools of fixed-size pages + a page table
# ---------------------------------------------------------------------------
#
# Pools are (num_pages, page_size, KVH, hd); the host-side allocator
# (serving/paged.py) maps each slot's logical page to a physical page via
# the int32 table (B, pages_per_seq).  Position p lives at logical page
# p // page_size, slot p % page_size.  Physical page 0 is the null page:
# dead slots point at it, so their writes land there harmlessly.


def init_paged_attn_cache(cfg, num_pages: int, page_size: int, dtype=torch.bfloat16,
                          device="cpu"):
    KVH, hd = cfg.n_kv_heads, cfg.hd
    shape = (num_pages, page_size, KVH, hd)
    if dtype == torch.int8:
        return {"k_pages": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_pages": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale_pages": torch.zeros(shape[:3], dtype=torch.float32, device=device),
                "v_scale_pages": torch.zeros(shape[:3], dtype=torch.float32, device=device)}
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


# Pools have no batch axis: they shard over the model axis on kv_heads, and
# the page axes stay whole (the table maps any slot to any physical page).
_KV_PAGES_AXES = sl.register_cache_kind(
    "attn.kv_pages", (None, None, "kv_heads", None), positional=True, paged=True)
_KV_SCALE_PAGES_AXES = sl.register_cache_kind(
    "attn.kv_scale_pages", (None, None, "kv_heads"), positional=True, paged=True)


def paged_attn_cache_axes(quantized: bool = False) -> dict:
    axes = {"k_pages": _KV_PAGES_AXES, "v_pages": _KV_PAGES_AXES}
    if quantized:
        axes["k_scale_pages"] = _KV_SCALE_PAGES_AXES
        axes["v_scale_pages"] = _KV_SCALE_PAGES_AXES
    return axes


def paged_cache_update(pool, new, page_table, pos):
    """Scatter T new (B, T, ...) entries per sequence through the page
    table, IN PLACE.  Target pages are privately owned (the engine's
    copy-on-write guarantees it); dead slots write into the null page.
    Logical page indices past the table clamp to its last column, as the
    reference's gather does."""
    ps = pool.shape[1]
    B, T = new.shape[:2]
    dev = pos.device
    positions = pos[:, None].long() + torch.arange(T, device=dev)[None]  # (B, T)
    lp = (positions // ps).clamp(max=page_table.shape[1] - 1)
    phys = page_table[torch.arange(B, device=dev)[:, None], lp].long()
    pool[phys, positions % ps] = new.to(pool.dtype)
    return pool


def gather_pages(pool, page_table):
    """(num_pages, ps, ...) pool -> (B, pages_per_seq * ps, ...) logical view."""
    g = pool[page_table.long()]
    B, P, ps = g.shape[:3]
    return g.reshape((B, P * ps) + tuple(g.shape[3:]))


def paged_decode_attention(q, k_pages, v_pages, page_table, pos, *, window=None,
                           softcap: float = 0.0, k_scale_pages=None, v_scale_pages=None,
                           causal: bool = True, use_kernel: bool = True, kv_heads=None):
    """Attention for T new tokens per sequence through the page table:
    kernel B3 for CUDA tensors (unless ``use_kernel=False``), its plain
    version (gather + ``decode_attention``) otherwise.  ``causal=False``
    gives every query the positions [0, pos] (``decode_attention``).
    ``kv_heads`` (offset, count) reads those KV heads of the pools only."""
    return ops.paged_decode_attention(
        q, k_pages, v_pages, page_table, pos, window=window, softcap=softcap,
        k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages, causal=causal,
        use_kernel=use_kernel, kv_heads=kv_heads)


def cross_decode_attention(q, xk, xv, *, softcap: float = 0.0, use_kernel: bool = True):
    """Decode-time enc-dec cross-attention: T queries (B, T, H, hd) against
    a static encoder pool xk/xv (B, Sf, KVH, hd).  For CUDA tensors kernel
    B3 over an identity page table, non-causal at pos = Sf - 1
    (``ops.cross_decode_attention``); otherwise, and for
    ``use_kernel=False``, plain non-causal attention, as the reference's
    gather path runs it."""
    if q.is_cuda and use_kernel:
        return ops.cross_decode_attention(q, xk, xv, softcap=softcap)
    return attention(q, xk, xv, causal=False, softcap=softcap, use_kernel=use_kernel)


def finite_rows(logits: torch.Tensor) -> torch.Tensor:
    """(B,) bool: whether every logit in batch row b is finite."""
    return torch.isfinite(logits).flatten(1).all(dim=1)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """A rank's attention heads on the model axis of the active mesh: its
    q heads [q0, q0 + nq) (``q_split``: the rank's piece of H over the
    model axis, else all of them), the KV heads its cache holds [pool0,
    pool0 + npool) (its piece where the model axis divides the KV heads,
    else all; ``kv_split``: the former), and the KV heads its q heads read
    [kv0, kv0 + nkv)."""

    q0: int
    nq: int
    q_split: bool
    pool0: int
    npool: int
    kv0: int
    nkv: int
    kv_split: bool

    @property
    def kv_in_pool(self) -> tuple:
        """(offset, count) of the read KV heads within the cache's."""
        return self.kv0 - self.pool0, self.nkv


def head_plan(cfg) -> HeadPlan:
    """The rank's ``HeadPlan`` (every head without a mesh): q heads split
    by the "heads" rule, the cache's KV heads by "kv_heads", each where
    the model axis divides them.  Raises NotImplementedError for a q-head
    split whose heads do not map onto whole GQA groups or one group."""
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    G = H // KVH
    q_split = sl.spec_for((H,), "heads") == ("model",)
    kv_split = sl.spec_for((KVH,), "kv_heads") == ("model",)
    M, m = sl.axis_size("model"), sl.axis_index("model")
    q0, nq = (m * H // M, H // M) if q_split else (0, H)
    pool0, npool = (m * KVH // M, KVH // M) if kv_split else (0, KVH)
    kv0, kv_last = q0 // G, (q0 + nq - 1) // G
    nkv = kv_last - kv0 + 1
    if not (nq == nkv * G and q0 % G == 0 or nkv == 1):
        raise NotImplementedError(f"{cfg.name}: q heads [{q0}, {q0 + nq}) cut GQA groups of {G}")
    return HeadPlan(q0, nq, q_split, pool0, npool, kv0, nkv, kv_split)


def qkv_heads(cfg, p, x, hp: HeadPlan) -> tuple:
    """q (B, S, nq, hd) of the rank's q heads and k, v (B, S, npool, hd) of
    its cache's KV heads, each projected on the rank's shard of its weight
    and cut (or gathered, then cut) to those heads: contiguous, as the
    attention kernels take them."""
    B, S, _ = x.shape
    hd = cfg.hd

    def heads(w, h0, n):
        y, split = sharded_linear(x, w)
        return sl.cols(y, split, h0 * hd, n * hd).contiguous().reshape(B, S, n, hd)

    return (heads(p["wq"], hp.q0, hp.nq), heads(p["wk"], hp.pool0, hp.npool),
            heads(p["wv"], hp.pool0, hp.npool))


def out_proj(cfg, p, o, hp: HeadPlan, seq: bool = False):
    """The o-projection of o (B, S, nq, hd) on the rank's shard of ``wo``;
    the whole (B, S, d) on every rank, or with ``seq`` (sequence
    parallelism) the rank's piece of the sequence."""
    B, S = o.shape[:2]
    return residual_linear(o.reshape(B, S, hp.nq * cfg.hd), p["wo"], hp.q_split, seq)


def read_heads(t: torch.Tensor, hp: HeadPlan) -> torch.Tensor:
    """The read KV heads of a (B, S, npool, ...) cache tensor (a view)."""
    off, n = hp.kv_in_pool
    # every KV head, read by the rank's own q heads (a part of the pool, or
    # all of one a MQA model's ranks share): its gradient is summed over the
    # model ranks under autograd (``shardlib.fan_out``)
    if hp.q_split and not hp.kv_split:
        t = sl.fan_out(t)
    return t if n == t.shape[2] else t.narrow(2, off, n)


def attn_window_and_base(cfg, kind: str) -> tuple:
    """(window, RoPE base) of an attention layer of ``kind``: a ``local``
    layer attends within ``local_window``; a ``global`` one takes
    ``rope_base_global`` where the config sets one (gemma3)."""
    if kind == "local":
        return cfg.local_window, cfg.rope_base
    return None, cfg.rope_base_global or cfg.rope_base


def all_heads(cfg) -> HeadPlan:
    """The ``HeadPlan`` of every q and KV head (what a rank attends with
    over a cache cut along its sequence, which holds every KV head)."""
    return HeadPlan(0, cfg.n_heads, False, 0, cfg.n_kv_heads, 0, cfg.n_kv_heads, False)


def apply_attn(cfg, p, x, *, kind: str = "global", cache: dict, pos, page_table=None,
               use_kernel: bool = True, rows: Optional[slice] = None, rope: bool = True):
    """A decode step for S new tokens per sequence at ``pos``: writes their
    K/V into the cache in place -- through ``page_table`` for a paged cache
    ({"k_pages", ...}), at pos % length for a contiguous one (a ``local``
    layer's ring) -- and attends, within ``local_window`` on a local
    layer.  ``use_kernel`` reaches the paged attention dispatch;
    ``rope=False`` leaves q and k unrotated (the enc-dec decoder's learned
    positions).

    On a mesh (``distributed/shardlib``) the rank attends with its heads
    (``head_plan``) over its cache's KV heads, and ``x``/``pos`` are its
    data replica's ``rows`` of the engine batch: the page pools, which
    every data replica holds whole, take the whole batch's K/V (gathered
    over the data axis) through the whole ``page_table``; a contiguous
    cache holds the replica's rows only.  A contiguous cache cut along its
    sequence (``cache_seq``, ``cache_seq_piece``) holds every KV head: the
    rank gathers every q head and every new K/V head (T tokens: small),
    writes the K/V whose slots it owns, attends over its slots with the
    flash-decoding combine (``decode_attention``) and keeps its own heads
    for ``out_proj``."""
    B, S, _ = x.shape
    hp = head_plan(cfg)
    piece = None
    if "k_pages" not in cache:
        piece = cache_seq_piece(cache["k"], rows is not None)
        if piece is not None and cache["k"].shape[2] != cfg.n_kv_heads:
            raise NotImplementedError(f"{cfg.name}: a cache cut along its sequence over "
                                      f"{piece.axes} and on its KV heads")
    window, base = attn_window_and_base(cfg, kind)
    q, k, v = qkv_heads(cfg, p, x, hp if piece is None else all_heads(cfg))
    if rope:
        positions = pos[:, None].long() + torch.arange(S, device=x.device)[None]
        q = apply_rope(q, positions, base)
        k = apply_rope(k, positions, base)
    if "k_pages" in cache:
        k, v = sl.gather_batch(k, rows), sl.gather_batch(v, rows)
        pos_all = sl.gather_batch(pos, rows)
        if "k_scale_pages" in cache:
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
            paged_cache_update(cache["k_scale_pages"], ks, page_table, pos_all)
            paged_cache_update(cache["v_scale_pages"], vs, page_table, pos_all)
        paged_cache_update(cache["k_pages"], k, page_table, pos_all)
        paged_cache_update(cache["v_pages"], v, page_table, pos_all)
        o = paged_decode_attention(
            q, cache["k_pages"], cache["v_pages"],
            page_table if rows is None else page_table[rows], pos, window=window,
            softcap=cfg.logit_softcap, k_scale_pages=cache.get("k_scale_pages"),
            v_scale_pages=cache.get("v_scale_pages"), use_kernel=use_kernel,
            kv_heads=None if hp.nkv == hp.npool else hp.kv_in_pool)
    else:
        def write(name, new):
            c = _cache_update(cache[name], new, pos, piece)
            return c if piece is not None else read_heads(c, hp)

        ksc = vsc = None
        if "k_scale" in cache:
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
            ksc, vsc = write("k_scale", ks), write("v_scale", vs)
        kc, vc = write("k", k), write("v", v)
        o = decode_attention(q, kc, vc, pos, window=window, softcap=cfg.logit_softcap,
                             k_scale=ksc, v_scale=vsc, piece=piece)
        if piece is not None:  # the rank's own heads
            o = o[:, :, hp.q0:hp.q0 + hp.nq]
    return out_proj(cfg, p, o, hp)


# ---------------------------------------------------------------------------
# MLP, embedding, unembedding
# ---------------------------------------------------------------------------

GATED = ("silu", "swiglu", "geglu", "gelu_glu")


def apply_mlp(cfg, p, x, seq: bool = False):
    """The MLP on the rank's shards (the whole weights without a mesh): the
    hidden layer keeps the rank's "ff" columns into ``w_down``; ``seq``
    returns the rank's piece of the sequence (``out_proj``)."""
    if "w_gate" in p:
        # fused-pair node: a packed (w_gate, w_up) pair is ONE kernel launch
        h, hs = sharded_gate_up(x, p["w_gate"], p["w_up"], cfg.activation)
    else:
        h, hs = sharded_linear(x, p["w_up"])
        h = GATE_ACTS[cfg.activation](h)
    return residual_linear(h, p["w_down"], hs, seq)


def _cdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def embed_tokens(cfg, p, tokens, seq: bool = False):
    """Rows of the token table (an int8 table dequantized after the
    gather), times sqrt(d_model) in the compute dtype where the config
    scales embeddings (gemma): the scalar is rounded to that dtype first, as
    the reference's weakly typed Python scalar is.  ``seq`` (sequence
    parallelism) returns the rank's piece of the sequence: a vocab-split
    table's partial rows reduce-scattered, a whole one's cut."""
    tok = p["tok"]
    idx = tokens.long()
    if isinstance(tok, ShardedLeaf):
        # a vocab-sharded table: this rank's rows, masked, summed over the
        # model axis (one nonzero term per token: exact)
        tok = tok.local
        rows = (tok.q if isinstance(tok, QuantLinear) else tok).shape[0]
        local = idx - sl.axis_index("model") * rows
        mine = (local >= 0) & (local < rows)
        local = local.clamp(0, rows - 1)
        table = tok.q if isinstance(tok, QuantLinear) else tok
        x = torch.where(mine[..., None], table[local].to(_cdtype(cfg)), 0)
        x = sl.scatter_seq(x) if seq else sl.reduce_sum(x, "model")
    elif isinstance(tok, QuantLinear):
        x = tok.q[idx].to(_cdtype(cfg))
    else:
        x = tok[idx].to(_cdtype(cfg))
    if seq and not isinstance(p["tok"], ShardedLeaf):  # a whole table's rows: cut
        x = sl.split_seq(x)
    if isinstance(tok, QuantLinear):  # int8 table: dequantize the gathered rows
        x = x * tok.s.to(x.dtype)
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def unembed_local(cfg, p, x) -> tuple:
    """(logits, start): through the head where the model has one (any
    representation), else through the tied token table -- ``x @ tok.T``,
    and for an int8 table ``(x * s) @ q.T``: its scales lie on the
    contraction axis, so this product is plain torch, not kernel B5, which
    scales output channels (the reference contracts it with ``dot_general``
    outside any Pallas kernel as well).  A ``logit_softcap`` > 0 caps the
    logits in fp32 (cap * tanh(y / cap)) and rounds them back to x's dtype,
    as the reference does.  Where the vocab rule splits the head's columns
    or the table's rows over the model axis, the logits are the rank's
    vocabulary columns, ungathered, from ``start`` (the training loss reads
    them so, ``shardlib.vocab_nll``); else the whole vocabulary, start
    None."""
    if "head" in p:
        y, ys = sharded_linear(x, p["head"])
        return _cap_logits(cfg, y), (sl.axis_index("model") * y.shape[-1] if ys else None)
    tok, split = p["tok"], isinstance(p["tok"], ShardedLeaf)
    if split:  # the rank's vocab rows: x enters rank-specific work
        tok, x = tok.local, sl.fan_out(x)
    if isinstance(tok, QuantLinear):
        y = (x * tok.s.to(x.dtype)) @ tok.q.to(x.dtype).T
    else:
        y = x @ tok.T.to(x.dtype)
    return _cap_logits(cfg, y), (sl.axis_index("model") * y.shape[-1] if split else None)


def unembed(cfg, p, x):
    """The whole vocabulary's logits on every rank (``unembed_local``, a
    split vocabulary's columns gathered): serving's decode and prefill."""
    y, start = unembed_local(cfg, p, x)
    return y if start is None else sl.gather_pieces(y, "model")


def _cap_logits(cfg, y):
    if cfg.logit_softcap <= 0.0:
        return y
    return _softcap(y.to(torch.float32), cfg.logit_softcap).to(y.dtype)
