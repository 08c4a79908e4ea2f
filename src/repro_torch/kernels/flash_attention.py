"""B3: paged multi-query decode attention -- wrapper, plain version and
launch counter of ``csrc/paged_attention.cu``.

Replaces ``repro/kernels/flash_attention.py:paged_decode_attention``.  What
bounds it on the H100: bytes -- each sequence's pages (K and V payload plus
their int8 scales), q and o cross device memory once per step, over
3.35 TB/s.  Its design: one CTA per (sequence, KV head) scores all T*G
query rows of that head against each page while the page sits in shared
memory, dequantizes int8 on load, keeps an fp32 online softmax, and stops
at the last page that covers ``pos + T - 1``.

The plain version is the reference's gather path: gather the pages into a
contiguous view and run ``models.layers.decode_attention``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

Q_DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on Hopper


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, pos, *,
                                 window=None, softcap=0.0,
                                 k_scale_pages=None, v_scale_pages=None) -> torch.Tensor:
    """Gather each sequence's pages, then contiguous decode attention."""
    from repro_torch.models import layers as L  # layers imports this module

    kc = L.gather_pages(k_pages, page_table)
    vc = L.gather_pages(v_pages, page_table)
    ksc = vsc = None
    if k_scale_pages is not None:
        ksc = L.gather_pages(k_scale_pages, page_table)
        vsc = L.gather_pages(v_scale_pages, page_table)
    return L.decode_attention(q, kc, vc, pos, window=window, softcap=softcap,
                              k_scale=ksc, v_scale=vsc)


def _check(q, k_pages, v_pages, page_table, pos, k_scale_pages, v_scale_pages):
    if q.dim() != 4 or q.dtype not in Q_DTYPES:
        raise ValueError(f"q must be (B, T, H, hd) in {Q_DTYPES}, got {tuple(q.shape)} {q.dtype}")
    B, T, H, hd = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape or k_pages.shape[3] != hd:
        raise ValueError(f"k/v pages must be (num_pages, ps, KVH, {hd})")
    num_pages, ps, KVH, _ = k_pages.shape
    if H % KVH:
        raise ValueError(f"H={H} is not a multiple of KVH={KVH}")
    quant = k_scale_pages is not None
    if quant:
        if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
            raise ValueError("scale pools select int8 K/V pages")
        for s in (k_scale_pages, v_scale_pages):
            if s.dtype != torch.float32 or tuple(s.shape) != (num_pages, ps, KVH):
                raise ValueError(f"scale pools must be float32 ({num_pages}, {ps}, {KVH})")
    elif k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("unquantized K/V pages must have q's dtype")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError("page_table must be (B, pages_per_seq) int32")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (B,):
        raise ValueError("pos must be (B,) int32")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("pos", pos),
                    ("k_scale_pages", k_scale_pages), ("v_scale_pages", v_scale_pages)):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_decode_attention(q, k_pages, v_pages, page_table, pos, *, window=None,
                           softcap: float = 0.0, k_scale_pages=None,
                           v_scale_pages=None, use_kernel: bool = True) -> torch.Tensor:
    """Attention of q (B, T, H, hd) -- query t of sequence b at position
    pos[b] + t -- against the paged pools (num_pages, ps, KVH, hd) through
    page_table (B, pages_per_seq).  int8 pools come with (num_pages, ps,
    KVH) float32 scale pools.

    The table is clamped to [0, num_pages - 1] first (the reference's
    guardrail, ``repro/kernels/ops.py:251``): a corrupted entry reads a
    wrong but valid page instead of arbitrary memory."""
    page_table = page_table.clamp(0, k_pages.shape[0] - 1)
    if not q.is_cuda or not use_kernel:
        return paged_decode_attention_plain(
            q, k_pages, v_pages, page_table, pos, window=window, softcap=softcap,
            k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)
    page_table = page_table.contiguous()
    _check(q, k_pages, v_pages, page_table, pos, k_scale_pages, v_scale_pages)
    B, T, H, hd = q.shape
    _, ps, KVH, _ = k_pages.shape
    P = page_table.shape[1]
    lib = build.load("paged_attention")
    smem = lib.paged_decode_smem_bytes(T * (H // KVH), hd, ps)
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged attention needs {smem} bytes of shared memory "
                         f"(T*G={T * H // KVH}, hd={hd}, page {ps}); the limit is {SMEM_LIMIT}")
    out = torch.empty_like(q)
    code = lib.paged_decode_launch(
        build.ptr(q), build.ptr(k_pages), build.ptr(v_pages),
        build.ptr(k_scale_pages), build.ptr(v_scale_pages),
        build.ptr(page_table), build.ptr(pos), build.ptr(out),
        B, T, H, KVH, hd, P, ps, 1, int(window or 0), float(softcap),
        1.0 / math.sqrt(hd), build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k_pages.dtype],
        build.stream_ptr(q.device))
    build.check(lib, code, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
