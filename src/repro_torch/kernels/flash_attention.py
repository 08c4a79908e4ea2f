"""B3 and B6: the attention kernels -- wrappers, plain versions and launch
counters of ``csrc/paged_attention.cu`` and ``csrc/flash_attention.cu``.

B3, paged multi-query decode attention, replaces
``repro/kernels/flash_attention.py:paged_decode_attention``.  What bounds
it on the H100: bytes and latency -- each sequence's pages (K and V
payload plus their int8 scales), q and o cross device memory once per
step, a few hundred KB, so the launch and the latency of a page weigh as
much as 3.35 TB/s.  Its design (``csrc/paged_attention.cu``): the live
pages of a (sequence, KV head) are dealt over a thread-block cluster of
``paged_split`` CTAs; in each CTA a producer warp keeps a ring of
``paged_stages`` pages in flight by TMA (int8 scales by cp.async) on
mbarriers, ``paged_groups`` groups of four consumer warps score their pages
(the four warps of a group splitting the T*G query rows) with an fp32
online softmax, and rank 0 combines the ranks' (m, l, acc) from
distributed shared memory in rank order.  Its plain version is the
reference's gather path: gather the pages into a contiguous view and run
``models.layers.decode_attention``.

B6, GQA flash attention forward (long prefill), replaces
``repro/kernels/flash_attention.py:flash_attention`` (line 105).  What
bounds it on the H100: operations -- 4 * hd flops per visible (query head,
key) pair on the bf16 tensor cores; a 2048-token causal prefill of
tinyllama moves 18.9 MB but does 17.2 GFLOP.  Its design for bf16 K/V (the
served path; see the source's note): a warp-specialised CTA per (batch x KV
head, 128 folded query rows) -- a producer warp streams 128-key K/V tiles
by TMA through an mbarrier ring, two consumer warpgroups run QK^T on
``wgmma`` from shared memory and PV on ``wgmma`` with P in registers, each
tile's softmax under the previous tile's PV; tiles wholly inside the band
run unmasked, tiles outside it are never loaded.  int8 K/V (off the main
path) keep the first port's ``mma.sync`` kernel.  A logit softcap (cap *
tanh(score / cap) on the scaled scores before the softmax, gemma2-style)
is a runtime argument of both bodies.  Its plain version is an fp32 online
softmax over key chunks (``models.layers.flash_rows``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import block_sparse as _bs
from repro_torch.kernels import build

Q_DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on Hopper


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, pos, *,
                                 window=None, softcap=0.0, k_scale_pages=None,
                                 v_scale_pages=None, causal: bool = True,
                                 kv_heads=None) -> torch.Tensor:
    """Gather each sequence's pages, then contiguous decode attention
    (non-causal: every query sees [0, pos]); ``kv_heads`` (offset, count)
    reads those KV heads of the pools only."""
    from repro_torch.models import layers as L  # layers imports this module

    if kv_heads is not None:
        k_pages, v_pages, k_scale_pages, v_scale_pages = (
            None if t is None else t.narrow(2, kv_heads[0], kv_heads[1])
            for t in (k_pages, v_pages, k_scale_pages, v_scale_pages))

    kc = L.gather_pages(k_pages, page_table)
    vc = L.gather_pages(v_pages, page_table)
    ksc = vsc = None
    if k_scale_pages is not None:
        ksc = L.gather_pages(k_scale_pages, page_table)
        vsc = L.gather_pages(v_scale_pages, page_table)
    return L.decode_attention(q, kc, vc, pos, window=window, softcap=softcap,
                              k_scale=ksc, v_scale=vsc, causal=causal)


PAGED_HEAD_DIMS = (64, 128, 256)  # the head dims of the repo's configs
# groups of consumer warps one CTA may run at each head dim (registers)
PAGED_MAX_GROUPS = {64: 4, 128: 2, 256: 1}
# CTAs of (hd, groups) one SM holds by registers (ptxas: about 92 a thread
# at hd 64, 128 at hd 128, 168 at hd 256; a CTA is 32 * (4 * groups + 1)
# threads of 65,536 registers an SM)
PAGED_CTAS_PER_SM = {(64, 4): 1, (64, 2): 2, (64, 1): 4, (128, 2): 1, (128, 1): 3,
                     (256, 1): 2}
PAGED_MAX_SPLIT = 8  # CTAs of a cluster (the portable limit)
PAGED_MAX_PAGE = 256  # slots of a page: a TMA box edge
PAGED_STAGE_BUDGET = 65536  # bytes of ring per CTA, within 3..8 stages
PAGED_MIN_STAGES, PAGED_MAX_STAGES = 3, 8


def _round_up(n: int, a: int) -> int:
    return -(-n // a) * a


def paged_stage_bytes(hd: int, ps: int, kv_dtype) -> int:
    """One ring stage of B3: the K and V tiles of a (page, KV head), each
    128-byte aligned for TMA, and for int8 their two scale vectors."""
    tile = _round_up(ps * hd * kv_dtype.itemsize, 128)
    scales = _round_up(ps * 4, 128) if kv_dtype == torch.int8 else 0
    return 2 * tile + 2 * scales


def paged_stages(hd: int, ps: int, kv_dtype) -> int:
    """Pages in flight per CTA: as many as PAGED_STAGE_BUDGET holds, 3 to 8."""
    return max(PAGED_MIN_STAGES,
               min(PAGED_MAX_STAGES, PAGED_STAGE_BUDGET // paged_stage_bytes(hd, ps, kv_dtype)))


def paged_smem_bytes(rows: int, hd: int, ps: int, kv_dtype, groups: int = 1) -> int:
    """Dynamic shared memory of a B3 launch over ``rows`` = T * G query rows
    with ``groups`` groups of consumer warps (``csrc/paged_attention.cu``'s
    Layout): q and each group's accumulator (rows x hd fp32 each), each
    group's m and l, each consumer warp's 2 x 16 probabilities, the ring,
    its mbarriers, 128 bytes of alignment."""
    stages = paged_stages(hd, ps, kv_dtype)
    ring = _round_up((1 + groups) * rows * hd * 4 + 2 * groups * rows * 4
                     + groups * 4 * 2 * 16 * 4, 128)
    return ring + stages * paged_stage_bytes(hd, ps, kv_dtype) + 2 * stages * 8 + 128


def paged_groups(rows: int, hd: int, ps: int, kv_dtype, pages_per_rank: int, ctas: int,
                 n_sm: int) -> int:
    """Groups of four consumer warps of a B3 launch of ``ctas`` CTAs, each
    group scoring its own pages: 4, 2 or 1 -- no more than the head dim's
    registers allow (PAGED_MAX_GROUPS), than a rank's share of the table,
    than the ring's stages (a group waits on the page ``groups`` ahead of its
    last one, and an mbarrier's parity tells only its last two phases
    apart), or than fit in shared memory (one group always fits what the
    wrapper admits); and only as many as keep the launch in one wave on
    three quarters of the SMs (clusters share a GPC, as ``launch_plan``
    allows for): a second wave costs more than the groups gain (PERF.md)."""
    cap = min(PAGED_MAX_GROUPS[hd], pages_per_rank, paged_stages(hd, ps, kv_dtype))
    for g in (4, 2):
        if g <= cap and ctas <= (3 * n_sm // 4) * PAGED_CTAS_PER_SM[hd, g] \
                and paged_smem_bytes(rows, hd, ps, kv_dtype, g) <= SMEM_LIMIT:
            return g
    return 1


def paged_max_rows(hd: int, ps: int, kv_dtype) -> int:
    """The largest T * G whose launch (one group of warps) fits SMEM_LIMIT."""
    lo, hi = 0, SMEM_LIMIT
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if paged_smem_bytes(mid, hd, ps, kv_dtype) <= SMEM_LIMIT:
            lo = mid
        else:
            hi = mid - 1
    return lo


def paged_split(B: int, KVH: int, pages_per_seq: int, n_sm: int) -> int:
    """CTAs per (sequence, KV head) of a B3 launch, from shapes alone (never
    from ``pos``, which lies on the card): enough clusters to give every SM
    two CTAs, at most PAGED_MAX_SPLIT and no more than the table's pages."""
    return max(1, min(PAGED_MAX_SPLIT, pages_per_seq, -(-2 * n_sm // max(1, B * KVH))))


def _check(q, k_pages, v_pages, page_table, pos, k_scale_pages, v_scale_pages, kv_heads):
    if q.dim() != 4 or q.dtype not in Q_DTYPES:
        raise ValueError(f"q must be (B, T, H, hd) in {Q_DTYPES}, got {tuple(q.shape)} {q.dtype}")
    B, T, H, hd = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape or k_pages.shape[3] != hd:
        raise ValueError(f"k/v pages must be (num_pages, ps, KVH, {hd})")
    num_pages, ps, KVH, _ = k_pages.shape
    off, n = kv_heads
    if off < 0 or n < 1 or off + n > KVH:
        raise ValueError(f"kv_heads {kv_heads} outside the pools' {KVH} KV heads")
    if H % n:
        raise ValueError(f"H={H} is not a multiple of the {n} KV heads read")
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
                           v_scale_pages=None, causal: bool = True,
                           use_kernel: bool = True, kv_heads=None) -> torch.Tensor:
    """Attention of q (B, T, H, hd) -- query t of sequence b at position
    pos[b] + t, seeing kv_pos <= pos[b] + t -- against the paged pools
    (num_pages, ps, KVH, hd) through page_table (B, pages_per_seq).  int8
    pools come with (num_pages, ps, KVH) float32 scale pools.
    ``causal=False`` gives every query the positions [0, pos[b]]: the
    enc-dec cross-attention over a sequence's frame pages, pos[b] its last
    frame (the stale tail of the last page lies past it).  ``kv_heads``
    (offset, count) reads only those KV heads of the pools, H / count query
    heads each: a rank's q heads against a pool that holds every KV head
    (a mesh whose model axis does not divide the KV heads), read in place,
    without a copy.

    The table is clamped to [0, num_pages - 1] first (the reference's
    guardrail, ``repro/kernels/ops.py:251``): a corrupted entry reads a
    wrong but valid page instead of arbitrary memory."""
    page_table = page_table.clamp(0, k_pages.shape[0] - 1)
    if not q.is_cuda or not use_kernel:
        return paged_decode_attention_plain(
            q, k_pages, v_pages, page_table, pos, window=window, softcap=softcap,
            k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages, causal=causal,
            kv_heads=kv_heads)
    page_table = page_table.contiguous()
    kv_heads = (0, k_pages.shape[2]) if kv_heads is None else tuple(kv_heads)
    _check(q, k_pages, v_pages, page_table, pos, k_scale_pages, v_scale_pages, kv_heads)
    B, T, H, hd = q.shape
    num_pages, ps, pool_kvh, _ = k_pages.shape
    kv_off, KVH = kv_heads
    P = page_table.shape[1]
    if hd not in PAGED_HEAD_DIMS:
        raise ValueError(f"head dim {hd}: paged attention kernel B3 takes {PAGED_HEAD_DIMS}")
    if ps > PAGED_MAX_PAGE:
        raise ValueError(f"pages of {ps} slots: kernel B3 takes at most {PAGED_MAX_PAGE}")
    smem = paged_smem_bytes(T * (H // KVH), hd, ps, k_pages.dtype)
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged attention needs {smem} bytes of shared memory "
                         f"(T*G={T * H // KVH}, hd={hd}, page {ps}); the limit is {SMEM_LIMIT}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (TMA)")
    n_sm = _bs.sm_count(q.device)
    split = paged_split(B, KVH, P, n_sm)
    groups = paged_groups(T * (H // KVH), hd, ps, k_pages.dtype, -(-P // split),
                          B * KVH * split, n_sm)
    lib = build.load("paged_attention")
    out = torch.empty_like(q)
    code = lib.paged_decode_launch(
        build.ptr(q), build.ptr(k_pages), build.ptr(v_pages),
        build.ptr(k_scale_pages), build.ptr(v_scale_pages),
        build.ptr(page_table), build.ptr(pos), build.ptr(out),
        B, T, H, KVH, hd, P, ps, num_pages, int(bool(causal)), int(window or 0), float(softcap),
        1.0 / math.sqrt(hd), build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k_pages.dtype],
        pool_kvh, kv_off, split, paged_stages(hd, ps, k_pages.dtype), groups,
        build.stream_ptr(q.device))
    build.check(lib, code, "paged_decode_attention")
    paged_decode_attention.launches += 1
    if causal:
        by_t = paged_decode_attention.launches_by_t
        by_t[T] = by_t.get(T, 0) + 1
    else:
        paged_decode_attention.launches_noncausal += 1
    return out


paged_decode_attention.launches = 0
# causal launches by query positions per sequence: T = 1 decode, T = k + 1 verify
paged_decode_attention.launches_by_t = {}
# non-causal launches (enc-dec cross-attention over frame pages)
paged_decode_attention.launches_noncausal = 0


# ---------------------------------------------------------------------------
# B6: flash attention forward
# ---------------------------------------------------------------------------

# the instantiated head dims: tinyllama's and llama3.2's 64, glm4's 128,
# gemma3's 256
FLASH_HEAD_DIMS = (64, 128, 256)
FLASH_BLOCK_K = 128  # the plain version's key chunk (the Pallas kernel's block_k)


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None, k_scale=None,
                          v_scale=None, softcap: float = 0.0) -> torch.Tensor:
    """B6's plain version: the Pallas kernel's arithmetic in PyTorch.  q is
    scaled by 1/sqrt(hd) in fp32, scores and the online softmax state are
    fp32, P is rounded to V's dtype before PV (bf16 V), and int8 K/V fold
    their per-(position, head) scales into the scores and into P in fp32;
    ``softcap`` > 0 caps the scaled scores (cap * tanh(s / cap)) before the
    mask, as the reference's jnp flash does.  Query i sits at position i,
    key j at j."""
    from repro_torch.models import layers as L  # layers imports this module

    B, Sq, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qs = q.to(torch.float32).reshape(B, Sq, KVH, G, hd).permute(0, 2, 3, 1, 4)
    qs = qs * (1.0 / math.sqrt(hd))
    o = L.flash_rows(qs, k, v, torch.arange(Sq, device=q.device), causal=causal,
                     window=window, softcap=softcap, chunk_k=FLASH_BLOCK_K,
                     k_scale=k_scale, v_scale=v_scale)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def _check_flash_features(q_offset):
    """B6 (and so its plain version) has no query offset, as the Pallas
    kernel has none."""
    if q_offset:
        raise ValueError(f"flash attention kernel B6 takes no q_offset (got {q_offset}): a "
                         "prefill continued from cached positions (a chunk of chunked "
                         "prefill) reads them through paged decode attention, kernel B3")


def _check_flash(q, k, v, k_scale, v_scale):
    """Raise ValueError on anything the CUDA kernel does not take."""
    if q.dim() != 4 or q.dtype != torch.bfloat16:
        raise ValueError(f"q must be (B, Sq, H, hd) bfloat16, got {tuple(q.shape)} {q.dtype}")
    B, Sq, H, hd = q.shape
    if hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel is built for {FLASH_HEAD_DIMS}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k/v must be (B={B}, Sk, KVH, hd={hd}) alike, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    Sk, KVH = k.shape[1], k.shape[2]
    if H % KVH:
        raise ValueError(f"H={H} is not a multiple of KVH={KVH}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if k_scale is not None:
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise ValueError("k_scale/v_scale select int8 K/V")
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or tuple(s.shape) != (B, Sk, KVH):
                raise ValueError(f"scales must be float32 ({B}, {Sk}, {KVH})")
    elif k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise ValueError(f"k/v must be bfloat16 (or int8 with scales), got {k.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("k_scale", k_scale), ("v_scale", v_scale)):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte loads, TMA)")


def flash_attention(q, k, v, *, causal: bool = True, window=None, k_scale=None,
                    v_scale=None, q_offset: int = 0, softcap: float = 0.0,
                    use_kernel: bool = True) -> torch.Tensor:
    """Flash attention forward of q (B, Sq, H, hd) against k/v (B, Sk, KVH,
    hd), GQA by H // KVH, query i at position i; optional int8 k/v with
    (B, Sk, KVH) float32 scales; ``softcap`` > 0 caps the scaled scores.
    ``q_offset`` is taken only to refuse it (ValueError): B6 has none.
    Ragged Sq and Sk need no padding."""
    _check_flash_features(q_offset)
    if not q.is_cuda or not use_kernel:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     k_scale=k_scale, v_scale=v_scale, softcap=softcap)
    _check_flash(q, k, v, k_scale, v_scale)
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    lib = build.load("flash_attention")
    out = torch.empty_like(q)
    code = lib.flash_attention_launch(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(k_scale), build.ptr(v_scale),
        build.ptr(out), B, Sq, Sk, H, KVH, hd, int(bool(causal)), int(window or 0),
        1.0 / math.sqrt(hd), float(softcap), build.DTYPE_CODES[k.dtype],
        build.stream_ptr(q.device))
    build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    if causal:
        by_w = flash_attention.launches_by_window
        by_w[int(window or 0)] = by_w.get(int(window or 0), 0) + 1
    else:
        flash_attention.launches_noncausal += 1
    return out


flash_attention.launches = 0
# causal launches by window: 0 = full causal, else the sliding window
flash_attention.launches_by_window = {}
# non-causal launches (the enc-dec encoder and cross-attention prefill)
flash_attention.launches_noncausal = 0
