"""B1 and B4: block-sparse (optionally int8) matmuls -- wrappers, plain
versions and launch counters of ``csrc/block_sparse.cu`` (B1) and
``csrc/block_sparse_col.cu`` (B4).

B1 replaces ``repro/kernels/block_sparse.py:block_sparse_matmul_mc``.  What
bounds it on the H100: at decode, M (the live batch) is far below the
card's ~295 FLOP/byte balance point, so the weight stream bounds it --
surviving payload + scales + x + y over 3.35 TB/s; at prefill (M up to
2032) each block serves every row, and the bf16 tensor-core rate bounds
it.  Its design for bf16 x against an int8 payload (``csrc/wgmma_column.cuh``)
reads only the surviving blocks, one byte per int8 weight, through a ring
of bulk copies (payload) and TMA loads (x) that a producer warp keeps in
flight, converts each block exactly to bf16 in shared memory and
multiplies on ``wgmma`` with fp32 sums.  ``launch_plan`` picks the regime
from shapes the host knows: at prefill one CTA per (output block-column,
128-row M tile), so each block is streamed once per 128 rows; at decode
(M <= 64) one 64-row tile, with a column's blocks split over a cluster of
up to 8 CTAs whose partial sums rank 0 adds in rank order.  Pairs with an
fp32 operand run fp32 CUDA-core FMAs.

B4 replaces ``repro/kernels/block_sparse.py:block_sparse_matmul`` (line
84), the reference's per-column sweep for a packed weight without a walk.
It is bound as B1 is (bytes at decode, operations at prefill), and it runs
B1's design: it takes exactly B1's operands, and B1's schedule never reads
the walk either (a CTA loops over its column's live slots; the walk stays
on the host).  So its C entry launches ``wgmma_column.cuh``'s column body
under its own kernel name and launch counter, in the regime ``launch_plan``
picks for B1 -- on the same operands its output equals B1's bit for bit.

``block_sparse_matmul`` (B1) and ``block_sparse_matmul_col`` (B4) launch
their kernel for CUDA tensors and run the plain version for CPU tensors;
on CUDA the plain version runs only when the caller passes
``use_kernel=False``.

Both also take a stack of experts (a MoE layer's ``(E, d, f)`` leaf): x
``(E, M, K)`` against operands with the same lead dim E, in ONE launch
whose grid's z axis runs over the experts, as the reference's ``jax.vmap``
of the Pallas call adds a grid axis (``repro/core/weight_plan.py:870-873``).  Each
CTA offsets its expert's blocks, rows, counts, scales, x rows and y rows
by ``blockIdx.z``; x's TMA map spans all E * M rows, and a tile's rows past
its expert's M are read but never stored.  ``launch_plan`` counts the
E * n_cols CTAs.  A stacked launch adds one to ``launches`` and to
``stacked_launches``, and E to ``stacked_experts``; a launch on the fp32
CUDA-core body (fp32 x, or the fp32 payload of a ``block_sparse`` leaf)
adds one to ``fma_launches``, so ``launches - fma_launches`` ran ``wgmma``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

BLOCK = 128  # the kernel's (bk, bn) block edge
DECODE_MAX_M = 64  # up to this many rows, one 64-row tile and a cluster split
MAX_SPLIT = 8  # the portable cluster size
X_DTYPES = (torch.float32, torch.bfloat16)
W_DTYPES = (torch.int8, torch.float32)


def block_sparse_fp32(x, blocks, block_rows, scales=None) -> torch.Tensor:
    """fp32 y = x @ W by gather (the reference's ``_packed_ref_matmul``):
    x's row-blocks are selected by ``block_rows`` and contracted with every
    stored block; padded blocks are zero, so ``counts`` is not consulted."""
    M, K = x.shape
    n_cols, mb = block_rows.shape
    bk, bn = blocks.shape[1], blocks.shape[2]
    xsel = x.reshape(M, K // bk, bk)[:, block_rows.reshape(-1).long()]
    xsel = xsel.reshape(M, n_cols, mb, bk).to(torch.float32)
    bl = blocks.reshape(n_cols, mb, bk, bn).to(torch.float32)
    y = torch.einsum("mcsk,cskn->mcn", xsel, bl).reshape(M, n_cols * bn)
    if scales is not None:
        y = y * scales.to(torch.float32)
    return y


def block_sparse_matmul_plain(x, blocks, block_rows, counts, scales=None) -> torch.Tensor:
    """The plain PyTorch version of the kernel (output in x's dtype); a
    stack of experts runs the 2-D version once per expert."""
    if x.dim() == 3:
        return torch.stack([
            block_sparse_matmul_plain(x[e], blocks[e], block_rows[e], counts[e],
                                      None if scales is None else scales[e])
            for e in range(x.shape[0])])
    return block_sparse_fp32(x, blocks, block_rows, scales).to(x.dtype)


def check_operands(x, blocks, block_rows, counts, scales) -> None:
    """Raise on anything the CUDA kernel does not take.  x (M, K) pairs with
    one packed weight, x (E, M, K) with a stack of E: every operand then
    carries the same lead dim E."""
    dev = x.device
    if x.dim() not in (2, 3) or x.dtype not in X_DTYPES:
        raise ValueError(f"x must be 2-D or 3-D {X_DTYPES}, got {tuple(x.shape)} {x.dtype}")
    lead = tuple(x.shape[:-2])
    if block_rows.dim() != len(lead) + 2 or tuple(block_rows.shape[:-2]) != lead:
        raise ValueError(f"block_rows {tuple(block_rows.shape)} does not stack as x "
                         f"{tuple(x.shape)} does (lead dims {lead})")
    n_cols, mb = block_rows.shape[-2:]
    if blocks.dtype not in W_DTYPES or tuple(blocks.shape) != lead + (n_cols * mb, BLOCK, BLOCK):
        raise ValueError(f"blocks must be {lead + (n_cols * mb, BLOCK, BLOCK)} in {W_DTYPES}, "
                         f"got {tuple(blocks.shape)} {blocks.dtype}")
    if block_rows.dtype != torch.int32 or counts.dtype != torch.int32 \
            or tuple(counts.shape) != lead + (n_cols,):
        raise ValueError(f"block_rows {lead + (n_cols, mb)} and counts {lead + (n_cols,)} "
                         f"must be int32, got {tuple(counts.shape)} counts")
    if x.shape[-1] % BLOCK:
        raise ValueError(f"K={x.shape[-1]} is not a multiple of {BLOCK}")
    if scales is not None and (scales.dtype != torch.float32
                               or tuple(scales.shape) != lead + (n_cols * BLOCK,)):
        raise ValueError(f"scales must be float32 {lead + (n_cols * BLOCK,)}")
    for name, t in (("x", x), ("blocks", blocks), ("block_rows", block_rows),
                    ("counts", counts), ("scales", scales)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if blocks.data_ptr() % 16:
        raise ValueError("blocks must be 16-byte aligned (cp.async)")


def check_x_aligned(x) -> None:
    """The kernels copy x in 16-byte pieces (cp.async, TMA)."""
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (cp.async, TMA)")


def launch_plan(M: int, n_cols: int, mb: int, n_sm: int, n_stack: int = 1) -> tuple:
    """(bm, split) of B1 and B2 for an (M, K) x against ``n_cols`` output
    block-columns of ``mb`` slots each (B2: the larger of its two mb), on a
    card of ``n_sm`` SMs, for one weight or a stack of ``n_stack`` experts
    (M rows each, ``n_stack * n_cols`` columns in all) -- from shapes
    alone, never from ``counts``, which lie on the card and would
    synchronise every launch.

    Prefill (M > DECODE_MAX_M): 128-row tiles, no split.  Decode: one
    64-row tile, and each column's slots dealt round-robin to ``split``
    CTAs of a cluster (rank r takes slots r, r + split, ...): at most
    MAX_SPLIT, no more than the slots, and no more CTAs than three
    quarters of the SMs -- a cluster's CTAs must share one GPC, so the
    card runs fewer large clusters at once than it has SMs, and a launch
    that does not fit them all runs in two waves (PERF.md, the split
    sweep)."""
    if M > DECODE_MAX_M:
        return 128, 1
    return 64, max(1, min(MAX_SPLIT, mb, (3 * n_sm // 4) // max(1, n_stack * n_cols)))


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def regime(x, block_rows) -> tuple:
    """(bm, split) of a B1 or B4 launch on x against packed operands with
    ``block_rows``: ``launch_plan`` from host ints (x's rows, the columns and
    slots, the card's SMs, the experts of a stack)."""
    return launch_plan(x.shape[-2], *block_rows.shape[-2:], sm_count(x.device), n_experts(x))


def body_plan(x, blocks, block_rows) -> tuple:
    """(bm, split) a B1, B2 or B4 launch hands its C entry, which picks the
    body from it: ``regime``'s for bf16 x against an int8 payload (the
    ``wgmma`` body), (0, 1) for any other pair (fp32 x, or the fp32 payload
    of a ``block_sparse`` leaf: the CUDA-core body of
    ``csrc/fma_column.cuh``)."""
    if x.dtype == torch.bfloat16 and blocks.dtype == torch.int8:
        return regime(x, block_rows)
    return 0, 1


def _launch(fn, source: str, entry: str, x, blocks, block_rows, counts,
            scales) -> torch.Tensor:
    """Allocate y, launch C entry ``entry`` of library ``source`` on the
    body ``body_plan`` picks and count it on ``fn``; the operands have
    passed ``check_operands``."""
    M, K = x.shape[-2:]
    n_cols, mb = block_rows.shape[-2:]
    N = n_cols * BLOCK
    y = torch.empty(x.shape[:-1] + (N,), dtype=x.dtype, device=x.device)
    bm, split = body_plan(x, blocks, block_rows)
    lib = build.load(source)
    code = getattr(lib, entry)(
        build.ptr(x), build.ptr(blocks), build.ptr(block_rows), build.ptr(counts),
        build.ptr(scales), build.ptr(y), M, K, N, mb, n_experts(x),
        build.DTYPE_CODES[x.dtype], build.DTYPE_CODES[blocks.dtype], bm, split,
        build.stream_ptr(x.device))
    build.check(lib, code, entry)
    count_launch(fn, x, bm)
    return y


def n_experts(x) -> int:
    """The experts a launch covers: E for x (E, M, K), 1 for x (M, K)."""
    return x.shape[0] if x.dim() == 3 else 1


def count_launch(fn, x, bm: int) -> None:
    """One launch of ``fn`` on x with the ``bm`` of ``body_plan``; a stacked
    one also adds to ``stacked_launches`` and its E to ``stacked_experts``,
    and one on the CUDA-core body (bm 0) to ``fma_launches``."""
    fn.launches += 1
    if x.dim() == 3:
        fn.stacked_launches += 1
        fn.stacked_experts += x.shape[0]
    if bm == 0:
        fn.fma_launches += 1


def zero_counts(fn) -> None:
    fn.launches = fn.stacked_launches = fn.stacked_experts = fn.fma_launches = 0


def block_sparse_matmul(x, blocks, block_rows, counts, scales=None, *,
                        use_kernel: bool = True) -> torch.Tensor:
    """y (M, N) = x (M, K) @ W for the block-sparse W, in x's dtype.

    blocks (N/128 * mb, 128, 128) int8 or float32; block_rows (N/128, mb)
    and counts (N/128,) int32; scales (N,) float32 per-output-channel
    dequant scales or None.  A stack of E experts: x (E, M, K), each
    operand with the lead dim E, y (E, M, N), one launch.
    ``use_kernel=False`` runs the plain version on CUDA tensors too; x
    must be 16-byte aligned."""
    if not x.is_cuda or not use_kernel:
        return block_sparse_matmul_plain(x, blocks, block_rows, counts, scales)
    check_operands(x, blocks, block_rows, counts, scales)
    check_x_aligned(x)
    return _launch(block_sparse_matmul, "block_sparse", "bsmm_launch", x, blocks, block_rows,
                   counts, scales)


zero_counts(block_sparse_matmul)


# B4 computes B1's function (padded slots hold zero blocks, so the plain
# version need not consult counts; the kernel never reads them)
block_sparse_matmul_col_plain = block_sparse_matmul_plain


def block_sparse_matmul_col(x, blocks, block_rows, counts, scales=None, *,
                            use_kernel: bool = True) -> torch.Tensor:
    """y (M, N) = x (M, K) @ W through kernel B4, in x's dtype; operands as
    for ``block_sparse_matmul`` (also a stack of experts), and x 16-byte
    aligned (its tiles come by TMA).  ``use_kernel=False`` runs the plain version on
    CUDA tensors too."""
    if not x.is_cuda or not use_kernel:
        return block_sparse_matmul_col_plain(x, blocks, block_rows, counts, scales)
    check_operands(x, blocks, block_rows, counts, scales)
    check_x_aligned(x)
    return _launch(block_sparse_matmul_col, "block_sparse_col", "bsmm_col_launch", x, blocks,
                   block_rows, counts, scales)


zero_counts(block_sparse_matmul_col)
