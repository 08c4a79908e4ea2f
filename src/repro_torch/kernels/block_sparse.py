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
    """The plain PyTorch version of the kernel (output in x's dtype)."""
    return block_sparse_fp32(x, blocks, block_rows, scales).to(x.dtype)


def check_operands(x, blocks, block_rows, counts, scales) -> None:
    """Raise on anything the CUDA kernel does not take."""
    dev = x.device
    if x.dim() != 2 or x.dtype not in X_DTYPES:
        raise ValueError(f"x must be 2-D {X_DTYPES}, got {tuple(x.shape)} {x.dtype}")
    n_cols, mb = block_rows.shape
    if blocks.dtype not in W_DTYPES or tuple(blocks.shape) != (n_cols * mb, BLOCK, BLOCK):
        raise ValueError(f"blocks must be ({n_cols * mb}, {BLOCK}, {BLOCK}) in {W_DTYPES}, "
                         f"got {tuple(blocks.shape)} {blocks.dtype}")
    if block_rows.dtype != torch.int32 or counts.dtype != torch.int32 \
            or tuple(counts.shape) != (n_cols,):
        raise ValueError("block_rows (n_cols, mb) and counts (n_cols,) must be int32")
    if x.shape[1] % BLOCK:
        raise ValueError(f"K={x.shape[1]} is not a multiple of {BLOCK}")
    if scales is not None and (scales.dtype != torch.float32
                               or tuple(scales.shape) != (n_cols * BLOCK,)):
        raise ValueError(f"scales must be float32 ({n_cols * BLOCK},)")
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


def launch_plan(M: int, n_cols: int, mb: int, n_sm: int) -> tuple:
    """(bm, split) of B1 and B2 for an (M, K) x against ``n_cols`` output
    block-columns of ``mb`` slots each (B2: the larger of its two mb), on a
    card of ``n_sm`` SMs -- from shapes alone, never from ``counts``, which
    lie on the card and would synchronise every launch.

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
    return 64, max(1, min(MAX_SPLIT, mb, (3 * n_sm // 4) // max(1, n_cols)))


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def regime(x, block_rows) -> tuple:
    """(bm, split) of a B1 or B4 launch on x against packed operands with
    ``block_rows``: ``launch_plan`` from host ints (x's rows, the columns and
    slots, the card's SMs)."""
    return launch_plan(x.shape[0], *block_rows.shape, sm_count(x.device))


def _launch(source: str, entry: str, x, blocks, block_rows, counts, scales) -> torch.Tensor:
    """Allocate y and launch C entry ``entry`` of library ``source`` in the
    regime ``regime`` picks; the operands have passed ``check_operands``."""
    M, K = x.shape
    n_cols, mb = block_rows.shape
    N = n_cols * BLOCK
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = build.load(source)
    code = getattr(lib, entry)(
        build.ptr(x), build.ptr(blocks), build.ptr(block_rows), build.ptr(counts),
        build.ptr(scales), build.ptr(y), M, K, N, mb,
        build.DTYPE_CODES[x.dtype], build.DTYPE_CODES[blocks.dtype], *regime(x, block_rows),
        build.stream_ptr(x.device))
    build.check(lib, code, entry)
    return y


def block_sparse_matmul(x, blocks, block_rows, counts, scales=None, *,
                        use_kernel: bool = True) -> torch.Tensor:
    """y (M, N) = x (M, K) @ W for the block-sparse W, in x's dtype.

    blocks (N/128 * mb, 128, 128) int8 or float32; block_rows (N/128, mb)
    and counts (N/128,) int32; scales (N,) float32 per-output-channel
    dequant scales or None.  ``use_kernel=False`` runs the plain version
    on CUDA tensors too; x must be 16-byte aligned."""
    if not x.is_cuda or not use_kernel:
        return block_sparse_matmul_plain(x, blocks, block_rows, counts, scales)
    check_operands(x, blocks, block_rows, counts, scales)
    check_x_aligned(x)
    y = _launch("block_sparse", "bsmm_launch", x, blocks, block_rows, counts, scales)
    block_sparse_matmul.launches += 1
    return y


block_sparse_matmul.launches = 0


# B4 computes B1's function (padded slots hold zero blocks, so the plain
# version need not consult counts; the kernel never reads them)
block_sparse_matmul_col_plain = block_sparse_matmul_plain


def block_sparse_matmul_col(x, blocks, block_rows, counts, scales=None, *,
                            use_kernel: bool = True) -> torch.Tensor:
    """y (M, N) = x (M, K) @ W through kernel B4, in x's dtype; operands as
    for ``block_sparse_matmul``, and x 16-byte aligned (its tiles come by
    TMA).  ``use_kernel=False`` runs the plain version on
    CUDA tensors too."""
    if not x.is_cuda or not use_kernel:
        return block_sparse_matmul_col_plain(x, blocks, block_rows, counts, scales)
    check_operands(x, blocks, block_rows, counts, scales)
    check_x_aligned(x)
    y = _launch("block_sparse_col", "bsmm_col_launch", x, blocks, block_rows, counts, scales)
    block_sparse_matmul_col.launches += 1
    return y


block_sparse_matmul_col.launches = 0
