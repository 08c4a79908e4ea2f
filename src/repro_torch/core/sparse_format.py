"""Block-sparse weight storage (port of the block part of
``repro/core/sparse_format.py``).

``BlockSparse`` stores the surviving (bk, bn) blocks of a (K, N) matrix
contiguously per block-column j: slots ``j*max_blocks .. j*max_blocks +
counts[j] - 1`` of ``blocks`` hold column j's survivors in ascending row
order, ``block_rows[j, s]`` is the activation row-block of slot s (the
paper's z_w analogue, Section 5.6) and the tail is zero padding.

``build_walk`` flattens that layout into the TPU kernel's pack-time block
list.  The Hopper kernels do not need it (one CTA per block-column walks
``block_rows[j, :counts[j]]`` directly), but ``PackedLinear`` still carries
it so pack parity with the reference covers it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.pruning import BlockPruneConfig, block_mask

# Per-step flag bits in the walk's ``flags`` array.
WALK_FIRST = 1  # first block of its output column: zero the accumulator
WALK_LAST = 2  # last block of its output column: run the epilogue + write
WALK_COMPUTE = 4  # real payload: fetch the block and MAC (clear => no-op)


@dataclasses.dataclass
class BlockSparse:
    """blocks (n_cols * max_blocks, bk, bn); block_rows (n_cols, max_blocks)
    int32; counts (n_cols,) int32; dense ``shape`` (K, N)."""

    blocks: torch.Tensor
    block_rows: torch.Tensor
    counts: torch.Tensor
    shape: tuple
    cfg: BlockPruneConfig

    @property
    def max_blocks(self) -> int:
        return self.block_rows.shape[1]


def to_block_sparse(w: torch.Tensor, q_prune: float,
                    cfg: BlockPruneConfig | None = None) -> BlockSparse:
    """Prune w to block sparsity q_prune and pack (see BlockSparse)."""
    cfg = cfg or BlockPruneConfig()
    K, N = w.shape
    bm = block_mask(w, q_prune, cfg).cpu().numpy()
    nrb, ncb = bm.shape
    wb = w.detach().to(torch.float32).cpu().numpy().reshape(nrb, cfg.bk, ncb, cfg.bn)
    counts = bm.sum(axis=0).astype(np.int32)
    mb = max(1, int(counts.max()))
    blocks = np.zeros((ncb * mb, cfg.bk, cfg.bn), np.float32)
    block_rows = np.zeros((ncb, mb), np.int32)
    for j in range(ncb):
        for s, i in enumerate(np.nonzero(bm[:, j])[0]):
            blocks[j * mb + s] = wb[i, :, j, :]
            block_rows[j, s] = i
    return BlockSparse(
        blocks=torch.from_numpy(blocks).to(w.device),
        block_rows=torch.from_numpy(block_rows).to(w.device),
        counts=torch.from_numpy(counts).to(w.device),
        shape=(K, N),
        cfg=cfg,
    )


def build_walk(block_rows, counts, mb: int) -> dict:
    """Flatten a per-column block list into the TPU kernel's walk: one entry
    per surviving block in (column, slot) order, flagged FIRST/LAST at column
    boundaries; an empty column gets one non-compute FIRST|LAST entry.
    Returns int32 numpy arrays ``idx``, ``rows``, ``cols``, ``flags``."""
    block_rows = np.asarray(block_rows)
    counts = np.asarray(counts)
    idx, rows, cols, flags = [], [], [], []
    for j in range(counts.shape[0]):
        c = int(counts[j])
        if c == 0:
            idx.append(j * mb)
            rows.append(0)
            cols.append(j)
            flags.append(WALK_FIRST | WALK_LAST)
            continue
        for s in range(c):
            idx.append(j * mb + s)
            rows.append(int(block_rows[j, s]))
            cols.append(j)
            f = WALK_COMPUTE
            if s == 0:
                f |= WALK_FIRST
            if s == c - 1:
                f |= WALK_LAST
            flags.append(f)
    return {
        "idx": np.asarray(idx, np.int32),
        "rows": np.asarray(rows, np.int32),
        "cols": np.asarray(cols, np.int32),
        "flags": np.asarray(flags, np.int32),
    }


def pad_walk(walk: dict, n_to: int) -> dict:
    """Pad a walk to ``n_to`` entries with no-op steps (flags 0) repeating
    the final entry's indices, so stacked slices share one layout."""
    n = walk["idx"].shape[0]
    if n == n_to:
        return walk
    if n > n_to:
        raise ValueError(f"walk of {n} entries cannot pad to {n_to}")
    pad = n_to - n

    def rep(a, fill=None):
        tail = np.full((pad,), a[-1] if fill is None else fill, np.int32)
        return np.concatenate([a, tail])

    return {
        "idx": rep(walk["idx"]),
        "rows": rep(walk["rows"]),
        "cols": rep(walk["cols"]),
        "flags": rep(walk["flags"], fill=0),
    }


def block_sparse_to_dense(s: BlockSparse) -> torch.Tensor:
    K, N = s.shape
    bk, bn = s.cfg.bk, s.cfg.bn
    out = torch.zeros((K, N), dtype=torch.float32, device=s.blocks.device)
    rows = s.block_rows.cpu().numpy()
    counts = s.counts.cpu().numpy()
    mb = s.max_blocks
    for j in range(rows.shape[0]):
        for k in range(int(counts[j])):
            i = int(rows[j, k])
            out[i * bk:(i + 1) * bk, j * bn:(j + 1) * bn] = s.blocks[j * mb + k]
    return out
