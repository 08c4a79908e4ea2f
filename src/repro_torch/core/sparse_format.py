"""Sparse weight storage formats (port of ``repro/core/sparse_format.py``;
paper Section 5.6).

1. ``WZStream`` -- the paper's streaming format, bit-exact: each row of
   the sparse matrix is a sequence of ``(w, z_w)`` tuples (w the surviving
   weight in Q7.8, z_w the number of zeros before it, 5 bits unsigned),
   r = 3 tuples per 64-bit word (3 x 21 = 63 bits, top bit unused), so
   q_overhead = 64 / 48 = 1.333.  It is the storage format of the element
   masks that ``models.fcnet.forward_pruned`` runs on.  numpy only.
2. ``BlockSparse`` -- the surviving (bk, bn) blocks of a (K, N) matrix,
   stored contiguously per block-column j: slots ``j*max_blocks ..
   j*max_blocks + counts[j] - 1`` of ``blocks`` hold column j's survivors
   in ascending row order, ``block_rows[j, s]`` is the activation row-block
   of slot s (the z_w analogue) and the tail is zero padding.

``build_walk`` flattens the block layout into the TPU kernel's pack-time
block list.  The Hopper kernels do not need it (one CTA per block-column
walks ``block_rows[j, :counts[j]]`` directly), but ``PackedLinear`` still
carries it so pack parity with the reference covers it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.pruning import BlockPruneConfig, block_mask
from repro_torch.core.quantization import q78_encode

# ---------------------------------------------------------------------------
# The paper's (w, z)^r 64-bit word stream -- bit-exact software codec
# ---------------------------------------------------------------------------

Z_BITS = 5
Z_MAX = (1 << Z_BITS) - 1  # 31
W_BITS = 16
TUPLES_PER_WORD = 3  # r = 3 in the paper's design


@dataclasses.dataclass
class WZStream:
    """Encoded sparse matrix: per-row uint64 word streams.

    words:     list (len s_out) of np.uint64 arrays — one stream per row of
               W^(j) in the paper's orientation (rows = output neurons).
    n_tuples:  number of valid (w, z) tuples per row (tail of last word is
               padding: zero-weight tuples are skipped by decode via count).
    s_in:      row length of the dense matrix (columns of W^(j)).
    """

    words: list
    n_tuples: list
    s_in: int

    @property
    def total_words(self) -> int:
        return int(sum(len(w) for w in self.words))

    @property
    def total_bytes(self) -> int:
        return 8 * self.total_words

    def q_overhead(self) -> float:
        """Achieved storage overhead per surviving weight vs dense 16-bit."""
        n = sum(self.n_tuples)
        return self.total_bytes / max(1, n * 2)


def _pack_word(tuples) -> np.uint64:
    """Pack up to 3 (w_int16, z) tuples into one 64-bit word.

    Layout (LSB first): tuple0 bits [0,21), tuple1 [21,42), tuple2 [42,63);
    within a tuple: w in low 16 bits (two's complement), z in next 5 bits.
    """
    word = np.uint64(0)
    for i, (w, z) in enumerate(tuples):
        t = (np.uint64(np.uint16(w)) | (np.uint64(z) << np.uint64(16)))
        word |= t << np.uint64(21 * i)
    return word


def _unpack_word(word: np.uint64):
    out = []
    for i in range(TUPLES_PER_WORD):
        t = (word >> np.uint64(21 * i)) & np.uint64((1 << 21) - 1)
        w = np.int16(np.uint16(t & np.uint64(0xFFFF)))
        z = int(t >> np.uint64(16))
        out.append((w, z))
    return out


def encode_row(row: np.ndarray) -> tuple[np.ndarray, int]:
    """Encode one dense float row into the (w, z)^3 word stream.

    Zero runs longer than Z_MAX are split by inserting explicit zero-valued
    weights (w=0, z=Z_MAX) — the same escape the 5-bit field forces on the
    hardware design.
    Returns (uint64 words, n_tuples).
    """
    q = q78_encode(torch.from_numpy(np.asarray(row, np.float32))).numpy()
    tuples = []
    zeros = 0
    for v in q:
        if v == 0:
            zeros += 1
            while zeros > Z_MAX:
                tuples.append((np.int16(0), Z_MAX))
                zeros -= Z_MAX + 1
            continue
        tuples.append((np.int16(v), zeros))
        zeros = 0
    # NOTE: trailing zeros need no tuples — decode pads with zeros to s_in.
    n = len(tuples)
    words = []
    for i in range(0, n, TUPLES_PER_WORD):
        chunk = tuples[i : i + TUPLES_PER_WORD]
        words.append(_pack_word(chunk))
    return np.asarray(words, np.uint64), n


def decode_row(words: np.ndarray, n_tuples: int, s_in: int) -> np.ndarray:
    """Decode a word stream back to a dense float32 row of length s_in."""
    row = np.zeros(s_in, np.float32)
    pos = 0
    seen = 0
    for word in words:
        for w, z in _unpack_word(word):
            if seen >= n_tuples:
                break
            pos += z
            if w != 0:
                row[pos] = float(np.float32(w) / 256.0)
            pos += 1
            seen += 1
    return row


def encode_matrix(w: np.ndarray) -> WZStream:
    """Encode a dense (s_out, s_in) matrix, paper row orientation."""
    w = np.asarray(w, np.float32)
    words, counts = [], []
    for row in w:
        ws, n = encode_row(row)
        words.append(ws)
        counts.append(n)
    return WZStream(words=words, n_tuples=counts, s_in=w.shape[1])


def decode_matrix(s: WZStream) -> np.ndarray:
    rows = [decode_row(w, n, s.s_in) for w, n in zip(s.words, s.n_tuples)]
    return np.stack(rows).astype(np.float32)


def stream_addresses(words: np.ndarray, n_tuples: int):
    """The paper's offset-calculation IP (Section 5.6): absolute input
    addresses for each surviving weight,  address_l = l + sum_{k<l} z_k,
    computed iteratively per pipeline word with the carried offset o_reg."""
    addrs = []
    o_reg = 0
    seen = 0
    for word in words:
        tuples = _unpack_word(word)
        # address_i = o_reg + i + sum_{k<=i} z_k   (per the paper)
        zsum = 0
        for i, (w, z) in enumerate(tuples):
            if seen >= n_tuples:
                break
            zsum += z
            addrs.append(o_reg + i + zsum)
            seen += 1
        o_reg = addrs[-1] + 1 if addrs else o_reg
    return addrs


# ---------------------------------------------------------------------------
# Block-sparse format
# ---------------------------------------------------------------------------


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
