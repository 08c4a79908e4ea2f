"""B7: weight-stationary fully-connected layer -- wrapper, plain version,
launch counters and stream plan of ``csrc/batched_ffn.cu``.

Replaces ``repro/kernels/batched_ffn.py:batched_ffn``: y = act(x @ w + b)
with an fp32 accumulator and bias + activation in the epilogue.  What
bounds it on the H100: at the paper's batches (1..32) each weight feeds at
most 32 MACs, so the weight stream (K * N * 4 bytes for fp32 over
3.35 TB/s).  Its design (``csrc/stream_tile.cuh``, shared with B8) reads
every weight byte once per launch through a cp.async ring of 16 KB stages,
on a grid of (column strip, K slice) CTAs that ``stream_plan`` sizes to
cover the card, each strip's K sum split over a thread-block cluster whose
rank 0 adds the partial sums in rank order; the CTA's K slice of x is
staged once in shared memory and every thread multiplies a 4 x 4 weight
tile of each stage by all batch rows (the paper's batch processing).  MACs
are fp32 on the CUDA cores (no TF32).

``stream_plan`` is also B8's (``kernels/quant_matmul.q78_matmul``): strip
width, cluster split, rows per rank and the weight's copy width, from
shapes and the weight's address alone.  ``batched_ffn.launches`` counts
every launch, ``batched_ffn.width_launches[w]`` those whose weight was
copied in pieces of w bytes.

``batched_ffn`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; on CUDA the plain version runs only when the
caller passes ``use_kernel=False``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_gate_up import ACT_CODES, ACTS

# the epilogue activations of the reference's B5/B7 (gelu: the tanh form)
FFN_ACTS = ("linear", "relu", "sigmoid", "gelu", "silu")
X_DTYPES = (torch.float32, torch.bfloat16)
MAX_ROWS = 65535 * 32  # grid.y (65535) times the kernels' 32 rows per CTA

# csrc/stream_tile.cuh's geometry
STRIP_BYTES = (128, 256, 512)  # a strip's columns, in weight bytes
STREAM_MAX_SPLIT = 8  # CTAs of a cluster (the portable limit)
STREAM_STAGES = 6  # the ring's stages
STAGE_BYTES = 16384  # strip bytes x rows of a stage
RING_PAD = 16  # bytes after every ring row
MAX_SMEM = 232448  # a CTA's shared memory on sm_90
COPY_WIDTHS = (16, 8, 4, 2)  # bytes per copy of the weight, widest first
# the stream kernels: weight element bytes and the k quantum of a rank's
# rows (B7: a thread's 4 k rows; B8: the 32 k of an mma step)
STREAM_KINDS = {"fp32": (4, 4), "bf16": (4, 4), "q78": (2, 32)}


class StreamPlan(NamedTuple):
    """A launch of the stream kernels: ``bm`` rows per CTA and ``tiles_y``
    row tiles; strips of ``sb`` weight bytes, each split over a cluster of
    ``split`` CTAs taking ``ks`` rows of K each; the weight copied in
    pieces of ``width`` bytes; ``smem`` bytes of shared memory a CTA."""
    bm: int
    tiles_y: int
    sb: int
    split: int
    width: int
    ks: int
    smem: int


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def stage_rows(sb: int) -> int:
    return STAGE_BYTES // sb


def stream_smem_bytes(kind: str, bm: int, sb: int, ks: int) -> int:
    """Shared memory of one CTA, as ``batched_ffn_smem_bytes`` and
    ``q78_matmul_smem_bytes`` compute it: the ring, x's K slice (fp32 for
    B7, plus bf16 x as it came; B8's hi/lo A fragments plus a's raw rows)
    and the cluster's receive area (an mbarrier and a 4-byte partial per
    output of the tile); B7's k-group partials reuse the ring."""
    ksr = _round_up(ks, stage_rows(sb))
    ring = STREAM_STAGES * stage_rows(sb) * (sb + RING_PAD)
    raw = bm * _round_up(2 * ksr + 4, 16)
    outs = bm * sb // STREAM_KINDS[kind][0]
    receive = 16 + _round_up(4 * (outs + STREAM_MAX_SPLIT), 16)
    if kind == "q78":
        return ring + (ksr // 32) * (bm // 16) * 1024 + raw + receive
    return ring + bm * ksr * 4 + (raw if kind == "bf16" else 0) + receive


def copy_width(addr: int, row_bytes: int, K: int, elem_bytes: int) -> int:
    """The widest copy (16, 8, 4 bytes; 2 for int16) that the weight's
    address and row stride (in bytes; unused for one row) both allow:
    every strip of every row then starts on a piece."""
    for width in COPY_WIDTHS:
        if width < elem_bytes:
            break
        if addr % width == 0 and (K <= 1 or row_bytes % width == 0):
            return width
    raise ValueError(f"a weight at {addr:#x} with {row_bytes}-byte rows is not "
                     f"{elem_bytes}-byte aligned")


def resident_clusters(device) -> tuple:
    """How many clusters of 1..8 CTAs (one CTA an SM, the most shared
    memory) the card keeps resident at once, from
    cudaOccupancyMaxActiveClusters -- a cluster's CTAs share a GPC, so an
    H100's 132 SMs hold 39 clusters of 3 but 22 of 5.  Asked once per
    device."""
    idx = torch.device(device).index or 0
    if idx not in _RESIDENT:
        lib = build.load("batched_ffn")
        counts = tuple(lib.stream_max_clusters(split, MAX_SMEM)
                       for split in range(1, STREAM_MAX_SPLIT + 1))
        if min(counts) <= 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: {counts}")
        _RESIDENT[idx] = counts
    return _RESIDENT[idx]


_RESIDENT: dict = {}


def pick_bm(kind: str, M: int) -> int:
    """Rows per CTA: B7 the smallest power of two >= M (at most 32), B8 one
    or two 16-row mma tiles."""
    if kind == "q78":
        return 16 if M <= 16 else 32
    bm = 1
    while bm < min(M, 32):
        bm *= 2
    return bm


def stream_plan(kind: str, M: int, K: int, N: int, ldw: int, w_addr: int,
                clusters: tuple) -> StreamPlan:
    """The launch of a stream kernel (``kind`` "fp32" / "bf16": B7 with that
    x; "q78": B8) for an (M, K) x against a (K, N) weight with row stride
    ``ldw`` (elements) at device address ``w_addr``, on a card that keeps
    ``clusters[s - 1]`` clusters of s CTAs resident (``resident_clusters``)
    -- from shapes, the address and the card alone.

    Among the (strip width, split) pairs whose K slice of x fits in shared
    memory and whose every rank has rows, the grid that runs in the fewest
    waves (a wave costs the ring's fill and the cluster's sum, a few
    microseconds) wins, then the one with the fewest weight bytes per CTA,
    then the one with fewer CTAs.  Raises ValueError
    when no split fits x's slice (K too deep)."""
    eb, quantum = STREAM_KINDS[kind]
    bm = pick_bm(kind, M)
    tiles_y = -(-M // bm)
    width = copy_width(w_addr, ldw * eb, K, eb)
    best = None
    for sb in STRIP_BYTES:
        n_strips = -(-N * eb // sb)
        for split in range(1, STREAM_MAX_SPLIT + 1):
            ks = max(quantum, _round_up(-(-K // split), quantum))
            if split > 1 and (split - 1) * ks >= K:
                continue  # a rank without rows
            smem = stream_smem_bytes(kind, bm, sb, ks)
            if smem > MAX_SMEM:
                continue
            ctas = n_strips * split * tiles_y
            waves = -(-ctas // (clusters[split - 1] * split))
            key = (waves, ks * sb, ctas, sb)
            if best is None or key < best[0]:
                best = (key, StreamPlan(bm, tiles_y, sb, split, width, ks, smem))
    if best is None:
        raise ValueError(f"K={K} is too deep for the stream kernel at {M} rows: x's slice "
                         f"does not fit in shared memory at a split of {STREAM_MAX_SPLIT}")
    return best[1]


def check_act(activation: str) -> None:
    if activation not in FFN_ACTS:
        raise ValueError(f"unknown activation {activation!r}; expected one of {FFN_ACTS}")


def check_matrix(name: str, t, dtypes, device) -> int:
    """Check a 2-D operand of the dense kernels B5, B7 and B8 (one of
    ``dtypes``, on ``device``, unit column stride) and return its row
    stride: rows may be strided, so a column section of a wider matrix
    needs no copy."""
    if t.dim() != 2 or t.dtype not in dtypes:
        raise ValueError(f"{name} must be 2-D {dtypes}, got {tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    rows, cols = t.shape
    ld = t.stride(0) if rows > 1 else cols
    if (cols > 1 and t.stride(1) != 1) or ld < cols:
        raise ValueError(f"{name} needs unit column stride and row stride >= {cols}, "
                         f"got strides {t.stride()}")
    return ld


def check_rows(M: int) -> None:
    if M > MAX_ROWS:
        raise ValueError(f"M={M} rows exceed the kernel's grid ({MAX_ROWS})")


def check_vector(name: str, t, n: int, device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != (n,) or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32 ({n},) on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def batched_ffn_plain(x, w, b, activation: str = "relu") -> torch.Tensor:
    """The plain PyTorch version: fp32 product, bias and activation, rounded
    once to x's dtype."""
    y = x.to(torch.float32) @ w.to(torch.float32) + b.to(torch.float32)
    return ACTS[activation](y).to(x.dtype)


def batched_ffn(x, w, b, *, activation: str = "relu", use_kernel: bool = True) -> torch.Tensor:
    """y (M, N) = act(x (M, K) @ w (K, N) + b (N,)) in x's dtype.

    x float32 or bfloat16; w and b float32.  ``use_kernel=False`` runs the
    plain version on CUDA tensors too."""
    check_act(activation)
    if not x.is_cuda or not use_kernel:
        return batched_ffn_plain(x, w, b, activation)
    ldx = check_matrix("x", x, X_DTYPES, x.device)
    ldw = check_matrix("w", w, (torch.float32,), x.device)
    M, K = x.shape
    if w.shape[0] != K:
        raise ValueError(f"x has K={K}, w has {w.shape[0]} rows")
    N = w.shape[1]
    check_vector("b", b, N, x.device)
    check_rows(M)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    plan = stream_plan("fp32" if x.dtype == torch.float32 else "bf16", M, K, N, ldw,
                       w.data_ptr(), resident_clusters(x.device))
    lib = build.load("batched_ffn")
    code = lib.batched_ffn_launch(
        build.ptr(x), build.ptr(w), build.ptr(b), build.ptr(y), M, K, N,
        ldx, ldw, ACT_CODES[activation], build.DTYPE_CODES[x.dtype], plan.sb, plan.split,
        plan.width, plan.ks, build.stream_ptr(x.device))
    build.check(lib, code, "batched_ffn")
    batched_ffn.launches += 1
    batched_ffn.width_launches[plan.width] += 1
    return y


batched_ffn.launches = 0
batched_ffn.width_launches = {w: 0 for w in COPY_WIDTHS}
