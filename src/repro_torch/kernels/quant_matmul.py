"""B5 and B8: the quantized-weight products -- wrappers, plain versions and
launch counters of ``csrc/quant_matmul.cu``.

``quant_matmul`` (B5) replaces ``repro/kernels/quant_matmul.py:quant_matmul``:
y = act((x @ w_q) * scales) for int8 w_q with per-output-channel fp32
scales.  It is bound by the int8 weight stream at decode and by the bf16
tensor-core rate at a long prefill.  Two regimes, picked by ``regime`` from
dtype and shapes before anything is built or launched:

- ``"wgmma"``: bf16 x whose operands TMA can address (K * 2, ldx * 2 and
  ldw multiples of 16) -- the int8 head and every ``--compress quant`` leaf
  of the served models.  B1's column body (``csrc/wgmma_column.cuh``) with
  a dense producer: 2-D TMA loads of (128 k x 128 n) weight boxes through
  an mbarrier ring, converted exactly to bf16, multiplied on ``wgmma``
  with fp32 sums, scales and activation in the epilogue; ``launch_plan``'s
  (bm, split) for ceil(N / 128) columns of ceil(K / 128) k blocks.  x and
  w must be 16-byte aligned there (ValueError otherwise).
- ``"dense_tile"``: fp32 x, and bf16 x that TMA cannot address: the
  CUDA-core kernel over ``csrc/dense_tile.cuh``, one byte per weight
  converted to fp32 for the MACs.

``quant_matmul.launches`` counts every launch, ``quant_matmul.wgmma_launches``
and ``quant_matmul.dense_tile_launches`` those of each regime.

``q78_matmul`` (B8) replaces ``repro/kernels/quant_matmul.py:
q78_matmul_kernel``: the paper's Q7.8 x Q7.8 -> Q15.16 MAC array, int16
operands and a 32-bit accumulator that wraps modulo 2^32, bit-identical to
``core.quantization.q78_matmul`` (its plain version).  Bound by the int16
weight stream at the paper's batches.  It runs B7's weight stream
(``csrc/stream_tile.cuh``, in ``batched_ffn.stream_plan``'s launch) with
the MACs on the int8 tensor cores: each int16 operand cut into a signed
high and an unsigned low byte, four ``mma.sync`` int8 products combined
with shifts into a wrapping 32-bit sum.  ``q78_matmul.width_launches[w]``
counts the launches whose weight was copied in pieces of w bytes.

Both launch their kernel for CUDA tensors and run the plain version for CPU
tensors; on CUDA the plain version runs only when the caller passes
``use_kernel=False``.
"""

from __future__ import annotations

import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels import block_sparse as _bs
from repro_torch.kernels import build
from repro_torch.kernels.batched_ffn import (
    COPY_WIDTHS,
    X_DTYPES,
    check_act,
    check_matrix,
    check_rows,
    check_vector,
    resident_clusters,
    stream_plan,
)
from repro_torch.kernels.fused_gate_up import ACT_CODES, ACTS

# the plain version of B8 is the codec's own oracle
q78_matmul_plain = Q.q78_matmul


def quant_matmul_plain(x, w_q, scales, activation: str = "linear") -> torch.Tensor:
    """The plain PyTorch version: fp32 product with the raw int8 values,
    then the scales and the activation, rounded once to x's dtype."""
    y = x.to(torch.float32) @ w_q.to(torch.float32)
    return ACTS[activation](y * scales.to(torch.float32)).to(x.dtype)


def regime(x_dtype, M: int, K: int, N: int, ldx: int, ldw: int, n_sm: int) -> tuple:
    """(name, bm, split) of a B5 launch, from dtype and shapes alone.

    ``("wgmma", bm, split)`` for bf16 x whose operands TMA can address --
    x's row (K * 2 bytes) and stride (ldx * 2) and w's stride (ldw bytes)
    multiples of 16 -- in ``launch_plan``'s regime for ceil(N / 128)
    output block-columns of ceil(K / 128) k blocks; ``("dense_tile", 0, 1)``
    otherwise (fp32 x, or strides TMA cannot take)."""
    if (x_dtype == torch.bfloat16 and K > 0 and (2 * K) % 16 == 0 and (2 * ldx) % 16 == 0
            and ldw % 16 == 0):
        n_cols, mb = -(-N // _bs.BLOCK), -(-K // _bs.BLOCK)
        return ("wgmma", *_bs.launch_plan(M, n_cols, mb, n_sm))
    return ("dense_tile", 0, 1)


def quant_matmul(x, w_q, scales, *, activation: str = "linear",
                 use_kernel: bool = True) -> torch.Tensor:
    """y (M, N) = act((x (M, K) @ w_q (K, N)) * scales (N,)) in x's dtype.

    x float32 or bfloat16; w_q int8; scales float32.  In the wgmma regime
    (``regime``) x and w_q must be 16-byte aligned (their tiles come by
    TMA).  ``use_kernel=False`` runs the plain version on CUDA tensors
    too."""
    check_act(activation)
    if not x.is_cuda or not use_kernel:
        return quant_matmul_plain(x, w_q, scales, activation)
    ldx = check_matrix("x", x, X_DTYPES, x.device)
    ldw = check_matrix("w_q", w_q, (torch.int8,), x.device)
    M, K = x.shape
    if w_q.shape[0] != K:
        raise ValueError(f"x has K={K}, w_q has {w_q.shape[0]} rows")
    N = w_q.shape[1]
    check_vector("scales", scales, N, x.device)
    check_rows(M)
    name, bm, split = regime(x.dtype, M, K, N, ldx, ldw, _bs.sm_count(x.device))
    if name == "wgmma":
        for what, t in (("x", x), ("w_q", w_q)):
            if t.data_ptr() % 16:
                raise ValueError(f"{what} must be 16-byte aligned (TMA) for the wgmma regime")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    lib = build.load("quant_matmul")
    code = lib.quant_matmul_launch(
        build.ptr(x), build.ptr(w_q), build.ptr(scales), build.ptr(y), M, K, N, ldx, ldw,
        ACT_CODES[activation], build.DTYPE_CODES[x.dtype], bm, split,
        build.stream_ptr(x.device))
    build.check(lib, code, "quant_matmul")
    quant_matmul.launches += 1
    if name == "wgmma":
        quant_matmul.wgmma_launches += 1
    else:
        quant_matmul.dense_tile_launches += 1
    return y


quant_matmul.launches = 0
quant_matmul.wgmma_launches = 0
quant_matmul.dense_tile_launches = 0


def q78_matmul(a_q, w_q, *, use_kernel: bool = True) -> torch.Tensor:
    """acc (M, N) int32 = a_q (M, K) int16 @ w_q (K, N) int16, wrapping
    modulo 2^32.  ``w_q`` may be a column section of a wider matrix (row
    stride > N).  ``use_kernel=False`` runs the plain version on CUDA
    tensors too."""
    if not a_q.is_cuda or not use_kernel:
        return q78_matmul_plain(a_q, w_q)
    lda = check_matrix("a_q", a_q, (torch.int16,), a_q.device)
    ldw = check_matrix("w_q", w_q, (torch.int16,), a_q.device)
    M, K = a_q.shape
    if w_q.shape[0] != K:
        raise ValueError(f"a_q has K={K}, w_q has {w_q.shape[0]} rows")
    N = w_q.shape[1]
    check_rows(M)
    y = torch.empty((M, N), dtype=torch.int32, device=a_q.device)
    if M == 0 or N == 0:
        return y
    plan = stream_plan("q78", M, K, N, ldw, w_q.data_ptr(), resident_clusters(a_q.device))
    lib = build.load("quant_matmul")
    code = lib.q78_matmul_launch(build.ptr(a_q), build.ptr(w_q), build.ptr(y), M, K, N,
                                 lda, ldw, plan.sb, plan.split, plan.width, plan.ks,
                                 build.stream_ptr(a_q.device))
    build.check(lib, code, "q78_matmul")
    q78_matmul.launches += 1
    q78_matmul.width_launches[plan.width] += 1
    return y


q78_matmul.launches = 0
q78_matmul.width_launches = {w: 0 for w in COPY_WIDTHS}
