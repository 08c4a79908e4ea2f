"""B5 and B8: the quantized-weight products -- wrappers, plain versions and
launch counters of ``csrc/quant_matmul.cu``.

``quant_matmul`` (B5) replaces ``repro/kernels/quant_matmul.py:quant_matmul``:
y = act((x @ w_q) * scales) for int8 w_q with per-output-channel fp32
scales.  It is bound by the int8 weight stream at the served batches: the
kernel reads one byte per weight and converts it exactly to fp32 for the
MACs; scales and activation run in the epilogue.

``q78_matmul`` (B8) replaces ``repro/kernels/quant_matmul.py:
q78_matmul_kernel``: the paper's Q7.8 x Q7.8 -> Q15.16 MAC array, int16
operands and a 32-bit accumulator that wraps modulo 2^32, bit-identical to
``core.quantization.q78_matmul`` (its plain version).  Bound by the int16
weight stream at the paper's batches.

Both launch their kernel for CUDA tensors and run the plain version for CPU
tensors; on CUDA the plain version runs only when the caller passes
``use_kernel=False``.
"""

from __future__ import annotations

import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels import build
from repro_torch.kernels.batched_ffn import (
    X_DTYPES,
    check_act,
    check_matrix,
    check_rows,
    check_vector,
)
from repro_torch.kernels.fused_gate_up import ACT_CODES, ACTS

# the plain version of B8 is the codec's own oracle
q78_matmul_plain = Q.q78_matmul


def quant_matmul_plain(x, w_q, scales, activation: str = "linear") -> torch.Tensor:
    """The plain PyTorch version: fp32 product with the raw int8 values,
    then the scales and the activation, rounded once to x's dtype."""
    y = x.to(torch.float32) @ w_q.to(torch.float32)
    return ACTS[activation](y * scales.to(torch.float32)).to(x.dtype)


def quant_matmul(x, w_q, scales, *, activation: str = "linear",
                 use_kernel: bool = True) -> torch.Tensor:
    """y (M, N) = act((x (M, K) @ w_q (K, N)) * scales (N,)) in x's dtype.

    x float32 or bfloat16; w_q int8; scales float32.  ``use_kernel=False``
    runs the plain version on CUDA tensors too."""
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
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    lib = build.load("quant_matmul")
    code = lib.quant_matmul_launch(
        build.ptr(x), build.ptr(w_q), build.ptr(scales), build.ptr(y), M, K, N, ldx, ldw,
        ACT_CODES[activation], build.DTYPE_CODES[x.dtype], build.stream_ptr(x.device))
    build.check(lib, code, "quant_matmul")
    quant_matmul.launches += 1
    return y


quant_matmul.launches = 0


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
    lib = build.load("quant_matmul")
    code = lib.q78_matmul_launch(build.ptr(a_q), build.ptr(w_q), build.ptr(y), M, K, N,
                                 lda, ldw, build.stream_ptr(a_q.device))
    build.check(lib, code, "q78_matmul")
    q78_matmul.launches += 1
    return y


q78_matmul.launches = 0
