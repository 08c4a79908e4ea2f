"""B7: weight-stationary fully-connected layer -- wrapper, plain version and
launch counter of ``csrc/batched_ffn.cu``.

Replaces ``repro/kernels/batched_ffn.py:batched_ffn``: y = act(x @ w + b)
with an fp32 accumulator and bias + activation in the epilogue.  What
bounds it on the H100: at the paper's batches (1..32) each weight feeds at
most 32 MACs, so the weight stream (K * N * 4 bytes for fp32 over
3.35 TB/s).  Its design (``csrc/dense_tile.cuh``) is the paper's batch
processing: one CTA owns 32 bytes' worth of output columns (8 fp32) for
up to 32 batch rows, each weight is read once into the register of the
thread that owns it and multiplied by every row, and K is walked in a loop
with the next tile's weights in flight.  MACs are fp32 on the CUDA cores (no TF32).

``batched_ffn`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; on CUDA the plain version runs only when the
caller passes ``use_kernel=False``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_gate_up import ACT_CODES, ACTS

# the epilogue activations of the reference's B5/B7 (gelu: the tanh form)
FFN_ACTS = ("linear", "relu", "sigmoid", "gelu", "silu")
X_DTYPES = (torch.float32, torch.bfloat16)
MAX_ROWS = 65535 * 32  # grid.y (65535) times the kernel's 32 rows per CTA


def check_act(activation: str) -> None:
    if activation not in FFN_ACTS:
        raise ValueError(f"unknown activation {activation!r}; expected one of {FFN_ACTS}")


def check_matrix(name: str, t, dtypes, device) -> int:
    """Check a 2-D operand of the dense-tile kernels (one of ``dtypes``, on
    ``device``, unit column stride) and return its row stride: rows may be
    strided, so a column section of a wider matrix needs no copy."""
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
    lib = build.load("batched_ffn")
    code = lib.batched_ffn_launch(
        build.ptr(x), build.ptr(w), build.ptr(b), build.ptr(y), M, K, N,
        ldx, ldw, ACT_CODES[activation], build.DTYPE_CODES[x.dtype], build.stream_ptr(x.device))
    build.check(lib, code, "batched_ffn")
    batched_ffn.launches += 1
    return y


batched_ffn.launches = 0
