"""Weight encodings (port of ``repro/core/quantization.py``; paper Sections
4.1 / 5.3).

Two codecs:

1. ``Q7.8`` -- the paper's 16-bit fixed point (1 sign, 7 integer, 8
   fractional bits) with 32-bit (Q15.16) accumulation, bit-exact: the same
   int16 codes, the same wrapping int32 accumulator, the same half-to-even
   rounding as the reference.  ``q78_matmul`` is the plain version of
   kernel B8 (``kernels/quant_matmul.q78_matmul``).
2. ``int8`` symmetric per-channel quantization with fp32 scales.
"""

from __future__ import annotations

import dataclasses

import torch

# ---------------------------------------------------------------------------
# Q7.8 fixed point (paper-faithful)
# ---------------------------------------------------------------------------

Q78_FRAC_BITS = 8
Q78_SCALE = 1 << Q78_FRAC_BITS  # 256
Q78_MIN = -(1 << 15)  # -32768
Q78_MAX = (1 << 15) - 1  # 32767

# fp64 sums of int16 x int16 products (each |p| <= 2^30) stay exact integers
# while K * 2^30 < 2^53
Q78_MATMUL_MAX_K = 1 << 23


def q78_encode(x) -> torch.Tensor:
    """float -> int16 Q7.8, rounding half to even, saturating."""
    scaled = torch.round(torch.as_tensor(x).to(torch.float32) * Q78_SCALE)
    return scaled.clamp(Q78_MIN, Q78_MAX).to(torch.int16)


def q78_decode(q: torch.Tensor) -> torch.Tensor:
    """int16 Q7.8 -> float32."""
    return q.to(torch.float32) / Q78_SCALE


def q78_quantize(x) -> torch.Tensor:
    """Round-trip to Q7.8 representable values (float out)."""
    return q78_decode(q78_encode(x))


def q78_matmul(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(..., K) int16 x (K, N) int16 -> int32 Q15.16 accumulator, wrapping
    modulo 2^32 exactly as the reference's int32 ``dot_general``.

    The products are summed in fp64, which is exact for K < 2^23 in any
    order, then wrapped through int64; PyTorch has no integer GEMM on CUDA,
    so this one path serves both devices."""
    K = a_q.shape[-1]
    if K >= Q78_MATMUL_MAX_K:
        raise ValueError(f"K={K}: the fp64 sum is exact only for K < 2^23")
    acc = (a_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int64)
    return ((acc + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def q1516_decode(acc: torch.Tensor) -> torch.Tensor:
    """int32 Q15.16 accumulator -> float32."""
    return acc.to(torch.float32) / (Q78_SCALE * Q78_SCALE)


def q78_requantize(acc: torch.Tensor) -> torch.Tensor:
    """Q15.16 accumulator -> Q7.8 activation (round half up, saturate).
    The int32 add wraps like the reference's."""
    shifted = (acc + (1 << (Q78_FRAC_BITS - 1))) >> Q78_FRAC_BITS
    return shifted.clamp(Q78_MIN, Q78_MAX).to(torch.int16)


def q78_relu(q: torch.Tensor) -> torch.Tensor:
    """ReLU in the fixed-point domain (paper Section 5.4)."""
    return q.clamp_min(0)


def q78_sigmoid_plan(q: torch.Tensor) -> torch.Tensor:
    """Piecewise linear sigmoid (PLAN, Amin et al. 1997) on Q7.8 codes:

        y = 1                      for x >= 5
        y = 0.03125*x + 0.84375   for 2.375 <= x < 5
        y = 0.125*x + 0.625       for 1 <= x < 2.375
        y = 0.25*x + 0.5          for 0 <= x < 1
        y(-x) = 1 - y(x)

    Every coefficient is a binary fraction, so each segment is exact in
    fp32 and the result equals the reference's bit for bit."""
    x = q78_decode(q)
    ax = x.abs()
    one = torch.ones_like(ax)
    y = torch.where(
        ax >= 5.0, one,
        torch.where(ax >= 2.375, 0.03125 * ax + 0.84375,
                    torch.where(ax >= 1.0, 0.125 * ax + 0.625, 0.25 * ax + 0.5)))
    y = torch.where(x < 0, 1.0 - y, y)
    return q78_encode(y)


# ---------------------------------------------------------------------------
# int8 symmetric per-channel quantization
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QuantizedTensor:
    """int8 values + per-channel fp32 scales (broadcastable along ``axis``)."""

    values: torch.Tensor  # int8
    scales: torch.Tensor  # fp32
    axis: int

    @property
    def shape(self):
        return self.values.shape

    def dequantize(self) -> torch.Tensor:
        return self.values.to(torch.float32) * self.scales


def quantize_int8(w, axis: int = -1) -> QuantizedTensor:
    """Symmetric per-channel int8 quantization along ``axis``."""
    w = torch.as_tensor(w).to(torch.float32)
    axis = axis % w.dim()
    reduce_dims = tuple(i for i in range(w.dim()) if i != axis)
    amax = w.abs().amax(dim=reduce_dims, keepdim=True) if reduce_dims else w.abs()
    scales = amax.clamp_min(1e-8) / 127.0
    q = torch.round(w / scales).clamp(-127, 127).to(torch.int8)
    return QuantizedTensor(values=q, scales=scales, axis=axis)


def int8_matmul(x: torch.Tensor, wq: QuantizedTensor) -> torch.Tensor:
    """Activations x int8 weights -> fp32: x rounded to bf16 (as the
    reference's operands), products exact in fp32, then the scales."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    y = xb @ wq.values.to(torch.float32)
    return y * wq.scales.reshape((1,) * (y.dim() - 1) + (-1,))


def quantize_pytree(params, axis: int = -1, min_size: int = 4096):
    """Quantize every >= 2-D tensor leaf of >= ``min_size`` elements of a
    nested dict/list tree; other leaves are kept as they are."""
    if isinstance(params, dict):
        return {k: quantize_pytree(v, axis, min_size) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_pytree(v, axis, min_size) for v in params)
    if isinstance(params, torch.Tensor) and params.dim() >= 2 and params.numel() >= min_size:
        return quantize_int8(params, axis=axis)
    return params


def quantization_error(w, axis: int = -1) -> float:
    """Relative L2 error of the int8 round trip (diagnostic)."""
    w = torch.as_tensor(w).to(torch.float32)
    wq = quantize_int8(w, axis)
    return float(torch.linalg.norm(w - wq.dequantize()) / (torch.linalg.norm(w) + 1e-12))


def bytes_per_weight(fmt: str) -> float:
    """b_weight for the perf model, by format name."""
    return {"fp32": 4.0, "bf16": 2.0, "q78": 2.0, "int8": 1.0, "int4": 0.5}[fmt]
