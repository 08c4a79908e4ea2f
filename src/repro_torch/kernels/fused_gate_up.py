"""B2: fused gate+up projection -- wrapper, plain version and launch counter
of ``csrc/fused_gate_up.cu``.

Replaces ``repro/kernels/fused_gate_up.py:fused_gate_up``.  Computes
``act(x @ Wg * sg) * (x @ Wu * su)`` in one launch for an independently
pruned (gate, up) pair.  What bounds it on the H100: as for B1, the weight
stream at decode (both surviving payloads + both scale vectors + x + y
over 3.35 TB/s) and the bf16 tensor-core rate at prefill.  Its design is
B1's (``csrc/wgmma_column.cuh``: ``wgmma``, a ring of bulk copies and TMA
loads, 128-row tiles at prefill, a cluster split of both slot lists at
decode, regime from ``block_sparse.launch_plan``) with two fp32
accumulators; the epilogue applies scales, activation and product, so the
gate projection never goes to device memory.  A stack of experts' pairs
(x (E, M, K), every operand with the lead dim E) runs in one launch over
a grid z axis of E, as B1's does (``kernels/block_sparse.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels import block_sparse as _bs
from repro_torch.kernels.block_sparse import block_sparse_fp32, check_operands

# weight_plan.GATE_ACTS name -> csrc/common.cuh Act code
ACT_CODES = {
    "linear": 0, "relu": 1, "sigmoid": 2, "gelu": 3, "geglu": 3, "gelu_glu": 3,
    "silu": 4, "swiglu": 4, "tanh": 5,
}

# the plain activations; gelu is the tanh approximation (jax.nn.gelu's default)
ACTS = {
    "linear": lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "swiglu": F.silu,
    "geglu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_glu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
}


def fused_gate_up_plain(x, gate, up, gate_scales=None, up_scales=None,
                        activation: str = "silu") -> torch.Tensor:
    """The plain PyTorch version: both products in fp32, then the gate
    activation and the product, rounded once to x's dtype.  ``gate``/``up``
    are (blocks, block_rows, counts) triples; a stack of experts runs the
    2-D version once per expert."""
    if x.dim() == 3:
        def pick(t, e):
            return None if t is None else t[e]

        return torch.stack([
            fused_gate_up_plain(x[e], [t[e] for t in gate], [t[e] for t in up],
                                pick(gate_scales, e), pick(up_scales, e), activation)
            for e in range(x.shape[0])])
    hg = block_sparse_fp32(x, gate[0], gate[1], gate_scales)
    hu = block_sparse_fp32(x, up[0], up[1], up_scales)
    return (ACTS[activation](hg) * hu).to(x.dtype)


def fused_gate_up(x, gate, up, gate_scales=None, up_scales=None, *,
                  activation: str = "silu", use_kernel: bool = True) -> torch.Tensor:
    """y (M, N) = act(x @ Wg) * (x @ Wu) for block-sparse Wg, Wu of the same
    dense shape and 128x128 geometry; ``gate``/``up`` are (blocks,
    block_rows, counts) triples, scales both given or both None; x must be
    16-byte aligned.  A stack of E expert pairs: x (E, M, K), every operand
    with the lead dim E, y (E, M, N), one launch."""
    if activation not in ACTS:
        raise ValueError(f"unknown gate activation {activation!r}")
    if (gate_scales is None) != (up_scales is None):
        raise ValueError("gate and up scales must both be given or both be None")
    if not x.is_cuda or not use_kernel:
        return fused_gate_up_plain(x, gate, up, gate_scales, up_scales, activation)
    check_operands(x, *gate, gate_scales)
    check_operands(x, *up, up_scales)
    if gate[0].dtype != up[0].dtype or gate[1].shape[-2] != up[1].shape[-2]:
        raise ValueError("gate and up must share payload dtype and output width")
    _bs.check_x_aligned(x)
    M, K = x.shape[-2:]
    n_cols = gate[1].shape[-2]
    N = n_cols * 128
    E = _bs.n_experts(x)
    rows = gate[1] if gate[1].shape[-1] >= up[1].shape[-1] else up[1]
    bm, split = _bs.body_plan(x, gate[0], rows)
    y = torch.empty(x.shape[:-1] + (N,), dtype=x.dtype, device=x.device)
    lib = build.load("fused_gate_up")
    code = lib.fused_gate_up_launch(
        build.ptr(x),
        build.ptr(gate[0]), build.ptr(gate[1]), build.ptr(gate[2]), build.ptr(gate_scales),
        build.ptr(up[0]), build.ptr(up[1]), build.ptr(up[2]), build.ptr(up_scales),
        build.ptr(y), M, K, N, gate[1].shape[-1], up[1].shape[-1], ACT_CODES[activation],
        build.DTYPE_CODES[x.dtype], build.DTYPE_CODES[gate[0].dtype], bm, split, E,
        build.stream_ptr(x.device))
    build.check(lib, code, "fused_gate_up")
    _bs.count_launch(fused_gate_up, x, bm)
    return y


_bs.zero_counts(fused_gate_up)
