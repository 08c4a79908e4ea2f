"""The kernel dispatch that ``core.weight_plan`` and ``models.layers`` call.

Each function unpacks the port's data structures into the kernel wrapper's
arguments.  The wrappers launch their CUDA kernel for CUDA tensors and run
their plain PyTorch version for CPU tensors; on CUDA the plain version runs
only for an explicit ``use_kernel=False`` (``PlanConfig.use_kernel``,
the plan nodes' ``use_kernel``, ``layers.paged_decode_attention(use_kernel=)``,
``layers.attention(use_kernel=)``, the ``models.fcnet`` forwards'
``use_kernel=``).  Nothing here catches a kernel failure to fall back.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import batched_ffn as _bffn
from repro_torch.kernels import block_sparse as _bs
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_gate_up as _fgu
from repro_torch.kernels import quant_matmul as _qmm


def _check_k(x2, w):
    # the kernels index x by the pack-time row blocks: K must be the weight's
    if x2.shape[-1] != w.shape[0]:
        raise ValueError(f"x has K={x2.shape[-1]}, the weight packs K={w.shape[0]}")


def block_sparse_matmul(x2, w):
    """(M, K) @ PackedLinear -> (M, N) in x2's dtype: kernel B1 for a leaf
    that carries its pack-time walk, B4 for one that does not -- the
    reference's route under its jitted engine (``ops.py:103-110``)."""
    _check_k(x2, w)
    fn = _bs.block_sparse_matmul if w.walk is not None else _bs.block_sparse_matmul_col
    return fn(x2, w.blocks, w.block_rows, w.counts, w.scales, use_kernel=w.use_kernel)


def fused_gate_up(x2, g, u, activation: str):
    """act(x2 @ g) * (x2 @ u) for a fusable PackedLinear pair (kernel B2)."""
    _check_k(x2, g)
    return _fgu.fused_gate_up(
        x2, (g.blocks, g.block_rows, g.counts), (u.blocks, u.block_rows, u.counts),
        g.scales, u.scales, activation=activation,
        use_kernel=g.use_kernel and u.use_kernel)


def paged_decode_attention(q, k_pages, v_pages, page_table, pos, *, window=None,
                           softcap=0.0, k_scale_pages=None, v_scale_pages=None,
                           causal: bool = True, use_kernel: bool = True, kv_heads=None):
    """Decode attention through the page table (kernel B3); ``kv_heads``
    (offset, count) reads those KV heads of the pools only."""
    return _fa.paged_decode_attention(
        q, k_pages, v_pages, page_table, pos, window=window, softcap=softcap,
        k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages, causal=causal,
        use_kernel=use_kernel, kv_heads=kv_heads)


CROSS_PAGE = 16  # slots of the identity table's pages (the served frame pages')


def cross_decode_attention(q, k, v, *, softcap: float = 0.0, use_kernel: bool = True):
    """Decode-time enc-dec cross-attention of q (B, T, H, hd) against a
    contiguous encoder pool k/v (B, Sf, KVH, hd) through kernel B3, as the
    reference's ``ops.cross_decode_attention`` runs its Pallas kernel: the
    frames padded to whole pages of CROSS_PAGE slots, an identity page
    table, ``causal=False`` at pos = Sf - 1 (the padded slots lie past pos
    and mask out).  The served path reads the paged frame pool in place
    (``models/encdec.py``); this one pads a copy every call."""
    B, Sf, KVH, hd = k.shape
    P = -(-Sf // CROSS_PAGE)
    pad = P * CROSS_PAGE - Sf

    def pool(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) if pad else x
        return x.contiguous().reshape(B * P, CROSS_PAGE, KVH, hd)

    table = torch.arange(B * P, dtype=torch.int32, device=q.device).reshape(B, P)
    pos = torch.full((B,), Sf - 1, dtype=torch.int32, device=q.device)
    return _fa.paged_decode_attention(q, pool(k), pool(v), table, pos, softcap=softcap,
                                      causal=False, use_kernel=use_kernel)


def flash_attention(q, k, v, *, causal: bool = True, window=None, q_offset: int = 0,
                    softcap: float = 0.0, k_scale=None, v_scale=None, use_kernel: bool = True):
    """Flash attention forward (kernel B6).  Unlike the reference's
    ``ops.flash_attention`` it pads nothing: the kernel masks ragged Sq and
    Sk itself, so non-causal calls never see padded keys.  B6 caps the
    scores where ``softcap`` > 0 and refuses ``q_offset``."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                               softcap=softcap, k_scale=k_scale, v_scale=v_scale,
                               use_kernel=use_kernel)


def quant_matmul(x2, w, activation: str = "linear"):
    """act((x2 @ w.q) * w.s) for a 2-D QuantLinear (kernel B5)."""
    _check_k(x2, w.q)
    return _qmm.quant_matmul(x2, w.q, w.s, activation=activation, use_kernel=w.use_kernel)


def batched_ffn(x, w, b, activation: str = "relu", use_kernel: bool = True):
    """act(x @ w + b), weight-stationary over the batch (kernel B7)."""
    return _bffn.batched_ffn(x, w, b, activation=activation, use_kernel=use_kernel)


def q78_matmul(a_q, w_q, use_kernel: bool = True):
    """Q7.8 x Q7.8 -> wrapping int32 Q15.16 accumulator (kernel B8)."""
    return _qmm.q78_matmul(a_q, w_q, use_kernel=use_kernel)
