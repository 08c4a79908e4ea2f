"""Decode-step roofline model (port of ``repro/core/perf_model.py``).

Only what serving and the engine call is ported: ``decode_n_opt``,
``pages_for_context``, ``paged_pool_pages`` and ``decode_step_time``.  The
hardware defaults are the NVIDIA H100 SXM data-sheet values, not
measurements: 989e12 FLOP/s dense bf16 on the tensor cores and 3.35e12 B/s
of HBM3 bandwidth.  They are the only hardware constants of the port.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet (dense, no sparsity, 700 W) -- not measured.
H100_PEAK_FLOPS = 989e12  # bf16 tensor-core FLOP/s
H100_HBM_BW = 3.35e12  # HBM3 bytes/s
HARDWARE_LABEL = "H100 SXM data-sheet constants (989 TFLOP/s bf16, 3.35 TB/s)"


def decode_n_opt(
    peak_flops: float = H100_PEAK_FLOPS,
    hbm_bw: float = H100_HBM_BW,
    b_weight: float = 2.0,
    q_prune: float = 0.0,
    q_overhead: float = 1.0,
    sparse_compute: bool = True,
    n_params: int | None = None,
    kv_bytes_per_token: float = 0.0,
    context_len: int = 0,
) -> float:
    """Batch size at which decode flips from HBM-bound to compute-bound.

    Balance: 2*n FLOPs per b_weight bytes == peak_flops / hbm_bw, so
    n_opt = peak_flops * b_weight * q_overhead / (2 * hbm_bw).  A kernel that
    skips pruned blocks (``sparse_compute``) scales both terms with
    (1 - q_prune); masked-dense execution scales n_opt with (1 - q_prune).
    Per-token KV reads never amortize with the batch and tilt n_opt upward:

        n_opt = (W_stream / hbm_bw) / (2*P_compute/peak - ctx*kv/hbm_bw)

    A non-positive denominator means memory-bound at any batch (inf).
    """
    if kv_bytes_per_token > 0.0 and context_len > 0:
        if n_params is None:
            raise ValueError("n_params required for kv-aware n_opt")
        eff = n_params * (1.0 - q_prune)
        comp = eff if sparse_compute else n_params
        denom = 2.0 * comp / peak_flops - context_len * kv_bytes_per_token / hbm_bw
        if denom <= 0.0:
            return float("inf")
        return (eff * b_weight * q_overhead / hbm_bw) / denom
    n = peak_flops * b_weight * q_overhead / (2.0 * hbm_bw)
    if not sparse_compute:
        n *= 1.0 - q_prune
    return n


def pages_for_context(context_len: int, page_size: int) -> int:
    """Pages a sequence of ``context_len`` tokens occupies in the paged cache."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    return -(-context_len // page_size)


def paged_pool_pages(
    n_sequences: int,
    mean_context_len: float,
    page_size: int,
    headroom: float = 1.1,
) -> int:
    """Pool capacity (pages, excluding the null page) for ``n_sequences``
    concurrent sequences of ``mean_context_len`` tokens; ``headroom`` covers
    page-granularity fragmentation and admission skew."""
    per_seq = pages_for_context(int(math.ceil(mean_context_len)), page_size)
    return int(math.ceil(n_sequences * per_seq * headroom))


def decode_step_time(
    n_params: int,
    batch: int,
    kv_bytes_per_token: float = 0.0,
    context_len: int = 0,
    peak_flops: float = H100_PEAK_FLOPS,
    hbm_bw: float = H100_HBM_BW,
    b_weight: float = 2.0,
    n_chips: int = 1,
    q_prune: float = 0.0,
    q_overhead: float = 1.0,
    sparse_compute: bool = True,
) -> dict:
    """Two-term decode-step model: dict of t_calc, t_mem, t_proc, bound."""
    eff_params = n_params * (1.0 - q_prune)
    flops = 2.0 * (eff_params if sparse_compute else n_params) * batch
    weight_bytes = eff_params * b_weight * q_overhead
    kv_read = batch * context_len * kv_bytes_per_token
    tc = flops / (peak_flops * n_chips)
    tm = (weight_bytes + kv_read) / (hbm_bw * n_chips)
    return {
        "t_calc": tc,
        "t_mem": tm,
        "t_proc": max(tc, tm),
        "bound": "compute" if tc >= tm else "memory",
    }
