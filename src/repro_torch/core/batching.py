"""Batch processing (port of ``repro/core/batching.py``; paper Sections
4.2 / 5.5).

Ported:

1. The paper's TDM section schedule -- which (section, sample) pair the
   FPGA datapath runs at each macro step -- its weight-transfer count and
   the latency / throughput model of Fig. 7 (``section_schedule``,
   ``weight_transfers``, ``batch_latency``, ``throughput_samples_per_s``).
   ``models.fcnet.forward_q78_sectioned`` runs in this order.
2. ``mean_decode_context`` and the balance point of ``BatchSizer``, which
   serving and the engine read.  The latency clamp, the speculative and
   multi-chip terms wait for their slices (ROADMAP A7, A13).  The sizer's
   defaults are the H100 data-sheet constants of ``core.perf_model``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Sequence

from repro_torch.core import perf_model as pm

# ---------------------------------------------------------------------------
# TDM section schedule (paper Fig. 2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SectionStep:
    layer: int
    section: int  # which m-neuron section of the layer
    sample: int  # which of the n batch samples
    new_weights: bool  # True iff this step needs a fresh weight transfer


def section_schedule(
    layer_sizes: Sequence[int], m: int, n: int
) -> Iterator[SectionStep]:
    """Yield the paper's processing order: all n samples of section 0, then
    all n samples of section 1, ... then the next layer.  Weights are
    transferred once per section (the first sample of the section)."""
    for j in range(len(layer_sizes) - 1):
        s_out = layer_sizes[j + 1]
        for sec in range(math.ceil(s_out / m)):
            for i in range(n):
                yield SectionStep(j, sec, i, new_weights=(i == 0))


def weight_transfers(layer_sizes: Sequence[int], m: int, n: int) -> dict:
    """Count weight-matrix traffic with and without batching (words)."""
    with_batch = 0
    without = 0
    for j in range(len(layer_sizes) - 1):
        s_in, s_out = layer_sizes[j], layer_sizes[j + 1]
        sections = math.ceil(s_out / m)
        rows = min(m, s_out)  # per section (last may be ragged; upper bound)
        per_section = rows * s_in
        with_batch += sections * per_section  # once per section
        without += sections * per_section * n  # refetched per sample
    return {"batched": with_batch, "unbatched": without, "ratio": without / max(1, with_batch)}


# ---------------------------------------------------------------------------
# Latency model (paper Section 6.3 / Fig. 7)
# ---------------------------------------------------------------------------


def batch_latency(
    net: Sequence[pm.LayerShape],
    hw: pm.HardwareSpec,
    n: int,
    q_prune: float = 0.0,
    q_overhead: float = 1.0,
    overlap: str = "add",
) -> float:
    """Average per-sample completion latency under batch size n [seconds].

    All n samples of a batch finish together (the batch sweeps sections), so
    every sample's latency is the whole batch's processing time.

    overlap="max" is the paper's idealized t_proc = max(t_calc, t_mem);
    overlap="add" models the measured hardware (Fig. 7 / Table 2), where
    per-section FIFO depth limits prefetch and the two streams largely
    serialize: latency ~ t_mem + t_calc.  "add" reproduces the paper's
    observed ~2x latency at n=8 and ~3x at n=16; "max" is the upper bound
    the architecture was designed toward.
    """
    tc = sum(pm.t_calc(l, hw, n, q_prune) for l in net)
    tm = sum(
        pm.t_mem(l, hw, n_samples=n, batch=n, q_prune=q_prune, q_overhead=q_overhead)
        for l in net
    )
    return tm + tc if overlap == "add" else max(tc, tm)


def throughput_samples_per_s(
    net: Sequence[pm.LayerShape],
    hw: pm.HardwareSpec,
    n: int,
    q_prune: float = 0.0,
    q_overhead: float = 1.0,
    overlap: str = "max",
) -> float:
    t = batch_latency(net, hw, n, q_prune, q_overhead, overlap)
    return n / t if t > 0 else float("inf")


# ---------------------------------------------------------------------------
# Serving batch sizer
# ---------------------------------------------------------------------------

# n_opt sentinel for "memory-bound at any batch"; render it as inf.
UNBOUNDED_NOPT = 1 << 20


def mean_decode_context(prompt_len: float, max_new: float) -> int:
    """Expected KV context per decode step over a request's lifetime:
    ``prompt_len + max_new / 2`` (the step at position t reads t tokens)."""
    return max(1, int(round(prompt_len + max_new / 2.0)))


@dataclasses.dataclass(frozen=True)
class BatchSizer:
    """The decode batch at the machine-balance point, n_opt."""

    n_params: int
    b_weight: float = 2.0
    peak_flops: float = pm.H100_PEAK_FLOPS
    hbm_bw: float = pm.H100_HBM_BW
    q_prune: float = 0.0
    q_overhead: float = 1.0
    sparse_compute: bool = True
    kv_bytes_per_token: float = 0.0
    context_len: int = 0

    @property
    def n_opt(self) -> int:
        n = pm.decode_n_opt(
            self.peak_flops, self.hbm_bw, self.b_weight,
            q_prune=self.q_prune, q_overhead=self.q_overhead,
            sparse_compute=self.sparse_compute, n_params=self.n_params,
            kv_bytes_per_token=self.kv_bytes_per_token,
            context_len=self.context_len,
        )
        if not math.isfinite(n):
            return UNBOUNDED_NOPT
        return max(1, int(round(n)))
