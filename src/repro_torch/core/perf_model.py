"""Analytical performance models (port of ``repro/core/perf_model.py``).

Two parts:

1. The paper's Section 4.4 model of a fully-connected layer transition as
   two overlapped streams -- MACs on an m x r array and the weight
   transfer -- with its batch-size optimum ``n_opt`` and the cycle counts of
   the paper's datapaths (Section 5.5).  Copied as it is: pure arithmetic,
   with the paper's ZedBoard designs as ``HardwareSpec``s.
2. The decode-step roofline that serving and the engine call:
   ``decode_n_opt``, ``pages_for_context``, ``paged_pool_pages``,
   ``decode_step_time`` and the speculative tick (``expected_committed``,
   ``spec_decode_n_opt``, ``spec_step_time``).  Its hardware defaults are the NVIDIA H100 SXM
   data-sheet values, not measurements: 989e12 FLOP/s dense bf16 on the
   tensor cores and 3.35e12 B/s of HBM3 bandwidth.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

# ---------------------------------------------------------------------------
# The paper's model (Section 4.4)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """A machine, in the paper's parameterization.

    m:        parallel processing units (neurons per section)
    r:        parallel MACs per processing unit
    f_pu:     clock of the processing units [Hz]
    T_mem:    achievable memory throughput [bytes/s]
    b_weight: bytes per stored weight
    name:     human-readable tag
    """

    name: str
    m: int
    r: int
    f_pu: float
    T_mem: float
    b_weight: float = 2.0  # Q7.8 -> 16 bit

    @property
    def macs_per_s(self) -> float:
        return self.m * self.r * self.f_pu

    @property
    def flops_per_s(self) -> float:
        # one MAC = 2 FLOPs (mul + add)
        return 2.0 * self.macs_per_s


# The paper's batch-processing design on the ZedBoard (Zynq XC7020):
# m = 114 MAC units (batch sizes 1..4), f_pu = 100 MHz, r = 1.
# The four Zynq HP ports at 133 MHz x 64 bit give a practical ~1.6 GB/s
# aggregated weight throughput (the paper states DDR3 controller peak of the
# PS side is shared; we calibrate T_mem from the paper's own n_opt = 12.66
# with m=114, r=1, f=100e6, b=2, q_ov=1:   T_mem = m*r*f*b/n_opt).
ZYNQ_BATCH = HardwareSpec(
    name="zedboard-batch-m114",
    m=114,
    r=1,
    f_pu=100e6,
    T_mem=114 * 1 * 100e6 * 2.0 / 12.66,  # ~1.80 GB/s, calibrated to n_opt=12.66
    b_weight=2.0,
)

# The paper's pruning design: m = 4 coprocessors x r = 3 MACs = 12 MACs.
ZYNQ_PRUNE = HardwareSpec(
    name="zedboard-prune-m4r3",
    m=4,
    r=3,
    f_pu=100e6,
    T_mem=ZYNQ_BATCH.T_mem,
    b_weight=2.0,
)

# ---------------------------------------------------------------------------
# Layer / network descriptions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """One FC transition: s_in inputs (s_j), s_out neurons (s_{j+1})."""

    s_in: int
    s_out: int

    @property
    def weights(self) -> int:
        return self.s_in * self.s_out


def fc_network(sizes: Sequence[int]) -> tuple[LayerShape, ...]:
    """A network '784x800x800x10' -> tuple of LayerShape transitions."""
    return tuple(LayerShape(a, b) for a, b in zip(sizes[:-1], sizes[1:]))


# The paper's four evaluation networks (Table 2 footnotes).
MNIST_4LAYER = fc_network([784, 800, 800, 10])
MNIST_8LAYER = fc_network([784, 800, 800, 800, 800, 800, 800, 10])
HAR_4LAYER = fc_network([561, 1200, 300, 6])
HAR_6LAYER = fc_network([561, 2000, 1500, 750, 300, 6])

PAPER_NETWORKS = {
    "mnist-4layer": MNIST_4LAYER,
    "mnist-8layer": MNIST_8LAYER,
    "har-4layer": HAR_4LAYER,
    "har-6layer": HAR_6LAYER,
}


def network_parameters(net: Sequence[LayerShape]) -> int:
    return sum(l.weights for l in net)


# ---------------------------------------------------------------------------
# The two-term model (Section 4.4)
# ---------------------------------------------------------------------------


def t_calc(
    layer: LayerShape,
    hw: HardwareSpec,
    n_samples: int,
    q_prune: float = 0.0,
) -> float:
    """Compute time for a layer across n_samples inputs [seconds]."""
    if not 0.0 <= q_prune <= 1.0:
        raise ValueError(f"q_prune must be in [0,1], got {q_prune}")
    ops = layer.s_out * layer.s_in * n_samples * (1.0 - q_prune)
    return ops / (hw.m * hw.r * hw.f_pu)


def t_mem(
    layer: LayerShape,
    hw: HardwareSpec,
    n_samples: int,
    batch: int = 1,
    q_prune: float = 0.0,
    q_overhead: float = 1.0,
) -> float:
    """Weight-transfer time for a layer across n_samples inputs [seconds].

    With batch processing, each weight is fetched once per `batch` samples.
    With pruning, only (1 - q_prune) of the weights are streamed, inflated by
    the sparse-format overhead q_overhead (paper: 64/(3*16) = 1.33).
    """
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if q_overhead < 1.0:
        raise ValueError(f"q_overhead must be >= 1, got {q_overhead}")
    nbytes = (
        layer.s_out
        * layer.s_in
        * hw.b_weight
        * q_overhead
        * (1.0 - q_prune)
        * n_samples
    )
    return nbytes / (hw.T_mem * batch)


def t_proc(
    layer: LayerShape,
    hw: HardwareSpec,
    n_samples: int,
    batch: int = 1,
    q_prune: float = 0.0,
    q_overhead: float = 1.0,
) -> float:
    """Overall processing time: compute and transfer are overlapped (max)."""
    return max(
        t_calc(layer, hw, n_samples, q_prune),
        t_mem(layer, hw, n_samples, batch, q_prune, q_overhead),
    )


def network_t_proc(
    net: Sequence[LayerShape],
    hw: HardwareSpec,
    n_samples: int,
    batch: int = 1,
    q_prune: float | Sequence[float] = 0.0,
    q_overhead: float = 1.0,
) -> float:
    """Sum of per-layer t_proc over a whole network [seconds]."""
    if isinstance(q_prune, (int, float)):
        q_prune = [float(q_prune)] * len(net)
    if len(q_prune) != len(net):
        raise ValueError("q_prune must have one entry per layer")
    return sum(
        t_proc(l, hw, n_samples, batch, q, q_overhead)
        for l, q in zip(net, q_prune)
    )


def n_opt(hw: HardwareSpec, q_overhead: float = 1.0) -> float:
    """Optimal batch size: machine-balance point t_calc == t_mem.

    n_opt = m * r * f_pu * b_weight * q_overhead / T_mem
    """
    return hw.m * hw.r * hw.f_pu * hw.b_weight * q_overhead / hw.T_mem


def arithmetic_intensity(batch: int, b_weight: float = 2.0) -> float:
    """MACs per weight byte streamed, as a function of batch size."""
    return batch / b_weight


def machine_balance(hw: HardwareSpec) -> float:
    """MACs per byte the machine can sustain (the roofline ridge point)."""
    return hw.macs_per_s / hw.T_mem


# ---------------------------------------------------------------------------
# Cycle-accurate variant (paper Section 5.5):
#   ceil(s_out/m) * s_in * n + m * c_a   clock cycles for the batch datapath
# ---------------------------------------------------------------------------


def batch_datapath_cycles(
    layer: LayerShape, m: int, n: int, c_a: int = 1
) -> int:
    """Exact cycle count of the paper's batch-processing datapath."""
    return math.ceil(layer.s_out / m) * layer.s_in * n + m * c_a


def pruning_datapath_cycles(
    layer: LayerShape, m: int, r: int, n: int, q_prune: float
) -> int:
    """Cycle count of the paper's pruning datapath (Section 4.4 general form)."""
    per_row = math.ceil(layer.s_in * (1.0 - q_prune) / r)
    return math.ceil(layer.s_out / m) * per_row * n


# ---------------------------------------------------------------------------
# Decode roofline on the H100
# ---------------------------------------------------------------------------

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
    model_parallel: int = 1,
    kv_parallel: int | None = None,
) -> float:
    """Batch size at which decode flips from HBM-bound to compute-bound.

    Balance: 2*n FLOPs per b_weight bytes == peak_flops / hbm_bw, so
    n_opt = peak_flops * b_weight * q_overhead / (2 * hbm_bw).  A kernel that
    skips pruned blocks (``sparse_compute``) scales both terms with
    (1 - q_prune); masked-dense execution scales n_opt with (1 - q_prune).
    Per-token KV reads never amortize with the batch and tilt n_opt upward:

        n_opt = (W_stream / hbm_bw) / (2*P_compute/peak - ctx*kv/hbm_bw)

    A non-positive denominator means memory-bound at any batch (inf).

    ``model_parallel`` = m cards each stream W/m weight bytes and run 1/m
    of the MACs; ``kv_parallel`` (default m) is the degree the KV cache
    actually shards by.  The kv term then weighs m / kv_m: a perfectly
    sharded group keeps the one-card balance point.
    """
    m = max(1, int(model_parallel))
    kv_m = max(1, int(kv_parallel if kv_parallel is not None else m))
    if kv_bytes_per_token > 0.0 and context_len > 0:
        if n_params is None:
            raise ValueError("n_params required for kv-aware n_opt")
        eff = n_params * (1.0 - q_prune)
        comp = eff if sparse_compute else n_params
        denom = (2.0 * comp / peak_flops
                 - (m / kv_m) * context_len * kv_bytes_per_token / hbm_bw)
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
    model_parallel: int = 1,
    kv_parallel: int | None = None,
) -> dict:
    """Two-term decode-step model: dict of t_calc, t_mem, t_proc, bound.
    ``model_parallel`` shards the weight stream and the MACs over m cards;
    ``kv_parallel`` (default m) is the degree the KV leaves shard by."""
    m = max(1, int(model_parallel))
    kv_m = max(1, int(kv_parallel if kv_parallel is not None else m))
    eff_params = n_params * (1.0 - q_prune)
    flops = 2.0 * (eff_params if sparse_compute else n_params) * batch
    weight_bytes = eff_params * b_weight * q_overhead
    kv_read = batch * context_len * kv_bytes_per_token
    tc = flops / (peak_flops * n_chips * m)
    tm = (weight_bytes / m + kv_read / kv_m) / (hbm_bw * n_chips)
    return {
        "t_calc": tc,
        "t_mem": tm,
        "t_proc": max(tc, tm),
        "bound": "compute" if tc >= tm else "memory",
    }


# ---------------------------------------------------------------------------
# Speculative decode: draft positions as extra batch samples
# ---------------------------------------------------------------------------


def expected_committed(accept_rate: float, spec_k: int) -> float:
    """Expected tokens committed per speculative tick, per sequence: with k
    drafts each kept with i.i.d. probability alpha, draft j commits only if
    drafts 1..j matched, and one resampled (bonus) token always commits:
    1 + alpha + ... + alpha^k, in [1, k+1]."""
    if not 0.0 <= accept_rate <= 1.0:
        raise ValueError(f"accept_rate must be in [0,1], got {accept_rate}")
    if spec_k < 0:
        raise ValueError(f"spec_k must be >= 0, got {spec_k}")
    return float(sum(accept_rate**j for j in range(spec_k + 1)))


def spec_decode_n_opt(
    spec_k: int,
    peak_flops: float = H100_PEAK_FLOPS,
    hbm_bw: float = H100_HBM_BW,
    b_weight: float = 2.0,
    q_prune: float = 0.0,
    q_overhead: float = 1.0,
    sparse_compute: bool = True,
    n_params: int | None = None,
    kv_bytes_per_token: float = 0.0,
    context_len: int = 0,
    model_parallel: int = 1,
    kv_parallel: int | None = None,
    single_pass_kv: bool = True,
) -> float:
    """Machine-balance *sequence* batch of the verify step: one pass of the
    weight stream carries B * (k+1) rows.  The paged attention kernel (B3)
    reads each page once for all k+1 positions (``single_pass_kv``), so the
    kv term stays the plain per-sequence read:
    ``decode_n_opt(kv / (k+1)) / (k+1)``; ``single_pass_kv=False`` charges
    kv per position (``decode_n_opt / (k+1)`` exactly)."""
    if spec_k < 0:
        raise ValueError(f"spec_k must be >= 0, got {spec_k}")
    kv = kv_bytes_per_token
    if single_pass_kv:
        kv = kv / (spec_k + 1)
    n = decode_n_opt(
        peak_flops, hbm_bw, b_weight, q_prune, q_overhead, sparse_compute,
        n_params, kv, context_len, model_parallel, kv_parallel,
    )
    return n / (spec_k + 1)


def spec_step_time(
    n_params: int,
    batch: int,
    spec_k: int,
    accept_rate: float,
    draft_n_params: int = 0,
    kv_bytes_per_token: float = 0.0,
    context_len: int = 0,
    peak_flops: float = H100_PEAK_FLOPS,
    hbm_bw: float = H100_HBM_BW,
    b_weight: float = 2.0,
    single_pass_kv: bool = True,
    **kw,
) -> dict:
    """One speculative tick: k draft steps at batch B plus one verify step at
    B * (k+1) rows (kv charged once a tick with ``single_pass_kv``).  Returns
    the verify step's dict plus ``t_draft``, ``t_tick``,
    ``committed_per_tick``, ``tokens_per_s`` and
    ``tokens_per_weight_stream`` (committed tokens per pass of the target's
    weight stream)."""
    kv = kv_bytes_per_token
    if single_pass_kv:
        kv = kv / (spec_k + 1)
    verify = decode_step_time(
        n_params, batch * (spec_k + 1), kv, context_len,
        peak_flops, hbm_bw, b_weight, **kw)
    t_draft = 0.0
    if spec_k > 0 and draft_n_params > 0:
        d = decode_step_time(
            draft_n_params, batch, 0.0, 0, peak_flops, hbm_bw, b_weight, **kw)
        t_draft = spec_k * d["t_proc"]
    committed = batch * expected_committed(accept_rate, spec_k)
    t_tick = verify["t_proc"] + t_draft
    out = dict(verify)
    out.update(
        t_draft=t_draft,
        t_tick=t_tick,
        committed_per_tick=committed,
        tokens_per_s=committed / t_tick,
        tokens_per_weight_stream=committed / 1.0,  # one stream per tick
    )
    return out
