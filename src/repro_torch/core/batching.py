"""Batch processing (port of ``repro/core/batching.py``; paper Sections
4.2 / 5.5).

Ported:

1. The paper's TDM section schedule -- which (section, sample) pair the
   FPGA datapath runs at each macro step -- its weight-transfer count and
   the latency / throughput model of Fig. 7 (``section_schedule``,
   ``weight_transfers``, ``batch_latency``, ``throughput_samples_per_s``).
   ``models.fcnet.forward_q78_sectioned`` runs in this order.
2. ``mean_decode_context``, ``BatchSizer`` (the balance point, the
   latency clamp, the multi-card and speculative terms, the acceptance EMA
   the engine feeds back), ``efficiency_curve`` and ``MixedSizer`` (the
   blend of several families' sizers under one mixed engine,
   ``serving/mixed.py``).  The sizer's defaults are the H100 data-sheet
   constants of ``core.perf_model``.
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
    """Pick decode batch sizes at the machine-balance point n_opt, clamped
    by ``max_latency_s`` (batching trades latency, paper Section 6.3).

    ``sparse_compute``: the datapath skips pruned blocks (t_calc scales with
    1 - q_prune).  ``kv_bytes_per_token`` at ``context_len``: per-sample
    cache reads, which never amortize with the batch.  ``model_parallel`` /
    ``kv_parallel``: the cards of one model group and the degree the KV
    cache shards by; ``n_chips`` scales a tick's time uniformly (data
    replicas splitting the batch), as in the reference.  ``spec_k`` draft
    tokens a tick make the verify step's batch B * (k+1) (the KV pages are
    read once a tick); ``spec_accept`` is the per-draft acceptance the
    engine feeds back (``observe_accept``), and ``draft_n_params`` charges
    the k+1 draft steps a tick."""

    n_params: int
    b_weight: float = 2.0
    peak_flops: float = pm.H100_PEAK_FLOPS
    hbm_bw: float = pm.H100_HBM_BW
    n_chips: int = 1
    max_latency_s: float | None = None
    q_prune: float = 0.0
    q_overhead: float = 1.0
    sparse_compute: bool = True
    kv_bytes_per_token: float = 0.0
    context_len: int = 0
    model_parallel: int = 1
    kv_parallel: int | None = None
    spec_k: int = 0
    spec_accept: float = 0.0
    draft_n_params: int = 0

    @property
    def n_opt(self) -> int:
        kw = dict(
            q_prune=self.q_prune,
            q_overhead=self.q_overhead,
            sparse_compute=self.sparse_compute,
            n_params=self.n_params,
            kv_bytes_per_token=self.kv_bytes_per_token,
            context_len=self.context_len,
            model_parallel=self.model_parallel,
            kv_parallel=self.kv_parallel,
        )
        if self.spec_k > 0:
            n = pm.spec_decode_n_opt(self.spec_k, self.peak_flops, self.hbm_bw,
                                     self.b_weight, **kw)
        else:
            n = pm.decode_n_opt(self.peak_flops, self.hbm_bw, self.b_weight, **kw)
        if not math.isfinite(n):
            return UNBOUNDED_NOPT
        return max(1, int(round(n)))

    def committed_per_tick(self, batch: int) -> float:
        """Expected committed tokens per engine tick at this batch."""
        if self.spec_k <= 0:
            return float(batch)
        return batch * pm.expected_committed(self.spec_accept, self.spec_k)

    @property
    def memory_bound(self) -> bool:
        """True when the kv stream alone exceeds the compute budget (n_opt is
        the UNBOUNDED_NOPT sentinel, not a balance point)."""
        return self.n_opt >= UNBOUNDED_NOPT

    def observe_accept(self, accept_rate: float, ema: float = 0.2) -> "BatchSizer":
        """A copy with one tick's measured acceptance folded into
        ``spec_accept`` (EMA; a fresh sizer adopts the first measurement)."""
        if not 0.0 <= accept_rate <= 1.0:
            raise ValueError(f"accept_rate must be in [0,1], got {accept_rate}")
        if self.spec_accept <= 0.0:
            new = accept_rate
        else:
            new = (1.0 - ema) * self.spec_accept + ema * accept_rate
        return dataclasses.replace(self, spec_accept=new)

    def step_time(self, batch: int, context_len: int | None = None,
                  kv_bytes_per_token: float | None = None,
                  prefill_tokens: int = 0) -> float:
        """Modeled seconds of one tick: the (verify) step at batch * (k+1)
        rows with the kv read charged once, the k+1 draft steps, and one
        more pass of the weight stream for ``prefill_tokens`` chunked-prefill
        rows (a chunk runs on its own batch-1 cache, so its weight traffic
        does not amortize with the decode batch's; its kv read is charged
        at half the context)."""
        kv0 = self.kv_bytes_per_token if kv_bytes_per_token is None else kv_bytes_per_token
        kv = kv0 / (self.spec_k + 1) if self.spec_k > 0 else kv0
        ctx = self.context_len if context_len is None else context_len
        common = dict(peak_flops=self.peak_flops, hbm_bw=self.hbm_bw, b_weight=self.b_weight,
                      n_chips=self.n_chips)
        model = dict(q_prune=self.q_prune, q_overhead=self.q_overhead,
                     sparse_compute=self.sparse_compute, model_parallel=self.model_parallel,
                     kv_parallel=self.kv_parallel)
        rows = batch * (self.spec_k + 1) if self.spec_k > 0 else batch
        t = pm.decode_step_time(self.n_params, rows, kv, ctx, **common, **model)["t_proc"]
        if self.spec_k > 0 and self.draft_n_params > 0:
            t += (self.spec_k + 1) * pm.decode_step_time(
                self.draft_n_params, batch, 0.0, 0, **common)["t_proc"]
        if prefill_tokens > 0:
            t += pm.decode_step_time(self.n_params, prefill_tokens, kv0, ctx // 2,
                                     **common, **model)["t_proc"]
        return t

    def spec_payoff(self, batch: int) -> float:
        """Modeled committed tokens/s of a speculative tick at this batch over
        the same sizer's plain decode; below 1, speculation loses."""
        if self.spec_k <= 0:
            return 1.0
        plain = dataclasses.replace(self, spec_k=0, spec_accept=0.0, draft_n_params=0)
        spec_rate = self.committed_per_tick(batch) / self.step_time(batch)
        plain_rate = batch / plain.step_time(batch)
        return spec_rate / plain_rate

    def spec_worthwhile(self, batch: int, min_accept: float = 0.0) -> bool:
        """Speculation stays on while the acceptance EMA clears
        ``min_accept`` and the modeled payoff is at least 1."""
        if self.spec_k <= 0:
            return False
        return self.spec_accept >= min_accept and self.spec_payoff(batch) >= 1.0

    def pick(self, waiting: int, context_len: int | None = None,
             kv_bytes_per_token: float | None = None) -> int:
        """Batch for the next decode step: min(waiting, n_opt), halved until
        a step fits the latency budget."""
        n = min(max(1, waiting), self.n_opt)
        if self.max_latency_s is not None:
            while n > 1 and self.step_time(n, context_len, kv_bytes_per_token) > self.max_latency_s:
                n //= 2
        return n


def efficiency_curve(sizer: BatchSizer, batches: Sequence[int]) -> list[dict]:
    """tokens/s and per-token latency across batch sizes (Fig. 7 analogue)."""
    out = []
    for b in batches:
        t = sizer.step_time(b)
        out.append({
            "batch": b,
            "step_s": t,
            "tokens_per_s": b / t,
            # useful model FLOPs only: masked-zero MACs are occupancy
            "model_flops_util": min(
                1.0,
                2.0 * sizer.n_params * (1 - sizer.q_prune) * b
                / (t * sizer.peak_flops)),
        })
    return out


# ---------------------------------------------------------------------------
# mixed-workload sizing (heterogeneous serving)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MixedSizer:
    """Machine-balance accounting for a blend of model families served by
    one engine (``serving/mixed.py``).  Each family keeps its own
    ``BatchSizer`` -- its own weight stream and bytes/token (``api.
    kv_bytes_per_token`` folds recurrent-state and encoder-frame streams
    into the rate) -- and a mixed tick runs one step per family, so its
    time is the SUM of the member steps at their batch shares.

    ``weights`` are traffic fractions (any positive scale).  ``n_opt``
    stays per family: mixing never moves a family's own balance point, it
    only divides the tick, which is why the blend's floor is the
    time-weighted solo rate (``blended_floor``), not the mean of the solo
    rates."""

    sizers: dict  # family name -> BatchSizer
    weights: dict  # family name -> traffic fraction

    def __post_init__(self):
        if set(self.sizers) != set(self.weights):
            raise ValueError(f"sizers/weights keys differ: {sorted(self.sizers)} vs "
                             f"{sorted(self.weights)}")
        if not self.sizers:
            raise ValueError("MixedSizer needs at least one family")
        if sum(self.weights.values()) <= 0:
            raise ValueError("weights must sum to a positive value")

    def share(self, name: str) -> float:
        return self.weights[name] / sum(self.weights.values())

    @property
    def n_opt(self) -> dict:
        """Per-family balance points, unchanged by mixing."""
        return {name: s.n_opt for name, s in self.sizers.items()}

    def batches(self, batch: int) -> dict:
        """A total batch split across the families by traffic share (each
        family at least 1)."""
        return {name: max(1, round(batch * self.share(name))) for name in self.sizers}

    def step_time(self, batch: int) -> float:
        """One mixed tick: every family's step at its share of the batch, one
        after another (one device)."""
        return sum(self.sizers[n].step_time(b) for n, b in self.batches(batch).items())

    def tokens_per_s(self, batch: int) -> float:
        return sum(self.batches(batch).values()) / self.step_time(batch)

    def blended_floor(self, batch: int) -> float:
        """The traffic-weighted solo rate a mixed engine is measured
        against: total tokens over the sum of each family's solo time for
        its share (the time-weighted harmonic blend)."""
        bs = self.batches(batch)
        return sum(bs.values()) / sum(self.sizers[n].step_time(b) for n, b in bs.items())
