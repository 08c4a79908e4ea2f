"""Serving batch sizer (port of ``repro/core/batching.py``).

Ported: ``mean_decode_context`` and the balance point of ``BatchSizer``,
which serving and the engine read; the latency clamp, the speculative and
multi-chip terms wait for their slices (ROADMAP A7, A13).  The sizer's
defaults are the H100 data-sheet constants of ``core.perf_model``.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import perf_model as pm

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
