"""Chunked-prefill scheduling primitives for continuous batching (port of
``repro/serving/scheduler.py``).

The engine's tick is ONE batched decode step, so a long prompt admitted
synchronously stalls every decoding neighbor for the full prefill — the
head-of-line blocking the paper's batch processing exists to avoid.
Continuous batching splits the prefill into fixed-size chunks and
advances at most ``prefill_budget`` prompt tokens per tick, interleaved
with the decode step, so the decode batch keeps committing while long
prompts stream in.

This module holds the pure, host-side pieces — span arithmetic, the
per-tick token budget, and the in-flight job record — so the scheduler
invariants are property-testable without building an engine.

Why the final span overlaps instead of padding
----------------------------------------------
Each chunk runs the multi-token decode step over ``(1, C)``
tokens at positions ``[start, start + C)`` of a private batch-1 cache.
Padding a ragged tail would (a) scatter garbage KV at positions past the
prompt — recoverable only by masking that the contiguous ring does not
apply to same-row rewrites — and (b) let ``start + C`` run past
``max_len`` where the ring scatter wraps onto position 0.  Re-processing
the overlapped span ``[S - C, S)`` instead recomputes KV entries that
are bit-identical to what the previous chunk already wrote (same tokens,
same positions, same params — attention over a causal prefix is a pure
function of both), so the rewrite is a no-op and the last logits row is
exactly the full-prefill logits row.  Prompts shorter than one chunk
take the ordinary prefill path and never reach ``chunk_spans``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple


def chunk_spans(S: int, chunk: int) -> List[Tuple[int, int]]:
    """Token spans ``[start, stop)`` that chunked prefill runs over a
    prompt of ``S`` tokens with chunk size ``chunk``.

    Every span is exactly ``chunk`` wide when ``S >= chunk`` (the ragged
    tail is covered by overlapping the final span back to ``S - chunk``;
    see the module docstring); a prompt shorter than one chunk is a
    single ``(0, S)`` span.  Invariants (property-tested): spans cover
    ``[0, S)`` exactly once in order, no span exceeds ``chunk`` tokens,
    the last span ends at ``S``, and a span never starts past the end of
    the previous one (re-processing, never a gap).
    """
    if S <= 0:
        raise ValueError(f"prompt length must be positive, got {S}")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if S <= chunk:
        return [(0, S)]
    spans = [(i * chunk, (i + 1) * chunk) for i in range(S // chunk)]
    if spans[-1][1] < S:
        spans.append((S - chunk, S))
    return spans


class TickBudget:
    """Per-tick prefill token budget: at most ``budget`` prompt tokens
    advance per engine tick, across all in-flight prefills.  The engine
    resets it each tick and charges every chunk (and every short-prompt
    inline prefill) against it; ``try_charge`` refuses work that would
    overrun, which is the invariant the property suite asserts."""

    def __init__(self, budget: int):
        if budget <= 0:
            raise ValueError(f"budget must be positive, got {budget}")
        self.budget = int(budget)
        self.used = 0

    @property
    def remaining(self) -> int:
        return self.budget - self.used

    def reset(self) -> None:
        self.used = 0

    def try_charge(self, n: int) -> bool:
        """Charge ``n`` tokens if they fit; a charge larger than the
        whole budget is allowed only from a fresh tick (``used == 0``) so
        a prompt span wider than the budget — possible only via the
        short-prompt inline path — still makes progress instead of
        starving forever."""
        if n <= 0:
            raise ValueError(f"charge must be positive, got {n}")
        if self.used + n > self.budget and not (self.used == 0 and n > self.budget):
            return False
        self.used += n
        return True


@dataclasses.dataclass
class PrefillJob:
    """One in-flight chunked prefill: the host-side record of a slot in
    RequestState.PREFILLING.  ``done`` is the token frontier (next chunk
    starts there); ``cache1`` is the private batch-1 contiguous cache the
    chunks write, scattered into the slot's pages/row only at the
    DECODING transition — until then the published page-table row stays
    all-NULL so batched-decode scatters from this slot are absorbed by
    the null page."""

    req: Any
    tokens: Any  # (S,) np.int32 prompt (+ committed output when resuming)
    S: int  # len(tokens) + model prefix
    resumed: bool
    shared_len: int = 0  # prefix-registry hit: positions [0, shared_len) shared
    prompt_key: Optional[tuple] = None  # registry key (paged + share_prefix)
    done: int = 0  # prompt tokens prefilled so far
    cache1: Any = None  # private batch-1 cache, built lazily at first chunk
    last_row: Any = None  # final chunk's last logits row (samples token 1)

    @property
    def finished(self) -> bool:
        return self.done >= self.S
