"""What the metric readers under ``portbench/metrics`` share.

A reader is ``read(run) -> float | None`` of a ``bench.Run``; None means
that it found nothing to read, and the metric is left out of the line.
A share of a peak or a roofline is never made up as 0: without the
profiled slice or a device time to divide by, its reader returns None.
"""

from __future__ import annotations

import math

from portbench import trace as TRACE
from portbench.work import BF16_FLOPS


def percentile(values: list, q: float):
    """The nearest-rank q-th percentile (the smallest value with at least q%
    of the values at or below it); None for no values.  inf counts as
    larger than every number (a request that never got its token)."""
    if not values:
        return None
    xs = sorted(values)
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def window_tokens(run) -> list:
    """Stamps of every token committed in the window."""
    return [t for r in run.records for t in r.times if run.in_window(t)]


def window_gaps(run) -> list:
    """Every gap between two consecutive tokens of a request, both in the
    window (seconds)."""
    gaps = []
    for r in run.records:
        ts = [t for t in r.times if run.in_window(t)]
        gaps += [b - a for a, b in zip(ts, ts[1:])]
    return gaps


def profile(run):
    """The profiled slice if it holds device events, else None."""
    p = run.profile
    if p is None or p.n_device_events == 0 or p.window_s <= 0:
        return None
    return p


def work(run, kind: str) -> tuple:
    """(least seconds, operations) summed over the profiled calls of
    ``kind`` ("decode", "prefill" or None for both)."""
    items = [w for w in run.profiled_work if kind is None or w[0] == kind]
    return sum(w[1] for w in items), sum(w[2] for w in items)


def mfu(run):
    """Model operations of every call in the profiled slice over the slice's
    seconds at the bf16 peak, in %."""
    p = profile(run)
    if p is None or not run.profiled_work:
        return None
    return 100.0 * work(run, None)[1] / (p.window_s * BF16_FLOPS)


def roofline(run, kind: str):
    """The least time of the profiled ``kind`` calls' work over the device
    time of the kernels inside them, in %."""
    p = profile(run)
    rng = TRACE.PREFILL if kind == "prefill" else TRACE.DECODE
    if p is None or rng not in p.range_device_s:
        return None
    device_s = p.range_device_s[rng][0]
    least = work(run, kind)[0]
    if device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s


def idle(run):
    """Share of the profiled slice with no device operation running, in %."""
    p = profile(run)
    if p is None:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
