"""Spans around the port's calls, and the reduction of a profiled slice.

``Spans`` wraps, on one engine, the model's ``prefill`` and
``decode_step`` (host spans that end in a synchronize, a
``record_function`` range each) and the engine's ``_prefill_request``
(which request a prefill serves), and, for a configuration with a MoE
layer, the module attribute ``repro_torch.models.moe.apply_moe`` that
``transformer.py`` calls (a ``record_function`` range).  While ``profiling`` is set it also counts
each call's work (``work.Work``).  Only a ``--trace 1`` run installs them.

``reduce_profile`` turns a ``torch.profiler`` capture of the slice into
what the per-layer readers take: the device operations' intervals, their
union (busy seconds), the device time of the kernels inside each range
name, the idle gaps labelled by the host span they fell in, and the top
operations by device time.  Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

import torch

clock = time.monotonic

SLICE, PREFILL, DECODE, MOE = ("portbench.slice", "portbench.prefill", "portbench.decode",
                               "portbench.moe")
MOE_IN_DECODE = "portbench.moe in decode"
GAP_LABELS = {PREFILL: "admission/prefill", DECODE: "decode call"}
HOST_BETWEEN = "host between calls"


@dataclasses.dataclass
class Span:
    kind: str  # "prefill" | "decode"
    start: float
    end: float
    uid: object = None
    tokens: int = 0  # prompt tokens (prefill) or live sequences (decode)


class Spans:
    def __init__(self, engine, work):
        self.engine = engine
        self.work = work
        self.spans: list = []
        self.profiling = False
        self.profiled_work: list = []  # (kind, least_s, flops) of calls in the slice
        self._uid = None
        self._sync = engine.device.type == "cuda"
        api = engine.api
        self._restore = []
        prefill, decode = api.prefill, api.decode_step

        def traced_prefill(cfg, params, batch, cache, **kw):
            S = int(batch["tokens"].shape[1])
            t = clock()
            with torch.profiler.record_function(PREFILL):
                out = prefill(cfg, params, batch, cache, **kw)
                self._wait()
            self.spans.append(Span("prefill", t, clock(), self._uid, S))
            if self.profiling:
                self.profiled_work.append(("prefill",) + self.work.prefill(S))
            return out

        def traced_decode(cfg, params, cache, tokens, pos, **kw):
            live = engine._decoding_slots()
            ctx = [int(engine.slot_pos[s]) + 1 for s in live]
            t = clock()
            with torch.profiler.record_function(DECODE):
                out = decode(cfg, params, cache, tokens, pos, **kw)
                self._wait()
            self.spans.append(Span("decode", t, clock(), None, len(live)))
            if self.profiling and live:
                self.profiled_work.append(("decode",) + self.work.decode(ctx))
            return out

        engine.api = dataclasses.replace(api, prefill=traced_prefill, decode_step=traced_decode)
        request = engine._prefill_request

        def traced_request(req, tokens):
            self._uid = req.uid
            return request(req, tokens)

        engine._prefill_request = traced_request
        if engine.cfg.moe is None:
            return

        from repro_torch.models import moe as moe_module

        apply_moe = moe_module.apply_moe

        def traced_moe(*a, **kw):
            with torch.profiler.record_function(MOE):
                return apply_moe(*a, **kw)

        moe_module.apply_moe = traced_moe
        self._restore.append((moe_module, "apply_moe", apply_moe))

    def _wait(self):
        if self._sync:
            torch.cuda.synchronize()

    def remove(self):
        for obj, attr, val in self._restore:
            setattr(obj, attr, val)
        self._restore = []


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclasses.dataclass
class Profile:
    """A profiled slice, times in seconds."""

    window_s: float
    busy_s: float
    ops: list  # [(name, device seconds)] largest first
    range_device_s: dict  # range name -> (device seconds of its kernels, calls)
    gaps: list  # [(label, seconds)] every idle gap, longest first
    n_device_events: int


def reduce_profile(prof) -> Profile:
    """The slice's numbers from a ``torch.profiler.profile`` whose body ran
    inside a ``portbench.slice`` range (times from the profiler's clock,
    microseconds, shared by host and device events)."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in events:
        if e.device_type == cuda:
            if e.name.startswith("portbench."):
                continue  # the device-side copy of a range: not an operation
            device.append(e)
        else:
            host.append(e)
    slices = [e for e in host if e.name == SLICE]
    if not slices:
        raise RuntimeError("the profile holds no portbench.slice range")
    s0, s1 = slices[0].time_range.start, slices[0].time_range.end
    spans = sorted((e.time_range.start, e.time_range.end, GAP_LABELS[e.name])
                   for e in host if e.name in GAP_LABELS)
    intervals = [(max(e.time_range.start, s0), min(e.time_range.end, s1)) for e in device]
    merged = _merge([iv for iv in intervals if iv[1] > iv[0]])
    busy_us = sum(b - a for a, b in merged)
    by_name: dict = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    ops = sorted(((n, us * 1e-6) for n, us in by_name.items()), key=lambda x: -x[1])
    decodes = sorted((e.time_range.start, e.time_range.end) for e in host if e.name == DECODE)
    starts = [a for a, _ in decodes]
    ranges: dict = {}
    for e in host:
        if e.name not in (PREFILL, DECODE, MOE):
            continue
        keys = [e.name]
        if e.name == MOE:  # the MoE calls of decode steps apart
            i = bisect.bisect_right(starts, e.time_range.start) - 1
            if i >= 0 and e.time_range.end <= decodes[i][1]:
                keys.append(MOE_IN_DECODE)
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = getattr(e, "cuda_time_total", 0.0)
        for k in keys:
            us, n = ranges.get(k, (0.0, 0))
            ranges[k] = (us + dev, n + 1)
    ranges = {k: (us * 1e-6, n) for k, (us, n) in ranges.items()}
    gaps = []
    edges = [s0] + [x for iv in merged for x in iv] + [s1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = next((lab for h0, h1, lab in spans if h0 <= mid <= h1), HOST_BETWEEN)
        gaps.append((label, (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return Profile(window_s=(s1 - s0) * 1e-6, busy_s=busy_us * 1e-6, ops=ops,
                   range_device_s=ranges, gaps=gaps, n_device_events=len(device))


def breakdown(p: Profile) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time, and the idle time by what the host was doing (totals first)
    followed by the longest gaps, ten entries at most."""
    totals: dict = {}
    for label, s in p.gaps:
        totals[label] = totals.get(label, 0.0) + s
    idle = [[f"all gaps: {k}", v] for k, v in sorted(totals.items(), key=lambda x: -x[1])]
    idle += [[f"gap: {label}", s] for label, s in p.gaps[:10 - len(idle)]]
    return {"device_ops": [[n, s] for n, s in p.ops[:10]], "idle_gaps": idle[:10]}
