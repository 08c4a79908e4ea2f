"""The failure model of the PyTorch port vs the JAX reference (tinyllama
smoke config, fp32): the fault schedule, deadlines, priority eviction,
retry backoff, every injection kind and a chaos soak give the reference
engine's terminal states and streams; a real error inside a kernel or a
draft step propagates out of ``step`` instead of taking a rung of the
degradation ladder."""

import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro.models import layers as RLayers
from repro.serving import faultinject as RFI

from repro_torch.models import layers as PLayers
from repro_torch.serving import faultinject as PFI
from repro_torch.serving.engine import Request, RequestState

sys.path.insert(0, str(Path(__file__).parent))
import _torch_serving as TS  # noqa: E402

FAILURE_COUNTERS = ("failed", "evicted", "timed_out", "retried", "fallback_ticks",
                    "decode_steps", "decode_tokens", "prefills", "completed")


@pytest.fixture(autouse=True)
def _quiet_and_restore_reference_kernel_switch():
    """The reference's kernel rung flips a process-global switch; restore
    it, and silence the ladder's warnings."""
    prev = RLayers.force_attention_kernel(None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    RLayers.force_attention_kernel(prev)


def _both(reqs_kw=None, lens=(8, 8, 8, 8), max_new=6, compress="none", **engine_kw):
    """Run both engines in lockstep over the same requests; returns (ref,
    port, ref requests, port requests)."""
    ref, eng = TS.engines(compress, **engine_kw)
    rreqs, reqs = TS.request_pair(TS.prompts(lens), max_new, **(reqs_kw or {}))
    TS.lockstep(ref, eng, rreqs, reqs, tables=bool(engine_kw.get("page_size")))
    return ref, eng, rreqs, reqs


def _same_outcome(ref, eng, rreqs, reqs):
    assert TS.states(reqs) == TS.states(rreqs)
    assert TS.outputs(reqs) == TS.outputs(rreqs)
    assert [[s.value for s in r.history] for r in reqs] == \
        [[s.value for s in r.history] for r in rreqs]
    assert [(r.retries, r.evictions, r.not_before) for r in reqs] == \
        [(r.retries, r.evictions, r.not_before) for r in rreqs]
    assert TS.counters(eng.stats, FAILURE_COUNTERS) == TS.counters(ref.stats, FAILURE_COUNTERS)
    assert sorted(eng.degraded) == sorted(ref.degraded)
    if eng.paged:
        eng.audit_pages()
        assert eng.pages_in_use == 0 == ref.pages_in_use


@pytest.mark.parametrize("seed", [0, 3])
def test_seeded_schedule_equals_reference(seed):
    rates = {k: 0.15 for k in PFI.KINDS}
    p = PFI.seeded_schedule(seed, n_ticks=40, uids=[0, 1, 2], rates=rates, slow_delay_s=2.0)
    r = RFI.seeded_schedule(seed, n_ticks=40, uids=[0, 1, 2], rates=rates, slow_delay_s=2.0)
    assert [vars(f) for f in p] == [vars(f) for f in r]
    assert {f.kind for f in p} == set(PFI.KINDS)
    with pytest.raises(ValueError):
        PFI.Fault(kind="meteor", tick=1)


def test_deadlines_ttft_and_total():
    """One slot, four requests: the queued ones blow a 3-tick TTFT budget,
    the running one a 5-tick total budget; slots and pages free at once."""
    ref, eng, rreqs, reqs = _both(
        lens=(8, 8, 8, 8), max_new=20, max_len=48, max_batch=1, page_size=8,
        tick_clock=True, ttft_deadline_s=3.0, request_timeout_s=5.0)
    _same_outcome(ref, eng, rreqs, reqs)
    assert eng.stats.timed_out == 4
    assert any("TTFT" in r.error for r in reqs) and any("total-latency" in r.error for r in reqs)


def test_priority_eviction_mid_prefill_and_readmission():
    """A high-priority arrival preempts a chunked prefill in flight; the
    evictee is readmitted from its prefix and finishes with the stream it
    would have had."""
    ref, eng = TS.engines("none", max_len=96, max_batch=1, page_size=16, prefill_chunk=4,
                          prefill_budget=4, evict_policy="priority", tick_clock=True)
    (rlow, rhigh), (low, high) = TS.request_pair(TS.prompts((40, 6)), 4)
    rhigh.priority = high.priority = 1
    for e, lo in ((ref, rlow), (eng, low)):
        e.submit(lo)
        e.step()
    assert low.state is RequestState.PREFILLING
    for e, hi in ((ref, rhigh), (eng, high)):
        e.submit(hi)
        e.step()
    assert RequestState.EVICTED in low.history
    for _ in range(200):
        if low.terminal and high.terminal:
            break
        ref.step()
        eng.step()
        eng.audit_pages()
    _same_outcome(ref, eng, [rlow, rhigh], [low, high])
    assert low.state is RequestState.FINISHED and eng.stats.evicted >= 1
    _, sync = TS.engines("none", max_len=96, max_batch=1, page_size=16)
    alone = Request(uid=0, prompt=low.prompt.copy(), max_new_tokens=4)
    sync.submit(alone)
    sync.run_until_done()
    assert alone.output == low.output


def test_retry_backoff():
    """NaN logits at ticks 3 and 6 send every live request through retries
    with a doubling backoff on the engine clock (equal to the reference's
    ``not_before`` gates, compared in ``_same_outcome``)."""
    faults = [("nan_logits", 3, {}), ("nan_logits", 6, {})]
    ref, eng, rreqs, reqs = _both(
        lens=(8, 9), max_new=8, max_len=48, max_batch=2, page_size=8, tick_clock=True,
        max_retries=3, retry_backoff_s=2.0, faults=faults)
    _same_outcome(ref, eng, rreqs, reqs)
    assert eng.stats.retried >= 2 and all(r.retries >= 1 for r in reqs)
    assert max(r.not_before for r in reqs) > 2.0


_KIND_RUNS = {
    # kind: (engine fields, fault tick, fault kwargs, max_new); alloc_fail
    # meets the first admissions
    "nan_logits": (dict(page_size=8, max_retries=2), 3, dict(uid=1), 6),
    "alloc_fail": (dict(page_size=8, max_retries=2), 1, dict(n_ticks=2), 6),
    "drop_tick": (dict(page_size=8, watchdog_timeout_s=2.5), 3, dict(n_ticks=4), 6),
    "dead_draft": (dict(page_size=8, spec_k=2, draft="near"), 3, dict(), 6),
    "slow_tick": (dict(page_size=8, request_timeout_s=9.0), 3, dict(delay_s=7.0), 8),
    "kernel_fault": (dict(page_size=8, spec_k=2, draft="near"), 3, dict(n_ticks=99), 6),
}


@pytest.mark.parametrize("kind", sorted(_KIND_RUNS))
def test_each_injection_kind_equals_reference(kind):
    fields, tick, fault_kw, max_new = _KIND_RUNS[kind]
    ref, eng, rreqs, reqs = _both(
        lens=(8, 12, 8), max_new=max_new, max_len=48, max_batch=2, kv_dtype="int8",
        tick_clock=True, faults=[(kind, tick, fault_kw)], **fields)
    _same_outcome(ref, eng, rreqs, reqs)
    fired = {k for _, k, _ in eng.fault_injector.fired}
    assert kind in fired and eng.fault_injector.fired == ref.fault_injector.fired
    if kind == "dead_draft":
        assert list(eng.degraded) == ["speculative"] and not eng.spec_active
    if kind == "kernel_fault":
        assert list(eng.degraded) == ["attention_kernel"] and not eng.attention_kernel
        assert eng.stats.fallback_ticks > 0
    if kind == "drop_tick":
        assert eng.watchdog.last_seen == ref.watchdog.last_seen
    if kind in ("dead_draft", "kernel_fault"):
        # the rung is taken mid-flight: every request keeps its stream
        assert all(r.state is RequestState.FINISHED for r in reqs)


@pytest.mark.parametrize("variant", ["int8-paged-chunked", "paged-spec"])
def test_chaos_soak_equals_reference(variant):
    """``run_chaos`` under one seeded schedule of every kind: equal terminal
    states and streams, zero leaks, a clean audit after every tick."""
    lens = (6, 30, 8, 26, 5, 12)
    kw = dict(max_len=96, max_batch=2, page_size=16, kv_dtype="int8", max_retries=3,
              tick_clock=True, watchdog_timeout_s=3.0)
    if variant == "paged-spec":
        kw.update(spec_k=2, draft="near")
    else:
        kw.update(prefill_chunk=4, prefill_budget=8)
    rates = {"nan_logits": 0.1, "alloc_fail": 0.1, "drop_tick": 0.05, "dead_draft": 0.02,
             "slow_tick": 0.05, "kernel_fault": 0.02}
    sched = RFI.seeded_schedule(3, n_ticks=80, uids=list(range(len(lens))), rates=rates,
                                slow_delay_s=1.0)
    faults = [(f.kind, f.tick, dict(uid=f.uid, delay_s=f.delay_s)) for f in sched]
    ref, eng = TS.engines("none", faults=faults, **kw)
    rreqs, reqs = TS.request_pair(TS.prompts(lens), 5)
    rrep = RFI.run_chaos(ref, [(1 + 2 * i, r) for i, r in enumerate(rreqs)])
    prep = PFI.run_chaos(eng, [(1 + 2 * i, r) for i, r in enumerate(reqs)])
    assert prep.all_terminal and prep.leaked_pages == 0
    assert prep.states == rrep.states and prep.outputs == rrep.outputs
    assert prep.ticks == rrep.ticks
    assert eng.fault_injector.fired == ref.fault_injector.fired
    assert sorted(eng.degraded) == sorted(ref.degraded)


def test_kernel_error_propagates_and_takes_no_rung(monkeypatch):
    """A RuntimeError inside the paged attention is not a fault the ladder
    takes: it leaves ``step()`` and ``degraded`` stays empty."""
    _, eng = TS.engines("none", max_len=48, max_batch=2, page_size=8)

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(PLayers, "paged_decode_attention", broken)
    eng.submit(Request(uid=0, prompt=np.arange(8, dtype=np.int32), max_new_tokens=4))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.run_until_done()
    assert eng.degraded == {} and eng.attention_kernel


def test_draft_error_propagates_and_takes_no_rung(monkeypatch):
    _, eng = TS.engines("none", max_len=48, max_batch=2, spec_k=2, draft="near")
    real = eng.draft_api

    class Broken:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def decode_step(*a, **k):
            raise RuntimeError("draft step failed to launch")

    eng.draft_api = Broken()
    eng.submit(Request(uid=0, prompt=np.arange(8, dtype=np.int32), max_new_tokens=4))
    with pytest.raises(RuntimeError, match="failed to launch"):
        eng.run_until_done()
    assert eng.degraded == {} and eng.spec_active


def test_cancel_and_resubmit():
    _, eng = TS.engines("none", max_len=48, max_batch=1, page_size=8)
    a, b = (Request(uid=i, prompt=np.arange(8, dtype=np.int32), max_new_tokens=6)
            for i in range(2))
    eng.submit(a)
    eng.submit(b)
    eng.step()
    assert eng.cancel(a) and eng.cancel(b) and not eng.cancel(a)
    assert a.state is b.state is RequestState.FAILED and a.error == "cancelled"
    eng.audit_pages()
    assert eng.pages_in_use == 0 and eng.stats.failed == 2
    with pytest.raises(ValueError, match="already submitted"):
        eng.submit(a)
