"""Continuous batching in the PyTorch port vs the JAX reference (tinyllama
smoke config, fp32): the scheduler primitives and the load generator equal
the reference's on the same inputs, the chunked engine's greedy streams
equal the reference's chunked engine and the port's synchronous engine,
and an open-loop run's summary (simulated time) equals the reference's."""

import sys
from pathlib import Path

import numpy as np
import pytest

from repro.serving import loadgen as RL
from repro.serving import scheduler as RS

from repro_torch.serving import loadgen as PL
from repro_torch.serving import scheduler as PS
from repro_torch.serving.engine import RequestState

sys.path.insert(0, str(Path(__file__).parent))
import _torch_serving as TS  # noqa: E402
from _hypcompat import given, settings, st  # noqa: E402

# ---------------------------------------------------------------------------
# scheduler primitives


def _same_spans(S, chunk):
    assert PS.chunk_spans(S, chunk) == RS.chunk_spans(S, chunk)


def _same_budget(budget, charges):
    p, r = PS.TickBudget(budget), RS.TickBudget(budget)
    for n in charges:
        assert p.try_charge(n) == r.try_charge(n)
        assert (p.used, p.remaining) == (r.used, r.remaining)
    p.reset()
    assert p.used == 0


@pytest.mark.parametrize("S,chunk", [(1, 1), (5, 8), (8, 8), (16, 8), (17, 8), (2032, 256),
                                     (1100, 256), (40, 256), (31, 4)])
def test_chunk_spans_equal_reference(S, chunk):
    _same_spans(S, chunk)


@given(st.integers(1, 3000), st.integers(1, 600))
@settings(max_examples=200, deadline=None)
def test_chunk_spans_equal_reference_property(S, chunk):
    _same_spans(S, chunk)


def test_scheduler_errors_equal_reference():
    for fn in (lambda m: m.chunk_spans(0, 4), lambda m: m.chunk_spans(4, 0),
               lambda m: m.TickBudget(0), lambda m: m.TickBudget(4).try_charge(0)):
        with pytest.raises(ValueError):
            fn(PS)
        with pytest.raises(ValueError):
            fn(RS)


@pytest.mark.parametrize("budget,charges", [(8, (4, 4, 1)), (8, (12, 1)), (8, (3, 12, 5)),
                                            (16, (8, 8, 8)), (1, (1, 1))])
def test_tick_budget_equal_reference(budget, charges):
    _same_budget(budget, charges)


@given(st.integers(1, 64), st.lists(st.integers(1, 80), max_size=12))
@settings(max_examples=200, deadline=None)
def test_tick_budget_equal_reference_property(budget, charges):
    _same_budget(budget, charges)


# ---------------------------------------------------------------------------
# load generator


@pytest.mark.parametrize("seed", [0, 11])
def test_loadgen_equals_reference(seed, tmp_path):
    for scale in (1, 3):
        pm, rm = PL.chat_mixture(scale), RL.chat_mixture(scale)
        assert pm.components == rm.components and pm.max_context == rm.max_context
        pa, ra = PL.poisson_trace(0.7, 12, pm, seed=seed), RL.poisson_trace(0.7, 12, rm, seed=seed)
        assert [tuple(vars(a).values()) for a in pa] == [tuple(vars(a).values()) for a in ra]
    preqs, rreqs = PL.make_requests(pa, 256, seed=seed), RL.make_requests(ra, 256, seed=seed)
    for p, r in zip(preqs, rreqs):
        assert p.uid == r.uid and p.max_new_tokens == r.max_new_tokens
        np.testing.assert_array_equal(p.prompt, r.prompt)
    # the JSONL trace round-trips, and each package reads the other's file
    PL.save_trace(str(tmp_path / "p.jsonl"), pa)
    RL.save_trace(str(tmp_path / "r.jsonl"), ra)
    assert PL.load_trace(str(tmp_path / "p.jsonl")) == pa
    assert [vars(a) for a in RL.load_trace(str(tmp_path / "p.jsonl"))] == \
        [vars(a) for a in PL.load_trace(str(tmp_path / "r.jsonl"))]
    with pytest.raises(ValueError):
        PL.LengthMixture(((1.0, (4, 2), (1, 1)),))


def test_serve_cli_open_loop_mixture_equals_reference():
    from repro.launch import serve as rserve

    from repro_torch.launch import serve as pserve

    for p, n, cap in ((12, 16, 128), (40, 16, 2048), (300, 8, 256)):
        assert pserve._open_loop_mixture(p, n, cap).components == \
            rserve._open_loop_mixture(p, n, cap).components


# ---------------------------------------------------------------------------
# the chunked engine


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_streams_equal_reference_and_synchronous(paged):
    cache = dict(kv_dtype="int8", page_size=16, share_prefix=True) if paged else {}
    lens = (14, 6, 40, 9)
    ref, eng = TS.engines("quant_sparse", max_len=64, max_batch=2, prefill_chunk=8,
                          prefill_budget=12, **cache)
    rreqs, reqs = TS.request_pair(TS.prompts(lens), 6)
    TS.lockstep(ref, eng, rreqs, reqs, tables=paged)
    assert TS.outputs(reqs) == TS.outputs(rreqs)
    names = ("prefill_chunks", "prefill_tokens", "decode_steps", "decode_tokens", "prefills")
    assert TS.counters(eng.stats, names) == TS.counters(ref.stats, names)
    assert eng.stats.prefill_chunks > len(lens)
    eng.audit_pages()
    assert eng.pages_in_use == 0
    _, sync = TS.engines("quant_sparse", max_len=64, max_batch=2, **cache)
    _, sreqs = TS.request_pair(TS.prompts(lens), 6)
    for r in sreqs:
        sync.submit(r)
    sync.run_until_done()
    assert TS.outputs(sreqs) == TS.outputs(reqs)


def _chunked_engine(**kw):
    base = dict(max_len=96, max_batch=2, page_size=16, prefill_chunk=4, prefill_budget=4,
                tick_clock=True)
    base.update(kw)
    return TS.engines("none", **base)[1]


def test_streaming_callbacks_budget_and_no_starvation():
    eng = _chunked_engine()
    short, long = TS.request_pair(TS.prompts((6, 40)), 12)[1]
    seen = {r.uid: [] for r in (short, long)}
    for r in (short, long):
        r.on_token = lambda req, tok: seen[req.uid].append((tok, eng.tick))
    eng.submit(short)
    while short.state is not RequestState.DECODING:
        eng.step()
    eng.submit(long)
    eng.step()  # admits long mid-stream; its first chunk runs
    assert long.state is RequestState.PREFILLING
    while long.state is RequestState.PREFILLING and not short.terminal:
        before = len(short.output)
        eng.step()
        eng.audit_pages()
        assert eng.last_tick_prefill_tokens <= eng.prefill_budget
        assert len(short.output) == before + 1, "decode starved"
    while not (short.terminal and long.terminal):
        eng.step()
    assert eng.stats.prefill_chunks >= 10
    for r in (short, long):
        assert r.state is RequestState.FINISHED
        assert [t for t, _ in seen[r.uid]] == list(r.output)  # streamed == final
        assert len({tick for _, tick in seen[r.uid]}) >= 2  # across ticks


def test_prefill_budget_respected_over_several_jobs():
    eng = _chunked_engine(max_batch=3, prefill_budget=8)
    reqs = TS.request_pair(TS.prompts((30, 28, 26)), 4)[1]
    for r in reqs:
        eng.submit(r)
    while eng.queue or eng._live_slots():
        eng.step()
        eng.audit_pages()
        assert eng.last_tick_prefill_tokens <= eng.prefill_budget
    assert eng.stats.prefill_chunks >= 3 * (26 // 4)
    assert all(r.state is RequestState.FINISHED for r in reqs)


def test_run_open_loop_requires_tickclock():
    _, eng = TS.engines("none", max_len=32, max_batch=1)
    with pytest.raises(TypeError):
        PL.run_open_loop(eng, [PL.Arrival(uid=0, t=0.0, prompt_len=4, max_new=2)])


def test_open_loop_as_the_serve_cli_equals_reference():
    """The serve CLI's ``--compress quant_sparse --q-prune 0.5 --block 16
    --kv-dtype int8 --page-size 16 --share-prefix --prefill-chunk 8
    --prefill-budget 16 --arrival-rate 0.5`` run on the reference's
    weights: the same arrivals, the same streams, token ticks and summary."""
    from repro.launch import serve as rserve

    ref, eng = TS.engines("quant_sparse", max_len=128, max_batch=8, kv_dtype="int8",
                          page_size=16, num_pages=19, share_prefix=True, expected_context=20,
                          prefill_chunk=8, prefill_budget=16, tick_clock=True)
    mix = rserve._open_loop_mixture(12, 16, 128)
    arrivals = RL.poisson_trace(0.5, 16, mix, seed=0)
    rrep = RL.run_open_loop(ref, arrivals, RL.make_requests(arrivals, 256, seed=0), seed=0)
    parr = PL.poisson_trace(0.5, 16, PL.LengthMixture(mix.components), seed=0)
    prep = PL.run_open_loop(eng, parr, PL.make_requests(parr, 256, seed=0), seed=0)
    assert prep.all_terminal and rrep.all_terminal
    assert prep.outputs == rrep.outputs
    assert prep.token_ticks == rrep.token_ticks
    assert prep.summary() == rrep.summary()
    assert prep.summary()["leaked_pages"] == 0 and eng.stats.prefill_chunks > 0
    for unit in ("tick", "work"):
        assert prep.max_intertoken_gap(unit=unit) == rrep.max_intertoken_gap(unit=unit)


def test_serve_cli_open_loop_on_cpu(capsys):
    from repro_torch.launch import serve

    eng = serve.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--requests", "6",
                      "--max-new", "4", "--page-size", "16", "--prefill-chunk", "8",
                      "--prefill-budget", "16", "--arrival-rate", "0.5",
                      "--evict-policy", "priority", "--request-timeout", "500"])
    out = capsys.readouterr().out
    assert "continuous batching: 8-token prefill chunks, 16 tok/tick budget" in out
    assert "poisson arrivals: 0.5/tick, n=6" in out
    assert "[serve] open-loop: 6/6 completed" in out and "leaked pages 0" in out
    assert eng.evict_policy == "priority" and eng.request_timeout_s == 500.0
