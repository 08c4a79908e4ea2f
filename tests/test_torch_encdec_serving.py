"""Serving the enc-dec (whisper-tiny) and VLM (internvl2-2b) families,
smoke, fp32, through the reference's engine and the port's over the same
packed quant_sparse plan, with the quickstart flags (--kv-dtype int8
--page-size 16 --share-prefix): identical greedy streams, page tables,
slot maps and frame tables every tick; whisper's frame pools equal slot for
slot, its frame pages claimed at admission and released at finish, a clean
page audit; the reference's warnings (int8 KV on the enc-dec, prefix
sharing with per-request frames or patches, speculative decode and chunked
prefill refused by the positional-state gate); a pool with room for a
request's decoder pages but not its frame pages admits nothing in either
engine (ROADMAP C5, pinned); and both serve CLIs on one plan-cache
directory print the same parameter count and emit the same tokens."""

import re
import warnings

import numpy as np
import pytest

import _torch_encdec as X
from repro.launch import serve as ref_serve
from repro.serving.engine import ServingEngine as RServingEngine

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.serving.engine import RequestState, ServingEngine


def _frame_pools_equal(ref, eng):
    """Every live slot's frame pages hold the same K/V in both engines."""
    for slot, pages in enumerate(eng.slot_xpages):
        if not pages:
            continue
        idx = np.asarray(pages)
        for i, pools in enumerate(eng.cache["x"]):
            for pk in ("k_pages", "v_pages"):
                np.testing.assert_allclose(pools[pk].numpy()[idx],
                                           np.asarray(ref.cache["x"][pk][i])[idx], **X.TOL)


@pytest.mark.parametrize("arch", X.ARCHS)
def test_greedy_streams_match_reference_quickstart(arch):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref, eng = X.engines(arch, **X.QUICKSTART)
    rreqs, reqs = X.request_pair(arch, X.prompts(), max_new=6)
    check = _frame_pools_equal if arch == X.WHISPER else None
    X.serve_both(ref, eng, rreqs, reqs, check=check)
    # equal token prefixes with different frames or patches share nothing
    assert eng.stats.pages_shared == ref.stats.pages_shared == 0
    assert eng.stats.prefills == ref.stats.prefills == 5
    if arch == X.INTERNVL:
        assert eng.kv_dtype is not None  # the VLM keeps its int8 cache


def test_frame_pages_claimed_at_admission_and_released_at_finish():
    """Each admitted whisper request holds ceil(n_frames / page_size) frame
    pages besides its decoder pages, in the allocator's count and audit;
    they free with the slot."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, eng = X.engines(X.WHISPER, **X.QUICKSTART)
    cfg = eng.cfg
    assert eng.xpages_per_seq == -(-cfg.n_frames // 16) == 1
    _, reqs = X.request_pair(X.WHISPER, X.prompts()[:3], max_new=4)
    for r in reqs:
        eng.submit(r)
    eng.step()
    live = eng._live_slots()
    assert len(live) == 3
    for s in live:
        assert len(eng.slot_xpages[s]) == eng.xpages_per_seq
        assert not set(eng.slot_xpages[s]) & set(eng.slot_pages[s])
    assert eng.pages_in_use == sum(len(eng.slot_pages[s]) + 1 for s in live)
    np.testing.assert_array_equal(eng.cache["xpage_table"].numpy()[live],
                                  eng._xtable[live])
    eng.audit_pages()
    eng.run_until_done()
    assert all(r.state is RequestState.FINISHED for r in reqs)
    assert eng.pages_in_use == 0 and all(not p for p in eng.slot_xpages)
    assert np.all(eng._xtable == 0)
    eng.audit_pages()


def _warned(build) -> list:
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        build()
    return sorted(str(x.message) for x in w if not issubclass(x.category, DeprecationWarning))


@pytest.mark.parametrize("arch", X.ARCHS)
def test_warnings_are_the_references(arch):
    """The quickstart flags: the enc-dec warns that its cache ignores int8
    KV and serves fp; both warn that prefix sharing is off."""
    rcfg, _, rplan = X.ref_model(arch, "quant_sparse")
    rconf, pconf = X.engine_configs(**X.QUICKSTART)
    cfg = get_config(arch, smoke=True)
    from repro_torch import interop

    plan = interop.plan_from_reference(rplan)
    want = _warned(lambda: RServingEngine(rcfg, rplan.params, plan=rplan, config=rconf))
    got = _warned(lambda: ServingEngine(cfg, None, plan=plan, device="cpu", config=pconf))
    assert got == want
    assert any("share_prefix" in m for m in got)
    assert any("kv_dtype=int8" in m for m in got) == (arch == X.WHISPER)


@pytest.mark.parametrize("arch", X.ARCHS)
def test_speculation_and_chunked_prefill_are_refused_by_the_gate(arch):
    """Neither family serves speculative decode or chunked prefill: both
    engines warn with the positional-state gate's text and serve plain,
    synchronous prefill."""
    from repro.serving import config as RC
    from repro_torch.serving import config as PC

    rcfg, rparams, _ = X.ref_model(arch)
    cfg = get_config(arch, smoke=True)
    params = X.port_params(arch)
    flat = dict(max_len=64, max_batch=2, prefill_chunk=8, prefill_budget=16)
    rconf = RC.EngineConfig.of(spec=RC.SpecConfig(draft_cfg=rcfg, draft_params=rparams,
                                                  spec_k=2), **flat)
    pconf = PC.EngineConfig.of(spec=PC.SpecConfig(draft_cfg=cfg, draft_params=params,
                                                  spec_k=2), **flat)
    want = _warned(lambda: RServingEngine(rcfg, rparams, config=rconf))
    holder = []
    got = _warned(lambda: holder.append(ServingEngine(cfg, params, device="cpu",
                                                      config=pconf)))
    assert got == want and len(got) == 2
    assert all("positionally-addressed cache" in m for m in got)
    eng = holder[0]
    assert eng.spec_k == 0 and eng.prefill_chunk is None


def test_pool_without_room_for_frame_pages_admits_nothing():
    """ROADMAP C5 pinned: 2 free pages hold a request's decoder pages (24 +
    4 tokens: 2 pages of 16) but not its frame page as well, so neither
    engine admits it, tick after tick (the reference's CLI sizes its default
    pool this way at full width)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref, eng = X.engines(X.WHISPER, num_pages=3, **X.QUICKSTART)
    rreqs, reqs = X.request_pair(X.WHISPER, X.prompts()[3:4], max_new=4)
    ref.submit(rreqs[0])
    eng.submit(reqs[0])
    for _ in range(5):
        ref.step()
        eng.step()
    for e, r in ((ref, rreqs[0]), (eng, reqs[0])):
        assert e.stats.prefills == 0 and e.pages_in_use == 0 and len(e.queue) == 1
        assert r.state.value == "QUEUED"


def _recording(cls):
    class Recording(cls):
        submitted: list = []

        def submit(self, req):
            Recording.submitted.append(req)
            return super().submit(req)

    return Recording


@pytest.mark.parametrize("arch", X.ARCHS)
def test_clis_print_the_same_count_and_tokens_from_one_plan_directory(arch, tmp_path,
                                                                      monkeypatch, capsys):
    """The reference CLI packs and saves with the quickstart smoke flags; the
    port's CLI (same flags, --device cpu) hits the directory, draws the same
    prompts and frames or patches, and emits the same greedy tokens."""
    flags = ["--arch", arch, "--smoke", "--requests", "3", "--max-new", "4", "--compress",
             "quant_sparse", "--q-prune", "0.5", "--block", "16", "--kv-dtype", "int8",
             "--page-size", "16", "--share-prefix", "--plan-cache", str(tmp_path / "plan")]
    rec_ref = _recording(RServingEngine)
    monkeypatch.setattr(ref_serve, "ServingEngine", rec_ref)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_serve.main(flags)
        ref_out = capsys.readouterr().out
        rec = _recording(ServingEngine)
        monkeypatch.setattr(serve, "ServingEngine", rec)
        eng = serve.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    n = {"whisper-tiny": "108,672", "internvl2-2b": "110,976"}[arch]
    assert f"n_params={n} " in ref_out and f"n_params={n} " in out
    # the sizer charges the same cache bytes (whisper: the frames over the context)
    kv = re.compile(r"kv=(\d+) B/tok @ ctx (\d+)")
    assert kv.search(out).groups() == kv.search(ref_out).groups()
    assert "plan cache hit" in out and "[serve] completed 3 requests" in out
    assert "prefix sharing off" in out  # what the engine serves, not the flag
    key = "frames" if arch == X.WHISPER else "patches"
    assert len(rec.submitted) == len(rec_ref.submitted) == 3
    for r, rr in zip(rec.submitted, rec_ref.submitted):
        np.testing.assert_array_equal(r.prompt, rr.prompt)
        np.testing.assert_array_equal(r.extras[key], rr.extras[key])
        assert len(r.output) == 4 and r.output == rr.output
    eng.audit_pages()
    assert eng.pages_in_use == 0
