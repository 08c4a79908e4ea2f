"""Mixed-family serving (``repro_torch/serving/mixed.py``), mirroring the
reference's tests/test_mixed_serving.py against the reference's engine:
spec validation and routing, a text + enc-dec + VLM + recurrent + xLSTM
mix whose per-family greedy streams equal each family served alone and the
reference's mixed engine over the same weights, fair back-pressure when the
shared pool is too small for every family at once, a contiguous-only mix
with no allocator, the union audit over the members' page references (a
member of a shared pool skips the refcount audit itself), the
``MixedSizer`` terms against the reference's, and the serve CLI's
``--workload-mix`` run against the reference CLI's (smoke configs, fp32,
``--compress none``)."""

import dataclasses
import warnings

import numpy as np
import pytest

import _torch_families as F
from repro.core import batching as RB
from repro.launch import serve as ref_serve
from repro.serving import config as RC
from repro.serving import mixed as RM
from repro.serving.engine import Request as RRequest

from repro_torch.configs import get_config
from repro_torch.core import batching as PB
from repro_torch.launch import serve
from repro_torch.models.api import get_api
from repro_torch.serving import config as PC
from repro_torch.serving import mixed as PM
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.paged import PageAllocator, PageAuditError

MIX = ["tinyllama-1.1b", "whisper-tiny", "internvl2-2b", "xlstm-350m", "recurrentgemma-2b"]


def _port_family(arch, seed=0):
    cfg = get_config(arch, smoke=True)
    return cfg, get_api(cfg), F.port_params(arch, "none", seed)


def _reqs(cfg, api, n, seed, uid0=0, max_new=5, prompt_len=4, cls=Request):
    """The reference test's requests: prompts of 4-5 tokens, each with its
    frames or patches drawn after its prompt."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(1, cfg.vocab, size=prompt_len + (i % 2)).astype(np.int32)
        extras = {}
        if "patches" in api.extra_keys:
            extras["patches"] = rng.normal(size=(cfg.n_patches, cfg.d_model)).astype(np.float32)
        if "frames" in api.extra_keys:
            extras["frames"] = rng.normal(size=(cfg.n_frames, cfg.d_model)).astype(np.float32)
        out.append(cls(uid=uid0 + i, prompt=prompt, max_new_tokens=max_new,
                       extras=extras or None))
    return out


def _mixed(specs, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the contiguous families' paging warning
        return PM.MixedServingEngine(specs, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the mixed engine
# ---------------------------------------------------------------------------


def test_spec_validation():
    cfg, _, params = _port_family("tinyllama-1.1b")
    ec = PC.EngineConfig(max_len=16, max_batch=1)
    spec = PM.WorkloadSpec(name="a", cfg=cfg, params=params, config=ec)
    with pytest.raises(ValueError, match="at least one workload"):
        _mixed([])
    with pytest.raises(ValueError, match="duplicate workload names"):
        _mixed([spec, spec])
    with pytest.raises(ValueError, match="weight must be positive"):
        _mixed([PM.WorkloadSpec(name="b", cfg=cfg, params=params, weight=0.0, config=ec)])
    with pytest.raises(ValueError, match="owns the shared pool"):
        _mixed([PM.WorkloadSpec(name="c", cfg=cfg, params=params, config=PC.EngineConfig(
            max_len=16, max_batch=1, cache=PC.CacheConfig(page_size=8,
                                                          allocator=PageAllocator(4))))])
    with pytest.raises(ValueError, match="max_batch"):
        _mixed([PM.WorkloadSpec(name="d", cfg=cfg, params=params, config=PC.EngineConfig(
            max_len=16, cache=PC.CacheConfig(page_size=8)))])


def test_unknown_workload_name():
    cfg, api, params = _port_family("tinyllama-1.1b")
    eng = _mixed([PM.WorkloadSpec(name="text", cfg=cfg, params=params,
                                  config=PC.EngineConfig(max_len=16, max_batch=1))])
    with pytest.raises(KeyError, match="unknown workload"):
        eng.submit("txet", _reqs(cfg, api, 1, seed=0)[0])


def test_mixed_streams_equal_solo_and_the_reference_mix():
    """Five families, paged where they can page (page size 8), two slots
    each: every family's greedy streams in the mix equal the family served
    alone, and the reference's MixedServingEngine over the same weights;
    the shared pool ends empty with a clean union audit."""
    flat = dict(max_len=32, max_batch=2, seed=0, page_size=8)
    solo, fams = {}, {}
    for fi, arch in enumerate(MIX):
        cfg, api, params = _port_family(arch, seed=fi)
        fams[arch] = (cfg, api, params)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eng = ServingEngine(cfg, params, device="cpu", config=PC.EngineConfig.of(**flat))
        reqs = _reqs(cfg, api, 2, seed=40 + fi, max_new=4)
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        assert all(r.done and r.error is None for r in reqs), arch
        solo[arch] = [list(r.output) for r in reqs]
    mixed = _mixed([PM.WorkloadSpec(name=a, cfg=fams[a][0], params=fams[a][2],
                                    config=PC.EngineConfig.of(**flat)) for a in MIX])
    assert sorted(n for n, e in mixed.engines.items() if e.paged) == sorted(
        ["tinyllama-1.1b", "whisper-tiny", "internvl2-2b"])
    assert all(not e._owns_allocator and e.allocator is mixed.allocator
               for e in mixed.engines.values() if e.paged)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = RM.MixedServingEngine([RM.WorkloadSpec(
            name=a, cfg=F.ref_model(a, "none", fi)[0], params=F.ref_model(a, "none", fi)[1],
            config=RC.EngineConfig.of(**flat)) for fi, a in enumerate(MIX)])
    assert mixed.num_pages == ref.num_pages
    reqs = {a: _reqs(fams[a][0], fams[a][1], 2, seed=40 + fi, max_new=4)
            for fi, a in enumerate(MIX)}
    rreqs = {a: _reqs(fams[a][0], fams[a][1], 2, seed=40 + fi, max_new=4, cls=RRequest)
             for fi, a in enumerate(MIX)}
    for a in MIX:
        for r, rr in zip(reqs[a], rreqs[a]):
            mixed.submit(a, r)
            ref.submit(a, rr)
    while mixed._busy():
        mixed.step()
        ref.step()
        mixed.audit_pages()
        assert mixed.allocator.used_pages == ref.allocator.used_pages
    assert not ref._busy() and mixed.tick == ref.tick
    mixed.audit_pages()
    assert mixed.allocator.used_pages == 0
    for a in MIX:
        got = [list(r.output) for r in reqs[a]]
        assert got == solo[a] == [list(r.output) for r in rreqs[a]], a
    agg = mixed.aggregate_stats()
    assert agg.completed == 2 * len(MIX) and agg.failed == 0
    assert agg.decode_tokens == ref.aggregate_stats().decode_tokens


def test_shared_pool_exhaustion_is_fair():
    """A pool with room for one whisper request and one text request at a
    time: admission back-pressures into the families' queues, both finish
    everything with no failures, page for page as the reference's mix, and
    the allocator audits clean with nothing live."""
    t_cfg, t_api, t_params = _port_family("tinyllama-1.1b")
    w_cfg, w_api, w_params = _port_family("whisper-tiny", seed=1)
    flat = dict(max_len=32, max_batch=2, seed=0, page_size=8)
    pool = 1 + (4 + -(-w_cfg.n_frames // 8)) + 4
    mixed = _mixed([PM.WorkloadSpec(name="text", cfg=t_cfg, params=t_params,
                                    config=PC.EngineConfig.of(**flat)),
                    PM.WorkloadSpec(name="audio", cfg=w_cfg, params=w_params,
                                    config=PC.EngineConfig.of(**flat))], num_pages=pool)
    ref = RM.MixedServingEngine(
        [RM.WorkloadSpec(name="text", cfg=F.ref_model("tinyllama-1.1b")[0],
                         params=F.ref_model("tinyllama-1.1b")[1],
                         config=RC.EngineConfig.of(**flat)),
         RM.WorkloadSpec(name="audio", cfg=F.ref_model("whisper-tiny", "none", 1)[0],
                         params=F.ref_model("whisper-tiny", "none", 1)[1],
                         config=RC.EngineConfig.of(**flat))], num_pages=pool)
    text = _reqs(t_cfg, t_api, 4, seed=5, max_new=4)
    audio = _reqs(w_cfg, w_api, 4, seed=6, uid0=100, max_new=4)
    rtext = _reqs(t_cfg, t_api, 4, seed=5, max_new=4, cls=RRequest)
    raudio = _reqs(w_cfg, w_api, 4, seed=6, uid0=100, max_new=4, cls=RRequest)
    for tr, ar, rtr, rar in zip(text, audio, rtext, raudio):
        mixed.submit("text", tr)
        mixed.submit("audio", ar)
        ref.submit("text", rtr)
        ref.submit("audio", rar)
    queued = 0
    while mixed._busy():
        mixed.step()
        ref.step()
        queued = max(queued, len(mixed.engine("audio").queue))
        assert mixed.allocator.used_pages == ref.allocator.used_pages
        assert [e.slot_pages for e in mixed.engines.values()] == \
            [e.slot_pages for e in ref.engines.values()]
    assert queued > 0  # the pool held the whisper queue back
    mixed.audit_pages()
    for r, rr in zip(text + audio, rtext + raudio):
        assert r.done and r.error is None, (r.uid, r.state, r.error)
        assert r.output == rr.output, r.uid
    assert mixed.allocator.used_pages == 0
    agg = mixed.aggregate_stats()
    assert agg.completed == 8 and agg.failed == 0


def test_contiguous_only_mix_has_no_allocator():
    for arch in ("xlstm-350m", "recurrentgemma-2b"):
        cfg, _, params = _port_family(arch)
        mixed = _mixed([PM.WorkloadSpec(name="rec", cfg=cfg, params=params,
                                        config=PC.EngineConfig(
                                            max_len=16, max_batch=1,
                                            cache=PC.CacheConfig(page_size=8)))])
        assert mixed.allocator is None and mixed.num_pages is None
        assert not mixed.engine("rec").paged
        mixed.audit_pages()  # nothing to audit: must not raise


def test_union_audit_catches_a_page_no_member_holds():
    """Members of a shared pool check their table mirrors only; the mixed
    engine's audit over the union of their page references catches a page
    the allocator counts that no member holds."""
    t_cfg, t_api, t_params = _port_family("tinyllama-1.1b")
    flat = dict(max_len=32, max_batch=2, page_size=8)
    mixed = _mixed([PM.WorkloadSpec(name=n, cfg=t_cfg, params=t_params,
                                    config=PC.EngineConfig.of(**flat)) for n in ("a", "b")])
    assert mixed.num_pages == 1 + 2 * 2 * 4
    for n, seed in (("a", 1), ("b", 2)):
        for r in _reqs(t_cfg, t_api, 2, seed=seed, max_new=6):
            mixed.submit(n, r)
    mixed.step()
    refs = mixed._page_refs()
    assert refs and sorted(refs) == sorted(
        mixed.engine("a")._page_refs() + mixed.engine("b")._page_refs())
    assert not set(mixed.engine("a")._page_refs()) & set(mixed.engine("b")._page_refs())
    mixed.audit_pages()
    leaked = mixed.allocator.alloc(1)
    mixed.engine("a").audit_pages()  # a member does not audit the shared refcounts
    with pytest.raises(PageAuditError):
        mixed.audit_pages()
    mixed.allocator.release(leaked)
    mixed.run_until_done()
    mixed.audit_pages()
    assert mixed.allocator.used_pages == 0


# ---------------------------------------------------------------------------
# MixedSizer
# ---------------------------------------------------------------------------


def _sizers(mod):
    kw = dict(peak_flops=989e12, hbm_bw=3.35e12)
    return {"a": mod.BatchSizer(n_params=1_000_000, kv_bytes_per_token=64, context_len=128, **kw),
            "b": mod.BatchSizer(n_params=4_000_000, kv_bytes_per_token=256, context_len=128,
                                **kw)}


def test_mixed_sizer_validation():
    s = _sizers(PB)
    with pytest.raises(ValueError, match="keys differ"):
        PB.MixedSizer(sizers=s, weights={"a": 1.0})
    with pytest.raises(ValueError, match="at least one family"):
        PB.MixedSizer(sizers={}, weights={})
    with pytest.raises(ValueError, match="positive"):
        PB.MixedSizer(sizers=s, weights={"a": 0.0, "b": 0.0})


@pytest.mark.parametrize("weights", [{"a": 3.0, "b": 1.0}, {"a": 1.0, "b": 2.0}])
def test_mixed_sizer_terms_match_reference(weights):
    ps, rs = PB.MixedSizer(_sizers(PB), weights), RB.MixedSizer(_sizers(RB), weights)
    assert ps.share("a") == pytest.approx(rs.share("a"))
    assert ps.n_opt == rs.n_opt
    for batch in (1, 8, 33):
        assert ps.batches(batch) == rs.batches(batch)
        assert ps.step_time(batch) == pytest.approx(rs.step_time(batch), rel=1e-12)
        assert ps.tokens_per_s(batch) == pytest.approx(rs.tokens_per_s(batch), rel=1e-12)
        assert ps.blended_floor(batch) == pytest.approx(rs.blended_floor(batch), rel=1e-12)
    s = _sizers(PB)
    bs = ps.batches(8)
    assert ps.step_time(8) == pytest.approx(sum(s[n].step_time(b) for n, b in bs.items()))
    fast = max(bs[n] / s[n].step_time(bs[n]) for n in bs)
    assert ps.blended_floor(8) <= fast
    assert PB.MixedSizer(s, {"a": 3.0, "b": 1.0}).batches(1) == {"a": 1, "b": 1}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _recording(cls):
    class Recording(cls):
        submitted: list = []

        def submit(self, name, req):
            Recording.submitted.append((name, req))
            return super().submit(name, req)

    return Recording


def test_workload_mix_cli_matches_reference(monkeypatch, capsys):
    """``--workload-mix tinyllama-1.1b:2,recurrentgemma-2b:1,whisper-tiny:1
    --compress none --page-size 16``: both CLIs (the port's over the
    reference's weights for --seed) size one shared pool of 137 pages for
    the two paged families, complete 8/8 requests with a clean audit and
    emit the same prompts, frames and greedy tokens per family."""
    flags = ["--workload-mix", "tinyllama-1.1b:2,recurrentgemma-2b:1,whisper-tiny:1",
             "--smoke", "--compress", "none", "--page-size", "16", "--requests", "8",
             "--max-new", "6"]
    rec_ref = _recording(RM.MixedServingEngine)
    monkeypatch.setattr(ref_serve, "MixedServingEngine", rec_ref)
    real_api = serve.get_api

    def ref_weights(cfg):
        return dataclasses.replace(real_api(cfg), init_params=lambda c, seed, device=None:
                                   F.port_params(_arch_of(c), "none", seed))

    monkeypatch.setattr(serve, "get_api", ref_weights)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_serve.main(flags)
        ref_out = capsys.readouterr().out
        rec = _recording(PM.MixedServingEngine)
        monkeypatch.setattr(serve, "MixedServingEngine", rec)
        eng = serve.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    for text in (ref_out, out):
        assert "shared page pool: 137 pages x 16 tok across 2 paged families" in text
        assert "mixed: 8/8 requests" in text and "page audit clean" in text
    assert len(rec.submitted) == len(rec_ref.submitted) == 8
    for (n, r), (rn, rr) in zip(rec.submitted, rec_ref.submitted):
        assert n == rn
        np.testing.assert_array_equal(r.prompt, rr.prompt)
        assert (r.extras is None) == (rr.extras is None)
        if r.extras:
            np.testing.assert_array_equal(r.extras["frames"], rr.extras["frames"])
        assert len(r.output) == 6 and r.output == rr.output, (n, r.uid)
    eng.audit_pages()
    assert eng.allocator.used_pages == 0
    assert [n for n, e in eng.engines.items() if e.kv_dtype is None] == list(eng.engines)


def _arch_of(cfg) -> str:
    """The registry id of a smoke config."""
    from repro_torch.configs import ARCH_IDS

    return next(a for a in ARCH_IDS if get_config(a, smoke=True) == cfg)


@pytest.mark.parametrize("flag", [["--arch", "tinyllama-1.1b"], ["--autotune-plan", "x"],
                                  ["--compress", "quant"], ["--draft-config", "tinyllama-1.1b"],
                                  ["--trace", "x"], ["--arrival-rate", "0.5"],
                                  ["--mesh", "host"]])
def test_workload_mix_refuses_what_the_reference_refuses(flag, capsys):
    """The reference's refusals, flag for flag; ``--mesh`` is not one of
    them: a mix on the host mesh (1 x 1 on the CPU) serves, its members on
    the mesh."""
    argv = ["--workload-mix", "tinyllama-1.1b:1", "--smoke", "--device", "cpu",
            "--requests", "2", "--max-new", "3"] + flag
    if flag[0] == "--mesh":
        eng = serve.main(argv)
        out = capsys.readouterr().out
        assert "[serve] mesh {'data': 1, 'model': 1}: data-parallel 1, model-parallel 1" in out
        assert "mixed: 2/2 requests" in out
        assert all(e.mesh is not None for e in eng.engines.values())
        return
    with pytest.raises(SystemExit) as e:
        serve.main(argv)
    assert e.value.code == 2
    assert ("drop " + flag[0]) in capsys.readouterr().err


def test_parse_mix():
    import argparse

    ap = argparse.ArgumentParser()
    assert serve.parse_mix("tinyllama-1.1b:2, whisper-tiny", ap) == [
        ("tinyllama-1.1b", 2.0), ("whisper-tiny", 1.0)]
    for bad in ("nope:1", "tinyllama-1.1b:x", " , "):
        with pytest.raises(SystemExit):
            serve.parse_mix(bad, ap)
