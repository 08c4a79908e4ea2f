"""Speculative decode in the PyTorch port vs the JAX reference (tinyllama
smoke config, fp32, 16-blocks): the perf-model and sizer terms on a grid,
then greedy streams and the spec counters of the port's engine against the
reference's engine over the same weights (``interop``), and against the
port's own plain engine."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import batching as RB
from repro.core import perf_model as RPM

from repro_torch.configs import get_config
from repro_torch.core import batching as PB
from repro_torch.core import perf_model as PPM
from repro_torch.models.transformer import init_params
from repro_torch.serving.config import CacheConfig, EngineConfig, SpecConfig
from repro_torch.serving.engine import Request, RequestState, ServingEngine

sys.path.insert(0, str(Path(__file__).parent))
import _torch_serving as TS  # noqa: E402

# the reference's defaults are TPU constants; both get the same machine
HW = dict(peak_flops=PPM.H100_PEAK_FLOPS, hbm_bw=PPM.H100_HBM_BW)
GRID = [(alpha, k) for alpha in (0.0, 0.3, 0.8, 1.0) for k in (0, 1, 4)]


@pytest.mark.parametrize("alpha,k", GRID)
def test_perf_model_spec_terms_equal_reference(alpha, k):
    assert PPM.expected_committed(alpha, k) == RPM.expected_committed(alpha, k)
    kw = dict(b_weight=1.1, n_params=10**9, kv_bytes_per_token=900.0, context_len=256, **HW)
    for single in (True, False):
        assert PPM.spec_decode_n_opt(k, single_pass_kv=single, **kw) == pytest.approx(
            RPM.spec_decode_n_opt(k, single_pass_kv=single, **kw), rel=1e-12)
    for mp in ({}, dict(model_parallel=4, kv_parallel=2)):
        a = PPM.spec_step_time(10**9, 8, k, alpha, draft_n_params=10**8,
                               kv_bytes_per_token=500.0, context_len=64, **HW, **mp)
        b = RPM.spec_step_time(10**9, 8, k, alpha, draft_n_params=10**8,
                               kv_bytes_per_token=500.0, context_len=64, **HW, **mp)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key] == pytest.approx(b[key], rel=1e-12), key


@pytest.mark.parametrize("alpha,k", GRID)
def test_batch_sizer_spec_methods_equal_reference(alpha, k):
    kw = dict(n_params=10**9, b_weight=1.25, q_prune=0.3, q_overhead=1.05,
              kv_bytes_per_token=700.0, context_len=300, spec_k=k, spec_accept=alpha,
              draft_n_params=10**8, max_latency_s=2e-4, model_parallel=2, kv_parallel=1, **HW)
    p, r = PB.BatchSizer(**kw), RB.BatchSizer(**kw)
    assert p.n_opt == r.n_opt and p.memory_bound == r.memory_bound
    for b in (1, 4, 16):
        assert p.committed_per_tick(b) == pytest.approx(r.committed_per_tick(b), rel=1e-12)
        assert p.step_time(b) == pytest.approx(r.step_time(b), rel=1e-12)
        assert p.step_time(b, prefill_tokens=32) == pytest.approx(
            r.step_time(b, prefill_tokens=32), rel=1e-12)
        assert p.spec_payoff(b) == pytest.approx(r.spec_payoff(b), rel=1e-12)
        assert p.spec_worthwhile(b, 0.5) == r.spec_worthwhile(b, 0.5)
        assert p.pick(b) == r.pick(b)
    assert p.observe_accept(0.25).spec_accept == pytest.approx(
        r.observe_accept(0.25).spec_accept, rel=1e-12)
    pc, rc = PB.efficiency_curve(p, [1, 8]), RB.efficiency_curve(r, [1, 8])
    assert [sorted(d) for d in pc] == [sorted(d) for d in rc]
    for a, b in zip(pc, rc):
        for key in a:
            assert a[key] == pytest.approx(b[key], rel=1e-12)


# (case, compress, spec_k, draft, cache fields, prompts, max_new, max_batch)
_CASES = {
    "k1-fp-contiguous": ("none", 1, "near", {}, (10, 12, 10, 12, 10), 8, 3),
    "k2-fp-contiguous": ("none", 2, "near", {}, (10, 12, 10, 12, 10), 8, 3),
    "k3-fp-contiguous": ("none", 3, "near", {}, (10, 12, 10, 12, 10), 8, 3),
    # int8 paged KV on the quant_sparse plan, requests 0-3 share a prefix
    "k2-int8-paged-prefix": ("quant_sparse", 2, "near",
                             dict(kv_dtype="int8", page_size=8, share_prefix=True),
                             "shared", 6, 4),
    # pages of 4 slots: every verify step (4 positions) crosses a page
    # boundary, and rejected tails roll back across it
    "k3-rollback-page-boundary": ("none", 3, "near", dict(kv_dtype="int8", page_size=4),
                                  (10, 13, 11), 9, 3),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_spec_streams_and_counters_equal_reference(case):
    compress, k, draft, cache, lens, max_new, B = _CASES[case]
    ps = TS.shared_prefix_prompts() if lens == "shared" else TS.prompts(lens)
    ref, eng = TS.engines(compress, draft=draft, spec_k=k, max_len=48, max_batch=B, **cache)
    rreqs, reqs = TS.request_pair(ps, max_new)
    TS.lockstep(ref, eng, rreqs, reqs, tables="page_size" in cache)
    assert TS.outputs(reqs) == TS.outputs(rreqs)
    assert all(r.state is RequestState.FINISHED for r in reqs)
    assert TS.counters(eng.stats) == TS.counters(ref.stats)
    assert eng.stats.draft_accepted > 0 and eng.stats.draft_accepted < eng.stats.draft_proposed
    assert not eng.degraded and not ref.degraded
    if "page_size" in cache:
        eng.audit_pages()
        assert eng.pages_in_use == 0
    if cache.get("share_prefix"):
        assert eng.stats.pages_shared == ref.stats.pages_shared > 0
        assert eng.stats.cow_copies == ref.stats.cow_copies > 0
    # the port's plain engine commits the same greedy streams
    _, plain = TS.engines(compress, max_len=48, max_batch=B, **cache)
    preqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=max_new) for i, p in enumerate(ps)]
    for r in preqs:
        plain.submit(r)
    plain.run_until_done()
    assert TS.outputs(preqs) == TS.outputs(reqs)


def test_spec_as_the_serve_cli_equals_reference():
    """The engine the serve CLI builds for ``--compress quant_sparse --q-prune
    0.5 --block 16 --kv-dtype int8 --page-size 16 --share-prefix
    --draft-config tinyllama-1.1b --spec-k 2`` (16 requests of 12 tokens,
    16 new, 8 slots, a seed-1 draft), on the reference's weights."""
    ref, eng = TS.engines("quant_sparse", draft="seed1", spec_k=2, max_len=128, max_batch=8,
                          kv_dtype="int8", page_size=16, num_pages=19, share_prefix=True,
                          expected_context=20)
    rreqs, reqs = TS.request_pair(TS.prompts([12] * 16, vocab=256), 16)
    TS.lockstep(ref, eng, rreqs, reqs, tables=True)
    assert TS.outputs(reqs) == TS.outputs(rreqs)
    assert TS.counters(eng.stats) == TS.counters(ref.stats)
    assert eng.stats.completed == 16 and eng.pages_in_use == 0


def _port_engine(params, draft=None, k=0, **kw):
    cfg = get_config("tinyllama-1.1b", smoke=True)
    spec = SpecConfig(draft_cfg=cfg, draft_params=draft, spec_k=k) if k else SpecConfig()
    return cfg, ServingEngine(cfg, params, device="cpu", config=EngineConfig(
        max_len=48, max_batch=3, spec=spec, **kw))


def _serve(eng, ps, max_new, **kw):
    reqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=max_new, **kw)
            for i, p in enumerate(ps)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return reqs


def test_all_rejected_ticks_still_commit():
    """A seed + 1 draft proposes tokens the target rejects: every verify tick
    still commits one token per slot, and the streams are the plain ones."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    params, draft = init_params(cfg, 0, device="cpu"), init_params(cfg, 1, device="cpu")
    ps = TS.prompts((10, 12, 10))
    _, spec = _port_engine(params, draft, 3)
    reqs = _serve(spec, ps, 8)
    _, plain = _port_engine(params)
    assert TS.outputs(reqs) == TS.outputs(_serve(plain, ps, 8))
    s = spec.stats
    assert s.accept_rate < 0.1
    # 7 tokens a request after its prefill's, at least one a tick
    assert s.decode_tokens == 3 * 7 and 6 <= s.decode_steps <= 7
    assert s.verified_positions <= 3 * 4 * s.decode_steps


def test_headroom_and_vocab_errors():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    params = init_params(cfg, 0, device="cpu")
    # prompt + max_new fits max_len 48, but not the k = 4 verify overhang
    for cache in (CacheConfig(), CacheConfig(page_size=8)):
        _, eng = _port_engine(params, params, 4, cache=cache)
        eng.submit(Request(uid=0, prompt=np.arange(30, dtype=np.int32), max_new_tokens=16))
        with pytest.raises(ValueError, match="spec_k"):
            eng.step()
    other = dataclasses.replace(cfg, vocab=cfg.vocab + 1)
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(cfg, params, device="cpu", config=EngineConfig(
            spec=SpecConfig(draft_cfg=other, draft_params=params, spec_k=2)))
    with pytest.raises(ValueError, match="draft"):
        ServingEngine(cfg, params, device="cpu", config=EngineConfig(spec=SpecConfig(spec_k=2)))


def test_temperature_spec_is_deterministic_per_seed():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    params, draft = init_params(cfg, 0, device="cpu"), init_params(cfg, 2, device="cpu")
    outs = []
    for seed in (5, 5, 6):
        _, eng = _port_engine(params, draft, 2, seed=seed)
        reqs = _serve(eng, TS.prompts((10, 12, 10)), 8, temperature=1.0)
        assert all(r.state is RequestState.FINISHED and len(r.output) == 8 for r in reqs)
        assert all(0 <= t < cfg.vocab for r in reqs for t in r.output)
        assert eng.stats.draft_proposed > 0
        outs.append(TS.outputs(reqs))
    assert outs[0] == outs[1] and outs[0] != outs[2]


def test_serve_cli_spec_on_cpu(capsys):
    from repro_torch.launch import serve

    eng = serve.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--requests", "4",
                      "--max-new", "6", "--spec-k", "2", "--draft-config", "tinyllama-1.1b"])
    out = capsys.readouterr().out
    assert "speculative decode: tinyllama-smoke drafts 2 tokens/tick" in out
    assert "[serve] speculative:" in out and "draft accept rate" in out
    assert eng.stats.completed == 4 and eng.spec_k == 2 and not eng.degraded
    for flags in (["--spec-k", "2"], ["--draft-config", "tinyllama-1.1b"]):
        with pytest.raises(SystemExit):
            serve.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu"] + flags)
