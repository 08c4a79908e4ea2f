"""Serving recurrentgemma-2b and xlstm-350m (smoke, fp32) through the
reference's engine and the port's over the same packed quant_sparse plan
with the quickstart flags: identical greedy streams on the contiguous cache
(neither family has a global attention layer to page, so both engines warn
and fall back; xlstm-350m, which has no KV, also warns that int8 KV is not
served); every leaf of a slot -- RG-LRU and xLSTM states included -- is
rewritten at admission, so nothing leaks from its previous owner;
speculative decode and chunked prefill are refused with the reference's
text; and both serve CLIs emit the same tokens from one plan directory
(tests/_torch_families.py has the shared set-up)."""

import re
import warnings

import numpy as np
import pytest
import torch

import _torch_families as F
from repro.launch import serve as ref_serve
from repro.serving import config as RC
from repro.serving.engine import ServingEngine as RServingEngine

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.serving import config as PC
from repro_torch.serving.engine import Request, RequestState, ServingEngine

ARCHS = ["recurrentgemma-2b", "xlstm-350m"]


def _warned(build) -> list:
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        build()
    return sorted(str(x.message) for x in w if not issubclass(x.category, DeprecationWarning))


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_match_reference_quickstart(arch):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref, eng = F.engines(arch, **F.QUICKSTART)
    assert not eng.paged and not ref.paged and eng.allocator is None
    assert (eng.kv_dtype is None) == (arch == "xlstm-350m") == (ref.kv_dtype is None)
    F.serve_both(ref, eng, F.prompts(), max_new=6)
    assert eng.stats.prefills == ref.stats.prefills == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_warnings_are_the_references(arch):
    """The quickstart flags: both engines warn that the family's decode path
    cannot page; xlstm-350m also that its cache holds no int8 KV."""
    rcfg, _, rplan = F.ref_model(arch, "quant_sparse")
    cfg = get_config(arch, smoke=True)
    plan = interop.plan_from_reference(rplan)
    flat = dict(max_len=64, max_batch=2, **F.QUICKSTART)
    want = _warned(lambda: RServingEngine(rcfg, rplan.params, plan=rplan,
                                          config=RC.EngineConfig.of(**flat)))
    got = _warned(lambda: ServingEngine(cfg, None, plan=plan, device="cpu",
                                        config=PC.EngineConfig.of(**flat)))
    assert got == want
    assert any("does not thread a page table" in m for m in got)
    assert any("kv_dtype=int8" in m for m in got) == (arch == "xlstm-350m")


@pytest.mark.parametrize("arch", ARCHS)
def test_speculation_and_chunked_prefill_are_refused_by_the_gate(arch):
    """Recurrent states are rewritten whole each step, so no rejected
    speculative token or chunk tail can be masked: both engines warn with
    the positional-state gate's text and serve plain, synchronous prefill."""
    rcfg, rparams, _ = F.ref_model(arch)
    cfg = get_config(arch, smoke=True)
    params = F.port_params(arch)
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
    assert f"({cfg.family} does not qualify)" in got[0]
    eng = holder[0]
    assert eng.spec_k == 0 and eng.prefill_chunk is None


@pytest.mark.parametrize("arch", ARCHS)
def test_admission_rewrites_every_state_leaf_of_the_slot(arch):
    """Every cache leaf of every slot is filled with garbage first; then the
    prompts are served two slots at a time (slots are reused by later
    requests).  Each admission rewrites its slot whole -- right after it
    the slot's leaves equal a private batch-1 prefill's -- and the streams
    equal a clean engine's."""
    cfg = get_config(arch, smoke=True)
    params = F.port_params(arch, "none")
    conf = PC.EngineConfig.of(max_len=64, max_batch=2, kv_dtype="int8")
    prompts = F.prompts()

    def run(poison: bool):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # xlstm-350m serves int8 KV as fp
            eng = ServingEngine(cfg, params, device="cpu", config=conf)
        g = torch.Generator().manual_seed(1)
        if poison:
            for layer in eng.cache["layers"]:
                for leaf in layer.values():
                    if leaf.is_floating_point():
                        leaf.copy_(torch.randn(leaf.shape, generator=g) * 100)
                    else:
                        leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g))
        write = eng._write_slot
        checked = []

        def checked_write(slot, cache1, cache):
            write(slot, cache1, cache)
            for layer, one in zip(cache["layers"], cache1["layers"]):
                for k, leaf in layer.items():
                    assert torch.equal(leaf[slot], one[k][0].to(leaf.dtype)), k
            checked.append(slot)

        eng._write_slot = checked_write
        reqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=5) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        assert all(r.state is RequestState.FINISHED for r in reqs)
        assert len(checked) == len(prompts) and set(checked) == {0, 1}
        return [r.output for r in reqs]

    assert run(poison=True) == run(poison=False)


def _recording(cls):
    class Recording(cls):
        submitted: list = []

        def submit(self, req):
            Recording.submitted.append(req)
            return super().submit(req)

    return Recording


@pytest.mark.parametrize("arch", ARCHS)
def test_clis_emit_the_same_tokens_from_one_plan_directory(arch, tmp_path, monkeypatch,
                                                           capsys):
    """The quickstart smoke flags (quant_sparse, q 0.5, blocks of 16, int8
    KV): the reference CLI packs and saves the plan, the port's CLI hits the
    directory, draws the same prompts, charges the sizer the same bytes and
    emits the same greedy tokens for all 8 requests."""
    flags = ["--arch", arch, "--smoke", "--requests", "8", "--max-new", "6", "--compress",
             "quant_sparse", "--q-prune", "0.5", "--block", "16", "--kv-dtype", "int8",
             "--plan-cache", str(tmp_path / "plan")]
    rec_ref = _recording(RServingEngine)
    monkeypatch.setattr(ref_serve, "ServingEngine", rec_ref)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_serve.main(flags)
        ref_out = capsys.readouterr().out
        rec = _recording(ServingEngine)
        monkeypatch.setattr(serve, "ServingEngine", rec)
        serve.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    n = {"recurrentgemma-2b": "201,664", "xlstm-350m": "159,184"}[arch]
    assert f"n_params={n} " in ref_out and f"n_params={n} " in out
    kv = re.compile(r"kv=(\d+) B/tok @ ctx (\d+)")
    assert kv.search(out).groups() == kv.search(ref_out).groups()
    plan = re.compile(r"plan\[([^\]]*)\]")
    assert plan.search(out).group(1) == plan.search(ref_out).group(1)
    assert "plan cache hit" in out and "[serve] completed 8 requests" in out
    assert len(rec.submitted) == len(rec_ref.submitted) == 8
    for r, rr in zip(rec.submitted, rec_ref.submitted):
        np.testing.assert_array_equal(r.prompt, rr.prompt)
        assert len(r.output) == 6 and r.output == rr.output
