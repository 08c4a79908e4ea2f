"""PyTorch port vs the JAX reference for the serving engine and the serve
CLI (tinyllama smoke config, fp32, 16-blocks).

Greedy token streams must be identical: both engines serve the same
requests over the same weights -- the reference's own params and its
packed plan, converted through ``interop``, so engine parity does not
hinge on the port's packer.  Paged runs share prompt prefixes (full pages
by refcount, the boundary page copied on write) and must leak no page."""

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.core import weight_plan as RW
from repro.models.api import get_api as ref_get_api
from repro.serving.config import CacheConfig as RCacheConfig
from repro.serving.config import EngineConfig as REngineConfig
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.serving.config import CacheConfig, EngineConfig, SchedulerConfig
from repro_torch.serving.engine import Request, RequestState, ServingEngine

MAX_NEW, MAX_LEN, PS = 6, 32, 8


def _prompts():
    """Requests 0-3 share a prefix (request 0's 12-token prompt, which 1-3
    extend by 4 tokens each: one full page shared + the boundary page
    copied on write); 4-5 are independent.  Two prompt lengths only, so
    the reference compiles two prefill shapes."""
    r = np.random.default_rng(0)
    prefix = r.integers(0, 256, 12).astype(np.int32)
    out = [prefix] + [np.concatenate([prefix, r.integers(0, 256, 4).astype(np.int32)])
                      for _ in range(3)]
    return out + [r.integers(0, 256, 16).astype(np.int32) for _ in range(2)]


def _reference(compress):
    rcfg = ref_get_config("tinyllama-1.1b", smoke=True)
    params = ref_get_api(rcfg).init_params(rcfg, jax.random.key(0))
    plan = None
    if compress != "none":
        plan = RW.compress(params, RW.PlanConfig(default=compress, q_prune=0.5, bk=16, bn=16))
        params = plan.params
    return rcfg, params, plan


@pytest.mark.parametrize("compress,kv,paged", [
    ("none", "fp", True), ("none", "int8", True), ("quant_sparse", "fp", True),
    ("quant_sparse", "int8", True), ("quant_sparse", "int8", False)])
def test_greedy_streams_match_reference(compress, kv, paged):
    rcfg, rparams, rplan = _reference(compress)
    kv_dtype = "int8" if kv == "int8" else None
    page = dict(page_size=PS, share_prefix=True) if paged else {}
    prompts = _prompts()

    ref = RServingEngine(rcfg, rparams, plan=rplan, config=REngineConfig(
        max_len=MAX_LEN, max_batch=4, cache=RCacheConfig(kv_dtype=kv_dtype, **page)))
    rreqs = [RRequest(uid=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
    for r in rreqs:
        ref.submit(r)

    cfg = get_config("tinyllama-1.1b", smoke=True)
    if rplan is not None:
        plan = interop.plan_from_reference(rplan)
        params = None
    else:
        plan = None
        params = interop.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams))
    eng = ServingEngine(cfg, params, plan=plan, device="cpu", config=EngineConfig(
        max_len=MAX_LEN, max_batch=4, cache=CacheConfig(kv_dtype=kv_dtype, **page),
        scheduler=SchedulerConfig()))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    # tick in lockstep: the same admissions, and (paged) the same page
    # tables and slot -> page mappings, every tick
    while ref.queue or ref._live_slots():
        ref.step()
        eng.step()
        if paged:
            np.testing.assert_array_equal(eng._table, ref._table)
            assert eng.slot_pages == ref.slot_pages
    assert not eng.queue and not eng._live_slots()

    for r, rr in zip(reqs, rreqs):
        assert r.state is RequestState.FINISHED
        assert r.output == rr.output, r.uid
    assert eng.stats.decode_steps == ref.stats.decode_steps
    if paged:
        eng.audit_pages()
        ref.audit_pages()
        assert eng.pages_in_use == 0 and ref.pages_in_use == 0
        assert eng.stats.pages_shared == ref.stats.pages_shared > 0
        assert eng.stats.cow_copies == ref.stats.cow_copies > 0


def test_paged_streams_equal_contiguous():
    """Within the port: the paged int8 engine emits the contiguous engine's
    greedy streams."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    from repro_torch.core.weight_plan import PlanConfig, compress
    from repro_torch.models.transformer import init_params

    plan = compress(init_params(cfg, 3, device="cpu"),
                    PlanConfig(q_prune=0.5, bk=16, bn=16))
    outs = []
    for page in ({}, dict(page_size=PS, share_prefix=True)):
        eng = ServingEngine(cfg, None, plan=plan, device="cpu", config=EngineConfig(
            max_len=MAX_LEN, max_batch=3, cache=CacheConfig(kv_dtype="int8", **page)))
        reqs = [Request(uid=i, prompt=p, max_new_tokens=MAX_NEW)
                for i, p in enumerate(_prompts())]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve

    eng = serve.main(["--arch", "tinyllama-1.1b", "--smoke", "--requests", "5", "--max-new",
                      "4", "--compress", "quant_sparse", "--q-prune", "0.5", "--block", "16",
                      "--kv-dtype", "int8", "--page-size", "16", "--share-prefix",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert "H100 SXM data-sheet constants" in out
    assert "plan[" in out and "quant_sparse:3" in out
    assert "[serve] completed 5 requests" in out and "tok/s on cpu" in out
    eng.audit_pages()
    assert eng.pages_in_use == 0


@pytest.mark.parametrize("flag", [["--autotune-plan", "x", "--compress", "quant"],
                                  ["--mesh", "host"], ["--workload-mix", "tinyllama-1.1b:1"]])
def test_serve_rejects_unserved_flags(flag, capsys):
    from repro_torch.launch import serve

    if flag[0] == "--mesh":
        # served now: "host" is 1 x 1 on the CPU, one rank in this process
        eng = serve.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
                          "--requests", "3", "--max-new", "3"] + flag)
        out = capsys.readouterr().out
        assert ("[serve] mesh {'data': 1, 'model': 1}: data-parallel 1, model-parallel 1, "
                "kv shard degree 1") in out
        assert "[serve] completed 3 requests" in out
        assert (eng.data_parallel, eng.model_parallel, eng.kv_parallel) == (1, 1, 1)
        return
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu"] + flag)
    assert e.value.code == 2
    err = capsys.readouterr().err
    if flag[0] == "--workload-mix":
        # served now, but closed-loop over its own families: --arch is refused
        assert "--workload-mix is closed-loop heterogeneous serving; drop --arch" in err
    elif flag[0] == "--autotune-plan":
        # served now, and it carries its own plan: --compress is refused
        assert "--autotune-plan carries its own plan; drop --compress" in err
    else:
        assert "ROADMAP" in err


@pytest.mark.parametrize("kw", [dict(cache=CacheConfig(allocator=object())),
                                dict(mesh=object())])
def test_engine_config_rejects_unserved_fields(kw):
    if "cache" in kw:  # a shared allocator is served now (serving/mixed.py)
        assert EngineConfig(**kw).cache.allocator is kw["cache"].allocator
        return
    # a mesh is served now (sharded serving): the config keeps it, and the
    # engine serves every family on it
    assert EngineConfig(**kw).mesh is kw["mesh"]


def test_temperature_sampling_uses_the_engine_generator():
    """Temperature draws come from the engine's seeded generator: the same
    seed gives the same streams, tokens stay in the vocabulary."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    from repro_torch.models.transformer import init_params

    params = init_params(cfg, 5, device="cpu")
    outs = []
    for _ in range(2):
        eng = ServingEngine(cfg, params, device="cpu",
                            config=EngineConfig(max_len=MAX_LEN, max_batch=2, seed=7))
        reqs = [Request(uid=i, prompt=p, max_new_tokens=MAX_NEW, temperature=1.0)
                for i, p in enumerate(_prompts()[:3])]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert all(0 <= t < cfg.vocab and len(o) == MAX_NEW for o in outs[0] for t in o)


def test_non_finite_logits_retry_then_fail_without_leaks():
    """The numeric guard: a model whose logits are NaN sends every request
    through its one retry to FAILED, and no page stays allocated."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    from repro_torch.models.transformer import init_params

    params = init_params(cfg, 1, device="cpu")
    params["embed"]["head"][0, 0] = float("nan")
    eng = ServingEngine(cfg, params, device="cpu", config=EngineConfig(
        max_len=MAX_LEN, max_batch=2, cache=CacheConfig(page_size=PS, share_prefix=True)))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(_prompts()[:3])]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.state is RequestState.FAILED and r.retries == 1 for r in reqs)
    assert eng.stats.failed == 3 and eng.stats.retried == 3
    eng.audit_pages()
    assert eng.pages_in_use == 0
