"""Shared set-up of the dense families' parity tests
(tests/test_torch_families.py, test_torch_families_serving.py,
test_torch_gemma3_serving.py): the reference's smoke params and packed
plans, carried into the port by ``interop``, and both engines over the
same quant_sparse plan with one flat configuration."""

import functools

import jax
import numpy as np

from repro.configs import get_config as ref_get_config
from repro.core import weight_plan as RW
from repro.models.api import get_api as ref_get_api
from repro.serving import config as RC
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.serving import config as PC
from repro_torch.serving.engine import Request, RequestState, ServingEngine

FAMILIES = ["llama3.2-1b", "glm4-9b", "gemma3-4b"]
TOL = dict(rtol=1e-4, atol=1e-4)
TOL_INT8 = dict(rtol=1e-4, atol=5e-3)
B, S, PS = 2, 12, 8
LENGTH = 32  # S + 8 single steps + one T=3 step, with room


@functools.lru_cache(maxsize=None)
def ref_model(arch: str, compress: str = "none", seed: int = 0):
    rcfg = ref_get_config(arch, smoke=True)
    params = ref_get_api(rcfg).init_params(rcfg, jax.random.key(seed))
    plan = None
    if compress != "none":
        plan = RW.compress(params, RW.PlanConfig(default=compress, q_prune=0.5, bk=16, bn=16))
        params = plan.params
    return rcfg, params, plan


def port_params(arch: str, compress: str = "none", seed: int = 0):
    _, params, _ = ref_model(arch, compress, seed)
    return interop.params_from_reference(jax.tree_util.tree_map(np.asarray, params))


def tokens(n, t, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(n, B, t)).astype(np.int32)


QUICKSTART = dict(kv_dtype="int8", page_size=16, share_prefix=True)


def prompts(seed: int = 0):
    """Requests 0-2 share request 0's 20-token prompt (one full page of 16
    mapped by refcount, the boundary page copied; gemma3's rings are still
    written whole); 3-4 stand alone."""
    r = np.random.default_rng(seed)
    prefix = r.integers(0, 256, 20).astype(np.int32)
    out = [prefix] + [np.concatenate([prefix, r.integers(0, 256, n).astype(np.int32)])
                      for n in (4, 6)]
    return out + [r.integers(0, 256, n).astype(np.int32) for n in (10, 27)]


def engines(arch, *, spec=None, max_len=64, max_batch=5, **flat):
    """(reference engine, port engine on the CPU) over the reference's packed
    quant_sparse plan; ``spec`` = (draft kind, k): "self" drafts with the
    target's dense weights before compression, "seed1" with an independent
    model."""
    rcfg, _, rplan = ref_model(arch, "quant_sparse")
    cfg = get_config(arch, smoke=True)
    rspec, pspec = RC.SpecConfig(), PC.SpecConfig()
    if spec is not None:
        kind, k = spec
        seed = 0 if kind == "self" else 1
        rspec = RC.SpecConfig(draft_cfg=rcfg, draft_params=ref_model(arch, "none", seed)[1],
                              spec_k=k)
        pspec = PC.SpecConfig(draft_cfg=cfg, draft_params=port_params(arch, "none", seed),
                              spec_k=k)
    rconf = RC.EngineConfig.of(max_len=max_len, max_batch=max_batch, spec=rspec, **flat)
    pconf = PC.EngineConfig.of(max_len=max_len, max_batch=max_batch, spec=pspec, **flat)
    ref = RServingEngine(rcfg, rplan.params, plan=rplan, config=rconf)
    eng = ServingEngine(cfg, None, plan=interop.plan_from_reference(rplan), device="cpu",
                        config=pconf)
    return ref, eng


def serve_both(ref, eng, prompts, max_new: int, tables: bool = True):
    rreqs = [RRequest(uid=i, prompt=p.copy(), max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    reqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for rr, tr in zip(rreqs, reqs):
        ref.submit(rr)
        eng.submit(tr)
    for _ in range(500):
        if not ref.queue and not ref._live_slots():
            break
        ref.step()
        eng.step()
        if tables and eng.paged:
            np.testing.assert_array_equal(eng._table, ref._table)
            assert eng.slot_pages == ref.slot_pages
    assert not eng.queue and not eng._live_slots()
    for tr, rr in zip(reqs, rreqs):
        assert tr.state is RequestState.FINISHED
        assert tr.output == rr.output, tr.uid
    if eng.paged:
        eng.audit_pages()
        assert eng.pages_in_use == 0
    return reqs
