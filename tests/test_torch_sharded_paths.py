"""Speculative decode and chunked prefill on a mesh of ranks
(``EngineConfig.mesh``) against the reference's unmeshed engine.

Each mesh's ranks run as gloo processes on the CPU (``tests/_torch_ranks``,
which imports the port only), one torch thread each, on smoke
tinyllama-1.1b with the settings of tests/test_torch_sharded_serving.py
(quant_sparse, blocks of 16, int8 pages of 8, prefix sharing).  A rank's
greedy streams must equal the reference's unmeshed engine's, bit for bit;
its caches -- the pools, the draft's contiguous cache, an in-flight
chunked prefill's private batch-1 cache -- must equal its slices of the
unsharded port engine's after every step: the target's bit for bit (no
product of its path is a partial sum: wo and w_down stay whole under
quant_sparse), the dense draft's within 1e-5 of the largest entry (its wo
and w_down split their contraction, so an all-reduce sums their partial
products in another order), and each step's logits within 1e-5 of the
largest."""

import os

import jax
import numpy as np
import pytest
import torch

import repro.configs as RCF
from repro.core import weight_plan as RW
from repro.models.api import get_api as ref_get_api
from repro.serving.config import EngineConfig as REngineConfig
from repro.serving.config import SpecConfig as RSpecConfig
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine

import _torch_ranks as R
from repro_torch import interop
from repro_torch.core.weight_plan import save_plan

LOGIT_RTOL = 1e-5
DRAFT_CACHE_RTOL = 1e-5
K = 2
CHUNK = dict(max_len=64, max_batch=4, kv_dtype="int8", page_size=8, prefill_chunk=4,
             prefill_budget=8)


def _serve(eng, prompts, max_new):
    reqs = [RRequest(uid=i, prompt=np.asarray(p, np.int32), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return [[int(t) for t in r.output] for r in reqs]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{path: the reference's unmeshed streams}, the plan directory and
    the draft's saved params (tinyllama smoke from seed 1, dense)."""
    rcfg = RCF.get_config(R.ARCH, smoke=True)
    rapi = ref_get_api(rcfg)
    rplan = rapi.compress(rcfg, rapi.init_params(rcfg, jax.random.key(0)), RW.PlanConfig(
        default="quant_sparse", q_prune=0.5, bk=16, bn=16, min_size=1024))
    rdraft = rapi.init_params(rcfg, jax.random.key(1))
    prompts = [p.tolist() for p in R.prompts(rcfg.vocab)]
    spec = RSpecConfig(draft_cfg=rcfg, draft_params=rdraft, spec_k=K)
    want = {
        "spec": _serve(RServingEngine(rcfg, None, plan=rplan,
                                      config=REngineConfig.of(**R.FLAT, spec=spec)),
                       prompts, 6),
        "chunked": _serve(RServingEngine(rcfg, None, plan=rplan,
                                         config=REngineConfig.of(**CHUNK)), prompts, 6),
    }
    tmp = tmp_path_factory.mktemp("paths")
    plan_dir = str(tmp / "plan")
    save_plan(plan_dir, interop.plan_from_reference(rplan))
    draft = str(tmp / "draft.pt")
    torch.save(interop.params_from_reference(jax.tree_util.tree_map(np.asarray, rdraft)),
               draft)
    return want, plan_dir, draft, prompts


def _job(reference, path, out):
    _, plan_dir, draft, prompts = reference
    job = dict(arch=R.ARCH, plan_dir=plan_dir, prompts=prompts, max_new=6, out=out,
               rules="rules_for")
    if path == "spec":
        job.update(flat=dict(R.FLAT, spec_k=K), draft=dict(arch=R.ARCH, params=draft))
    else:
        job.update(flat=CHUNK)
    return job


def _check(res, want):
    for r in res:
        assert r["streams"] == want, r["rank"]
        assert r["solo_streams"] == want
        assert r["cache_exact"], (r["rank"], r["cache_err"])
        assert r["draft_err"] <= DRAFT_CACHE_RTOL, r["draft_err"]
        assert r["logit_err"] <= LOGIT_RTOL, r["logit_err"]
        assert r["logit_steps"][0] == r["logit_steps"][1] > 0
        assert r["tables"] == r["solo_tables"]
        assert r["stats"] == r["solo_stats"]
        assert r["pages_in_use"] == 0 and not r["degraded"]
        assert set(r["states"]) == {"FINISHED"}
        assert r["weight_bytes"][0] < r["weight_bytes"][1]
    first = res[0]
    assert all((r["streams"], r["steps"], r["stats"]) ==
               (first["streams"], first["steps"], first["stats"]) for r in res)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_meshed_speculative_decode_equals_the_reference(reference, shape, tmp_path):
    """k 2 with a seed-1 draft: the draft's params and contiguous cache on
    the rank's shards (batch over data, KV heads over model), the verify
    step's (B, 3) on the rank's KV heads; the acceptance counts equal the
    unsharded engine's on every rank."""
    res = R.run_path(shape, _job(reference, "spec", str(tmp_path)))
    _check(res, reference[0]["spec"])
    # every tick verified k + 1 positions a slot (a seed-1 draft of random
    # weights rarely matches: the accept counts are held to the unsharded
    # engine's above)
    assert all(r["stats"][1] > 0 for r in res)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_meshed_chunked_prefill_equals_the_reference(reference, shape, tmp_path):
    """4-token chunks, 8 a tick: every chunk step on the rank's shards over
    its private batch-1 cache of the rank's KV heads (whole over data),
    held to its slice of the unsharded job's cache while in flight."""
    res = R.run_path(shape, _job(reference, "chunked", str(tmp_path)))
    _check(res, reference[0]["chunked"])
    assert all(r["stats"][2] > 0 and r["chunk_checks"] > 0 for r in res)
