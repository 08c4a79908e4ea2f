"""recurrentgemma-2b on a mesh of ranks against the reference's unmeshed
engine: the RG-LRU's channels split over the model axis and its local
attention layers on the rank's q heads.

The ranks run as gloo processes on the CPU (``tests/_torch_ranks``), one
torch thread each, on smoke recurrentgemma-2b (4 q heads over 1 KV head,
an RG-LRU 64 channels wide) on the contiguous cache it serves (it has no
global layer to page), over its dense weights and over the reference's
packed quant_sparse plan (blocks of 16, ``tests/_torch_moe.PLAN``'s low
``min_size`` / ``min_contract``, so that the smoke projections pack).  A
rank's greedy streams must equal the reference's unmeshed engine's bit for
bit.  A split contraction (the dense ``w_out``, ``wo``, ``w_down``) sums
its partial products in another order under the all-reduce, so a rank's
caches -- its KV rings and its channels of the RG-LRU's ``h`` and conv
states -- are held to its slices of the unsharded port engine's within
1e-5 of the largest entry after every step, and each step's logits within
1e-5 of the largest."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import weight_plan as RW
from repro.models.api import get_api as ref_get_api
from repro.serving.config import EngineConfig as REngineConfig
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine

import _torch_moe as TM
import _torch_ranks as R
from repro_torch import interop
from repro_torch.core import weight_plan as WP

ARCH = "recurrentgemma-2b"
CACHE_RTOL = 1e-5
LOGIT_RTOL = 1e-5
FLAT = dict(max_len=64, max_batch=4)


def _prompts() -> list:
    """Five prompts of 6-20 tokens (past and within the smoke window of
    8); five requests on four slots, so one waits for a slot and takes a
    used slot's fixed-size state."""
    r = np.random.default_rng(0)
    return [r.integers(0, 256, n).astype(np.int32).tolist() for n in (12, 20, 6, 9, 15)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    rcfg = ref_get_config(ARCH, smoke=True)
    rapi = ref_get_api(rcfg)
    rparams = rapi.init_params(rcfg, jax.random.key(0))
    rplan = rapi.compress(rcfg, rparams, RW.PlanConfig(**TM.PLAN))
    prompts = _prompts()
    want = {}
    for name, plan, params in (("quant_sparse", rplan, None), ("none", None, rparams)):
        eng = RServingEngine(rcfg, params, plan=plan, config=REngineConfig.of(**FLAT))
        reqs = [RRequest(uid=i, prompt=np.asarray(p, np.int32), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        want[name] = [[int(t) for t in r.output] for r in reqs]
    tmp = tmp_path_factory.mktemp("rg")
    plan_dir = str(tmp / "plan")
    WP.save_plan(plan_dir, interop.plan_from_reference(rplan))
    dense = str(tmp / "dense.pt")
    torch.save(interop.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams)),
               dense)
    return want, plan_dir, dense, prompts


@pytest.mark.parametrize("shape,compress,kinds", [
    ((1, 2), "none", {"rec.w_x": "n_split", "rec.w_out": "k_split"}),
    ((2, 2), "none", {"rec.w_x": "n_split", "rec.w_out": "k_split"}),
    ((1, 2), "quant_sparse", {"rec.w_x": "n_split", "rec.w_out": "whole"}),
])
def test_meshed_recurrentgemma_equals_the_reference(reference, shape, compress, kinds,
                                                    tmp_path):
    """Each rank projects, convolves and scans its 32 RG-LRU channels
    (``kinds``: a dense ``w_out`` contracts them into a partial sum that
    one all-reduce adds; a packed one stays whole, C1, and gathers the
    channels first), attends with its 2 of the 4 q heads over the one KV
    head, which stays whole, and at 2x2 holds its data replica's rows."""
    want, plan_dir, dense, prompts = reference
    job = dict(arch=ARCH, flat=FLAT, prompts=prompts, max_new=6, out=str(tmp_path),
               rules="rules_for")
    if compress == "none":
        job["params"] = dense
    else:
        job["plan_dir"] = plan_dir
    res = R.run_path(shape, job)
    for r in res:
        assert r["streams"] == want[compress], r["rank"]
        assert r["solo_streams"] == want[compress]
        assert r["cache_err"] <= CACHE_RTOL, r["cache_err"]
        assert r["logit_err"] <= LOGIT_RTOL, r["logit_err"]
        assert r["kinds"] == kinds
        assert set(r["states"]) == {"FINISHED"} and not r["degraded"]
        assert r["weight_bytes"][0] < r["weight_bytes"][1]
    first = res[0]
    assert all((r["streams"], r["steps"]) == (first["streams"], first["steps"]) for r in res)
