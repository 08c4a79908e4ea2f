"""whisper-tiny (its frame pages) and internvl2-2b (its patches) on a mesh
of ranks against the reference's unmeshed engine.

The ranks run as gloo processes on the CPU (``tests/_torch_ranks``), one
torch thread each, over the reference's packed quant_sparse plan of each
smoke config (``tests/_torch_encdec.PLAN``), with each request's frames or
patches drawn with numpy.  whisper-tiny smoke (6/6 heads, 16 frames)
serves paged with frame pages on an fp cache (the enc-dec cache ignores
``kv_dtype``; the pool is sized for the frame pages too, C5): at 1x2 a
rank runs 3 heads of the encoder and of both attentions and holds 3 KV
heads of the self and frame pools; at 1x4 the 6 heads do not divide and
stay whole (the kv fallback) while the MLP's columns split; at 2x2 also
its data replica's rows.  internvl2-2b smoke (4/2 heads, 8 patches)
serves paged int8 with the projector replicated.  A rank's greedy
streams must equal the reference's unmeshed engine's bit for bit; its
caches (self and frame pools) are held to its slices of the unsharded
port engine's within 1e-5 of the largest entry after every step (a split
contraction sums in another order under the all-reduce), each step's
logits within 1e-5 of the largest, and its page and frame tables and free
list equal the unsharded engine's."""

import numpy as np
import pytest

from repro.serving.config import EngineConfig as REngineConfig
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine

import _torch_encdec as X
import _torch_ranks as R
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import weight_plan as WP

CACHE_RTOL = 1e-5
LOGIT_RTOL = 1e-5
# whisper: 6 decoder pages and 2 frame pages a request, 4 slots, the null page
FLAT = {X.WHISPER: dict(max_len=48, max_batch=4, page_size=8, num_pages=33),
        X.INTERNVL: dict(max_len=48, max_batch=4, page_size=8, kv_dtype="int8")}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """arch -> (the reference's unmeshed streams, a plan directory, prompts,
    extras)."""
    out = {}
    tmp = tmp_path_factory.mktemp("encdec")
    prompts = X.prompts()
    for arch in X.ARCHS:
        rcfg, _, rplan = X.ref_model(arch, "quant_sparse")
        extras = X.extras(get_config(arch, smoke=True), len(prompts), seed=1)
        eng = RServingEngine(rcfg, rplan.params, plan=rplan,
                             config=REngineConfig.of(**FLAT[arch]))
        reqs = [RRequest(uid=i, prompt=p.copy(), max_new_tokens=6, extras=e)
                for i, (p, e) in enumerate(zip(prompts, extras))]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        plan_dir = str(tmp / arch)
        WP.save_plan(plan_dir, interop.plan_from_reference(rplan))
        out[arch] = ([[int(t) for t in r.output] for r in reqs], plan_dir, extras)
    return out, [p.tolist() for p in prompts]


@pytest.mark.parametrize("arch,shape,kv", [
    (X.WHISPER, (1, 2), 2), (X.WHISPER, (2, 2), 2), (X.WHISPER, (1, 4), 1),
    (X.INTERNVL, (1, 2), 2), (X.INTERNVL, (2, 2), 2),
])
def test_meshed_encdec_and_vlm_equal_the_reference(reference, arch, shape, kv, tmp_path):
    refs, prompts = reference
    want, plan_dir, extras = refs[arch]
    res = R.run_path(shape, dict(arch=arch, flat=FLAT[arch], plan_dir=plan_dir,
                                 rules="rules_for", prompts=prompts, extras=extras, max_new=6,
                                 out=str(tmp_path)))
    D, M = shape
    for r in res:
        assert r["streams"] == want, r["rank"]
        assert r["solo_streams"] == want
        assert r["cache_err"] <= CACHE_RTOL, r["cache_err"]
        assert r["logit_err"] <= LOGIT_RTOL, r["logit_err"]
        assert r["degrees"] == [D, M, kv]
        assert r["tables"] == r["solo_tables"] and r["free"] == r["solo_free"]
        assert r["pages_in_use"] == 0 and set(r["states"]) == {"FINISHED"}
        assert not r["degraded"]
        assert r["weight_bytes"][0] < r["weight_bytes"][1]
    first = res[0]
    assert all((r["streams"], r["free"], r["steps"]) ==
               (first["streams"], first["free"], first["steps"]) for r in res)
