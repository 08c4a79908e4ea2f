"""MoE layers on a mesh of ranks (expert parallelism) against the
reference's unmeshed engine, and ``weight_plan.local_leaf``'s cut of an
expert stack's lead axis.

The ranks run as gloo processes on the CPU (``tests/_torch_ranks``), one
torch thread each, on the MoE smoke configs: granite-moe-1b-a400m (4
experts: 2 a rank at 1x2, 1 at 1x4) and qwen2-moe-a2.7b (6 experts and 2
shared: 3 a rank at 1x2; 6 do not divide 4, so at 1x4 the stacks stay
whole and no routed all-reduce is issued), over the reference's packed
quant_sparse plan (blocks of 16, ``tests/_torch_moe.PLAN``) and over its
dense weights, on a paged fp cache.  A rank's greedy streams must equal
the reference's unmeshed engine's bit for bit.  The routed experts'
partial sums (and the shared experts' ``w_down`` partial product) add up
in another order under the all-reduce, so a rank's caches are held to its
slices of the unsharded port engine's within 1e-5 of the largest entry
after every step, and each step's logits within 1e-5 of the largest."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models.api import get_api as ref_get_api
from repro.serving.config import EngineConfig as REngineConfig
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine

import _torch_moe as TM
import _torch_ranks as R
from repro_torch import interop
from repro_torch.core import weight_plan as WP
from repro_torch.distributed import shardlib as sl
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T

CACHE_RTOL = 1e-5
LOGIT_RTOL = 1e-5
FLAT = dict(max_len=64, max_batch=4, page_size=8)
GRANITE, QWEN = TM.ARCHS


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """arch -> (plan directory, saved dense params, {compress: the
    reference's unmeshed streams}); the plans record their param axes."""
    from repro.core import weight_plan as RW

    out = {}
    tmp = tmp_path_factory.mktemp("moe")
    prompts = [p.tolist() for p in TM.prompts()]
    for arch in TM.ARCHS:
        rcfg, _ = TM.configs(arch)
        rapi = ref_get_api(rcfg)
        rparams = rapi.init_params(rcfg, jax.random.key(0))
        rplan = rapi.compress(rcfg, rparams, RW.PlanConfig(**TM.PLAN))
        want = {}
        for name, plan, params in (("quant_sparse", rplan, None), ("none", None, rparams)):
            eng = RServingEngine(rcfg, params, plan=plan, config=REngineConfig.of(**FLAT))
            reqs = [RRequest(uid=i, prompt=np.asarray(p, np.int32), max_new_tokens=6)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_done()
            want[name] = [[int(t) for t in r.output] for r in reqs]
        plan_dir = str(tmp / f"{arch}-plan")
        WP.save_plan(plan_dir, interop.plan_from_reference(rplan))
        dense = str(tmp / f"{arch}.pt")
        torch.save(interop.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams)),
                   dense)
        out[arch] = (plan_dir, dense, want)
    return out, prompts


@pytest.mark.parametrize("arch,shape,compress,rules,experts,reduces", [
    (GRANITE, (1, 2), "quant_sparse", "rules_for", 2, 3),
    (GRANITE, (1, 4), "quant_sparse", "rules_for", 1, 3),
    (QWEN, (1, 2), "quant_sparse", "rules_for", 3, 3),
    (QWEN, (1, 4), "quant_sparse", "default", 6, 1),
    (QWEN, (1, 2), "none", "rules_for", 3, 5),
    (QWEN, (1, 4), "none", "rules_for", 6, 5),
])
def test_meshed_moe_streams_equal_the_reference(reference, arch, shape, compress, rules,
                                                experts, reduces, tmp_path):
    """Each rank holds ``experts`` experts of every stack (6: whole), routes
    every token, runs its experts and joins the others' through ONE
    all-reduce a MoE layer, which also carries the shared experts' partial
    ``w_down`` product.  ``reduces``: the all-reduces a decode step issues
    -- the vocab-split embedding's, one a MoE layer where a product is
    partial (none where the packed stacks stayed whole; dense qwen2 at 1x4
    splits every expert's FFN width under ``rules_for``'s expert_ff rule),
    and one a dense ``wo``, whose contraction splits."""
    refs, prompts = reference
    plan_dir, dense, want = refs[arch]
    job = dict(arch=arch, flat=FLAT, prompts=prompts, max_new=6, out=str(tmp_path),
               rules=rules)
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
        assert r["tables"] == r["solo_tables"] and r["pages_in_use"] == 0
        m = r["coords"]["model"]
        Ep = 6 if arch == QWEN else 4
        assert r["experts"] == ([m * experts, experts] if experts < Ep else [0, Ep])
        assert set(r["step_reduces"]) == {reduces}
    first = res[0]
    assert all((r["streams"], r["steps"], r["step_reduces"]) ==
               (first["streams"], first["steps"], first["step_reduces"]) for r in res)


# -- local_leaf on a stack of experts (no ranks: a mesh of shapes with this
# rank's coordinates)

STACK_AXES = (None, "experts", "d", "expert_ff")
BLOCKS = WP.PlanConfig(bk=16, bn=16, q_prune=0.5)


def _mesh(m: int, M: int = 2) -> sl.MeshShape:
    return sl.MeshShape({"data": 1, "model": M}, {"data": 0, "model": m})


def _stack(E: int, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((2, E, 32, 48), generator=g)


@pytest.mark.parametrize("m", [0, 1])
def test_local_leaf_cuts_a_dense_and_an_int8_expert_stack(m):
    w = _stack(4)
    loc = WP.local_leaf(w, STACK_AXES, _mesh(m), sl.DEFAULT_RULES)
    assert isinstance(loc, WP.ShardedLeaf)
    assert (loc.experts, loc.k_split, loc.n_split, loc.shape) == ((2 * m, 2), False, False,
                                                                   (32, 48))
    assert torch.equal(loc.local, w[:, 2 * m:2 * m + 2])
    q = WP.quantize_leaf(w)
    lq = WP.local_leaf(q, STACK_AXES, _mesh(m), sl.DEFAULT_RULES)
    assert lq.experts == (2 * m, 2) and not (lq.k_split or lq.n_split)
    assert torch.equal(lq.local.q, q.q[:, 2 * m:2 * m + 2])
    assert torch.equal(lq.local.s, q.s[:, 2 * m:2 * m + 2])


@pytest.mark.parametrize("m", [0, 1])
def test_local_leaf_cuts_a_packed_expert_stack_with_a_walk_per_expert(m):
    """Every child of the packed stack narrowed to the rank's experts; each
    kept expert's walk is the one packed for that expert alone (its rows,
    columns and flags; its block indices at the stack's ``mb``)."""
    from repro_torch.core.sparse_format import build_walk

    w = _stack(4)
    p = WP.pack_block_sparse(w, BLOCKS, quant=True)
    loc = WP.local_leaf(p, STACK_AXES, _mesh(m), sl.DEFAULT_RULES)
    assert isinstance(loc, WP.ShardedLeaf) and loc.experts == (2 * m, 2)
    lp = loc.local
    sel = slice(2 * m, 2 * m + 2)
    for name in ("blocks", "block_rows", "counts", "scales"):
        assert torch.equal(getattr(lp, name), getattr(p, name)[:, sel]), name
    mb = p.block_rows.shape[-1]
    for layer in range(2):
        for e in range(2):
            walk = {k: v[layer, e].numpy() for k, v in lp.walk.items()}
            live = walk["flags"] != 0
            own = WP.pack_block_sparse(w[layer, 2 * m + e], BLOCKS, quant=True).walk
            want = build_walk(p.block_rows[layer, 2 * m + e].numpy(),
                              p.counts[layer, 2 * m + e].numpy(), mb)
            for k in ("idx", "rows", "cols", "flags"):
                np.testing.assert_array_equal(walk[k][live], want[k], err_msg=k)
            for k in ("rows", "cols", "flags"):
                np.testing.assert_array_equal(walk[k][live], own[k].numpy()[own["flags"] != 0])
    # the kept walks pad to the longest kept one, not the stack's
    n_live = [int((lp.walk["flags"][layer, e] != 0).sum()) for layer in range(2)
              for e in range(2)]
    assert lp.walk["flags"].shape[-1] == max(n_live)
    # the rank's experts compute what the whole stack computes for them
    x = torch.randn(4, 5, 32, generator=torch.Generator().manual_seed(1))
    y = WP.apply_linear(x[sel], T._layer_leaf(lp, 0))
    assert torch.equal(y, WP.apply_linear(x, T._layer_leaf(p, 0))[sel])


@pytest.mark.parametrize("kind", ["dense", "quant", "packed"])
def test_local_leaf_keeps_a_stack_whole_where_the_model_axis_does_not_divide_it(kind):
    """6 experts on a 4-wide model axis: the mapping drops, the stack stays
    whole on every rank (no ShardedLeaf)."""
    w = _stack(6)
    node = {"dense": lambda: w, "quant": lambda: WP.quantize_leaf(w),
            "packed": lambda: WP.pack_block_sparse(w, BLOCKS, quant=True)}[kind]()
    for m in range(4):
        assert WP.local_leaf(node, STACK_AXES, _mesh(m, 4), sl.DEFAULT_RULES) is node


def test_a_saved_plan_with_axes_loads_onto_a_mesh_with_the_same_cut(tmp_path):
    """A plan packed with its axes (``LeafPlan.axes``), saved and loaded,
    places onto a mesh as the family's dense axes place it: the same
    experts a rank, the same pieces."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_api

    cfg = get_config(QWEN, smoke=True)
    api = get_api(cfg)
    dense = T.init_params(cfg, 0, device="cpu")
    plan = api.compress(cfg, dense, WP.PlanConfig(**TM.PLAN))
    WP.save_plan(str(tmp_path), plan)
    loaded = WP.load_plan(str(tmp_path), dense)
    assert all(lp.axes for lp in loaded.leaves.values())
    for m in range(2):
        mesh = _mesh(m)
        a = WP.local_params(loaded.params, loaded.axes_tree(), mesh, sl.DEFAULT_RULES)
        b = WP.local_params(plan.params, api.param_axes(cfg), mesh, sl.DEFAULT_RULES)
        for k in ("w_gate", "w_up", "w_down"):
            la, lb = a["unit"][0]["moe"][k], b["unit"][0]["moe"][k]
            assert la.experts == lb.experts == (3 * m, 3), k
            for f in ("blocks", "block_rows", "counts", "scales"):
                assert torch.equal(getattr(la.local, f), getattr(lb.local, f)), (k, f)
            assert all(torch.equal(la.local.walk[w], lb.local.walk[w]) for w in la.local.walk)
        fa, fb = WP.flatten_leaves(a), WP.flatten_leaves(b)
        assert len(fa) == len(fb) and all(torch.equal(x, y) for x, y in zip(fa, fb))
