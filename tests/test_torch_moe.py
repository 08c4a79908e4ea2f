"""PyTorch port vs the JAX reference for the MoE family (granite-moe-1b-a400m,
qwen2-moe-a2.7b and qwen2-moe with its experts padded 6 -> 8) at smoke
configs, fp32, model level: configs and parameter counts, param trees,
``apply_moe`` with its kept/dropped assignments, top-k ties, the expert
plan and its packs, the stacked kernels' plain versions, prefill and
decode logits, and the plan cache (tests/_torch_moe.py has the shared
set-up; test_torch_moe_serving.py the engines, test_torch_moe_host.py the
stacked launches' host side).

``apply_moe`` is held to atol 1e-5 (fp32 sums over the top-k in another
order), its dispatched expert buffer exactly (the same tokens in the same
(expert, group, slot) rows: the same kept and dropped sets); logits as in
test_torch_families.py (1e-4; int8 KV atol 5e-3 for a rounding tie)."""

import dataclasses
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as F
import _torch_moe as MF
from repro.core import weight_plan as RW
from repro.models import moe as RM
from repro.models import transformer as RT

from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import weight_plan as TW
from repro_torch.kernels import block_sparse as BS
from repro_torch.kernels import fused_gate_up as FG
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T

MOE_ATOL = 1e-5


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MF.ARCHS)
def test_configs_and_counts_are_the_references(arch):
    from repro.configs import get_config as ref_get_config

    assert arch in ARCH_IDS
    for smoke in (False, True):
        cfg, rcfg = get_config(arch, smoke), ref_get_config(arch, smoke)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
        assert (cfg.moe.n_experts_padded, cfg.moe.capacity_factor, cfg.moe.router_aux_weight) \
            == (rcfg.moe.n_experts_padded, rcfg.moe.capacity_factor, rcfg.moe.router_aux_weight)
        assert (cfg.n_params(), cfg.n_active_params()) == (rcfg.n_params(),
                                                           rcfg.n_active_params())
        assert T.n_params_exact(cfg) == RT.n_params_exact(rcfg)
        assert TM.moe_n_params(cfg) == RM.moe_n_params(rcfg)


@pytest.mark.parametrize("variant", MF.VARIANTS)
def test_param_shapes_match_reference(variant):
    rcfg, cfg = MF.configs(variant)
    ref = jax.eval_shape(lambda: RT.init_params(rcfg, jax.random.key(0)))
    got = T.init_params(cfg, 0, device="cpu")
    assert T.n_params_exact(cfg) == RT.n_params_exact(rcfg)
    flat = jax.tree_util.tree_leaves_with_path(ref)
    assert len(flat) == len(TW.flatten_leaves(got))
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert tuple(node.shape) == tuple(leaf.shape), path
    moe = got["unit"][0]["moe"]
    one = TM.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), one) == \
        jax.tree_util.tree_map(lambda t: tuple(t.shape[1:]), moe)
    Ep, f = cfg.moe.n_experts_padded, cfg.moe.expert_d_ff
    assert tuple(moe["w_down"].shape) == (cfg.n_layers, Ep, f, cfg.d_model)
    # fan-in on the contraction axis of each expert: LeCun-normal's scale
    for name, fan_in in (("w_gate", cfg.d_model), ("w_down", f)):
        assert abs(float(moe[name].std()) * fan_in ** 0.5 - 1.0) < 0.05


# ---------------------------------------------------------------------------
# apply_moe: routing, capacity, the combine, the aux loss
# ---------------------------------------------------------------------------


def _moe_inputs(variant, shape, capacity_factor=None):
    rcfg, cfg = MF.configs(variant)
    if capacity_factor is not None:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    rp = jax.jit(functools.partial(RM.init_moe, rcfg))(jax.random.key(3))
    rp = jax.tree_util.tree_map(np.asarray, rp)
    x = np.random.default_rng(sum(shape)).normal(size=shape + (cfg.d_model,)).astype(np.float32)
    return rcfg, cfg, rp, interop.params_from_reference(rp), x


def _with_dispatch(module, fn):
    """``fn`` with ``module.apply_gate_up`` watched: returns fn's result and
    the buffer handed to its first call (the stacked experts' input; the
    shared experts' comes after), reshaped (Ep, nG * C, d).  Traceable, so
    the reference runs under one jit."""
    def run(*args):
        seen = []
        inner = module.apply_gate_up

        def spy(x, *a, **k):
            if not seen:
                seen.append(x.reshape(x.shape[0], -1, x.shape[-1]))
            return inner(x, *a, **k)

        module.apply_gate_up = spy
        try:
            out = fn(*args)
        finally:
            module.apply_gate_up = inner
        return out, seen[0]

    return run


T_CASES = [((2, 4), None), ((2, 128), None), ((3, 100), 0.5), ((1, 521), None)]


@pytest.mark.parametrize("variant,shape,cf", [
    *[(arch, shape, cf) for arch in MF.ARCHS for shape, cf in T_CASES],
    (MF.PADDED, (2, 4), None), (MF.PADDED, (3, 100), 0.5)])
def test_apply_moe_matches_reference(variant, shape, cf):
    """T = 8 and 256 (full capacity), 300 with capacity_factor 0.5 (the
    reference drops assignments), 521 (prime: groups of one token, capacity
    1); the padded variant at 8 and 300: the same output with and without
    the aux loss, the same aux loss, the same dispatched buffer."""
    rcfg, cfg, rp, tp, x = _moe_inputs(variant, shape, cf)
    ref = _with_dispatch(RM, lambda p, x: RM.apply_moe(rcfg, p, x, return_aux=True))
    (want, want_aux), ref_buf = jax.jit(ref)(rp, jnp.asarray(x))
    ref_buf = np.asarray(ref_buf)
    got, buf = _with_dispatch(TM, lambda: TM.apply_moe(cfg, tp, torch.from_numpy(x)))()
    np.testing.assert_array_equal(buf.numpy(), ref_buf)  # the same kept (token, slot) rows
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOE_ATOL, rtol=0)
    got_y, got_aux = TM.apply_moe(cfg, tp, torch.from_numpy(x), return_aux=True)
    torch.testing.assert_close(got_y, got, rtol=0, atol=0)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    T_ = shape[0] * shape[1]
    kept = int((np.abs(ref_buf).sum(-1) > 0).sum())
    if cf is not None:
        assert kept < T_ * cfg.moe.top_k  # the reference dropped assignments
    elif T_ <= TM.FULL_CAPACITY_TOKENS or T_ == 521:
        assert kept == T_ * cfg.moe.top_k
    # padded experts never receive a token
    assert not ref_buf[cfg.moe.n_experts:].any()


def test_routing_keeps_the_earliest_assignments_up_to_capacity():
    """Capacity ranks an expert's assignments in (token, k) order: a group
    of 300 tokens at capacity_factor 0.5 keeps, per expert, exactly its
    first ``capacity`` assignments."""
    _, cfg, _, tp, x = _moe_inputs("granite-moe-1b-a400m", (3, 100), 0.5)
    xg = torch.from_numpy(x).reshape(1, 300, cfg.d_model)
    r = TM.route(cfg, xg, tp["router"])
    assert r.capacity == 75  # ceil(300 * 2 / 4 * 0.5)
    idx, keep = r.idx.reshape(-1).tolist(), r.keep.reshape(-1).tolist()
    seen = {}
    for e, k in zip(idx, keep):
        seen[e] = seen.get(e, 0) + 1
        assert k == (seen[e] <= r.capacity)


@pytest.mark.parametrize("row,k", [
    ([0.1, 0.5, 0.5, 0.2, 0.5], 2),
    ([0.25, 0.25, 0.25, 0.25], 3),
    ([0.3, 0.1, 0.3, 0.3], 2),
    ([0.0, 0.5, 0.0, 0.5, 0.0, 0.0], 4),
])
def test_top_k_breaks_ties_as_jax_does(row, k):
    """Exact ties go to the lower expert index, largest first, as
    ``jax.lax.top_k`` orders them; torch.topk on the CPU returns [2, 4] for
    the first row."""
    p = np.asarray(row, np.float32)[None]
    want_v, want_i = jax.lax.top_k(jnp.asarray(p), k)
    got_v, got_i = TM.top_k(torch.from_numpy(p), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ---------------------------------------------------------------------------
# the expert plan: kinds, packs, the stacked plain kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["granite-moe-1b-a400m", MF.PADDED])
def test_expert_plan_kinds_and_packs_are_the_references(variant):
    """The port's compress of the reference's dense params gives the
    reference plan's kinds and, leaf for leaf, its packs: the router stays
    dense, every expert stack (L, Ep, K, N) is quant_sparse, pruned slice
    by slice with one mb."""
    _, _, rplan = MF.ref_model(variant, "quant_sparse")
    _, cfg = MF.configs(variant)
    plan = TW.compress(MF.port_params(variant), TW.PlanConfig(**MF.PLAN))
    assert {p: l.kind for p, l in plan.leaves.items()} == \
        {p: l.kind for p, l in rplan.leaves.items()}
    kinds = {p.split("moe/")[-1]: l.kind for p, l in plan.leaves.items() if "/moe/" in p}
    assert kinds["router"] == "dense"
    for name in ("w_gate", "w_up", "w_down"):
        assert kinds[name] == "quant_sparse"
    g = plan.params["unit"][0]["moe"]["w_gate"]
    assert g.blocks.dim() == 5 and g.counts.shape[:2] == (cfg.n_layers,
                                                          cfg.moe.n_experts_padded)
    want = TW.flatten_leaves(interop.plan_from_reference(rplan).params)
    got = TW.flatten_leaves(plan.params)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert plan.fused_pairs == rplan.fused_pairs


def _stack(variant="qwen2-moe-a2.7b"):
    """Layer 0's packed expert stacks of the reference plan: (reference
    nodes with their kernels on in interpret mode, port nodes)."""
    _, _, rplan = MF.ref_model(variant, "quant_sparse")
    rmoe = jax.tree_util.tree_map(lambda a: a[0], rplan.params["unit"][0]["moe"])
    rmoe = {k: dataclasses.replace(v, use_kernel=True, interpret=True)
            if isinstance(v, RW.PackedLinear) else v for k, v in rmoe.items()}
    tmoe = T.unstack(MF.configs(variant)[1], interop.plan_from_reference(rplan).params)
    return rmoe, tmoe["layers"][0]["moe"]


def test_stacked_plain_kernels_match_the_vmapped_pallas_kernels():
    """The stacked plain versions of B1 and B2 (the 2-D plain version over
    each expert) against the reference's ``ops.block_sparse_matmul`` (with
    walks: the multi-column kernel) and ``ops.fused_gate_up`` vmapped over
    the 8 padded experts, in interpret mode."""
    rmoe, tmoe = _stack(MF.PADDED)
    g, u, dn = tmoe["w_gate"], tmoe["w_up"], tmoe["w_down"]
    E, (K, N) = g.blocks.shape[0], g.shape
    x = np.random.default_rng(7).normal(size=(E, 5, K)).astype(np.float32)
    want_h = RW.apply_gate_up(jnp.asarray(x), rmoe["w_gate"], rmoe["w_up"], "silu")
    h = FG.fused_gate_up(torch.from_numpy(x), (g.blocks, g.block_rows, g.counts),
                         (u.blocks, u.block_rows, u.counts), g.scales, u.scales)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=1e-5, atol=2e-4)
    want_y = RW.apply_linear(want_h, rmoe["w_down"])
    y = BS.block_sparse_matmul(h, dn.blocks, dn.block_rows, dn.counts, dn.scales)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5, atol=2e-4)
    assert y.shape == (E, 5, dn.shape[1])
    # B4's plain version is B1's
    torch.testing.assert_close(
        BS.block_sparse_matmul_col(h, dn.blocks, dn.block_rows, dn.counts, dn.scales), y,
        rtol=0, atol=0)


def test_unstack_leaves_each_layer_a_stack_of_experts():
    """``transformer.unstack`` slices the layer dim off an (L, Ep, ...)
    leaf: a packed leaf keeps (Ep, ...) children and its walk's row, an int8
    leaf (Ep, K, N) payload and (Ep, N) scales, a dense leaf (Ep, K, N)."""
    variant = "granite-moe-1b-a400m"
    _, cfg = MF.configs(variant)
    Ep = cfg.moe.n_experts_padded
    packed = T.unstack(cfg, MF.port_params(variant, "quant_sparse"))["layers"]
    dense_tree = MF.port_params(variant)
    quant = T.unstack(cfg, TW.compress(dense_tree, TW.PlanConfig(
        **dict(MF.PLAN, default="quant"))).params)["layers"]
    dense = T.unstack(cfg, dense_tree)["layers"]
    stacked = packed[0]["moe"]["w_down"]
    whole = MF.port_params(variant, "quant_sparse")["unit"][0]["moe"]["w_down"]
    assert isinstance(stacked, TW.PackedLinear) and TW.is_stacked(stacked)
    assert torch.equal(stacked.blocks, whole.blocks[0])
    assert torch.equal(packed[1]["moe"]["w_down"].blocks, whole.blocks[1])
    assert torch.equal(packed[1]["moe"]["w_down"].walk["idx"], whole.walk["idx"][1])
    q = quant[1]["moe"]["w_up"]
    assert isinstance(q, TW.QuantLinear) and tuple(q.q.shape) == (Ep, cfg.d_model,
                                                                   cfg.moe.expert_d_ff)
    assert tuple(q.s.shape) == (Ep, cfg.moe.expert_d_ff)
    assert tuple(dense[1]["moe"]["w_gate"].shape) == (Ep, cfg.d_model, cfg.moe.expert_d_ff)


# ---------------------------------------------------------------------------
# model level: prefill and decode logits
# ---------------------------------------------------------------------------


def _decode_run(variant, compress, paged):
    """A 12-token prompt (contiguous: one prefill; paged int8: three T=4
    steps), then 8 single-token steps and one T=3 step, logits held to the
    reference's at every step."""
    rcfg, rparams, _ = MF.ref_model(variant, compress)
    _, cfg = MF.configs(variant)
    tparams = T.unstack(cfg, MF.port_params(variant, compress))
    B, LENGTH, PS = F.B, F.LENGTH, F.PS
    rdecode = jax.jit(functools.partial(RT.decode_step, rcfg))
    steps = list(F.tokens(8, 1, seed=2)) + [F.tokens(1, 3, seed=3)[0]]
    pos = np.zeros((B,), np.int32)
    if paged:
        P = LENGTH // PS
        table = (1 + np.random.default_rng(4).permutation(B * P)).reshape(B, P).astype(np.int32)
        rcache = RT.init_cache(rcfg, B, LENGTH, jnp.float32, kv_dtype=jnp.int8, page_size=PS,
                               num_pages=1 + B * P)
        rcache["page_table"] = jnp.asarray(table)
        tcache = T.init_cache(cfg, B, LENGTH, torch.float32, kv_dtype=torch.int8, page_size=PS,
                              num_pages=1 + B * P)
        tcache["page_table"].copy_(torch.from_numpy(table))
        steps = list(F.tokens(3, 4, seed=5)) + steps
        tol = F.TOL_INT8
    else:
        prompt = F.tokens(1, F.S, seed=1)[0]
        rcache = RT.init_cache(rcfg, B, LENGTH, jnp.float32)
        tcache = T.init_cache(cfg, B, LENGTH, torch.float32)
        rl, rcache = jax.jit(functools.partial(RT.prefill, rcfg))(rparams, jnp.asarray(prompt),
                                                                 rcache)
        tl, tcache = T.prefill(cfg, tparams, torch.from_numpy(prompt), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **F.TOL)
        pos += F.S
        tol = F.TOL
    for toks in steps:
        rl, rcache = rdecode(rparams, rcache, jnp.asarray(toks), jnp.asarray(pos))
        tl, tcache = T.decode_step(cfg, tparams, tcache, torch.from_numpy(toks),
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **tol)
        pos = pos + toks.shape[1]


@pytest.mark.parametrize("arch,compress", [("granite-moe-1b-a400m", "none"),
                                           ("qwen2-moe-a2.7b", "quant_sparse")])
def test_prefill_and_decode_contiguous(arch, compress):
    _decode_run(arch, compress, paged=False)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b"])
def test_prompt_and_decode_paged_int8(arch):
    _decode_run(arch, "quant_sparse", paged=True)


# ---------------------------------------------------------------------------
# the plan cache of a MoE tree
# ---------------------------------------------------------------------------


def test_plan_cache_round_trips_a_moe_plan():
    variant = "qwen2-moe-a2.7b"
    _, cfg = MF.configs(variant)
    dense = T.init_params(cfg, 0, device="cpu")
    plan = TW.compress(dense, TW.PlanConfig(**MF.PLAN))
    with tempfile.TemporaryDirectory() as d:
        TW.save_plan(os.path.join(d, "plan"), plan)
        back = TW.load_plan(os.path.join(d, "plan"), dense)
    want, got = TW.flatten_leaves(plan.params), TW.flatten_leaves(back.params)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    node = back.params["unit"][0]["moe"]["w_down"]
    assert isinstance(node, TW.PackedLinear) and node.blocks.dim() == 5
    assert node.walk is not None
    assert {p: l.kind for p, l in back.leaves.items()} == {p: l.kind
                                                           for p, l in plan.leaves.items()}


def test_reference_moe_plan_directory_loads_in_the_port():
    _, _, rplan = MF.ref_model(MF.PADDED, "quant_sparse")
    _, cfg = MF.configs(MF.PADDED)
    with tempfile.TemporaryDirectory() as d:
        RW.save_plan(os.path.join(d, "plan"), rplan)
        back = TW.load_plan(os.path.join(d, "plan"), T.init_params(cfg, 0, device="cpu"))
    want = TW.flatten_leaves(interop.plan_from_reference(rplan).params)
    got = TW.flatten_leaves(back.params)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert torch.equal(a, b)

