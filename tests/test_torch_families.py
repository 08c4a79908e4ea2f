"""PyTorch port vs the JAX reference for the dense families llama3.2-1b
(tied embeddings), glm4-9b (hd 128 at full width, GQA groups of 4 here)
and gemma3-4b (sliding-window local layers, a global RoPE base, scaled and
tied embeddings, gelu_glu) at their smoke configs, fp32, model level:
configs, param trees, the layer pattern, prefill plus decode logits on the
contiguous and the paged cache, gemma3's rings, the tied int8 head and the
plan cache of a tied tree (tests/_torch_families.py has the shared set-up;
test_torch_families_serving.py and test_torch_gemma3_serving.py the
engines).

Logits are held to rtol 1e-4 / atol 1e-4 (fp32 sums in another order over
2-8 layers); with int8 KV to atol 5e-3: a K or V value whose fp32 sum
lands on a rounding tie may quantize one int8 step apart (under 1e-3 of
the entries), which moves gemma3-smoke's logits by about 1e-3."""

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
from repro.configs import get_config as ref_get_config
from repro.core import weight_plan as RW
from repro.models import layers as RL
from repro.models import transformer as RT

from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import weight_plan as TW
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T

FAMILIES, TOL, TOL_INT8 = F.FAMILIES, F.TOL, F.TOL_INT8
B, S, PS, LENGTH = F.B, F.S, F.PS, F.LENGTH


# ---------------------------------------------------------------------------
# configs, params, the layer pattern
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_configs_are_the_references(arch):
    assert arch in ARCH_IDS
    for smoke in (False, True):
        assert get_config(arch, smoke).__dict__ == ref_get_config(arch, smoke).__dict__


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_shapes_match_reference(arch):
    rcfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    ref = jax.eval_shape(lambda: RT.init_params(rcfg, jax.random.key(0)))
    got = T.init_params(cfg, 0, device="cpu")
    assert T.n_params_exact(cfg) == RT.n_params_exact(rcfg)
    assert ("head" in got["embed"]) == (not cfg.tie_embeddings)
    flat = jax.tree_util.tree_leaves_with_path(ref)
    assert len(flat) == len(TW.flatten_leaves(got))
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert tuple(node.shape) == tuple(leaf.shape), path


@pytest.mark.parametrize("arch", FAMILIES)
def test_full_width_unit_factorisation_matches_reference(arch):
    cfg = get_config(arch)
    assert T.find_unit(cfg.layer_kinds) == RT.find_unit(cfg.layer_kinds)
    assert T.rem_runs(T.find_unit(cfg.layer_kinds)[2]) == RT.rem_runs(
        RT.find_unit(cfg.layer_kinds)[2])


def test_gemma3_pattern_is_five_local_global_units_and_a_local_tail():
    unit, n, rem = T.find_unit(get_config("gemma3-4b").layer_kinds)
    assert unit == ("local",) * 5 + ("global",) and n == 5
    assert T.rem_runs(rem) == [("local", 4)]
    cfg = get_config("gemma3-4b", smoke=True)
    view = T.unstack(cfg, F.port_params("gemma3-4b"))
    assert len(view["layers"]) == cfg.n_layers == 8


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", *FAMILIES])
def test_layer_kind_sets_window_and_rope_base(arch):
    """The reference's rule (``transformer.apply_layer``, ``layers.apply_attn``):
    a local layer attends within ``local_window`` at ``rope_base``; a global
    one attends to every position at ``rope_base_global`` where it is set."""
    cfg = get_config(arch)
    glob = cfg.rope_base_global if cfg.rope_base_global else cfg.rope_base
    assert TL.attn_window_and_base(cfg, "global") == (None, glob)
    assert TL.attn_window_and_base(cfg, "local") == (cfg.local_window, cfg.rope_base)
    if arch == "gemma3-4b":
        assert TL.attn_window_and_base(cfg, "global") == (None, 1e6)
        assert TL.attn_window_and_base(cfg, "local") == (1024, 1e4)


def test_check_supported_still_names_what_is_not_ported():
    """Logit softcaps, once refused as A8c, pass; a layer kind the port does
    not have is refused by name; the recurrent and xLSTM families, once
    refused as A10, pass at smoke and full width."""
    cfg = get_config("gemma3-4b", smoke=True)
    for smoke in (True, False):
        T.check_supported(dataclasses.replace(get_config("gemma3-4b", smoke=smoke),
                                              logit_softcap=30.0))
    with pytest.raises(NotImplementedError, match="mamba"):
        T.check_supported(dataclasses.replace(cfg, pattern=("mamba",) * cfg.n_layers))
    for arch in ("recurrentgemma-2b", "xlstm-350m"):
        for smoke in (True, False):
            T.check_supported(ref_get_config(arch, smoke=smoke))
            T.check_supported(get_config(arch, smoke=smoke))


# ---------------------------------------------------------------------------
# model level: prefill and decode logits
# ---------------------------------------------------------------------------


def _run_contiguous(arch, compress, kv, prompt_len):
    rcfg, rparams, _ = F.ref_model(arch, compress)
    cfg = get_config(arch, smoke=True)
    tparams = T.unstack(cfg, F.port_params(arch, compress))
    rkv, tkv = (jnp.int8, torch.int8) if kv == "int8" else (None, None)
    tol = TOL_INT8 if kv == "int8" else TOL
    prompt = F.tokens(1, prompt_len, seed=1)[0]
    rcache = RT.init_cache(rcfg, B, LENGTH, jnp.float32, kv_dtype=rkv)
    tcache = T.init_cache(cfg, B, LENGTH, torch.float32, kv_dtype=tkv)
    rl, rcache = jax.jit(functools.partial(RT.prefill, rcfg))(rparams, jnp.asarray(prompt),
                                                             rcache)
    tl, tcache = T.prefill(cfg, tparams, torch.from_numpy(prompt), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **tol)
    pos = np.full((B,), prompt_len, np.int32)
    rdecode = jax.jit(functools.partial(RT.decode_step, rcfg))
    for toks in list(F.tokens(8, 1, seed=2)) + [F.tokens(1, 3, seed=3)[0]]:
        rl, rcache = rdecode(rparams, rcache, jnp.asarray(toks), jnp.asarray(pos))
        tl, tcache = T.decode_step(cfg, tparams, tcache, torch.from_numpy(toks),
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **tol)
        pos = pos + toks.shape[1]
    return rcache, tcache


@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("compress", ["none", "quant_sparse"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_contiguous(arch, compress, kv):
    """A 12-token prompt (past gemma3-smoke's window of 8: its local rings
    wrap at prefill and go on wrapping in decode), 8 single-token steps
    and one T=3 step."""
    _run_contiguous(arch, compress, kv, S)


def test_gemma3_rings_hold_the_references_slots():
    """The rolled ring fill: every local layer's ring holds the reference's
    K/V slot for slot (8 slots, 23 positions written; fp cache, so that a
    misplaced slot cannot hide behind an int8 rounding tie)."""
    rcache, tcache = _run_contiguous("gemma3-4b", "none", "fp", S)
    cfg = get_config("gemma3-4b", smoke=True)
    unit, n, rem = RT.find_unit(cfg.layer_kinds)
    ref_layers = [jax.tree_util.tree_map(lambda a, u=u: np.asarray(a[u]), rcache["unit"][pi])
                  for u in range(n) for pi in range(len(unit))]
    for ri, (_, count) in enumerate(RT.rem_runs(rem)):
        ref_layers += [jax.tree_util.tree_map(lambda a, i=i: np.asarray(a[i]), rcache["rem"][ri])
                       for i in range(count)]
    for kind, want, got in zip(cfg.layer_kinds, ref_layers, tcache["layers"]):
        assert got["k"].shape[1] == (cfg.local_window if kind == "local" else LENGTH)
        for name in ("k", "v"):
            np.testing.assert_allclose(got[name].numpy(), want[name], **TOL)


@pytest.mark.parametrize("compress", ["none", "quant_sparse"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prompt_and_decode_paged(arch, compress):
    """int8 KV: global layers paged (pages scrambled across the pool),
    gemma3's local layers on their rings; the prompt goes in as three T=4
    steps (no wider than the window), then 8 single-token steps."""
    rcfg, rparams, _ = F.ref_model(arch, compress)
    cfg = get_config(arch, smoke=True)
    tparams = T.unstack(cfg, F.port_params(arch, compress))
    P = LENGTH // PS
    num_pages = 1 + B * P
    table = (1 + np.random.default_rng(4).permutation(B * P)).reshape(B, P).astype(np.int32)
    rcache = RT.init_cache(rcfg, B, LENGTH, jnp.float32, kv_dtype=jnp.int8, page_size=PS,
                           num_pages=num_pages)
    rcache["page_table"] = jnp.asarray(table)
    tcache = T.init_cache(cfg, B, LENGTH, torch.float32, kv_dtype=torch.int8, page_size=PS,
                          num_pages=num_pages)
    tcache["page_table"].copy_(torch.from_numpy(table))
    kinds = [("k_pages" in c) for c in tcache["layers"]]
    assert kinds == [k == "global" for k in cfg.layer_kinds]
    pos = np.zeros((B,), np.int32)
    rdecode = jax.jit(functools.partial(RT.decode_step, rcfg))
    for toks in list(F.tokens(3, 4, seed=5)) + list(F.tokens(8, 1, seed=6)):
        rl, rcache = rdecode(rparams, rcache, jnp.asarray(toks), jnp.asarray(pos))
        tl, tcache = T.decode_step(cfg, tparams, tcache, torch.from_numpy(toks),
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL_INT8)
        pos = pos + toks.shape[1]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-4b"])
def test_tied_head_int8_table(arch):
    """Under quant_sparse the tied table is an int8 QuantLinear (QUANT_KEYS):
    the embedding gathers dequantized rows and the head contracts
    (x * s) @ q.T, as the reference's dot_general does."""
    params = F.port_params(arch, "quant_sparse")
    tok = params["embed"]["tok"]
    assert isinstance(tok, TW.QuantLinear) and tok.q.dtype == torch.int8
    assert "head" not in params["embed"]
    rtok = F.ref_model(arch, "quant_sparse")[1]["embed"]["tok"]
    np.testing.assert_array_equal(tok.q.numpy(), np.asarray(rtok["q"]))
    np.testing.assert_array_equal(tok.s.numpy(), np.asarray(rtok["s"]))


# ---------------------------------------------------------------------------
# the plan cache of a tied tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-4b"])
def test_plan_cache_round_trips_a_tied_tree(arch):
    cfg = get_config(arch, smoke=True)
    dense = T.init_params(cfg, 0, device="cpu")
    plan = TW.compress(dense, TW.PlanConfig(default="quant_sparse", q_prune=0.5, bk=16, bn=16))
    with tempfile.TemporaryDirectory() as d:
        TW.save_plan(os.path.join(d, "plan"), plan)
        back = TW.load_plan(os.path.join(d, "plan"), dense)
    want, got = TW.flatten_leaves(plan.params), TW.flatten_leaves(back.params)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert isinstance(back.params["embed"]["tok"], TW.QuantLinear)
    assert "head" not in back.params["embed"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-4b"])
def test_reference_plan_directory_of_a_tied_tree_loads_in_the_port(arch):
    _, _, rplan = F.ref_model(arch, "quant_sparse")
    cfg = get_config(arch, smoke=True)
    with tempfile.TemporaryDirectory() as d:
        RW.save_plan(os.path.join(d, "plan"), rplan)
        back = TW.load_plan(os.path.join(d, "plan"), T.init_params(cfg, 0, device="cpu"))
    want = TW.flatten_leaves(interop.plan_from_reference(rplan).params)
    got = TW.flatten_leaves(back.params)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_gemma3_embedding_scale_rounds_like_the_reference():
    """sqrt(d_model) is rounded to the compute dtype before the product
    (the reference's weakly typed scalar): bf16 embeddings agree exactly."""
    rcfg = dataclasses.replace(ref_get_config("gemma3-4b", smoke=True), compute_dtype="bfloat16")
    cfg = dataclasses.replace(get_config("gemma3-4b", smoke=True), compute_dtype="bfloat16")
    tok = np.random.default_rng(0).normal(size=(256, cfg.d_model)).astype(np.float32)
    ids = np.arange(0, 256, 7, dtype=np.int32)[None]
    want = RL.embed_tokens(rcfg, {"tok": jnp.asarray(tok)}, jnp.asarray(ids))
    got = TL.embed_tokens(cfg, {"tok": torch.from_numpy(tok)}, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
