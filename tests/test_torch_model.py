"""PyTorch port vs the JAX reference for the whole decoder (tinyllama smoke
config, fp32): prefill plus 8 decode steps of logits, on the contiguous and
the paged cache, with fp and int8 KV, dense and quant_sparse weights.

Reference params (and the reference's packed plan) cross over through
``repro_torch.interop``, so both packages run the identical weights.  Both
compute in fp32 with sums taken in another order; over 2 layers the logits
are held to rtol 1e-4 / atol 1e-4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import weight_plan as RW
from repro.models import transformer as RT
from repro.models.api import get_api as ref_get_api

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import weight_plan as TW
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, STEPS, PS = 2, 6, 8, 8
LENGTH = 24  # cache length: S + STEPS + 3 (one T=3 step) fits


def _models(compress: str):
    rcfg = ref_get_config("tinyllama-1.1b", smoke=True)
    params = ref_get_api(rcfg).init_params(rcfg, jax.random.key(0))
    if compress != "none":
        params = RW.compress(params, RW.PlanConfig(default=compress, q_prune=0.5,
                                                   bk=16, bn=16)).params
    cfg = get_config("tinyllama-1.1b", smoke=True)
    tparams = T.unstack(cfg, interop.params_from_reference(
        jax.tree_util.tree_map(np.asarray, params)))
    return rcfg, params, cfg, tparams


def _tokens(n, T_, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(n, B, T_)).astype(np.int32)


@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("compress", ["none", "quant_sparse"])
def test_prefill_and_decode_contiguous(compress, kv):
    rcfg, rparams, cfg, tparams = _models(compress)
    rkv, tkv = (jnp.int8, torch.int8) if kv == "int8" else (None, None)
    prompt = _tokens(1, S, seed=1)[0]
    rcache = RT.init_cache(rcfg, B, LENGTH, jnp.float32, kv_dtype=rkv)
    tcache = T.init_cache(cfg, B, LENGTH, torch.float32, kv_dtype=tkv)
    rl, rcache = jax.jit(functools.partial(RT.prefill, rcfg))(
        rparams, jnp.asarray(prompt), rcache)
    tl, tcache = T.prefill(cfg, tparams, torch.from_numpy(prompt), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
    pos = np.full((B,), S, np.int32)
    steps = list(_tokens(STEPS, 1, seed=2)) + [_tokens(1, 3, seed=3)[0]]  # then T=3
    rdecode = jax.jit(functools.partial(RT.decode_step, rcfg))
    for toks in steps:
        rl, rcache = rdecode(rparams, rcache, jnp.asarray(toks), jnp.asarray(pos))
        tl, tcache = T.decode_step(cfg, tparams, tcache, torch.from_numpy(toks),
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
        pos = pos + toks.shape[1]


@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("compress", ["none", "quant_sparse"])
def test_prompt_and_decode_paged(compress, kv):
    """The prompt goes in as one multi-token (T=6) paged decode step, then 8
    single-token steps; pages are scrambled across the pool."""
    rcfg, rparams, cfg, tparams = _models(compress)
    rkv, tkv = (jnp.int8, torch.int8) if kv == "int8" else (None, None)
    P = LENGTH // PS
    num_pages = 1 + B * P
    table = (1 + np.random.default_rng(4).permutation(B * P)).reshape(B, P).astype(np.int32)
    rcache = RT.init_cache(rcfg, B, LENGTH, jnp.float32, kv_dtype=rkv, page_size=PS,
                           num_pages=num_pages)
    rcache["page_table"] = jnp.asarray(table)
    tcache = T.init_cache(cfg, B, LENGTH, torch.float32, kv_dtype=tkv, page_size=PS,
                          num_pages=num_pages)
    tcache["page_table"].copy_(torch.from_numpy(table))
    pos = np.zeros((B,), np.int32)
    rdecode = jax.jit(functools.partial(RT.decode_step, rcfg))
    for toks in [_tokens(1, S, seed=5)[0]] + list(_tokens(STEPS, 1, seed=6)):
        rl, rcache = rdecode(rparams, rcache, jnp.asarray(toks), jnp.asarray(pos))
        tl, tcache = T.decode_step(cfg, tparams, tcache, torch.from_numpy(toks),
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
        pos = pos + toks.shape[1]
    # the pools hold the same int8 payloads (exact) / fp values; the
    # reference stacks its 2 layers' pools, the port keeps one per layer
    for name in ("k_pages", "v_pages"):
        got = torch.stack([c[name] for c in tcache["layers"]]).numpy()
        want = np.asarray(rcache["unit"][0][name])
        if kv == "int8":
            assert (got != want).mean() < 1e-3  # a rounding tie may flip a value
        else:
            np.testing.assert_allclose(got, want, **TOL)


def test_param_shapes_match_reference():
    rcfg = ref_get_config("tinyllama-1.1b", smoke=True)
    cfg = get_config("tinyllama-1.1b", smoke=True)
    ref = jax.eval_shape(lambda: RT.init_params(rcfg, jax.random.key(0)))
    got = T.init_params(cfg, 0, device="cpu")
    rl = jax.tree_util.tree_leaves_with_path(ref)
    assert T.n_params_exact(cfg) == RT.n_params_exact(rcfg)
    for path, leaf in rl:
        node = got
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert tuple(node.shape) == tuple(leaf.shape), path
    # the reference's init scales: LeCun-normal weights, N(0, 0.02) tokens
    w = got["unit"][0]["mlp"]["w_up"]
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert abs(float(got["embed"]["tok"].std()) - 0.02) < 0.002


def test_unstack_gives_per_layer_views():
    """``unstack`` runs once per model: one params dict per layer, whose
    leaves are views of the stacked tensors; packed leaves keep their
    layer's row of the walk, on the host.  Applied to its own output it is
    a no-op."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    plan = TW.compress(T.init_params(cfg, 0, device="cpu"),
                       TW.PlanConfig(q_prune=0.5, bk=16, bn=16))
    view = T.unstack(cfg, plan.params)
    assert len(view["layers"]) == cfg.n_layers
    assert T.unstack(cfg, view) is view
    stacked = plan.params["unit"][0]
    assert stacked["mlp"]["w_up"].walk["idx"].device.type == "cpu"
    for i, layer in enumerate(view["layers"]):
        w = layer["mlp"]["w_up"]
        assert isinstance(w, TW.PackedLinear) and w.blocks.dim() == 3
        assert w.walk is not None and set(w.walk) == set(stacked["mlp"]["w_up"].walk)
        for k, v in w.walk.items():
            assert v.device.type == "cpu" and torch.equal(v, stacked["mlp"]["w_up"].walk[k][i])
        assert w.blocks.data_ptr() == stacked["mlp"]["w_up"].blocks[i].data_ptr()
        assert layer["ln1"]["scale"].data_ptr() == stacked["ln1"]["scale"][i].data_ptr()
