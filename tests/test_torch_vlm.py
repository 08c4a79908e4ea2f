"""PyTorch port vs the JAX reference for the VLM family (internvl2-2b,
``models/vlm.py``) at its smoke config, fp32, model level: the param tree
with ``proj``, the patch projection, and prefill plus decode at the
8-patch offset (positions and cache slots start after the patches) on the
contiguous cache and the paged int8 cache, dense and through a packed
quant_sparse plan.  Tolerance 1e-5; int8 KV at atol 5e-3, as
tests/test_torch_families.py holds it (a K or V sum on a rounding tie may
quantize one step apart)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_encdec as X
from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models import vlm as RV

from repro_torch.configs import get_config
from repro_torch.core import weight_plan as TW
from repro_torch.models import transformer as T
from repro_torch.models import vlm as V
from repro_torch.models.api import get_api

ARCH = X.INTERNVL
TOL = X.TOL
TOL_INT8 = dict(rtol=1e-4, atol=5e-3)
B, S, PS = 2, 6, 8


def _cfgs():
    return ref_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)


def _np(a):
    return np.asarray(a, np.float32)


def test_param_tree_matches_reference():
    rcfg, cfg = _cfgs()
    ref = jax.eval_shape(lambda: RV.init_params(rcfg, jax.random.key(0)))
    got = V.init_params(cfg, 0, device="cpu")
    flat = jax.tree_util.tree_leaves_with_path(ref)
    assert len(flat) == len(TW.flatten_leaves(got))
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert tuple(node.shape) == tuple(leaf.shape), path
    view = V.unstack(cfg, got)
    assert view["proj"] is got["proj"] and len(view["layers"]) == cfg.n_layers
    api = get_api(cfg)
    assert api.extra_keys == ("patches",) and api.prefix_len(cfg) == cfg.n_patches == 8


@pytest.mark.parametrize("compress", ["none", "quant_sparse"])
def test_project_matches_reference(compress):
    rcfg, cfg = _cfgs()
    _, rparams, _ = X.ref_model(ARCH, compress)
    params = V.unstack(cfg, X.port_params(ARCH, compress))
    patches = X.batch_extra(cfg, B, seed=2)
    want = RV._project(rcfg, rparams, jnp.asarray(patches))
    got = V._project(cfg, params, torch.from_numpy(patches))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def _inputs(cfg):
    r = np.random.default_rng(4)
    return (r.integers(0, cfg.vocab, (B, S)).astype(np.int32), X.batch_extra(cfg, B, seed=5),
            r.integers(0, cfg.vocab, (3, B, 1)).astype(np.int32))


@pytest.mark.parametrize("compress", ["none", "quant_sparse"])
def test_prefill_and_contiguous_decode_at_the_patch_offset(compress):
    """Prefill over 8 patches + 6 tokens, then 3 decode steps at positions
    14, 15, 16: logits and the KV of every position."""
    rcfg, cfg = _cfgs()
    _, rparams, _ = X.ref_model(ARCH, compress)
    params = V.unstack(cfg, X.port_params(ARCH, compress))
    toks, patches, steps = _inputs(cfg)
    n = 32
    rcache = RT.init_cache(rcfg, B, n, jnp.float32)
    rl, rcache = RV.prefill(rcfg, rparams, jnp.asarray(toks), jnp.asarray(patches), rcache)
    cache = V.init_cache(cfg, B, n, torch.float32)
    lg, cache = V.prefill(cfg, params, torch.from_numpy(toks), torch.from_numpy(patches), cache)
    np.testing.assert_allclose(lg.numpy(), _np(rl), **TOL)
    P = cfg.n_patches
    for j in range(3):
        pos = np.full((B,), P + S + j, np.int32)
        rl, rcache = RV.decode_step(rcfg, rparams, rcache, jnp.asarray(steps[j]),
                                    jnp.asarray(pos))
        lg, cache = V.decode_step(cfg, params, cache, torch.from_numpy(steps[j]),
                                  torch.from_numpy(pos))
        np.testing.assert_allclose(lg.numpy(), _np(rl), **TOL)
    rk = np.concatenate([_np(x["k"]) for x in rcache["unit"]])  # (L, B, n, KVH, hd)
    got = np.stack([c["k"].numpy() for c in cache["layers"]])
    np.testing.assert_allclose(got[:, :, :P + S + 3], rk[:, :, :P + S + 3], **TOL)


def test_paged_int8_decode_at_the_patch_offset():
    """The quickstart cache: the prefill's int8 KV (patches and prompt)
    scattered into pages of 8 through the same table in both packages,
    then paged decode steps from position 14 (the second page's middle)."""
    rcfg, cfg = _cfgs()
    _, rparams, _ = X.ref_model(ARCH, "quant_sparse")
    params = V.unstack(cfg, X.port_params(ARCH, "quant_sparse"))
    toks, patches, steps = _inputs(cfg)
    n, P0 = 32, cfg.n_patches + S
    rc1 = RT.init_cache(rcfg, B, n, jnp.float32, kv_dtype=jnp.int8)
    _, rc1 = RV.prefill(rcfg, rparams, jnp.asarray(toks), jnp.asarray(patches), rc1)
    c1 = V.init_cache(cfg, B, n, torch.float32, kv_dtype=torch.int8)
    V.prefill(cfg, params, torch.from_numpy(toks), torch.from_numpy(patches), c1)
    pages = n // PS
    table = (1 + np.random.default_rng(6).permutation(B * pages)).reshape(B, pages)
    table = table.astype(np.int32)
    rcache = RT.init_cache(rcfg, B, n, jnp.float32, kv_dtype=jnp.int8, page_size=PS,
                           num_pages=1 + B * pages)
    cache = V.init_cache(cfg, B, n, torch.float32, kv_dtype=torch.int8, page_size=PS,
                         num_pages=1 + B * pages)
    pos_w = np.arange(P0)
    phys = table[:, pos_w // PS]  # (B, P0)
    for u, entry in enumerate(rcache["unit"]):
        new = dict(entry)
        for pk, ck in (("k_pages", "k"), ("v_pages", "v"), ("k_scale_pages", "k_scale"),
                       ("v_scale_pages", "v_scale")):
            vals = np.asarray(rc1["unit"][u][ck])[:, :, :P0]  # (L, B, P0, ...)
            arr = np.array(entry[pk])
            for b in range(B):
                arr[:, phys[b], pos_w % PS] = vals[:, b]
            new[pk] = jnp.asarray(arr)
        rcache["unit"][u] = new
    rcache["page_table"] = jnp.asarray(table)
    for c, one in zip(cache["layers"], c1["layers"]):
        for pk, ck in (("k_pages", "k"), ("v_pages", "v"), ("k_scale_pages", "k_scale"),
                       ("v_scale_pages", "v_scale")):
            for b in range(B):
                c[pk][torch.from_numpy(phys[b]).long(), torch.from_numpy(pos_w % PS)] = \
                    one[ck][b, :P0]
    cache["page_table"].copy_(torch.from_numpy(table))
    for j in range(3):
        pos = np.full((B,), P0 + j, np.int32)
        rl, rcache = RV.decode_step(rcfg, rparams, rcache, jnp.asarray(steps[j]),
                                    jnp.asarray(pos))
        lg, cache = V.decode_step(cfg, params, cache, torch.from_numpy(steps[j]),
                                  torch.from_numpy(pos))
        np.testing.assert_allclose(lg.numpy(), _np(rl), **TOL_INT8)


def test_transformer_takes_a_layernorm_config():
    """The transformer follows cfg.norm as the reference does (no config of
    the repo is a layernorm decoder-only stack; this one is tinyllama-smoke
    with LayerNorms): param shapes and prefill logits."""
    import dataclasses

    from repro.models.api import get_api as ref_get_api

    from repro_torch import interop

    rcfg = dataclasses.replace(ref_get_config("tinyllama-1.1b", smoke=True), norm="layernorm")
    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True), norm="layernorm")
    rparams = ref_get_api(rcfg).init_params(rcfg, jax.random.key(0))
    params = T.unstack(cfg, interop.params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams)))
    assert set(params["final_norm"]) == {"scale", "bias"}
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    rl, _ = RT.prefill(rcfg, rparams, jnp.asarray(toks), RT.init_cache(rcfg, B, 16, jnp.float32))
    lg, _ = T.prefill(cfg, params, torch.from_numpy(toks), T.init_cache(cfg, B, 16, torch.float32))
    np.testing.assert_allclose(lg.numpy(), _np(rl), rtol=1e-4, atol=1e-4)
