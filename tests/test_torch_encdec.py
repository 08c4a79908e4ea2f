"""PyTorch port vs the JAX reference for the enc-dec family (whisper-tiny,
``models/encdec.py``) at its smoke config, fp32, model level: the config
and its parameter counts, the param tree, LayerNorm, ``encode`` (also at
1100 frames, past the dense threshold: the flash branch), prefill logits
and caches, decode on the contiguous cache at T 1 and T 3 and on the paged
cache (self-attention pages and frame pages through their tables), and
the two attention calls this family adds: B3 non-causal (the decode's
cross-attention over frame pages) and B6 non-causal at Sq != Sk (the
prefill's cross-attention), each against the reference's own function.

Tolerance 1e-5 (fp32 sums in another order) unless stated; the flash
plain version against the reference's Pallas kernel at 5e-5, as
tests/test_torch_flash_hd.py holds it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_encdec as X
from repro.configs import get_config as ref_get_config
from repro.kernels import ops as rops
from repro.models import encdec as RE
from repro.models import layers as RL

from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import weight_plan as TW
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models.api import get_api

ARCH = X.WHISPER
TOL = X.TOL
B, S, LENGTH = 2, 6, 32


def _cfgs():
    return ref_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)


def _np(a):
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# config, params, norms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,smoke,n", [(X.WHISPER, True, 108_672),
                                          (X.WHISPER, False, 49_031_040),
                                          (X.INTERNVL, True, 110_976),
                                          (X.INTERNVL, False, 1_893_343_232)])
def test_configs_and_parameter_counts_are_the_references(arch, smoke, n):
    from repro.models.api import get_api as ref_get_api

    assert arch in ARCH_IDS
    rcfg, cfg = ref_get_config(arch, smoke), get_config(arch, smoke)
    assert cfg.__dict__ == rcfg.__dict__
    assert get_api(cfg).n_params_exact(cfg) == ref_get_api(rcfg).n_params_exact(rcfg) == n


def test_param_tree_matches_reference_and_unstacks():
    rcfg, cfg = _cfgs()
    ref = jax.eval_shape(lambda: RE.init_params(rcfg, jax.random.key(0)))
    got = E.init_params(cfg, 0, device="cpu")
    flat = jax.tree_util.tree_leaves_with_path(ref)
    assert len(flat) == len(TW.flatten_leaves(got))
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
    assert torch.all(got["enc_norm"]["scale"] == 1) and torch.all(got["enc_norm"]["bias"] == 0)
    view = E.unstack(cfg, got)
    assert len(view["enc"]) == cfg.enc_layers and len(view["layers"]) == cfg.n_layers
    assert "lnx" in view["layers"][0] and "lnx" not in view["enc"][0]
    assert E.unstack(cfg, view) is view


def test_layernorm_matches_reference():
    r = np.random.default_rng(0)
    x = (r.normal(size=(3, 5, 48)) * 3 + 1).astype(np.float32)
    p = {"scale": r.normal(size=48).astype(np.float32),
         "bias": r.normal(size=48).astype(np.float32)}
    want = RL.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), "layernorm")
    got = L.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                       "layernorm")
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    # the default stays RMSNorm
    rms = L.apply_norm({"scale": torch.from_numpy(p["scale"])}, torch.from_numpy(x))
    np.testing.assert_allclose(
        rms.numpy(), _np(RL.apply_norm({"scale": jnp.asarray(p["scale"])}, jnp.asarray(x))),
        **TOL)


# ---------------------------------------------------------------------------
# encode, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_frames", [16, 1100])
def test_encode_matches_reference(n_frames):
    """At the smoke config's 16 frames (dense attention) and at 1100 (past
    the 1024 dense threshold: the flash branch, B6's plain version)."""
    rcfg, cfg = _cfgs()
    rcfg = dataclasses.replace(rcfg, n_frames=n_frames)
    cfg = dataclasses.replace(cfg, n_frames=n_frames)
    _, rparams, _ = X.ref_model(ARCH)
    params = E.unstack(cfg, X.port_params(ARCH))
    frames = X.batch_extra(cfg, 1 if n_frames > 16 else B, seed=3)
    want = RE.encode(rcfg, rparams, jnp.asarray(frames))
    got = E.encode(cfg, params, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def _prefilled(compress: str = "none"):
    """Both packages' prefill over the same tokens and frames into a
    contiguous cache of LENGTH: (ref params, params, ref logits, ref cache,
    logits, cache)."""
    rcfg, cfg = _cfgs()
    _, rparams, _ = X.ref_model(ARCH, compress)
    params = E.unstack(cfg, X.port_params(ARCH, compress))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = X.batch_extra(cfg, B, seed=6)
    rcache = RE.init_cache(rcfg, B, LENGTH, jnp.float32)
    rl, rcache = RE.prefill(rcfg, rparams, jnp.asarray(tokens), jnp.asarray(frames), rcache)
    cache = E.init_cache(cfg, B, LENGTH, torch.float32)
    lg, cache = E.prefill(cfg, params, torch.from_numpy(tokens), torch.from_numpy(frames), cache)
    return rparams, params, rl, rcache, lg, cache


@pytest.mark.parametrize("compress", ["none", "quant_sparse"])
def test_prefill_logits_and_caches_match_reference(compress):
    _, _, rl, rcache, lg, cache = _prefilled(compress)
    np.testing.assert_allclose(lg.numpy(), _np(rl), **TOL)
    for i, c in enumerate(cache["layers"]):
        for key in ("k", "v", "xk", "xv"):
            np.testing.assert_allclose(c[key].numpy(), _np(rcache[key][i]), **TOL)


@pytest.mark.parametrize("T", [1, 3])
def test_contiguous_decode_step_matches_reference(T):
    """Two steps of T tokens (T 3: the reference's multi-token decode shape)
    after the prefill: logits and every cache leaf."""
    rcfg, cfg = _cfgs()
    rparams, params, _, rcache, _, cache = _prefilled()
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, B, T)).astype(np.int32)
    for j in range(2):
        pos = np.full((B,), S + j * T, np.int32)
        rl, rcache = RE.decode_step(rcfg, rparams, rcache, jnp.asarray(toks[j]), jnp.asarray(pos))
        lg, cache = E.decode_step(cfg, params, cache, torch.from_numpy(toks[j]),
                                  torch.from_numpy(pos))
        assert tuple(lg.shape) == (B, T, cfg.vocab)
        np.testing.assert_allclose(lg.numpy(), _np(rl), **TOL)
    for i, c in enumerate(cache["layers"]):
        for key in ("k", "v", "xk", "xv"):
            np.testing.assert_allclose(c[key].numpy(), _np(rcache[key][i]), **TOL)


def test_multitoken_step_equals_sequential_steps():
    """T 3 in one step equals three single steps (the reference's
    ``test_encdec_multitoken_decode_step``, in the port)."""
    _, cfg = _cfgs()
    _, params, _, _, _, cache0 = _prefilled()
    chain = torch.tensor([[5, 7, 123]] * B)
    pos0 = torch.full((B,), S, dtype=torch.int32)
    seq = {"layers": [{k: t.clone() for k, t in c.items()} for c in cache0["layers"]]}
    one = [E.decode_step(cfg, params, seq, chain[:, t:t + 1], pos0 + t)[0][:, 0] for t in range(3)]
    multi, _ = E.decode_step(cfg, params, cache0, chain, pos0)
    for t in range(3):
        np.testing.assert_allclose(multi[:, t].numpy(), one[t].numpy(), rtol=2e-5, atol=2e-5)


def _paged_pair(ps: int = 4, seed: int = 8):
    """The same paged cache in both packages: random self-attention and
    frame pools, scrambled tables (16 frames over 4 pages of 4; 8 decode
    pages a sequence)."""
    rcfg, cfg = _cfgs()
    r = np.random.default_rng(seed)
    P, Px = LENGTH // ps, -(-cfg.n_frames // ps)
    num_pages = 1 + B * (P + Px)
    shape = (cfg.n_layers, num_pages, ps, cfg.n_kv_heads, cfg.hd)
    pools = {n: r.normal(size=shape).astype(np.float32) for n in ("k", "v", "xk", "xv")}
    perm = 1 + r.permutation(num_pages - 1)
    table = perm[:B * P].reshape(B, P).astype(np.int32)
    xtable = perm[B * P:].reshape(B, Px).astype(np.int32)
    rcache = {"dec": {"k_pages": jnp.asarray(pools["k"]), "v_pages": jnp.asarray(pools["v"])},
              "x": {"k_pages": jnp.asarray(pools["xk"]), "v_pages": jnp.asarray(pools["xv"])},
              "page_table": jnp.asarray(table), "xpage_table": jnp.asarray(xtable)}
    cache = E.init_cache(cfg, B, LENGTH, torch.float32, page_size=ps, num_pages=num_pages)
    for i in range(cfg.n_layers):
        for (grp, pk), name in (((("layers", "k_pages")), "k"), (("layers", "v_pages"), "v"),
                                (("x", "k_pages"), "xk"), (("x", "v_pages"), "xv")):
            cache[grp][i][pk].copy_(torch.from_numpy(pools[name][i]))
    cache["page_table"].copy_(torch.from_numpy(table))
    cache["xpage_table"].copy_(torch.from_numpy(xtable))
    return rcfg, cfg, rcache, cache


@pytest.mark.parametrize("T", [1, 3])
def test_paged_decode_step_matches_reference(T):
    """Decode through the page table and the frame table (page size 4, so
    positions straddle pages); logits and the self-attention pools after
    the step, and the frame pools untouched."""
    rcfg, cfg, rcache, cache = _paged_pair()
    _, rparams, _ = X.ref_model(ARCH)
    params = E.unstack(cfg, X.port_params(ARCH))
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (B, T)).astype(np.int32)
    pos = np.asarray([5, 14], np.int32)
    xk0 = [c["k_pages"].clone() for c in cache["x"]]
    rl, rcache = RE.decode_step(rcfg, rparams, rcache, jnp.asarray(toks), jnp.asarray(pos))
    lg, cache = E.decode_step(cfg, params, cache, torch.from_numpy(toks), torch.from_numpy(pos))
    np.testing.assert_allclose(lg.numpy(), _np(rl), **TOL)
    for i in range(cfg.n_layers):
        for pk in ("k_pages", "v_pages"):
            np.testing.assert_allclose(cache["layers"][i][pk].numpy(), _np(rcache["dec"][pk][i]),
                                       **TOL)
        assert torch.equal(cache["x"][i]["k_pages"], xk0[i])


def test_paged_cache_layout():
    _, cfg = _cfgs()
    c = E.init_cache(cfg, 3, 40, torch.float32, kv_dtype=torch.int8, page_size=16, num_pages=9)
    assert tuple(c["page_table"].shape) == (3, 3) and tuple(c["xpage_table"].shape) == (3, 1)
    assert len(c["layers"]) == len(c["x"]) == cfg.n_layers
    assert c["layers"][0]["k_pages"].dtype == torch.float32  # kv_dtype is ignored
    assert set(c["x"][0]) == {"k_pages", "v_pages"}


# ---------------------------------------------------------------------------
# the two attention calls of the family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,G", [(1, 1), (3, 1), (1, 2)])
def test_b3_noncausal_plain_matches_reference_cross_kernel(T, G):
    """B3's plain version with ``causal=False`` over 40 frames in pages of
    16 (the last page holds 8 frames and a stale tail), pos = 39, against
    the reference's ``ops.cross_decode_attention`` (its Pallas paged kernel
    over an identity table, interpret mode), hd 64."""
    r = np.random.default_rng(T + G)
    Bq, KVH, hd, Sf, ps = 2, 2, 64, 40, 16
    q = r.normal(size=(Bq, T, KVH * G, hd)).astype(np.float32)
    k = r.normal(size=(Bq, Sf, KVH, hd)).astype(np.float32)
    v = r.normal(size=(Bq, Sf, KVH, hd)).astype(np.float32)
    want = rops.cross_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       interpret=True)
    P = -(-Sf // ps)
    table = (1 + r.permutation(Bq * P)).reshape(Bq, P).astype(np.int32)
    kp = r.normal(size=(1 + Bq * P, ps, KVH, hd)).astype(np.float32)  # stale everywhere
    vp = r.normal(size=kp.shape).astype(np.float32)
    for b in range(Bq):
        for f in range(Sf):
            kp[table[b, f // ps], f % ps] = k[b, f]
            vp[table[b, f // ps], f % ps] = v[b, f]
    t = torch.from_numpy
    pos = torch.full((Bq,), Sf - 1, dtype=torch.int32)
    n = FA.paged_decode_attention.launches
    got = FA.paged_decode_attention(t(q), t(kp), t(vp), t(table), pos, causal=False)
    assert FA.paged_decode_attention.launches == n  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=2e-5)
    # the contiguous dispatch (identity table of its own) computes the same
    got2 = L.cross_decode_attention(t(q), t(k), t(v))
    np.testing.assert_allclose(got2.numpy(), _np(want), rtol=2e-5, atol=2e-5)


def test_b6_noncausal_plain_matches_reference_flash_at_40_by_1100():
    """The prefill's cross-attention shape: 40 queries against 1100 keys
    (ragged against 128-key chunks), non-causal, against the reference's
    pure-JAX ``layers.flash_attention`` (what its prefill runs)."""
    r = np.random.default_rng(11)
    q = r.normal(size=(1, 40, 6, 64)).astype(np.float32)
    k = r.normal(size=(1, 1100, 6, 64)).astype(np.float32)
    v = r.normal(size=(1, 1100, 6, 64)).astype(np.float32)
    want = RL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False, None, 0,
                              0.0, 128, 512)
    got = FA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=False)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("Sq,Sk", [(32, 96), (64, 128)])
def test_b6_noncausal_plain_matches_pallas_at_block_multiples(Sq, Sk):
    """Non-causal, Sq != Sk, against the Pallas kernel in interpret mode
    only at block multiples: the reference's wrapper pads a ragged Sk and
    masks the padding only causally (ROADMAP C1b)."""
    r = np.random.default_rng(Sq + Sk)
    q = r.normal(size=(1, Sq, 4, 64)).astype(np.float32)
    k = r.normal(size=(1, Sk, 2, 64)).astype(np.float32)
    v = r.normal(size=(1, Sk, 2, 64)).astype(np.float32)
    want = rops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                                block_q=32, block_k=32, interpret=True)
    got = FA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=False)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=5e-5)


def test_params_from_reference_compressed_tree_serves_the_encoder():
    """A quant_sparse plan of the reference converts leaf for leaf: packed
    enc/dec projections, dense pos_dec and norms."""
    _, cfg = _cfgs()
    _, _, rplan = X.ref_model(ARCH, "quant_sparse")
    plan = interop.plan_from_reference(rplan)
    kinds = {p: type(n).__name__ for p, n in plan._by_path.items()}
    assert kinds["enc/attn/wq"] == kinds["dec/xattn/wk"] == "PackedLinear"
    assert kinds["pos_dec"] == "Tensor" and kinds["enc_norm/bias"] == "Tensor"
    assert set(rplan.leaves) == set(plan.leaves)


@pytest.mark.parametrize("arch", X.ARCHS)
def test_port_plan_cache_round_trip(arch, tmp_path):
    """The port packs the enc-dec and VLM trees itself (``compress``: the
    enc/dec stacks, ``proj/w``; ``pos_dec`` and the norms dense), saves the
    plan and loads it back leaf for leaf."""
    cfg = get_config(arch, smoke=True)
    dense = get_api(cfg).init_params(cfg, 0, device="cpu")
    plan = TW.compress(dense, TW.PlanConfig(**X.PLAN))
    packed = {p for p, n in plan._by_path.items() if isinstance(n, TW.PackedLinear)}
    assert ("enc/mlp/w_up" in packed) == (arch == X.WHISPER)
    assert ("proj/w" in packed) == (arch == X.INTERNVL)
    TW.save_plan(str(tmp_path), plan)
    back = TW.load_plan(str(tmp_path), dense)
    assert back.cfg == plan.cfg
    for a, b in zip(TW.flatten_leaves(back.params), TW.flatten_leaves(plan.params)):
        assert torch.equal(a, b)
