"""PyTorch port vs the JAX reference for the RG-LRU block
(``repro_torch/models/recurrent.py``) and for the two recurrent families at
model level: recurrentgemma-2b (RG-LRU ``rec`` layers and windowed
``local`` attention, 2:1) and xlstm-350m (``mlstm`` / ``slstm`` cells),
smoke configs, fp32, the reference's own params carried across by
``interop``.

Tolerance: the port's log-depth scan is held to the reference's
``jax.lax.associative_scan`` at rtol 1e-5 / atol 1e-5 (both reassociate
the fp32 recurrence, in different trees); logits at rtol 1e-4 / atol
1e-4 (fp32 sums in another order over 4-5 layers).  Also: the cache's
dtypes under ``kv_dtype=int8`` (states keep the compute dtype, only
attention KV goes int8), ``state_bytes_per_step`` / ``kv_bytes_per_token``
and the cache capability probes for every arch of both registries, the
param trees, and the representation ``compress`` gives every leaf at smoke
and full width."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as F
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.core import weight_plan as RW
from repro.models import api as RA
from repro.models import recurrent as RR
from repro.models import transformer as RT

from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import weight_plan as TW
from repro_torch.models import api as A
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_LOGITS = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["recurrentgemma-2b", "xlstm-350m"]
RG = "recurrentgemma-2b"


def _rglru(seed: int = 0):
    rcfg, cfg = ref_get_config(RG, smoke=True), get_config(RG, smoke=True)
    rp = jax.tree_util.tree_map(np.asarray, RR.init_rglru(rcfg, jax.random.key(seed)))
    return rcfg, cfg, rp, interop.params_from_reference(rp)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S_len", [1, 2, 13, 100])
def test_apply_rglru_matches_reference_from_a_carried_state(S_len):
    """S 1 is the fused decode step, S > 1 the parallel scan; both start
    from a non-zero state (h and the conv's last inputs)."""
    rcfg, cfg, rp, tp = _rglru()
    rng = np.random.default_rng(S_len)
    x = rng.standard_normal((2, S_len, cfg.d_model)).astype(np.float32)
    w = cfg.lru_dim
    st = {"h": rng.standard_normal((2, w)).astype(np.float32),
          "conv": rng.standard_normal((2, cfg.conv_width - 1, w)).astype(np.float32)}
    ry, rst = RR.apply_rglru(rcfg, rp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    y, tst = R.apply_rglru(cfg, tp, torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in st.items()})
    _close(y, ry)
    for k in rst:
        _close(tst[k], rst[k])


@pytest.mark.parametrize("S_len", [1, 5, 16, 33])
def test_linear_scan_equals_the_sequential_recurrence(S_len):
    g = torch.Generator().manual_seed(S_len)
    a = torch.rand((3, S_len, 7), generator=g)
    b = torch.randn((3, S_len, 7), generator=g)
    h0 = torch.randn((3, 7), generator=g)
    want, h = [], h0
    for t in range(S_len):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(R.linear_scan(a, b, h0), torch.stack(want, dim=1), **TOL)


def test_rglru_prefill_then_decode_equals_longer_prefill():
    rcfg, cfg, rp, tp = _rglru(seed=3)
    x = np.random.default_rng(9).standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    for apply, wrap in ((RR.apply_rglru, jnp.asarray), (R.apply_rglru, torch.from_numpy)):
        c, p = (rcfg, rp) if apply is RR.apply_rglru else (cfg, tp)
        y_all, _ = apply(c, p, wrap(x))
        _, st = apply(c, p, wrap(x[:, :9]))
        y1, _ = apply(c, p, wrap(x[:, 9:]), st)
        np.testing.assert_allclose(np.asarray(y1)[:, 0], np.asarray(y_all)[:, -1], **TOL)


def test_lambda_init_puts_the_decay_in_range():
    """a = exp(-c softplus(lam)) lies in (0.9, 0.999), as the reference's
    init makes it."""
    cfg = get_config(RG)
    lam = T.init_params(get_config(RG, smoke=True), 0, device="cpu")["unit"][0]["rec"]["lam"]
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
    assert float(a.min()) > 0.9 - 1e-6 and float(a.max()) < 0.999 + 1e-6
    assert R.rglru_shapes(cfg)["w_x"][0] == (2560, 2560)


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_trees_match_reference(arch):
    for smoke in (False, True):
        assert get_config(arch, smoke).__dict__ == ref_get_config(arch, smoke).__dict__
    rcfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
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
    full = get_config(arch)
    assert T.n_params_exact(full) == RT.n_params_exact(ref_get_config(arch))
    assert T.find_unit(full.layer_kinds) == RT.find_unit(full.layer_kinds)
    T.check_supported(full)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv", [None, "int8"])
def test_prefill_then_decode_logits_match_reference(arch, kv):
    """A prefill of 10 tokens, then a decode step of T = 1 and one of T = 3
    (recurrentgemma's windowed rings of 8 wrap), against the reference."""
    rcfg, rp, _ = F.ref_model(arch)
    cfg = get_config(arch, smoke=True)
    view = T.unstack(cfg, F.port_params(arch))
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    S_len = 10
    rc = RT.init_cache(rcfg, 2, 32, jnp.float32, kv_dtype=jnp.int8 if kv else None)
    c = T.init_cache(cfg, 2, 32, torch.float32, kv_dtype=torch.int8 if kv else None,
                     device="cpu")
    rl, rc = RT.prefill(rcfg, rp, jnp.asarray(toks[:, :S_len]), rc)
    lg, c = T.prefill(cfg, view, torch.from_numpy(toks[:, :S_len]), c)
    tol = TOL_LOGITS if kv is None else F.TOL_INT8
    _close(lg, rl, tol)
    pos = S_len
    for T_len in (1, 3):
        t = toks[:, pos:pos + T_len]
        rl, rc = RT.decode_step(rcfg, rp, rc, jnp.asarray(t), jnp.full((2,), pos, jnp.int32))
        lg, c = T.decode_step(cfg, view, c, torch.from_numpy(t),
                              torch.full((2,), pos, dtype=torch.int32))
        _close(lg, rl, tol)
        pos += T_len


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_longer_prefill_at_model_level(arch):
    cfg = get_config(arch, smoke=True)
    view = T.unstack(cfg, F.port_params(arch))
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, (2, 9))
                            .astype(np.int32))
    full, _ = T.prefill(cfg, view, toks, T.init_cache(cfg, 2, 16, torch.float32, device="cpu"))
    c = T.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    _, c = T.prefill(cfg, view, toks[:, :8], c)
    step, _ = T.decode_step(cfg, view, c, toks[:, 8:], torch.full((2,), 8, dtype=torch.int32))
    torch.testing.assert_close(step[:, -1], full[:, -1], **TOL_LOGITS)


@pytest.mark.parametrize("arch", ARCHS)
def test_states_keep_the_compute_dtype_under_int8_kv(arch):
    """kv_dtype reaches attention caches only: recurrentgemma's local rings
    go int8, every RG-LRU / xLSTM state keeps fp32 (h, C, n, m, c) or the
    compute dtype (conv), leaf for leaf as the reference's cache."""
    for smoke, dt, rdt in ((True, torch.float32, jnp.float32),
                           (False, torch.bfloat16, jnp.bfloat16)):
        cfg, rcfg = get_config(arch, smoke), ref_get_config(arch, smoke)
        c = T.init_cache(cfg, 2, 16, dt, kv_dtype=torch.int8, device="meta")
        rc = jax.eval_shape(lambda: RT.init_cache(rcfg, 2, 16, rdt, kv_dtype=jnp.int8))
        unit, n_units, rem = T.find_unit(cfg.layer_kinds)
        ref_layers = [jax.tree_util.tree_map(lambda x: x, rc["unit"][pi]) for _ in range(n_units)
                      for pi in range(len(unit))]
        ref_layers += [rc["rem"][ri] for ri, (_, n) in enumerate(T.rem_runs(rem))
                       for _ in range(n)]
        for kind, mine, ref in zip(cfg.layer_kinds, c["layers"], ref_layers):
            assert set(mine) == set(ref), kind
            for k, v in mine.items():
                assert str(v.dtype).split(".")[-1] == str(ref[k].dtype), (kind, k)
                assert tuple(v.shape) == ref[k].shape[1:], (kind, k)
                if kind != "local":
                    assert v.dtype != torch.int8
                    assert v.dtype == (dt if k == "conv" else torch.float32), (kind, k)


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_state_bytes_and_kv_rate_match_reference(arch):
    """Every arch of both registries, smoke and full width: the
    non-positional state a step reads, the KV rate at no context, at 128
    and past a window, fp and int8, and the cache capability probes."""
    assert arch in ARCH_IDS
    for smoke in (True, False):
        cfg, rcfg = get_config(arch, smoke), ref_get_config(arch, smoke)
        assert A.state_bytes_per_step(cfg) == RA.state_bytes_per_step(rcfg)
        for kv, rkv in ((None, None), ("int8", jnp.int8)):
            for ctx in (None, 128, 5000):
                assert A.kv_bytes_per_token(cfg, kv, ctx) == pytest.approx(
                    RA.kv_bytes_per_token(rcfg, rkv, ctx), rel=1e-12), (kv, ctx)
        assert A.supports_int8_kv(cfg) == RA.supports_int8_kv(rcfg)
        assert A.supports_paged_kv(cfg) == RA.supports_paged_kv(rcfg)
        assert A.supports_spec_decode(cfg) == RA.supports_spec_decode(rcfg)
    if arch == "xlstm-350m":
        # the mLSTM's C alone: 12 layers x 4 heads x 512 x 512 fp32 a sequence
        assert A.state_bytes_per_step(get_config(arch)) > 12 * 4 * 512 * 512 * 4


# ---------------------------------------------------------------------------
# the plan: each leaf's representation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("min_size", [16384, 256])
def test_plan_representations_match_reference(arch, min_size):
    """compress over the same params at blocks of 16: every leaf's
    representation and statistics equal the reference's, and the packed
    payloads too."""
    rcfg, rp, _ = F.ref_model(arch)
    kw = dict(default="quant_sparse", q_prune=0.5, bk=16, bn=16, min_size=min_size,
              min_contract=16)
    rplan = RW.compress(rp, RW.PlanConfig(**kw))
    plan = TW.compress(F.port_params(arch), TW.PlanConfig(**kw))
    assert set(plan.leaves) == set(rplan.leaves)
    for path, rl in rplan.leaves.items():
        l = plan.leaves[path]
        assert (l.kind, l.shape, l.n_weights, l.surviving) == \
            (rl.kind, tuple(rl.shape), rl.n_weights, rl.surviving), path
    ported = interop.plan_from_reference(rplan)
    for a, b in zip(TW.flatten_leaves(plan.params), TW.flatten_leaves(ported.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_representations_match_reference(arch):
    """At full width and blocks of 128, ``assign_leaf`` on every stacked
    leaf (shapes only): conv, lam, s_*, b_*, r_gates and the RG-LRU's
    w_rgate / w_igate (contraction over the stack axis) stay dense;
    xLSTM's w_if (N 8), slstm w_up / w_down (2730 / 1365) and the head go
    int8 (kernel B5); the 128-aligned projections quant_sparse."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    pc, rpc = TW.PlanConfig(q_prune=0.5), RW.PlanConfig(q_prune=0.5)
    ref = jax.eval_shape(lambda: RT.init_params(rcfg, jax.random.key(0)))
    shapes = T.param_shapes(cfg)
    kinds = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        node = shapes
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        p = "/".join(str(k.key if hasattr(k, "key") else k.idx) for k in path)
        mine = TW.assign_leaf(p, torch.empty(node[0], device="meta"), pc)
        assert mine == RW.assign_leaf(path, leaf, rpc), p
        kinds[p] = mine[0]
    if arch == "xlstm-350m":
        assert kinds["unit/0/cell/w_if"] == kinds["unit/1/cell/w_up"] == "quant"
        assert kinds["unit/1/cell/w_down"] == kinds["embed/head"] == "quant"
        assert kinds["unit/0/cell/w_u"] == kinds["unit/1/cell/w_gates"] == "quant_sparse"
        assert kinds["unit/1/cell/r_gates"] == kinds["unit/0/cell/conv"] == "dense"
    else:
        assert kinds["unit/0/rec/w_rgate"] == kinds["rem/0/rec/w_igate"] == "dense"
        assert kinds["unit/0/rec/w_x"] == kinds["unit/2/attn/wk"] == "quant_sparse"
        assert kinds["unit/0/mlp/w_gate"] == kinds["unit/0/mlp/w_down"] == "quant_sparse"
        assert kinds["embed/tok"] == "quant"
