"""The port's training step against the reference's, for the four dense
archs at smoke size (fp32 compute): the loss and every gradient leaf
against ``jax.value_and_grad`` of the reference's ``loss_fn``, the params
after three ``make_train_step`` steps (the reference's under ``jax.jit``,
no mesh), gradient accumulation, both compression codecs, remat, the
flash-attention backward past ``dense_threshold`` against the reference's
custom VJP, and the synthetic data.  The reference's params are carried
into the port through ``interop``; leaves compare in the reference's
flatten order.

Tolerances: the loss to 1e-5 relative; a gradient leaf to 1e-4 of its
max |g| (fp32 sums in another order); params after the steps to 1e-4
absolute, a tenth of lr = 1e-3: AdamW divides each element's moment by
its own root-mean-square, so an element whose gradient is near zero moves
by an amount its roundoff sets (up to 1.5e-5 seen), while a wrong update
moves it by about lr."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import LMDataConfig as RLMDataConfig
from repro.data import synthetic_lm_batch as ref_lm_batch
from repro.models import layers as RL
from repro.models.api import get_api as ref_get_api
from repro.training import optimizer as RO
from repro.training.trainer import make_train_step as ref_make_train_step

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core.weight_plan import flatten_leaves
from repro_torch.data import LMDataConfig, synthetic_lm_batch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.api import get_api
from repro_torch.training import optimizer as O
from repro_torch.training.trainer import make_eval_step, make_train_step

from _torch_train import one_thread  # noqa: F401  (the fixture)

# torch on one thread: under the suite's workers a full pool per test crawls
pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = ["tinyllama-1.1b", "llama3.2-1b", "glm4-9b", "gemma3-4b"]
OPT = dict(lr=1e-3, grad_clip=1.0, warmup_steps=0, decay_steps=10**9, min_lr_ratio=1.0)
PARAM_ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _ref(arch: str):
    cfg = ref_get_config(arch, smoke=True)
    params = ref_get_api(cfg).init_params(cfg, jax.random.key(0))
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def _port_params(arch: str):
    return interop.params_from_reference(_ref(arch)[1])


def _batch(arch: str, B: int = 4, S: int = 16, step: int = 0) -> dict:
    cfg = get_config(arch, smoke=True)
    return synthetic_lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B), step)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_grads(cfg, params, batch):
    for p in flatten_leaves(params):
        p.requires_grad_(True)
    loss, metrics = T.loss_fn(cfg, params, _t(batch))
    return loss.detach(), metrics, torch.autograd.grad(loss, flatten_leaves(params))


def _assert_grads(got, want, rel=1e-4):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"leaf {i}")


def _assert_params(port, ref, atol=PARAM_ATOL):
    got, want = flatten_leaves(port), jax.tree_util.tree_leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=atol)


def _ref_steps(arch, n, **kw):
    cfg, params = _ref(arch)
    oc = RO.OptimizerConfig(**OPT)
    step = jax.jit(ref_make_train_step(cfg, ref_get_api(cfg).loss_fn, oc, **kw))
    opt = RO.init_opt_state(oc, params, error_feedback=kw.get("compression") is not None)
    losses = []
    for s in range(n):
        params, opt, m = step(params, opt, _j(_batch(arch, step=s)))
        losses.append(float(m["loss"]))
    return params, losses


def _port_steps(arch, n, cfg=None, **kw):
    cfg = cfg or get_config(arch, smoke=True)
    params = _port_params(arch)
    oc = O.OptimizerConfig(**OPT)
    step = make_train_step(cfg, get_api(cfg).loss_fn, oc, **kw)
    opt = O.init_opt_state(oc, params, error_feedback=kw.get("compression") is not None)
    losses = []
    for s in range(n):
        params, opt, m = step(params, opt, _t(_batch(arch, step=s)))
        losses.append(float(m["loss"]))
    return params, losses


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match(arch):
    rcfg, rparams = _ref(arch)
    batch = _batch(arch)
    (rloss, rm), rgrads = jax.value_and_grad(
        lambda p: ref_get_api(rcfg).loss_fn(rcfg, p, _j(batch)), has_aux=True)(rparams)
    loss, m, grads = _port_grads(get_config(arch, smoke=True), _port_params(arch), batch)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    assert float(m["loss"].detach()) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(m["aux"]) == float(rm["aux"]) == 0.0
    _assert_grads(grads, jax.tree_util.tree_leaves(rgrads))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_after_three_steps_match(arch):
    rparams, rlosses = _ref_steps(arch, 3)
    params, losses = _port_steps(arch, 3)
    np.testing.assert_allclose(losses, rlosses, rtol=1e-5)
    _assert_params(params, rparams)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compressed_steps_match(arch, kind):
    """Two compressed steps.  A codec is discontinuous: a gradient element
    within roundoff of a rounding edge (int8) or of the top-k threshold
    takes the other code in one package, and its AdamW update differs by up
    to a few lr.  So at most 0.1% of the elements may differ by more than
    PARAM_ATOL, and none by more than 10 lr; the codecs themselves are held
    bit for bit on equal inputs in test_torch_optimizer.py."""
    rparams, rlosses = _ref_steps(arch, 2, compression=kind)
    params, losses = _port_steps(arch, 2, compression=kind)
    np.testing.assert_allclose(losses, rlosses, rtol=1e-5)
    got = np.concatenate([t.detach().numpy().ravel() for t in flatten_leaves(params)])
    want = np.concatenate([np.asarray(w).ravel() for w in jax.tree_util.tree_leaves(rparams)])
    d = np.abs(got - want)
    assert (d > PARAM_ATOL).mean() <= 1e-3 and d.max() <= 10 * OPT["lr"], \
        ((d > PARAM_ATOL).sum(), d.max())


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_accum_equivalent(arch):
    """accum 4 over the batch of 4 equals one step over it, as the
    reference's test holds (5e-5: sums in another order)."""
    p1, l1 = _port_steps(arch, 2)
    p4, l4 = _port_steps(arch, 2, accum_steps=4)
    np.testing.assert_allclose(l4, l1, rtol=1e-5)
    _assert_params(p4, jax.tree_util.tree_map(lambda t: t.detach().numpy(), p1), atol=5e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch):
    cfg = get_config(arch, smoke=True)
    batch = _batch(arch)
    _, _, want = _port_grads(cfg, _port_params(arch), batch)
    loss_r, _, got = _port_grads(dataclasses.replace(cfg, remat=True), _port_params(arch), batch)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    p, l = _port_steps(arch, 2, cfg=dataclasses.replace(cfg, remat=True))
    q, m = _port_steps(arch, 2)
    assert l == m
    for a, b in zip(flatten_leaves(p), flatten_leaves(q)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_step_and_data(arch):
    """``make_eval_step`` gives the loss without gradients; the synthetic
    batches equal the reference's element for element."""
    cfg = get_config(arch, smoke=True)
    for step in (0, 3):
        got = _batch(arch, B=3, S=9, step=step)
        want = ref_lm_batch(RLMDataConfig(vocab=cfg.vocab, seq_len=9, global_batch=3), step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    m = make_eval_step(cfg, T.loss_fn)(_port_params(arch), _t(_batch(arch)))
    assert not m["loss"].requires_grad and np.isfinite(float(m["loss"]))


# --- the flash-attention backward past dense_threshold ---------------------

S_LONG = 1100  # past the 1024-token dense threshold: chunks of 512, a short last one


@pytest.mark.parametrize("window,softcap", [(None, 0.0), (300, 0.0), (None, 30.0),
                                            (300, 5.0)])
def test_flash_function_grads_match_reference_vjp(window, softcap):
    """dq, dk, dv of ``FlashAttention`` (through ``train_attention``'s
    dispatch) against the reference's custom VJP at the chunks its
    ``attention`` picks, causal, under a window (gemma3's local layers) and
    with a softcap; to 1e-4 of each gradient's max, fp32."""
    r = np.random.default_rng(11)
    B, H, KVH, hd = 1, 4, 2, 16
    q, k, v, do = (r.normal(size=s).astype(np.float32)
                   for s in ((B, S_LONG, H, hd), (B, S_LONG, KVH, hd), (B, S_LONG, KVH, hd),
                             (B, S_LONG, H, hd)))
    ref_o, vjp = jax.vjp(lambda a, b, c: RL.flash_attention(a, b, c, True, window, 0, softcap,
                                                            512, 512),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    f0, b0 = L.FlashAttention.forward_calls, L.FlashAttention.backward_calls
    o = L.train_attention(tq, tk, tv, causal=True, window=window, softcap=softcap)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    assert (L.FlashAttention.forward_calls - f0, L.FlashAttention.backward_calls - b0) == (1, 1)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref_o), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(ref_o)).max())
    _assert_grads(got, want)


def test_train_attention_dense_below_threshold_matches_reference():
    """At or below 1024 tokens the training path is dense attention under
    autograd, as the reference's dispatch is."""
    r = np.random.default_rng(12)
    q, k, v, do = (r.normal(size=s).astype(np.float32)
                   for s in ((2, 40, 4, 8), (2, 40, 2, 8), (2, 40, 2, 8), (2, 40, 4, 8)))
    _, vjp = jax.vjp(lambda a, b, c: RL.attention(a, b, c, causal=True, window=7),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    f0 = L.FlashAttention.forward_calls
    o = L.train_attention(tq, tk, tv, causal=True, window=7)
    _assert_grads(torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do)),
                  vjp(jnp.asarray(do)))
    assert L.FlashAttention.forward_calls == f0


def test_long_sequence_train_step_matches():
    """A tinyllama smoke step at 1100 tokens (every layer through the flash
    Function): loss and gradients against the reference's."""
    arch = "tinyllama-1.1b"
    rcfg, rparams = _ref(arch)
    batch = _batch(arch, B=1, S=S_LONG)
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: ref_get_api(rcfg).loss_fn(rcfg, p, _j(batch)), has_aux=True)(rparams)
    cfg = get_config(arch, smoke=True)
    f0, b0 = L.FlashAttention.forward_calls, L.FlashAttention.backward_calls
    loss, _, grads = _port_grads(cfg, _port_params(arch), batch)
    assert (L.FlashAttention.forward_calls - f0,
            L.FlashAttention.backward_calls - b0) == (cfg.n_layers, cfg.n_layers)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    _assert_grads(grads, jax.tree_util.tree_leaves(rgrads))


# --- refusals ---------------------------------------------------------------

def test_compressed_or_unstacked_tree_refused():
    from repro_torch.core.weight_plan import PlanConfig, compress

    cfg = get_config("tinyllama-1.1b", smoke=True)
    params = _port_params("tinyllama-1.1b")
    batch = _t(_batch("tinyllama-1.1b"))
    plan = compress(params, PlanConfig(default="quant", min_size=0, min_contract=0))
    with pytest.raises(ValueError, match="dense weights"):
        T.loss_fn(cfg, plan.params, batch)
    with pytest.raises(ValueError, match="stacked params tree"):
        T.loss_fn(cfg, T.unstack(cfg, params), batch)
