"""Logit softcaps (gemma2-style: cap * tanh(s / cap) on the attention
scores and on the final logits) on the port against the reference, at the
smoke configs of tinyllama-1.1b, gemma3-4b (windowed and global layers)
and whisper-tiny with ``logit_softcap`` set on both sides -- no config of
either registry sets it.  Cap 30 (the issue's) barely bends smoke scores;
cap 2 bends them visibly (logits, and streams and gradients of one arch
each), and the capped logits must differ from the uncapped ones there.

- prefill and decode logits at fp32 tolerance;
- greedy streams through both engines equal;
- the training loss and gradients at the training tests' tolerances;
- an 1100-token prompt on the flash path (past the 1024-token dense
  threshold): B6's plain version on the CPU against the reference's jnp
  flash;
- B6's plain version at cap 30 against the reference's jnp
  ``flash_attention`` and ``dense_attention``, causal and windowed.

The card's check of B6 and B3 at cap 30 is tests/test_torch_softcap_gpu.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models.api import get_api as ref_get_api
from repro.serving import config as RC
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import transformer as T
from repro_torch.models.api import get_api
from repro_torch.serving import config as PC
from repro_torch.serving.engine import Request, RequestState, ServingEngine

import _torch_train as TT
from _torch_train import one_thread  # noqa: F401  (the fixture)

ARCHS = ["tinyllama-1.1b", "gemma3-4b", "whisper-tiny"]
CAPS = [30.0, 2.0]
TOL = dict(rtol=1e-4, atol=1e-4)
B, LENGTH = 2, 48


@functools.lru_cache(maxsize=None)
def _models(arch: str, cap: float):
    """(reference cfg, its params, port cfg, port params) of the capped
    smoke config; the port's params carried over by ``interop``."""
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True), logit_softcap=cap)
    cfg = dataclasses.replace(get_config(arch, smoke=True), logit_softcap=cap)
    rparams = ref_get_api(rcfg).init_params(rcfg, jax.random.key(0))
    tparams = interop.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams))
    return rcfg, rparams, cfg, tparams


def _batch(cfg, tokens: np.ndarray, seed: int = 5) -> dict:
    """The prompt batch with the family's frames (whisper), numpy."""
    out = {"tokens": tokens}
    if get_api(cfg).extra_keys:
        r = np.random.default_rng(seed)
        out["frames"] = r.normal(size=(tokens.shape[0], cfg.n_frames, cfg.d_model)) \
            .astype(np.float32)
    return out


def _prefill_and_decode(arch: str, cap: float, S: int, length: int, steps: int = 4) -> list:
    """Prefill B prompts of S tokens, then ``steps`` decode steps, in both
    packages; returns [(port logits, reference logits)] per call."""
    rcfg, rparams, cfg, tparams = _models(arch, cap)
    rapi, api = ref_get_api(rcfg), get_api(cfg)
    r = np.random.default_rng(S)
    batch = _batch(cfg, r.integers(0, 256, (B, S)).astype(np.int32))
    rcache = rapi.init_cache(rcfg, B, length, jnp.float32)
    tcache = api.init_cache(cfg, B, length, torch.float32)
    rl, rcache = jax.jit(functools.partial(rapi.prefill, rcfg))(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()}, rcache)
    view = api.unstack(cfg, tparams)
    tl, tcache = api.prefill(cfg, view, {k: torch.from_numpy(v) for k, v in batch.items()},
                             tcache)
    out = [(tl, rl)]
    pos = np.full((B,), S, np.int32)
    rdecode = jax.jit(functools.partial(rapi.decode_step, rcfg))
    for _ in range(steps):
        toks = r.integers(0, 256, (B, 1)).astype(np.int32)
        rl, rcache = rdecode(rparams, rcache, jnp.asarray(toks), jnp.asarray(pos))
        tl, tcache = api.decode_step(cfg, view, tcache, torch.from_numpy(toks),
                                     torch.from_numpy(pos))
        out.append((tl, rl))
        pos = pos + 1
    return out


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_capped_prefill_and_decode_logits_match_reference(arch, cap):
    out = _prefill_and_decode(arch, cap, S=20, length=LENGTH)
    for tl, rl in out:
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
    if cap == 2.0:  # the cap bends these logits: uncapped ones differ
        tl = out[0][0]
        (ul, _), = _prefill_and_decode(arch, 0.0, S=20, length=LENGTH, steps=0)
        assert float((tl - ul).abs().max()) > 1e-3
        assert float(tl.abs().max()) <= cap


def test_flash_path_1100_token_prompt_capped():
    """gemma3's 1100-token prefill runs past the dense threshold: the plain
    chunked flash on the CPU, windowed and global layers, capped."""
    (tl, rl), = _prefill_and_decode("gemma3-4b", 2.0, S=1100, length=1104, steps=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)


def _engines(arch: str, cap: float):
    rcfg, rparams, cfg, tparams = _models(arch, cap)
    flat = {} if arch == "whisper-tiny" else dict(kv_dtype="int8", page_size=16,
                                                   share_prefix=True)
    ref = RServingEngine(rcfg, rparams, config=RC.EngineConfig.of(max_len=64, max_batch=4,
                                                                  **flat))
    eng = ServingEngine(cfg, tparams, device="cpu",
                        config=PC.EngineConfig.of(max_len=64, max_batch=4, **flat))
    return ref, eng


@pytest.mark.parametrize("arch,cap", [(a, 30.0) for a in ARCHS] + [("tinyllama-1.1b", 2.0)])
def test_capped_greedy_streams_match_reference_engine(arch, cap):
    ref, eng = _engines(arch, cap)
    r = np.random.default_rng(11)
    prefix = r.integers(0, 256, 20).astype(np.int32)
    prompts = [prefix, np.concatenate([prefix, r.integers(0, 256, 5).astype(np.int32)]),
               r.integers(0, 256, 13).astype(np.int32)]
    cfg = _models(arch, cap)[2]
    ex = [{k: v[0] for k, v in _batch(cfg, p[None], seed=i).items() if k != "tokens"}
          for i, p in enumerate(prompts)]
    rreqs = [RRequest(uid=i, prompt=p.copy(), max_new_tokens=8, extras=e or None)
             for i, (p, e) in enumerate(zip(prompts, ex))]
    reqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=8, extras=e or None)
            for i, (p, e) in enumerate(zip(prompts, ex))]
    for rr, tr in zip(rreqs, reqs):
        ref.submit(rr)
        eng.submit(tr)
    for _ in range(200):
        if not ref.queue and not ref._live_slots():
            break
        ref.step()
        eng.step()
    for tr, rr in zip(reqs, rreqs):
        assert tr.state is RequestState.FINISHED
        assert tr.output == rr.output, tr.uid


@pytest.mark.parametrize("arch,cap", [(a, 30.0) for a in ARCHS] + [("gemma3-4b", 2.0)])
@pytest.mark.usefixtures("one_thread")
def test_capped_train_loss_and_gradients_match_reference(arch, cap):
    rcfg, cfg = TT.configs(arch, logit_softcap=cap)
    batch = TT.batch(cfg)
    (rloss, _), rgrads = TT.ref_loss_and_grads(rcfg, batch)
    loss, _, grads = TT.port_loss_and_grads(cfg, TT.port_params(rcfg), batch)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    TT.assert_grads(grads, rgrads)


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("G", [1, 4])
def test_b6_plain_capped_matches_reference_flash_and_dense(window, G):
    """B6's plain version at cap 30 on scores that reach past it (q scaled
    by 20) against the reference's jnp flash (block 32) and dense
    attention, fp32."""
    r = np.random.default_rng(G + (window or 0))
    KVH, hd, S = 2, 64, 96
    q = (r.normal(size=(1, S, KVH * G, hd)) * 20.0).astype(np.float32)
    k = r.normal(size=(1, S, KVH, hd)).astype(np.float32)
    v = r.normal(size=(1, S, KVH, hd)).astype(np.float32)
    got = FA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), window=window,
                             softcap=30.0).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    flash = RL.flash_attention(jq, jk, jv, True, window, 0, 30.0, 32, 32)
    dense = RL.dense_attention(jq, jk, jv, causal=True, window=window, softcap=30.0)
    np.testing.assert_allclose(got, np.asarray(flash), atol=5e-5)
    np.testing.assert_allclose(got, np.asarray(dense), atol=5e-5)
    uncapped = FA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  window=window).numpy()
    assert np.abs(uncapped - got).max() > 1e-2


def test_b6_still_refuses_a_query_offset():
    q = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match="q_offset"):
        FA.flash_attention(q, q, q, q_offset=3, softcap=30.0)


def test_capped_configs_pass_check_supported():
    for arch in ARCHS:
        T.check_supported(dataclasses.replace(get_config(arch), logit_softcap=30.0))
