"""PyTorch port vs the JAX reference for long-prompt prefill: kernel B6's
plain version against the Pallas flash kernel (interpret mode, as the
reference's own tests run it), the chunked ``layers.flash_attention``
against the reference's, the ``layers.attention`` dispatch, and the slice
end to end -- a 1100-token prompt served by both engines.

Tolerances are the reference's own: 5e-5 (fp32) and 3e-2 (bf16) for the
Pallas kernel (``tests/test_kernels.py``), 2e-5 for the chunked flash path
(``tests/test_attention.py``); greedy token streams must be identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import weight_plan as RW
from repro.kernels import ops as rops
from repro.models import layers as RL
from repro.models.api import get_api as ref_get_api
from repro.serving.config import CacheConfig as RCacheConfig
from repro.serving.config import EngineConfig as REngineConfig
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.serving.config import CacheConfig, EngineConfig
from repro_torch.serving.engine import Request, RequestState, ServingEngine


def _qkv(B, Sq, Sk, H, KVH, hd, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, Sq, H, hd)).astype(np.float32),
            r.normal(size=(B, Sk, KVH, hd)).astype(np.float32),
            r.normal(size=(B, Sk, KVH, hd)).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


# ---------------------------------------------------------------------------
# (a) B6's plain version vs the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,KVH,hd,window", [
    (2, 256, 4, 2, 64, None),   # GQA
    (1, 256, 8, 1, 32, None),   # MQA
    (2, 256, 4, 4, 64, 96),     # MHA + sliding window
    (2, 200, 4, 2, 64, None),   # ragged length (the Pallas wrapper pads it)
])
def test_b6_plain_matches_pallas(B, S, H, KVH, hd, window):
    q, k, v = _qkv(B, S, S, H, KVH, hd, seed=S + H)
    want = rops.flash_attention(*_j(q, k, v), causal=True, window=window,
                                block_q=64, block_k=64, interpret=True)
    n = FA.flash_attention.launches
    got = ops.flash_attention(*_t(q, k, v), causal=True, window=window)
    assert FA.flash_attention.launches == n  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("H,KVH,window", [(8, 1, None), (16, 2, None), (8, 2, None),
                                          (8, 1, 64)])
def test_b6_plain_matches_pallas_across_a_row_tile(H, KVH, window):
    """S = 136: at G = 8 the 1088 folded rows of a KV head straddle B6's
    128-row CTA tile (and 17 positions per tile at G = 8, 34 at G = 4); the
    Pallas wrapper pads the length to its block, which causal attention
    never sees."""
    q, k, v = _qkv(1, 136, 136, H, KVH, 64, seed=H + KVH)
    want = rops.flash_attention(*_j(q, k, v), causal=True, window=window, block_q=64,
                                block_k=64, interpret=True)
    got = ops.flash_attention(*_t(q, k, v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    bq, bk, bv = _t(q, k, v, dtype=torch.bfloat16)
    want16 = rops.flash_attention(*_j(q, k, v, dtype=jnp.bfloat16), causal=True, window=window,
                                  block_q=64, block_k=64, interpret=True)
    got16 = FA.flash_attention(bq, bk, bv, causal=True, window=window)
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(want16, np.float32), atol=3e-2)


def test_b6_plain_matches_pallas_bf16():
    q, k, v = _qkv(2, 256, 256, 4, 2, 32, seed=3)
    want = rops.flash_attention(*_j(q, k, v, dtype=jnp.bfloat16), block_q=64, block_k=64,
                                interpret=True)
    got = FA.flash_attention(*_t(q, k, v, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


def test_b6_plain_matches_pallas_int8_kv():
    """int8 K/V with (B, S, KVH) scales, quantized by the reference's
    ``quantize_kv``: the scales fold into scores and P, where Pallas
    dequantizes the tiles; the same in fp32."""
    q, k, v = _qkv(2, 256, 256, 4, 2, 64, seed=4)
    kq, ks = RL.quantize_kv(jnp.asarray(k))
    vq, vs = RL.quantize_kv(jnp.asarray(v))
    want = rops.flash_attention(jnp.asarray(q), kq, vq, causal=True, block_q=64, block_k=64,
                                k_scale=ks, v_scale=vs, interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = FA.flash_attention(t(q), t(kq), t(vq), k_scale=t(ks), v_scale=t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    # the port's own int8 codec gives the same payload and scales
    tq, tks = TL.quantize_kv(t(k))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(kq))
    np.testing.assert_array_equal(tks.numpy(), np.asarray(ks))


def test_b6_plain_non_causal_matches_pallas_at_block_multiples():
    """Non-causal at Sk a multiple of the block: the Pallas wrapper pads
    nothing, so both see the same keys."""
    q, k, v = _qkv(2, 128, 256, 4, 2, 64, seed=5)
    want = rops.flash_attention(*_j(q, k, v), causal=False, block_q=64, block_k=64,
                                interpret=True)
    got = FA.flash_attention(*_t(q, k, v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def test_b6_plain_non_causal_ragged_masks_its_tail():
    """Ragged non-causal Sk: the port masks the real Sk like the reference's
    ``layers.flash_attention`` (the Pallas wrapper would attend to its zero
    padding, which the port does not copy)."""
    q, k, v = _qkv(2, 100, 250, 4, 2, 64, seed=6)
    want = RL.flash_attention(*_j(q, k, v), False, None, 0, 0.0, 64, 64)
    got = FA.flash_attention(*_t(q, k, v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


# ---------------------------------------------------------------------------
# (b) the chunked layers.flash_attention vs the reference's
# ---------------------------------------------------------------------------

CASES = [
    # B, Sq, Sk, H, KVH, hd, causal, window, softcap
    (2, 257, 257, 4, 2, 32, True, None, 0.0),
    (1, 300, 300, 8, 1, 32, True, None, 0.0),   # MQA
    (2, 200, 200, 4, 2, 32, True, 64, 0.0),     # sliding window
    (2, 200, 200, 4, 2, 32, True, None, 30.0),  # softcap (gemma)
    (2, 100, 250, 4, 2, 32, False, None, 0.0),  # cross attention
]


@pytest.mark.parametrize("B,Sq,Sk,H,KVH,hd,causal,window,cap", CASES)
def test_layers_flash_matches_reference(B, Sq, Sk, H, KVH, hd, causal, window, cap):
    q, k, v = _qkv(B, Sq, Sk, H, KVH, hd, seed=Sq + Sk)
    want = RL.flash_attention(*_j(q, k, v), causal, window, 0, cap, 64, 64)
    got = TL.flash_attention(*_t(q, k, v), causal, window, 0, cap, 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_layers_flash_q_offset_and_chunk_invariance():
    q, k, v = _qkv(1, 300, 300, 4, 2, 32, seed=7)
    tq, tk, tv = _t(q, k, v)
    full = TL.flash_attention(tq, tk, tv, True, None, 0, 0.0, 64, 64)
    for cq, ck in ((32, 64), (128, 32), (256, 256)):
        out = TL.flash_attention(tq, tk, tv, True, None, 0, 0.0, cq, ck)
        np.testing.assert_allclose(out.numpy(), full.numpy(), atol=2e-5)
    tail = TL.flash_attention(tq[:, 192:], tk, tv, True, None, 192, 0.0, 64, 64)
    np.testing.assert_allclose(tail.numpy(), full[:, 192:].numpy(), atol=2e-5)
    want = RL.flash_attention(*_j(q[:, 192:], k, v), True, None, 192, 0.0, 64, 64)
    np.testing.assert_allclose(tail.numpy(), np.asarray(want), atol=2e-5)


def test_layers_flash_bf16_matches_reference():
    q, k, v = _qkv(2, 256, 256, 4, 2, 32, seed=8)
    want = RL.flash_attention(*_j(q, k, v, dtype=jnp.bfloat16), True, None, 0, 0.0, 64, 64)
    got = TL.flash_attention(*_t(q, k, v, dtype=torch.bfloat16), True, None, 0, 0.0, 64, 64)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


# ---------------------------------------------------------------------------
# (c) layers.attention on both sides of a lowered dense_threshold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,threshold,flash", [(96, 96, False), (97, 96, True), (200, 64, True)])
@pytest.mark.parametrize("window,cap", [(None, 0.0), (40, 0.0), (None, 30.0)])
def test_attention_dispatch_matches_reference(S, threshold, flash, window, cap, monkeypatch):
    q, k, v = _qkv(1, S, S, 4, 2, 32, seed=S)
    want = RL.attention(*_j(q, k, v), causal=True, window=window, softcap=cap,
                        dense_threshold=threshold, chunk=64)
    calls = []
    real = TL.flash_attention
    monkeypatch.setattr(TL, "flash_attention", lambda *a: calls.append(a) or real(*a))
    got = TL.attention(*_t(q, k, v), causal=True, window=window, softcap=cap,
                       dense_threshold=threshold, chunk=64)
    assert bool(calls) == flash  # a sequence of exactly the threshold stays dense
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# ---------------------------------------------------------------------------
# (f) what B6 refuses, on the wrapper's checks (no card needed)
# ---------------------------------------------------------------------------


def test_b6_refuses_q_offset_and_softcap():
    """B6 refuses a q_offset; a logit softcap, once refused (A8c), it
    takes: on CPU tensors its plain version with the cap."""
    q, k, v = _t(*_qkv(1, 64, 64, 4, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="kernel B3"):
        ops.flash_attention(q, k, v, q_offset=8)
    got = ops.flash_attention(q, k, v, softcap=30.0)
    assert torch.equal(got, FA.flash_attention_plain(q, k, v, softcap=30.0))
    assert got.shape == q.shape and got.dtype == q.dtype


@pytest.mark.parametrize("bad", ["fp32 q", "hd 32", "fp32 k", "scales without int8",
                                 "one scale", "strided k"])
def test_b6_check_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = _t(*_qkv(1, 64, 64, 4, 2, 64), dtype=torch.bfloat16)
    ks = vs = None
    if bad == "fp32 q":
        q = q.float()
    elif bad == "hd 32":
        q, k, v = q[..., :32].contiguous(), k[..., :32].contiguous(), v[..., :32].contiguous()
    elif bad == "fp32 k":
        k = k.float()
    elif bad == "scales without int8":
        ks = vs = torch.ones((1, 64, 2))
    elif bad == "one scale":
        k, v = k.to(torch.int8), v.to(torch.int8)
        ks = torch.ones((1, 64, 2))
    else:
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        FA._check_flash(q, k, v, ks, vs)
    good = _t(*_qkv(1, 64, 64, 4, 2, 64), dtype=torch.bfloat16)
    FA._check_flash(*good, None, None)  # what the kernel takes passes


class _OnCard(torch.Tensor):
    """A CPU tensor that claims to lie on the card, so that the wrapper
    takes its kernel branch."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_b6_refuses_misaligned_operands_before_any_launch(which, monkeypatch):
    """The bf16 kernel reads Q in 16-byte pieces and K/V by TMA: an operand
    off a 16-byte boundary is refused before any library is loaded."""
    loads = []

    def load(name):
        loads.append(name)
        raise RuntimeError("launch reached")

    monkeypatch.setattr(build, "load", load)
    ops_ = dict(zip("qkv", _t(*_qkv(1, 64, 64, 4, 2, 64), dtype=torch.bfloat16)))
    base = torch.zeros(ops_[which].numel() + 8, dtype=torch.bfloat16)
    ops_[which] = base[1:1 + ops_[which].numel()].view(ops_[which].shape)
    args = {n: t.as_subclass(_OnCard) for n, t in ops_.items()}
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.flash_attention(**args)
    assert loads == []
    ops_[which] = base[8:8 + ops_[which].numel()].view(ops_[which].shape)
    args = {n: t.as_subclass(_OnCard) for n, t in ops_.items()}
    with pytest.raises(RuntimeError, match="launch reached"):
        FA.flash_attention(**args)
    assert loads == ["flash_attention"]


# ---------------------------------------------------------------------------
# (d) the slice: a long prompt through both engines; (e) the serve CLI
# ---------------------------------------------------------------------------

MAX_LEN, PS, MAX_NEW = 1152, 16, 4


def test_long_prompt_greedy_streams_match_reference():
    """quant_sparse weights, paged int8 KV: an 1100-token prompt (past the
    dense threshold: the chunked flash prefill) and a 12-token one give the
    reference engine's greedy tokens, tick for tick."""
    rcfg = ref_get_config("tinyllama-1.1b", smoke=True)
    rplan = RW.compress(ref_get_api(rcfg).init_params(rcfg, jax.random.key(0)),
                        RW.PlanConfig(default="quant_sparse", q_prune=0.5, bk=16, bn=16))
    r = np.random.default_rng(0)
    prompts = [r.integers(0, 256, 1100).astype(np.int32), r.integers(0, 256, 12).astype(np.int32)]
    cache = dict(kv_dtype="int8", page_size=PS, share_prefix=True)
    ref = RServingEngine(rcfg, rplan.params, plan=rplan, config=REngineConfig(
        max_len=MAX_LEN, max_batch=2, cache=RCacheConfig(**cache)))
    eng = ServingEngine(get_config("tinyllama-1.1b", smoke=True), None,
                        plan=interop.plan_from_reference(rplan), device="cpu",
                        config=EngineConfig(max_len=MAX_LEN, max_batch=2,
                                            cache=CacheConfig(**cache)))
    rreqs = [RRequest(uid=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
    for rr, tr in zip(rreqs, reqs):
        ref.submit(rr)
        eng.submit(tr)
    while ref.queue or ref._live_slots():
        ref.step()
        eng.step()
        np.testing.assert_array_equal(eng._table, ref._table)
    assert not eng.queue and not eng._live_slots()
    for tr, rr in zip(reqs, rreqs):
        assert tr.state is RequestState.FINISHED
        assert tr.output == rr.output, tr.uid
    eng.audit_pages()
    assert eng.pages_in_use == 0
    assert eng.stats.prefill_tokens == 1112


def test_serve_cli_long_prompt_on_cpu(capsys):
    from repro_torch.launch import serve

    eng = serve.main(["--arch", "tinyllama-1.1b", "--smoke", "--requests", "2", "--max-new",
                      "4", "--compress", "quant_sparse", "--q-prune", "0.5", "--block", "16",
                      "--kv-dtype", "int8", "--page-size", "16", "--share-prefix",
                      "--prompt-len", "1100", "--max-len", "1152", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] completed 2 requests" in out and "tok/s on cpu" in out
    assert eng.stats.prefill_tokens == 2200
    eng.audit_pages()
    assert eng.pages_in_use == 0
