"""The attention kernels at the wider head dims of the dense families:
B6 (``csrc/flash_attention.cu``) at hd 128 (glm4-9b) and 256 (gemma3-4b),
and B3 (``csrc/paged_attention.cu``) at the same head dims.

On the CPU: the plain versions against the reference's Pallas kernels in
interpret mode (as the reference's own tests run them), causal and
windowed, GQA groups of 2 and 16, at small lengths -- fp32 held to the
reference's 5e-5 (flash) and 2e-5 (paged) -- and the B6 wrapper's head-dim
gate, which refuses every other head dim before anything is built.

On the card (``gpu`` marker; skip here): B6 at hd 128 and 256 against its
plain version (about one bf16 ulp, held to 1e-2 of the max), two launches
equal bit for bit, and hd 64 unchanged against digests pinned from the
kernel before the head-dim template (NVIDIA H100 80GB HBM3)."""

import hashlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA

FLASH_TOL = dict(atol=5e-5)
PAGED_TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(B, Sq, Sk, H, KVH, hd, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, Sq, H, hd)).astype(np.float32),
            r.normal(size=(B, Sk, KVH, hd)).astype(np.float32),
            r.normal(size=(B, Sk, KVH, hd)).astype(np.float32))


# ---------------------------------------------------------------------------
# B6's plain version vs the Pallas flash kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("H,KVH,window", [(4, 2, None), (32, 2, None), (4, 2, 24),
                                          (32, 2, 40)])
def test_b6_plain_matches_pallas_at_wide_head_dims(hd, H, KVH, window):
    """G = 2 (gemma3's 8/4) and 16 (glm4's 32/2), causal, with and without
    a window, over two 32-blocks of a 64-token prompt."""
    q, k, v = _qkv(1, 64, 64, H, KVH, hd, seed=hd + H + (window or 0))
    want = rops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                window=window, block_q=32, block_k=32, interpret=True)
    n = FA.flash_attention.launches
    got = FA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                             window=window)
    assert FA.flash_attention.launches == n  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)


class _OnCard(torch.Tensor):
    """A CPU tensor that claims to lie on the card, so that the wrapper
    takes its kernel branch."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def no_launch(monkeypatch):
    """Records the libraries a wrapper loads, and stops it there."""
    loads = []

    def load(name):
        loads.append(name)
        raise RuntimeError("launch reached")

    monkeypatch.setattr(build, "load", load)
    return loads


def _card_qkv(hd, KVH=2, H=4, S=16):
    return [torch.zeros(shape, dtype=torch.bfloat16).as_subclass(_OnCard)
            for shape in ((1, S, H, hd), (1, S, KVH, hd), (1, S, KVH, hd))]


@pytest.mark.parametrize("hd", FA.FLASH_HEAD_DIMS)
def test_b6_takes_the_served_head_dims(no_launch, hd):
    assert FA.FLASH_HEAD_DIMS == (64, 128, 256)
    with pytest.raises(RuntimeError, match="launch reached"):
        FA.flash_attention(*_card_qkv(hd), causal=True)
    assert no_launch == ["flash_attention"]


@pytest.mark.parametrize("hd", [16, 32, 80, 96, 160, 192, 512])
def test_b6_refuses_other_head_dims_before_any_build(no_launch, hd):
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(*_card_qkv(hd), causal=True)
    assert no_launch == []


@pytest.mark.parametrize("hd", [128, 256])
def test_b6_int8_kv_at_wide_head_dims_reaches_the_build(no_launch, hd):
    q, k, v = _card_qkv(hd)
    k8, v8 = (t.to(torch.int8).as_subclass(_OnCard) for t in (k, v))
    scales = [torch.ones((1, 16, 2)).as_subclass(_OnCard) for _ in range(2)]
    with pytest.raises(RuntimeError, match="launch reached"):
        FA.flash_attention(q, k8, v8, k_scale=scales[0], v_scale=scales[1])
    assert no_launch == ["flash_attention"]


@pytest.fixture
def fake_launch(monkeypatch):
    """Stands in for the built library: the wrapper runs to its launch site
    and counts there, and the launch itself does nothing."""
    lib = types.SimpleNamespace(flash_attention_launch=lambda *args: 0)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(build, "check", lambda lib, code, what: None)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(FA.flash_attention, "launches", 0)
    monkeypatch.setattr(FA.flash_attention, "launches_by_window", {})


@pytest.mark.parametrize("hd", FA.FLASH_HEAD_DIMS)
def test_b6_counts_its_launches_by_window(fake_launch, hd):
    for window in (None, 1024, 1024, 8):
        FA.flash_attention(*_card_qkv(hd), causal=True, window=window)
    # a CPU tensor takes the plain version, which counts nowhere
    FA.flash_attention(*[t.as_subclass(torch.Tensor) for t in _card_qkv(hd)], window=8)
    assert FA.flash_attention.launches == 4
    assert FA.flash_attention.launches_by_window == {0: 1, 1024: 2, 8: 1}


# ---------------------------------------------------------------------------
# B3's plain version vs the Pallas paged kernel
# ---------------------------------------------------------------------------


def _paged_inputs(hd, T, G, int8, seed):
    """B = 2 sequences, 2 KV heads, pages of 8, a scrambled table; positions
    that straddle page boundaries."""
    r = np.random.default_rng(seed)
    B, KVH, ps, P = 2, 2, 8, 4
    num_pages = 1 + B * P
    q = r.normal(size=(B, T, KVH * G, hd)).astype(np.float32)
    table = (1 + r.permutation(B * P)).reshape(B, P).astype(np.int32)
    pos = np.asarray([9, 20], np.int32)
    if int8:
        k = r.integers(-127, 128, size=(num_pages, ps, KVH, hd)).astype(np.int8)
        v = r.integers(-127, 128, size=k.shape).astype(np.int8)
        ks = (r.random((num_pages, ps, KVH)) * 0.02 + 0.005).astype(np.float32)
        vs = (r.random((num_pages, ps, KVH)) * 0.02 + 0.005).astype(np.float32)
        return q, k, v, table, pos, ks, vs
    k = r.normal(size=(num_pages, ps, KVH, hd)).astype(np.float32)
    v = r.normal(size=k.shape).astype(np.float32)
    return q, k, v, table, pos, None, None


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("hd,G", [(128, 16), (256, 2)])
def test_b3_plain_matches_pallas_at_wide_head_dims(hd, G, T, window):
    """int8 pages (the served pool): T = 1 decode and T = 5 verify, glm4's
    16 and gemma3's 2 query heads a KV head."""
    q, k, v, table, pos, ks, vs = _paged_inputs(hd, T, G, True, seed=hd + T)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    want = rops.paged_decode_attention(j(q), j(k), j(v), j(table), j(pos), window=window,
                                       k_scale_pages=j(ks), v_scale_pages=j(vs),
                                       interpret=True)
    got = FA.paged_decode_attention(t(q), t(k), t(v), t(table), t(pos), window=window,
                                    k_scale_pages=t(ks), v_scale_pages=t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PAGED_TOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_inputs(B, S, H, KVH, hd, seed):
    """q, k, v as bf16 on the card from numpy draws (the same on any card)."""
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.normal(size=shape).astype(np.float32)).cuda().bfloat16()
            for shape in ((B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hd))]


def _close(got, want, rtol):
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= rtol, float(err)


WIDE_CASES = [  # (B, S, H, KVH, causal, window)
    (1, 1, 8, 2, True, None), (2, 63, 8, 2, True, None), (1, 129, 32, 2, True, None),
    (2, 300, 8, 4, True, 96), (1, 1100, 32, 2, True, None), (1, 2048, 8, 4, True, 1024),
    (2, 200, 16, 1, False, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WIDE_CASES)
@pytest.mark.parametrize("hd", [128, 256])
def test_b6_wide_head_dims_match_plain_on_the_card(cuda, hd, case):
    B, S, H, KVH, causal, window = case
    q, k, v = _card_inputs(B, S, H, KVH, hd, seed=S + hd)
    n = FA.flash_attention.launches
    o = FA.flash_attention(q, k, v, causal=causal, window=window)
    assert FA.flash_attention.launches == n + 1
    ref = FA.flash_attention(q, k, v, causal=causal, window=window, use_kernel=False)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all()
    _close(o, ref, 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [128, 256])
def test_b6_wide_head_dims_int8_kv_match_plain_on_the_card(cuda, hd):
    q, _, _ = _card_inputs(1, 1100, 8, 2, hd, seed=hd)
    g = torch.Generator(device=cuda).manual_seed(hd)
    k = torch.randint(-127, 128, (1, 1100, 2, hd), generator=g, device=cuda, dtype=torch.int8)
    v = torch.randint(-127, 128, k.shape, generator=g, device=cuda, dtype=torch.int8)
    ks = torch.rand((1, 1100, 2), generator=g, device=cuda) * 0.02 + 0.002
    vs = torch.rand((1, 1100, 2), generator=g, device=cuda) * 0.02 + 0.002
    kw = dict(k_scale=ks, v_scale=vs, causal=True, window=256)
    o = FA.flash_attention(q, k, v, **kw)
    ref = FA.flash_attention(q, k, v, use_kernel=False, **kw)
    torch.cuda.synchronize()
    _close(o, ref, 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,H,KVH,window", [(128, 32, 2, None), (256, 8, 4, 1024)])
def test_b6_wide_head_dims_are_bitwise_deterministic(cuda, hd, H, KVH, window):
    q, k, v = _card_inputs(1, 2048, H, KVH, hd, seed=1)
    a = FA.flash_attention(q, k, v, causal=True, window=window)
    b = FA.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# sha256 (first 16 hex digits) of B6's hd 64 bf16 output on these inputs,
# taken from the kernel before the head-dim template
HD64_DIGESTS = {
    (1100, 32, 4, None): "b2d4b129fb6bde61",
    (1100, 32, 4, 256): "f6b938f52faf2138",
    (2048, 32, 8, None): "b1188df9e9684d9b",
    (300, 8, 1, None): "7b6f6b81b440cbf7",
}


@pytest.mark.gpu
@pytest.mark.parametrize("key", sorted(HD64_DIGESTS, key=str))
def test_b6_hd64_is_unchanged(cuda, key):
    S, H, KVH, window = key
    q, k, v = _card_inputs(1, S, H, KVH, 64, seed=S + H)
    o = FA.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    got = hashlib.sha256(o.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
    assert got == HD64_DIGESTS[key]
