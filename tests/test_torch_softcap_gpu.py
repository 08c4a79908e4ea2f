"""Logit softcaps on the card: kernel B6 (``csrc/flash_attention.cu``) at
cap 30 against its plain version, at hd 64, 128 and 256, causal and under
a window, over bf16 K/V (the served path) and int8 K/V, and kernel B3
(``csrc/paged_attention.cu``) at cap 30 at T 1 and T 5.  The queries are
scaled so that the scaled scores reach past the cap (|s| up to ~60), so
the tanh bends them.  These need a CUDA device and nvcc; they carry the
``gpu`` marker and skip elsewhere (and import no JAX, which the card's
machine lacks):

    python -m pytest -q -m gpu tests/test_torch_softcap_gpu.py

bf16 outputs are held to 1e-2 of the max (fp32 sums in another order,
rounded once), as in tests/test_torch_gpu.py; two launches give the same
bits."""

import pytest
import torch

from repro_torch.kernels import flash_attention as FA

CAP = 30.0
RTOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(got, want) -> float:
    torch.cuda.synchronize()
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("hd,H,KVH,S,window", [(64, 32, 4, 1100, None), (128, 32, 2, 700, None),
                                               (256, 8, 4, 700, None), (256, 8, 4, 700, 256),
                                               (64, 16, 4, 129, 64)])
@pytest.mark.parametrize("int8", [False, True])
def test_b6_capped_matches_plain(cuda, hd, H, KVH, S, window, int8):
    g = torch.Generator(device=cuda).manual_seed(hd + S)
    q = (torch.randn((1, S, H, hd), generator=g, device=cuda) * 20.0).to(torch.bfloat16)
    if int8:
        k = torch.randint(-127, 128, (1, S, KVH, hd), generator=g, device=cuda,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, k.shape, generator=g, device=cuda, dtype=torch.int8)
        kw = dict(k_scale=torch.rand((1, S, KVH), generator=g, device=cuda) * 0.02 + 0.002,
                  v_scale=torch.rand((1, S, KVH), generator=g, device=cuda) * 0.02 + 0.002)
    else:
        k = torch.randn((1, S, KVH, hd), generator=g, device=cuda).to(torch.bfloat16)
        v = torch.randn(k.shape, generator=g, device=cuda).to(torch.bfloat16)
        kw = {}
    n = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, window=window, softcap=CAP, **kw)
    again = FA.flash_attention(q, k, v, window=window, softcap=CAP, **kw)
    assert FA.flash_attention.launches == n + 2
    want = FA.flash_attention(q, k, v, window=window, softcap=CAP, use_kernel=False, **kw)
    uncapped = FA.flash_attention(q, k, v, window=window, use_kernel=False, **kw)
    assert _rel(got, want) <= RTOL
    assert torch.equal(got, again)
    assert _rel(uncapped, want) > RTOL  # the cap bites at these scores


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 5])
def test_b3_capped_matches_plain(cuda, T):
    """tinyllama's 32/4 heads, hd 64, int8 pages of 16, B 8 at the serve
    phase's contexts."""
    g = torch.Generator(device=cuda).manual_seed(T)
    B, H, KVH, hd, ps, P = 8, 32, 4, 64, 16, 8
    pos = torch.tensor([43, 47, 47, 47, 47, 47, 47, 47], dtype=torch.int32, device=cuda)
    table = (1 + torch.randperm(B * P, generator=g, device=cuda)).reshape(B, P)
    table = table.to(torch.int32).contiguous()
    shape = (1 + B * P, ps, KVH, hd)
    kp = torch.randint(-127, 128, shape, generator=g, device=cuda, dtype=torch.int8)
    vp = torch.randint(-127, 128, shape, generator=g, device=cuda, dtype=torch.int8)
    kw = dict(k_scale_pages=torch.rand(shape[:3], generator=g, device=cuda) * 0.02 + 0.005,
              v_scale_pages=torch.rand(shape[:3], generator=g, device=cuda) * 0.02 + 0.005)
    q = (torch.randn((B, T, H, hd), generator=g, device=cuda) * 20.0).to(torch.bfloat16)
    got = FA.paged_decode_attention(q, kp, vp, table, pos, softcap=CAP, **kw)
    again = FA.paged_decode_attention(q, kp, vp, table, pos, softcap=CAP, **kw)
    want = FA.paged_decode_attention(q, kp, vp, table, pos, softcap=CAP, use_kernel=False, **kw)
    uncapped = FA.paged_decode_attention(q, kp, vp, table, pos, use_kernel=False, **kw)
    assert _rel(got, want) <= RTOL
    assert torch.equal(got, again)
    assert _rel(uncapped, want) > RTOL
