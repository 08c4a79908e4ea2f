"""The attention kernels' non-causal modes on the card, at the enc-dec's
shapes: B3 (``csrc/paged_attention.cu``) with ``causal=False`` over
whisper-tiny's 1500 frames in 94 pages of 16 (the last page's stale tail
past pos = 1499 must mask out), read in place through a scrambled frame
table and through the contiguous dispatch's identity table; and B6
(``csrc/flash_attention.cu``) non-causal at Sq = Sk = 1500 (the encoder)
and at 40 queries against 1500 keys (the prefill's cross-attention).
Each against its plain version (bf16, held to 1e-2 of the max, as
tests/test_torch_gpu.py holds it), and two launches equal bit for bit.
These need a CUDA device and nvcc; they carry the ``gpu`` marker and skip
elsewhere (and import no JAX, which the card's machine lacks):

    python -m pytest -q -m gpu tests/test_torch_encdec_gpu.py"""

import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops

RTOL = 1e-2
FRAMES, PS, KVH, HD = 1500, 16, 6, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= RTOL, float(err)


def _frame_pool(B, T, seed, device):
    """q (B, T, 6, 64) and frame pools of 94 pages a sequence (a scrambled
    table; every slot random, so the last page's tail is stale), bf16."""
    g = torch.Generator(device=device).manual_seed(seed)
    P = -(-FRAMES // PS)
    table = (1 + torch.randperm(B * P, generator=g, device=device)).reshape(B, P)
    shape = (1 + B * P, PS, KVH, HD)
    kp = torch.randn(shape, generator=g, device=device).bfloat16()
    vp = torch.randn(shape, generator=g, device=device).bfloat16()
    q = torch.randn((B, T, KVH, HD), generator=g, device=device).bfloat16()
    pos = torch.full((B,), FRAMES - 1, dtype=torch.int32, device=device)
    return q, kp, vp, table.to(torch.int32).contiguous(), pos


@pytest.mark.gpu
@pytest.mark.parametrize("B,T", [(8, 1), (2, 3)])
def test_b3_noncausal_over_frame_pages_matches_plain(cuda, B, T):
    q, kp, vp, table, pos = _frame_pool(B, T, seed=B + T, device=cuda)
    n = FA.paged_decode_attention.launches_noncausal
    o = FA.paged_decode_attention(q, kp, vp, table, pos, causal=False)
    assert FA.paged_decode_attention.launches_noncausal == n + 1
    _close(o, FA.paged_decode_attention(q, kp, vp, table, pos, causal=False, use_kernel=False))
    assert torch.equal(o, FA.paged_decode_attention(q, kp, vp, table, pos, causal=False))
    # every query sees every frame: the causal kernel at the same pos differs for T > 1
    if T > 1:
        c = FA.paged_decode_attention(q, kp, vp, table, pos - (T - 1))
        assert not torch.equal(o[:, 0], c[:, 0])


@pytest.mark.gpu
def test_b3_cross_dispatch_on_a_contiguous_pool_matches_plain(cuda):
    """The contiguous cache's cross-attention: 1500 frames padded into pages
    of 16 under an identity table, against plain non-causal attention."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((4, 1, KVH, HD), generator=g, device=cuda).bfloat16()
    k = torch.randn((4, FRAMES, KVH, HD), generator=g, device=cuda).bfloat16()
    v = torch.randn(k.shape, generator=g, device=cuda).bfloat16()
    o = ops.cross_decode_attention(q, k, v)
    _close(o, ops.cross_decode_attention(q, k, v, use_kernel=False))
    assert torch.equal(o, ops.cross_decode_attention(q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("Sq", [40, 1500, 1])
def test_b6_noncausal_at_1500_keys_matches_plain(cuda, Sq):
    g = torch.Generator(device=cuda).manual_seed(Sq)
    q = torch.randn((2, Sq, KVH, HD), generator=g, device=cuda).bfloat16()
    k = torch.randn((2, FRAMES, KVH, HD), generator=g, device=cuda).bfloat16()
    v = torch.randn(k.shape, generator=g, device=cuda).bfloat16()
    n = FA.flash_attention.launches_noncausal
    o = FA.flash_attention(q, k, v, causal=False)
    assert FA.flash_attention.launches_noncausal == n + 1
    _close(o, FA.flash_attention(q, k, v, causal=False, use_kernel=False))
    assert torch.equal(o, FA.flash_attention(q, k, v, causal=False))
