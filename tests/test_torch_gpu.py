"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and the CUDA toolkit (nvcc); they carry the
``gpu`` marker and skip elsewhere.  ``python3 chip_smoke.py`` is the
authoritative check on the card (full-width shapes, timings, the serving
path); these cover the wrappers' contracts at small shapes:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: kernel and plain version both accumulate in fp32 and round to
the output dtype once, in another order -- fp32 outputs agree to 1e-5
relative, bf16 outputs to about one bf16 ulp (held to 1e-2 of the max)."""

import pytest
import torch

from repro_torch.core.weight_plan import PlanConfig, pack_block_sparse
from repro_torch.kernels import block_sparse as BS
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_gate_up as FG

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _packed(K, N, quant, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((K, N), generator=g, device=device) / K ** 0.5
    return pack_block_sparse(w, PlanConfig(q_prune=0.5), quant=quant)


def _close(got, want, rtol):
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= rtol, float(err)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("M", [1, 8, 21])
def test_block_sparse_kernel_matches_plain(cuda, M, quant, dtype, rtol):
    p = _packed(384, 256, quant, 0, cuda)
    x = torch.randn((M, 384), device=cuda).to(dtype)
    n = BS.block_sparse_matmul.launches
    y = BS.block_sparse_matmul(x, p.blocks, p.block_rows, p.counts, p.scales)
    assert BS.block_sparse_matmul.launches == n + 1
    ref = BS.block_sparse_matmul(x, p.blocks, p.block_rows, p.counts, p.scales,
                                 use_kernel=False)
    assert BS.block_sparse_matmul.launches == n + 1
    torch.cuda.synchronize()
    _close(y, ref, rtol)


def test_block_sparse_empty_column_writes_zeros(cuda):
    w = torch.randn((256, 256), device=cuda)
    w[:, :128] = 0.0
    p = pack_block_sparse(w, PlanConfig(q_prune=0.5), quant=True)
    assert int(p.counts[0]) == 0
    x = torch.randn((4, 256), device=cuda)
    y = BS.block_sparse_matmul(x, p.blocks, p.block_rows, p.counts, p.scales)
    torch.cuda.synchronize()
    assert torch.all(y[:, :128] == 0)


@pytest.mark.parametrize("activation", ["silu", "gelu", "relu"])
def test_fused_gate_up_kernel_matches_plain(cuda, activation):
    g, u = _packed(256, 384, True, 1, cuda), _packed(256, 384, True, 2, cuda)
    x = torch.randn((9, 256), device=cuda)
    args = ((g.blocks, g.block_rows, g.counts), (u.blocks, u.block_rows, u.counts),
            g.scales, u.scales)
    y = FG.fused_gate_up(x, *args, activation=activation)
    ref = FG.fused_gate_up(x, *args, activation=activation, use_kernel=False)
    torch.cuda.synchronize()
    _close(y, ref, 1e-5)


@pytest.mark.parametrize("window,softcap", [(None, 0.0), (20, 30.0)])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("int8", [True, False])
def test_paged_attention_kernel_matches_plain(cuda, int8, T, window, softcap):
    B, H, KVH, hd, ps, P = 3, 8, 2, 64, 16, 4
    num_pages = 1 + B * P
    q = torch.randn((B, T, H, hd), device=cuda)
    table = (1 + torch.randperm(B * P, device=cuda)).reshape(B, P).to(torch.int32)
    table[1, 0] = table[0, 0]
    pos = torch.tensor([15, 16, 40], dtype=torch.int32, device=cuda)
    if int8:
        kp = torch.randint(-127, 128, (num_pages, ps, KVH, hd), device=cuda, dtype=torch.int8)
        vp = torch.randint(-127, 128, kp.shape, device=cuda, dtype=torch.int8)
        ks = torch.rand((num_pages, ps, KVH), device=cuda) * 0.02
        vs = torch.rand((num_pages, ps, KVH), device=cuda) * 0.02
    else:
        kp = torch.randn((num_pages, ps, KVH, hd), device=cuda)
        vp = torch.randn(kp.shape, device=cuda)
        ks = vs = None
    kw = dict(k_scale_pages=ks, v_scale_pages=vs, window=window, softcap=softcap)
    o = FA.paged_decode_attention(q, kp, vp, table, pos, **kw)
    ref = FA.paged_decode_attention(q, kp, vp, table, pos, use_kernel=False, **kw)
    torch.cuda.synchronize()
    _close(o, ref, 1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    p = _packed(256, 256, True, 3, cuda)
    x = torch.randn((4, 256), device=cuda)
    with pytest.raises(ValueError):
        BS.block_sparse_matmul(x.t().contiguous().t()[:, :128], p.blocks, p.block_rows,
                               p.counts, p.scales)
    with pytest.raises(ValueError):
        BS.block_sparse_matmul(x.cpu().cuda().double(), p.blocks, p.block_rows, p.counts,
                               p.scales)
