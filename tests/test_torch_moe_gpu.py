"""The stacked kernels on the card: B1, B4 and B2 over a stack of experts
(x (E, M, K), one launch over a grid z axis of E) against their plain
versions, B4 equal to B1, and a stacked launch equal bit for bit to E
single-expert launches in the same regime.  These need a CUDA device and
nvcc; they carry the ``gpu`` marker and skip elsewhere (and import no JAX,
which the card's machine lacks):

    python -m pytest -q -m gpu tests/test_torch_moe_gpu.py

bf16 outputs are held to 1e-2 of the max (fp32 sums in another order,
rounded once), as in tests/test_torch_gpu.py."""

import pytest
import torch

from repro_torch.core import weight_plan as TW
from repro_torch.kernels import block_sparse as BS
from repro_torch.kernels import fused_gate_up as FG


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_stack(E, K, N, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((E, K, N), generator=g, device=device) / K ** 0.5
    return TW.pack_block_sparse(w, TW.PlanConfig(q_prune=0.5), quant=True)


def _same_regime_per_expert(monkeypatch, E):
    """Single-expert launches in the regime of a stack of E (the split
    decides the order of a column's partial sums)."""
    plan = BS.launch_plan
    monkeypatch.setattr(BS, "launch_plan",
                        lambda M, n_cols, mb, n_sm, n_stack=1: plan(M, n_cols, mb, n_sm, E))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 8, 65, 130])
def test_stacked_kernels_match_plain_and_per_expert_launches(cuda, M, monkeypatch):
    """Stacked B1, B4 and B2 within 1e-2 of their plain versions (bf16 out,
    fp32 sums in another order), B4 equal to B1, and each equal bit for bit
    to E single-expert launches in the same regime."""
    E, K, N = 4, 256, 384
    w, u = _card_stack(E, K, N, 0, cuda), _card_stack(E, K, N, 1, cuda)
    x = torch.randn((E, M, K), device=cuda).to(torch.bfloat16)
    ops_w = (w.blocks, w.block_rows, w.counts, w.scales)
    y1 = BS.block_sparse_matmul(x, *ops_w)
    y4 = BS.block_sparse_matmul_col(x, *ops_w)
    gu = ((w.blocks, w.block_rows, w.counts), (u.blocks, u.block_rows, u.counts), w.scales,
          u.scales)
    y2 = FG.fused_gate_up(x, *gu)
    torch.cuda.synchronize()
    for got, want in ((y1, BS.block_sparse_matmul(x, *ops_w, use_kernel=False)),
                      (y2, FG.fused_gate_up(x, *gu, use_kernel=False))):
        err = (got.float() - want.float()).abs().max() / want.float().abs().max()
        assert float(err) <= 1e-2
    assert torch.equal(y4, y1)
    _same_regime_per_expert(monkeypatch, E)
    one1 = torch.stack([BS.block_sparse_matmul(x[e].contiguous(), *[t[e] for t in ops_w])
                        for e in range(E)])
    one2 = torch.stack([FG.fused_gate_up(x[e].contiguous(), *[[t[e] for t in p] for p in gu[:2]],
                                         gu[2][e], gu[3][e]) for e in range(E)])
    assert torch.equal(one1, y1) and torch.equal(one2, y2)
