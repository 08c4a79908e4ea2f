"""The kernels at the recurrent families' new shapes, on the card: B6
(``csrc/flash_attention.cu``) at recurrentgemma-2b's 10 query heads over 1
KV head (G = 10), hd 256, window 2048, at 2048 and 4096 tokens (the window
bites in the second); B5 (``csrc/quant_matmul.cu``) in its ``dense_tile``
regime at xlstm-350m's ragged leaves (w_if 1024 x 8, the sLSTM's w_up
1024 x 2730 and w_down 1365 x 1024) and in ``wgmma`` at its 1024 x 50304
head; B2 (``csrc/fused_gate_up.cu``) with the gelu_glu epilogue at
recurrentgemma's 2560 x 7680 pair.  Each against its plain version (bf16,
held to 1e-2 of the max, as tests/test_torch_gpu.py holds it), and two
launches equal bit for bit.  These need a CUDA device and nvcc; they carry
the ``gpu`` marker and skip elsewhere (and import no JAX, which the card's
machine lacks):

    python -m pytest -q -m gpu tests/test_torch_recurrent_gpu.py"""

import pytest
import torch

from repro_torch.core.weight_plan import PlanConfig, pack_block_sparse, quantize_leaf
from repro_torch.kernels import block_sparse as BS
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_gate_up as FG
from repro_torch.kernels import quant_matmul as QM

RTOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= RTOL, float(err)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [2048, 4096])
def test_b6_windowed_at_ten_query_heads_a_kv_head(cuda, S):
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn((1, S, 10, 256), generator=g, device=cuda).bfloat16()
    k = torch.randn((1, S, 1, 256), generator=g, device=cuda).bfloat16()
    v = torch.randn((1, S, 1, 256), generator=g, device=cuda).bfloat16()
    n = FA.flash_attention.launches_by_window.get(2048, 0)
    o = FA.flash_attention(q, k, v, window=2048)
    assert FA.flash_attention.launches_by_window[2048] == n + 1
    _close(o, FA.flash_attention(q, k, v, window=2048, use_kernel=False))
    assert torch.equal(o, FA.flash_attention(q, k, v, window=2048))
    if S > 2048:  # the window bites: the last query differs from full causal attention
        full = FA.flash_attention(q, k, v, use_kernel=False)
        assert not torch.allclose(o[:, -1].float(), full[:, -1].float(), atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("K,N,regime", [(1024, 8, "dense_tile"), (1024, 2730, "dense_tile"),
                                        (1365, 1024, "dense_tile"), (1024, 50304, "wgmma")])
@pytest.mark.parametrize("M", [8, 40])
def test_b5_at_the_xlstm_leaves(cuda, K, N, regime, M):
    g = torch.Generator(device=cuda).manual_seed(K + N + M)
    leaf = quantize_leaf(torch.randn((K, N), generator=g, device=cuda) / K ** 0.5)
    x = torch.randn((M, K), generator=g, device=cuda).bfloat16()
    assert QM.regime(x.dtype, M, K, N, K, N, BS.sm_count(cuda))[0] == regime
    before = getattr(QM.quant_matmul, f"{regime}_launches")
    y = QM.quant_matmul(x, leaf.q, leaf.s)
    assert getattr(QM.quant_matmul, f"{regime}_launches") == before + 1
    _close(y, QM.quant_matmul(x, leaf.q, leaf.s, use_kernel=False))
    assert torch.equal(y, QM.quant_matmul(x, leaf.q, leaf.s))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 40])
def test_b2_gelu_glu_at_the_recurrentgemma_pair(cuda, M):
    g = torch.Generator(device=cuda).manual_seed(M)
    packs = [pack_block_sparse(torch.randn((2560, 7680), generator=g, device=cuda) / 2560 ** 0.5,
                               PlanConfig(q_prune=0.5), quant=True) for _ in range(2)]
    gate, up = ((p.blocks, p.block_rows, p.counts) for p in packs)
    x = torch.randn((M, 2560), generator=g, device=cuda).bfloat16()
    args = (x, gate, up, packs[0].scales, packs[1].scales)
    y = FG.fused_gate_up(*args, activation="gelu_glu")
    _close(y, FG.fused_gate_up(*args, activation="gelu_glu", use_kernel=False))
    assert torch.equal(y, FG.fused_gate_up(*args, activation="gelu_glu"))
