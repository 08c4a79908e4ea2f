"""Host side of the kernels at the dense families' leaves: what B1/B2
(``kernels/block_sparse.launch_plan``), B5 (``quant_matmul.regime``) and B3
(``flash_attention.paged_split`` / ``paged_groups``, the shared-memory
bound) choose for glm4-9b's and gemma3-4b's shapes, which no earlier path
reached -- glm4's d_ff of 13696 is 107 blocks of 128, an odd column count,
its untied int8 head 151552 wide; gemma3's hd 256 -- and which heads skip
B5 (the tied ones).  Every choice comes from dtypes and shapes, so nothing
here needs a card."""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import weight_plan as TW
from repro_torch.kernels import block_sparse as BS
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_gate_up as FG
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as QM
from repro_torch.models import layers as L

H100_SMS = 132
MS = [1, 8, 40, 63, 64, 65, 128, 129, 2048]


def _leaves(arch: str) -> dict:
    """name -> (K, N) of one layer's matmul leaves at full width."""
    c = get_config(arch)
    d, q, kv, f = c.d_model, c.n_heads * c.hd, c.n_kv_heads * c.hd, c.d_ff
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d), "w_gate": (d, f),
            "w_up": (d, f), "w_down": (f, d)}


def test_glm4_ffn_has_an_odd_number_of_column_blocks():
    assert _leaves("glm4-9b")["w_gate"] == (4096, 13696) and 13696 == 107 * 128
    assert _leaves("gemma3-4b")["w_gate"] == (2560, 10240) and get_config("gemma3-4b").hd == 256


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("arch", ["llama3.2-1b", "glm4-9b", "gemma3-4b"])
def test_launch_plan_at_every_leaf(arch, M):
    """Every leaf at q 0.5 (at most half the row blocks survive a column,
    and at least one): the regime, a split no larger than the slots, and
    clusters within three quarters of the card unless one CTA per column
    is already more."""
    for K, N in _leaves(arch).values():
        n_cols = -(-N // 128)
        for mb in sorted({1, max(1, K // 256), K // 128}):
            bm, split = BS.launch_plan(M, n_cols, mb, H100_SMS)
            if M > BS.DECODE_MAX_M:
                assert (bm, split) == (128, 1)
            else:
                assert bm == 64 and 1 <= split <= min(BS.MAX_SPLIT, mb)
                assert n_cols * split <= max(3 * H100_SMS // 4, n_cols)


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("arch", ["llama3.2-1b", "glm4-9b", "gemma3-4b"])
def test_b5_regime_at_every_quant_leaf(arch, M):
    """Under --compress quant every leaf, and glm4's untied head, runs B5's
    wgmma regime in bf16 (TMA addresses every one of these strides)."""
    cfg = get_config(arch)
    leaves = list(_leaves(arch).values())
    if not cfg.tie_embeddings:
        leaves.append((cfg.d_model, cfg.vocab))
    for K, N in leaves:
        name, bm, split = QM.regime(torch.bfloat16, M, K, N, K, N, H100_SMS)
        assert name == "wgmma"
        assert (bm, split) == BS.launch_plan(M, -(-N // 128), -(-K // 128), H100_SMS)
    # fp32 x (the smoke configs on a card) takes the CUDA-core tile
    assert QM.regime(torch.float32, 8, 4096, 151552, 4096, 151552, H100_SMS)[0] == "dense_tile"


def test_glm4_head_is_one_cta_a_column():
    # 1184 output block-columns already fill the card: no split at decode
    assert QM.regime(torch.bfloat16, 8, 4096, 151552, 4096, 151552, H100_SMS) == ("wgmma", 64, 1)


class _OnCard(torch.Tensor):
    @property
    def is_cuda(self):
        return True


class _Lib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


@pytest.fixture
def fake_lib(monkeypatch):
    libs = {}
    monkeypatch.setattr(build, "load", lambda name: libs.setdefault(name, _Lib()))
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(BS, "sm_count", lambda device: H100_SMS)
    return libs


def _packed_like(n_cols, mb, K):
    blocks = torch.zeros((n_cols * mb, 128, 128), dtype=torch.int8).as_subclass(_OnCard)
    rows = torch.zeros((n_cols, mb), dtype=torch.int32).as_subclass(_OnCard)
    counts = torch.zeros((n_cols,), dtype=torch.int32).as_subclass(_OnCard)
    scales = torch.ones((n_cols * 128,)).as_subclass(_OnCard)
    return blocks, rows, counts, scales


@pytest.mark.parametrize("M", [8, 2048])
@pytest.mark.parametrize("act", ["silu", "gelu_glu"])
def test_b2_launches_glm4_and_gemma3_pairs_with_their_plan_and_epilogue(fake_lib, M, act):
    """The fused gate/up launch at 107 (glm4) and 80 (gemma3) columns gets
    launch_plan's (bm, split), N = n_cols * 128, and the activation code of
    csrc/common.cuh (gelu_glu: the tanh gelu, code 3)."""
    for K, n_cols, mb in ((4096, 107, 16), (2560, 80, 10)):
        x = torch.zeros((M, K), dtype=torch.bfloat16).as_subclass(_OnCard)
        g, u = _packed_like(n_cols, mb, K), _packed_like(n_cols, mb, K)
        y = FG.fused_gate_up(x, g[:3], u[:3], g[3], u[3], activation=act)
        assert tuple(y.shape) == (M, n_cols * 128)
        entry, args = fake_lib["fused_gate_up"].calls[-1]
        # ..., M, K, N, mb_g, mb_u, act, x_dtype, w_dtype, bm, split, stream
        assert args[10:13] == (M, K, n_cols * 128)
        assert args[15] == FG.ACT_CODES[act] == (3 if act == "gelu_glu" else 4)
        assert args[18:20] == BS.launch_plan(M, n_cols, mb, H100_SMS)


def test_tied_heads_do_not_reach_b5(monkeypatch):
    """A tied int8 table unembeds as (x * s) @ q.T in plain torch: its
    scales lie on the contraction axis, which B5 does not scale."""
    def refuse(*a, **k):
        raise AssertionError("a tied head reached B5")

    monkeypatch.setattr(ops, "quant_matmul", refuse)
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True))
    tok = TW.quantize_leaf(torch.randn(cfg.vocab, cfg.d_model))
    x = torch.randn(2, 3, cfg.d_model)
    got = L.unembed(cfg, {"tok": tok}, x)
    want = x @ (tok.q.float() * tok.s).T
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# B3 at hd 128 and 256: the largest T * G one launch takes (int8 pages of 16)
@pytest.mark.parametrize("hd,kv,rows", [(128, torch.int8, 190), (128, torch.bfloat16, 160),
                                        (256, torch.int8, 83), (256, torch.bfloat16, 80)])
def test_b3_shared_memory_bound_at_wide_head_dims(hd, kv, rows):
    assert FA.paged_max_rows(hd, 16, kv) == rows
    assert FA.paged_smem_bytes(rows, hd, 16, kv) <= FA.SMEM_LIMIT
    assert FA.paged_smem_bytes(rows + 1, hd, 16, kv) > FA.SMEM_LIMIT


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("arch,B,P", [("glm4-9b", 8, 8), ("glm4-9b", 4, 128),
                                      ("gemma3-4b", 8, 8), ("gemma3-4b", 4, 128)])
def test_b3_plan_at_the_families_serve_and_long_shapes(arch, B, P, T):
    """The serve phase (8 sequences, 8 pages of 16) and the long phase (4,
    128 pages): T * G within the bound, a cluster of 8, and the groups the
    head dim's registers allow."""
    cfg = get_config(arch)
    G, hd, KVH = cfg.n_heads // cfg.n_kv_heads, cfg.hd, cfg.n_kv_heads
    assert T * G <= FA.paged_max_rows(hd, 16, torch.int8)
    split = FA.paged_split(B, KVH, P, H100_SMS)
    assert split == 8
    groups = FA.paged_groups(T * G, hd, 16, torch.int8, -(-P // split), B * KVH * split,
                             H100_SMS)
    assert 1 <= groups <= FA.PAGED_MAX_GROUPS[hd]
    if P // split < 2:
        assert groups == 1
