"""Host side of the kernels on the enc-dec and VLM paths, which no earlier
path reached: B3 (``csrc/paged_attention.cu``) launched non-causal over a
sequence's frame pages -- the causal flag its C entry receives, the
counters, its split and groups at whisper-tiny's and internvl2-2b's
shapes -- B6's non-causal counter, and B5's regime at internvl's untied
2048 x 92553 head, whose odd row stride TMA cannot take.  Every choice
comes from dtypes and shapes, and the library is stood in for, so nothing
here needs a card."""

import types

import numpy as np
import pytest
import torch

import _torch_encdec as X
from repro_torch.configs import get_config
from repro_torch.kernels import block_sparse as BS
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as QM
from repro_torch.models import encdec as E
from repro_torch.models import layers as L

H100_SMS = 132
CAUSAL_ARG = 16  # paged_decode_launch(q, k, v, ks, vs, table, pos, out, B, T, H, KVH, hd, P,
#                  ps, num_pages, causal, ...)


class _OnCard(torch.Tensor):
    @property
    def is_cuda(self):
        return True


@pytest.fixture
def fake_b3(monkeypatch):
    """The B3 wrapper runs to its C entry, which records its arguments."""
    calls = []
    lib = types.SimpleNamespace(paged_decode_launch=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(build, "check", lambda lib, code, what: None)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(BS, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(FA.paged_decode_attention, "launches", 0)
    monkeypatch.setattr(FA.paged_decode_attention, "launches_by_t", {})
    monkeypatch.setattr(FA.paged_decode_attention, "launches_noncausal", 0)
    return calls


def _card(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype).as_subclass(_OnCard)


def test_b3_c_entry_takes_the_causal_flag(fake_b3):
    """causal 1 for the self-attention call, 0 for the cross-attention over
    frame pages (in place through the table, or the contiguous dispatch's
    identity table); the non-causal launches are counted apart from
    ``launches_by_t``."""
    B, KVH, hd, ps = 2, 6, 64, 16
    q = _card(B, 1, KVH, hd)
    pool = _card(9, ps, KVH, hd)
    table = _card(B, 4, dtype=torch.int32)
    pos = _card(B, dtype=torch.int32)
    L.paged_decode_attention(q, pool, pool, table, pos)
    L.paged_decode_attention(q, pool, pool, table, pos, causal=False)
    xk = _card(B, 40, KVH, hd)
    L.cross_decode_attention(q, xk, xk)
    assert [c[CAUSAL_ARG] for c in fake_b3] == [1, 0, 0]
    ident = fake_b3[2]
    assert ident[13:16] == (3, ps, B * 3)  # 40 frames: 3 pages a sequence
    assert FA.paged_decode_attention.launches == 3
    assert FA.paged_decode_attention.launches_by_t == {1: 1}
    assert FA.paged_decode_attention.launches_noncausal == 2


def test_whisper_paged_step_calls_b3_causal_then_non_causal(monkeypatch):
    """A paged decode step of whisper-smoke calls the paged attention twice
    a layer: its self-attention causal, its cross-attention non-causal over
    the frame table at pos = n_frames - 1."""
    seen = []
    inner = ops.paged_decode_attention

    def spy(q, kp, vp, table, pos, **kw):
        seen.append((kw.get("causal", True), tuple(table.shape), pos.tolist()))
        return inner(q, kp, vp, table, pos, **kw)

    monkeypatch.setattr(ops, "paged_decode_attention", spy)
    cfg = get_config(X.WHISPER, smoke=True)
    params = E.unstack(cfg, X.port_params(X.WHISPER))
    cache = E.init_cache(cfg, 2, 32, torch.float32, page_size=16, num_pages=7)
    E.decode_step(cfg, params, cache, torch.tensor([[3], [4]]), torch.tensor([5, 9],
                                                                            dtype=torch.int32))
    want = [(True, (2, 2), [5, 9]), (False, (2, 1), [15, 15])] * cfg.n_layers
    assert seen == want


@pytest.mark.parametrize("arch,T,P,want_split", [
    (X.WHISPER, 1, 94, 6),    # cross: 1500 frames in 94 pages, 6/6 heads (G 1)
    (X.WHISPER, 1, 8, 6),     # self: max_len 128
    (X.INTERNVL, 1, 20, 5),   # self: 256 patches + 40 + 16 in pages of 16, 16/8 heads
])
def test_b3_split_and_groups_at_the_served_shapes(arch, T, P, want_split):
    """The serve phase's batch of 8: a cluster of ``paged_split`` CTAs a
    (sequence, KV head) and one group of consumer warps (more would spill
    the launch past one wave of three quarters of the SMs), within the
    shared-memory bound."""
    cfg = get_config(arch)
    B, G, hd = 8, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    kv = torch.bfloat16 if arch == X.WHISPER else torch.int8
    assert T * G <= FA.paged_max_rows(hd, 16, kv)
    split = FA.paged_split(B, cfg.n_kv_heads, P, H100_SMS)
    assert split == want_split
    groups = FA.paged_groups(T * G, hd, 16, kv, -(-P // split), B * cfg.n_kv_heads * split,
                             H100_SMS)
    assert groups == 1
    assert FA.paged_smem_bytes(T * G, hd, 16, kv, groups) <= FA.SMEM_LIMIT


def test_whisper_frames_fill_94_pages_of_16_with_a_ragged_tail():
    cfg = get_config(X.WHISPER)
    assert cfg.n_frames == 1500 and -(-cfg.n_frames // 16) == 94 and 1500 % 16 == 12


@pytest.mark.parametrize("M", [1, 8, 256])
def test_internvl_head_takes_the_dense_tile_regime(M):
    """internvl2-2b's untied int8 head is 2048 x 92553: a row of 92553 bytes
    is no multiple of 16, so TMA cannot address w and B5 runs its CUDA-core
    ``dense_tile`` kernel (ROADMAP: a padded row stride); the 2048-wide
    projections keep ``wgmma``."""
    cfg = get_config(X.INTERNVL)
    assert cfg.vocab == 92553 and not cfg.tie_embeddings and cfg.vocab % 16 == 9
    assert QM.regime(torch.bfloat16, M, cfg.d_model, cfg.vocab, cfg.d_model, cfg.vocab,
                     H100_SMS) == ("dense_tile", 0, 1)
    assert QM.regime(torch.bfloat16, M, 2048, 2048, 2048, 2048, H100_SMS)[0] == "wgmma"


def test_b6_counts_non_causal_launches_apart(monkeypatch):
    lib = types.SimpleNamespace(flash_attention_launch=lambda *args: 0)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(build, "check", lambda lib, code, what: None)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(FA.flash_attention, "launches", 0)
    monkeypatch.setattr(FA.flash_attention, "launches_by_window", {})
    monkeypatch.setattr(FA.flash_attention, "launches_noncausal", 0)
    q, kv = _card(1, 40, 6, 64), _card(1, 1500, 6, 64)
    FA.flash_attention(q, kv, kv, causal=False)
    FA.flash_attention(kv, kv, kv, causal=False)
    FA.flash_attention(kv, kv, kv)
    assert FA.flash_attention.launches == 3 and FA.flash_attention.launches_noncausal == 2
    assert FA.flash_attention.launches_by_window == {0: 1}


def test_kv_bytes_charge_the_frames_over_the_context():
    """The enc-dec's frames are read whole every step: kv_bytes_per_token
    spreads their bytes over the context, as the reference does."""
    from repro_torch.models.api import kv_bytes_per_token, state_bytes_per_step

    cfg = get_config(X.WHISPER)
    frames = 2 * cfg.n_layers * cfg.n_frames * cfg.n_kv_heads * cfg.hd * 2
    assert state_bytes_per_step(cfg) == frames
    base = kv_bytes_per_token(cfg)
    assert kv_bytes_per_token(cfg, context_len=48) == pytest.approx(base + frames / 48)
    assert state_bytes_per_step(get_config(X.INTERNVL)) == 0.0
    np.testing.assert_equal(kv_bytes_per_token(get_config(X.INTERNVL), "int8", 48),
                            kv_bytes_per_token(get_config(X.INTERNVL), "int8"))
