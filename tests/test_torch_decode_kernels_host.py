"""Host side of kernels B5 (``csrc/quant_matmul.cu``) and B3
(``csrc/paged_attention.cu``): the regime and the cluster split each launch
takes, the shared-memory bound, and the refusals the wrappers make before
anything is built or launched.  Nothing here needs a card: every choice
comes from dtypes and shapes, and a wrapper that refuses does so before it
loads a library."""

import inspect

import pytest
import torch
from _hypcompat import given, settings, st

from repro_torch.kernels import block_sparse as BS
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import quant_matmul as QM

H100_SMS = 132
# full-width tinyllama-1.1b's int8 leaves under --compress quant (K, N):
# wq/wo, wk/wv, w_gate/w_up, w_down, and the head
TINYLLAMA_LEAVES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000)]
B5_MS = [1, 8, 40, 63, 64, 65, 128, 129, 2032]


class _OnCard(torch.Tensor):
    """A CPU tensor that claims to lie on the card, so that a wrapper takes
    its kernel branch."""

    @property
    def is_cuda(self):
        return True


class _Lib:
    """Stands in for a kernel library: records each C entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


@pytest.fixture
def fake_lib(monkeypatch):
    """Loads record their library's name and return a recording _Lib."""
    libs = {}
    monkeypatch.setattr(build, "load", lambda name: libs.setdefault(name, _Lib()))
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(BS, "sm_count", lambda device: H100_SMS)
    return libs


@pytest.fixture
def no_launch(monkeypatch):
    """Records the libraries a wrapper loads, and stops it there."""
    loads = []

    def load(name):
        loads.append(name)
        raise RuntimeError("launch reached")

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(BS, "sm_count", lambda device: H100_SMS)
    return loads


# -- B5 ------------------------------------------------------------------------------


@pytest.mark.parametrize("M", B5_MS)
@pytest.mark.parametrize("K,N", TINYLLAMA_LEAVES)
def test_b5_served_shapes_take_the_wgmma_regime(K, N, M):
    want = BS.launch_plan(M, -(-N // 128), -(-K // 128), H100_SMS)
    assert QM.regime(torch.bfloat16, M, K, N, K, N, H100_SMS) == ("wgmma", *want)


@pytest.mark.parametrize("M", [1, 8, 2032])
@pytest.mark.parametrize("K,N", TINYLLAMA_LEAVES)
def test_b5_fp32_x_takes_dense_tile(K, N, M):
    assert QM.regime(torch.float32, M, K, N, K, N, H100_SMS) == ("dense_tile", 0, 1)


# the card test's ragged shapes (K = 70 / N = 37, N = 1000, N = 6): x's row
# or w's stride is not a multiple of 16 bytes, so TMA cannot address them;
# a strided x whose stride is not either
@pytest.mark.parametrize("M,K,N,ldx,ldw", [(5, 70, 37, 70, 37), (40, 2048, 1000, 2048, 1000),
                                          (1, 64, 6, 64, 6), (8, 2048, 2048, 2052, 2048),
                                          (8, 2048, 2048, 2048, 2056)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_b5_untma_able_shapes_take_dense_tile(M, K, N, ldx, ldw, dtype):
    assert QM.regime(dtype, M, K, N, ldx, ldw, H100_SMS) == ("dense_tile", 0, 1)


def test_b5_ragged_tma_able_shapes_take_wgmma():
    """K not a multiple of 128 and N a multiple of 16 but not of 128 (the
    card test's edges), and a strided x: TMA zero-fills the edges."""
    assert QM.regime(torch.bfloat16, 8, 1000, 1040, 1000, 1040, H100_SMS) == \
        ("wgmma", *BS.launch_plan(8, 9, 8, H100_SMS))
    assert QM.regime(torch.bfloat16, 300, 1000, 1037, 1064, 1056, H100_SMS) == \
        ("wgmma", 128, 1)


def _b5_x(M, K, aligned: bool):
    base = torch.zeros(M * K + 8, dtype=torch.bfloat16)
    x = (base[8:] if aligned else base[1:1 + M * K]).view(M, K)
    assert (x.data_ptr() % 16 == 0) == aligned
    return x.as_subclass(_OnCard)


def _b5_w(K, N):
    return torch.zeros((K, N), dtype=torch.int8), torch.ones(N)


def test_b5_refuses_misaligned_bf16_x_before_any_build(no_launch):
    w, s = _b5_w(256, 256)
    with pytest.raises(ValueError, match="16-byte aligned"):
        QM.quant_matmul(_b5_x(4, 256, False), w, s)
    assert no_launch == []
    with pytest.raises(RuntimeError, match="launch reached"):
        QM.quant_matmul(_b5_x(4, 256, True), w, s)
    assert no_launch == ["quant_matmul"]


def test_b5_refuses_misaligned_w_before_any_build(no_launch):
    base = torch.zeros(256 * 256 + 1, dtype=torch.int8)
    w = base[1:].view(256, 256)
    with pytest.raises(ValueError, match="16-byte aligned"):
        QM.quant_matmul(_b5_x(4, 256, True), w, torch.ones(256))
    assert no_launch == []


@pytest.mark.parametrize("M", [1, 8, 40, 2032])
def test_b5_launches_in_its_regime_and_counts_it(M, fake_lib):
    K, N = 2048, 5632
    w, s = _b5_w(K, N)
    counts = (QM.quant_matmul.launches, QM.quant_matmul.wgmma_launches,
              QM.quant_matmul.dense_tile_launches)
    QM.quant_matmul(_b5_x(M, K, True), w, s, activation="silu")
    QM.quant_matmul(_b5_x(M, K, True).float(), w, s)
    (e1, a1), (e2, a2) = fake_lib["quant_matmul"].calls
    assert e1 == e2 == "quant_matmul_launch"
    # ..., act, x_dtype, bm, split, stream
    assert a1[-3:-1] == BS.launch_plan(M, N // 128, K // 128, H100_SMS)
    assert a2[-3:-1] == (0, 1)
    assert (QM.quant_matmul.launches, QM.quant_matmul.wgmma_launches,
            QM.quant_matmul.dense_tile_launches) == (counts[0] + 2, counts[1] + 1, counts[2] + 1)


# -- B3 ------------------------------------------------------------------------------


def _live_pages(p0: int, T: int, ps: int, P: int, window) -> tuple:
    """(first, end): the table slots B3 reads for a sequence at ``p0``, as
    ``csrc/paged_attention.cu`` computes them from ``pos`` on the card --
    from the first page the window lets any row see to the last that covers
    p0 + T - 1 (causal)."""
    end = max(1, min((p0 + T - 1) // ps + 1, P))
    first = min(max(p0 - window + 1, 0) // ps, end - 1) if window else 0
    return first, end


def _rank_pages(first: int, end: int, split: int, rank: int) -> list:
    """The live pages cluster rank ``rank`` streams, as the kernel deals
    them: first + rank, first + rank + split, ... below ``end``."""
    return list(range(first + rank, end, split))


def _covered_once(first: int, end: int, split: int) -> bool:
    pages = [p for r in range(split) for p in _rank_pages(first, end, split, r)]
    return sorted(pages) == list(range(first, end))


def _check_split_plan(B, KVH, P, ps, p0, T, window):
    split = FA.paged_split(B, KVH, P, H100_SMS)
    assert 1 <= split <= FA.PAGED_MAX_SPLIT and split <= P
    first, end = _live_pages(p0, T, ps, P, window)
    assert 0 <= first < end <= P
    assert _covered_once(first, end, split)
    # every page that holds a key some row sees is live
    for t in range(T):
        q_pos = p0 + t
        lo = max(0, q_pos - window + 1) if window else 0
        for kv in range(lo, q_pos + 1):
            if kv // ps < P:
                assert first <= kv // ps < end


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 8), KVH=st.integers(1, 8), P=st.integers(1, 128),
       ps=st.sampled_from([8, 16, 32]), T=st.integers(1, 4), frac=st.floats(0.0, 1.0),
       window=st.one_of(st.none(), st.integers(1, 700)))
def test_b3_split_plan_covers_every_live_page_once(B, KVH, P, ps, T, frac, window):
    p0 = int(frac * (P * ps - T))
    _check_split_plan(B, KVH, P, ps, max(0, p0), T, window)


# the same property on a fixed grid, so that it runs where hypothesis does not
@pytest.mark.parametrize("B,KVH", [(1, 1), (8, 4), (4, 4), (3, 8), (8, 8)])
@pytest.mark.parametrize("P", [1, 2, 8, 37, 128])
@pytest.mark.parametrize("window", [None, 20, 300])
def test_b3_split_plan_grid(B, KVH, P, window):
    ps = 16
    for T in (1, 3):
        for p0 in sorted({0, 14, 15, 16, 17, P * ps // 2, max(0, P * ps - T)}):
            _check_split_plan(B, KVH, P, ps, p0, T, window)


def test_b3_split_is_a_function_of_shapes_only():
    assert list(inspect.signature(FA.paged_split).parameters) == \
        ["B", "KVH", "pages_per_seq", "n_sm"]
    # the serve phase (B = 8, 8 pages) and the long phase (B = 4, 128 pages)
    # of full-width tinyllama-1.1b (4 KV heads) on an H100
    assert FA.paged_split(8, 4, 8, H100_SMS) == 8
    assert FA.paged_split(4, 4, 128, H100_SMS) == 8
    assert FA.paged_split(1, 1, 3, H100_SMS) == 3
    assert FA.paged_split(64, 8, 128, H100_SMS) == 1


def _b3_operands(B=3, T=1, H=8, KVH=2, hd=64, ps=16, P=8, kv=torch.int8, pos=(15, 16, 40)):
    q = torch.zeros((B, T, H, hd)).as_subclass(_OnCard)
    shape = (1 + B * P, ps, KVH, hd)
    kp, vp = torch.zeros(shape, dtype=kv), torch.zeros(shape, dtype=kv)
    scales = {}
    if kv == torch.int8:
        scales = dict(k_scale_pages=torch.ones(shape[:3]), v_scale_pages=torch.ones(shape[:3]))
    table = (1 + torch.arange(B * P)).reshape(B, P).to(torch.int32)
    return q, kp, vp, table, torch.tensor(pos, dtype=torch.int32), scales


def test_b3_split_does_not_depend_on_pos(fake_lib):
    splits = []
    for pos in ((0, 0, 0), (15, 16, 40), (127, 127, 127)):
        q, kp, vp, table, p, kw = _b3_operands(pos=pos)
        FA.paged_decode_attention(q, kp, vp, table, p, **kw)
        entry, args = fake_lib["paged_attention"].calls[-1]
        assert entry == "paged_decode_launch"
        splits.append(args[-4:-1])  # ..., split, stages, groups, stream
    split = FA.paged_split(3, 2, 8, H100_SMS)
    groups = FA.paged_groups(4, 64, 16, torch.int8, -(-8 // split), 3 * 2 * split, H100_SMS)
    assert splits == [(split, FA.paged_stages(64, 16, torch.int8), groups)] * 3


@pytest.mark.parametrize("kv,rows", [(torch.int8, 410), (torch.bfloat16, 382),
                                     (torch.float32, 319)])
def test_b3_shared_memory_bound_at_hd64_pages_of_16(kv, rows):
    """The largest T * G one launch takes at hd 64 and pages of 16 (int8 is
    the served pool): ROADMAP A7 sizes chunked prefill by it."""
    assert FA.paged_max_rows(64, 16, kv) == rows
    assert FA.paged_smem_bytes(rows, 64, 16, kv) <= FA.SMEM_LIMIT
    assert FA.paged_smem_bytes(rows + 1, 64, 16, kv) > FA.SMEM_LIMIT


def test_b3_refuses_rows_past_the_bound_before_any_launch(no_launch):
    # 52 tokens of 8 grouped heads: 416 rows > 410
    q, kp, vp, table, pos, kw = _b3_operands(T=52, H=8, KVH=1)
    with pytest.raises(ValueError, match="shared memory"):
        FA.paged_decode_attention(q, kp, vp, table, pos, **kw)
    assert no_launch == []
    q, kp, vp, table, pos, kw = _b3_operands(T=51, H=8, KVH=1)
    with pytest.raises(RuntimeError, match="launch reached"):
        FA.paged_decode_attention(q, kp, vp, table, pos, **kw)
    assert no_launch == ["paged_attention"]


@pytest.mark.parametrize("hd", [32, 80, 96, 160, 512])
def test_b3_refuses_other_head_dims_before_any_launch(no_launch, hd):
    q, kp, vp, table, pos, kw = _b3_operands(hd=hd)
    with pytest.raises(ValueError, match="head dim"):
        FA.paged_decode_attention(q, kp, vp, table, pos, **kw)
    assert no_launch == []


@pytest.mark.parametrize("hd", FA.PAGED_HEAD_DIMS)
def test_b3_takes_the_repo_head_dims(no_launch, hd):
    q, kp, vp, table, pos, kw = _b3_operands(hd=hd)
    with pytest.raises(RuntimeError, match="launch reached"):
        FA.paged_decode_attention(q, kp, vp, table, pos, **kw)
    assert no_launch == ["paged_attention"]


def test_b3_refuses_pages_past_a_tma_box(no_launch):
    q, kp, vp, table, pos, kw = _b3_operands(ps=300, P=1, pos=(0, 0, 0), T=1, hd=64)
    with pytest.raises(ValueError, match="at most 256"):
        FA.paged_decode_attention(q, kp, vp, table, pos, **kw)
    assert no_launch == []


@pytest.mark.parametrize("hd", FA.PAGED_HEAD_DIMS)
def test_b3_groups_fit_registers_pages_and_shared_memory(hd):
    for kv in (torch.int8, torch.bfloat16, torch.float32):
        assert FA.paged_groups(8, hd, 16, kv, 16, 8, H100_SMS) == FA.PAGED_MAX_GROUPS[hd]
        # one page per rank: one group
        assert FA.paged_groups(8, hd, 16, kv, 1, 8, H100_SMS) == 1
        # fp32 pages of 64 slots: 32 KB stages, three of them, so 3 groups at most
        assert FA.paged_groups(8, hd, 64, kv, 16, 8, H100_SMS) <= FA.paged_stages(hd, 64, kv)
        rows = FA.paged_max_rows(hd, 16, kv)
        for r in (1, 8, rows // 4, rows // 2, rows):
            g = FA.paged_groups(r, hd, 16, kv, 128, 8, H100_SMS)
            assert 1 <= g <= FA.PAGED_MAX_GROUPS[hd]
            assert FA.paged_smem_bytes(r, hd, 16, kv, g) <= FA.SMEM_LIMIT


@pytest.mark.parametrize("ctas", [1, 32, 99, 100, 128, 198, 199, 256, 1000])
def test_b3_groups_keep_the_launch_in_one_wave(ctas):
    g = FA.paged_groups(8, 64, 16, torch.int8, 128, ctas, H100_SMS)
    assert g == 1 or ctas <= 99 * FA.PAGED_CTAS_PER_SM[64, g]
    assert g == (4 if ctas <= 99 else 2 if ctas <= 198 else 1)


def test_b3_groups_on_the_served_shapes():
    # the serve phase: 8 sequences x 4 KV heads x 8 ranks, a page per rank;
    # the long phase: 4 x 4 x 8 CTAs, 16 pages per rank; one sequence at a
    # long context: 4 x 8 CTAs
    assert FA.paged_groups(8, 64, 16, torch.int8, 1, 256, H100_SMS) == 1
    assert FA.paged_groups(8, 64, 16, torch.int8, 16, 128, H100_SMS) == 2
    assert FA.paged_groups(8, 64, 16, torch.int8, 16, 32, H100_SMS) == 4


def test_b3_stages_stay_between_three_and_eight():
    for hd in FA.PAGED_HEAD_DIMS:
        for ps in (1, 8, 16, 64, 256):
            for kv in (torch.int8, torch.bfloat16, torch.float32):
                assert 3 <= FA.paged_stages(hd, ps, kv) <= 8
    assert FA.paged_stages(64, 16, torch.int8) == 8
