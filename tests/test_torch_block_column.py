"""Host side of kernels B1 and B2 (``csrc/wgmma_column.cuh``): the regime
each launch takes, the cluster split of a column's slots, and the refusals
the wrappers make before anything is built or launched.  Nothing here needs
a card: the regime comes from shapes alone, and a wrapper that refuses x
does so before it loads a library."""

import pytest
import torch

from repro_torch.core.weight_plan import PlanConfig, pack_block_sparse
from repro_torch.kernels import block_sparse as BS
from repro_torch.kernels import build
from repro_torch.kernels import fused_gate_up as FG

H100_SMS = 132
# full-width tinyllama-1.1b at q 0.5: (n_cols, mb) of wq/wo, wk/wv, w_down
# and of the gate/up pair (slots per column at most K/128)
TINYLLAMA = [(16, 16), (2, 16), (16, 44), (44, 16)]


@pytest.mark.parametrize("M", [1, 8, 63, 64, 65, 127, 128, 129, 2032])
@pytest.mark.parametrize("n_cols,mb", TINYLLAMA + [(1, 1), (3, 2), (200, 8)])
def test_launch_plan_regimes(M, n_cols, mb):
    bm, split = BS.launch_plan(M, n_cols, mb, H100_SMS)
    if M > BS.DECODE_MAX_M:
        assert (bm, split) == (128, 1)
    else:
        assert bm == 64 and 1 <= split <= min(BS.MAX_SPLIT, mb)
        # the clusters take three quarters of the card at most, unless one
        # CTA per column already takes more
        assert n_cols * split <= max(3 * H100_SMS // 4, n_cols)


def test_launch_plan_fills_the_card_at_decode():
    # wq/wo/w_down: 16 columns x 6 ranks; wk/wv: 2 x 8; gate/up: 44 x 2
    assert [BS.launch_plan(8, n, mb, H100_SMS)[1] for n, mb in TINYLLAMA] == [6, 8, 6, 2]


def _split_slots(count: int, split: int) -> list:
    """The slots of a column of ``count`` live blocks that each cluster rank
    streams, as ``csrc/wgmma_column.cuh`` deals them: rank r takes
    ceil((count - r) / split) slots, r + i * split."""
    return [[r + i * split for i in range(max(0, -(-(count - r) // split)))]
            for r in range(split)]


@pytest.mark.parametrize("split", range(1, BS.MAX_SPLIT + 1))
@pytest.mark.parametrize("count", [0, 1, 2, 5, 7, 8, 9, 22, 44])
def test_every_slot_goes_to_exactly_one_rank(count, split):
    ranks = _split_slots(count, split)
    assert len(ranks) == split
    assert sorted(s for r in ranks for s in r) == list(range(count))
    for r, slots in enumerate(ranks):
        assert all(s % split == r for s in slots)
    if count < split:  # ranks past the count stream nothing and add zeros
        assert all(ranks[r] == [] for r in range(count, split))


class _OnCard(torch.Tensor):
    """A CPU tensor that claims to lie on the card, so that a wrapper takes
    its kernel branch."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def no_launch(monkeypatch):
    """Records the libraries a wrapper loads (and stops it there), and
    checks that the regime is computed from host ints alone: ``counts``
    lie on the card, and reading them would synchronise every launch."""
    loads = []
    plan = BS.launch_plan

    def host_plan(*args):
        assert all(type(a) is int for a in args), args
        return plan(*args)

    def load(name):
        loads.append(name)
        raise RuntimeError("launch reached")

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(BS, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(BS, "launch_plan", host_plan)
    return loads


def _operands():
    w = torch.randn((256, 256), generator=torch.Generator().manual_seed(0))
    p = pack_block_sparse(w, PlanConfig(q_prune=0.5), quant=True)
    return p.blocks, p.block_rows, p.counts, p.scales


def _x(aligned: bool):
    base = torch.zeros(4 * 256 + 8, dtype=torch.bfloat16)
    x = (base[8:] if aligned else base[1:1 + 4 * 256]).view(4, 256)
    assert (x.data_ptr() % 16 == 0) == aligned
    return x.as_subclass(_OnCard)


def test_b1_refuses_misaligned_x_before_any_launch(no_launch):
    args = _operands()
    with pytest.raises(ValueError, match="16-byte aligned"):
        BS.block_sparse_matmul(_x(False), *args)
    assert no_launch == []
    with pytest.raises(RuntimeError, match="launch reached"):
        BS.block_sparse_matmul(_x(True), *args)
    assert no_launch == ["block_sparse"]


def test_b2_refuses_misaligned_x_before_any_launch(no_launch):
    blocks, rows, counts, scales = _operands()
    pair = ((blocks, rows, counts), (blocks, rows, counts), scales, scales)
    with pytest.raises(ValueError, match="16-byte aligned"):
        FG.fused_gate_up(_x(False), *pair)
    assert no_launch == []
    with pytest.raises(RuntimeError, match="launch reached"):
        FG.fused_gate_up(_x(True), *pair)
    assert no_launch == ["fused_gate_up"]


# B4 (csrc/block_sparse_col.cu) runs B1's column body, so its wrapper must
# hand its C entry B1's regime: the same (bm, split) for the same shapes


@pytest.mark.parametrize("M", [1, 8, 40, 64, 65, 2032])
@pytest.mark.parametrize("n_cols,mb", TINYLLAMA)
def test_regime_is_launch_plans_for_tinyllama(M, n_cols, mb, monkeypatch):
    monkeypatch.setattr(BS, "sm_count", lambda device: H100_SMS)
    x = torch.zeros((M, 128), dtype=torch.bfloat16)
    rows = torch.zeros((n_cols, mb), dtype=torch.int32)
    assert BS.regime(x, rows) == BS.launch_plan(M, n_cols, mb, H100_SMS)


class _Lib:
    """Stands in for a kernel library: records each C entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


@pytest.mark.parametrize("M", [1, 8, 40, 65, 2032])
def test_b4_launches_in_b1s_regime(M, monkeypatch):
    libs = {}
    monkeypatch.setattr(build, "load", lambda name: libs.setdefault(name, _Lib()))
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(BS, "sm_count", lambda device: H100_SMS)
    blocks, rows, counts, scales = _operands()
    base = torch.zeros(M * 256 + 8, dtype=torch.bfloat16)
    x = base[8:].view(M, 256).as_subclass(_OnCard)
    n1, n4 = BS.block_sparse_matmul.launches, BS.block_sparse_matmul_col.launches
    BS.block_sparse_matmul(x, blocks, rows, counts, scales)
    BS.block_sparse_matmul_col(x, blocks, rows, counts, scales)
    (e1, a1), = libs["block_sparse"].calls
    (e4, a4), = libs["block_sparse_col"].calls
    assert (e1, e4) == ("bsmm_launch", "bsmm_col_launch")
    want = BS.launch_plan(M, *rows.shape, H100_SMS)
    # ..., x_dtype, w_dtype, bm, split, stream: everything but y's address agrees
    assert a4[-3:-1] == a1[-3:-1] == want
    assert a4[6:] == a1[6:] and a4[:5] == a1[:5]
    assert BS.block_sparse_matmul.launches == n1 + 1
    assert BS.block_sparse_matmul_col.launches == n4 + 1


def test_b4_refuses_misaligned_x_before_any_launch(no_launch):
    args = _operands()
    with pytest.raises(ValueError, match="16-byte aligned"):
        BS.block_sparse_matmul_col(_x(False), *args)
    assert no_launch == []
    with pytest.raises(RuntimeError, match="launch reached"):
        BS.block_sparse_matmul_col(_x(True), *args)
    assert no_launch == ["block_sparse_col"]


# the host picks B1's, B2's and B4's body (``body_plan``) and counts what it
# handed the C entry: bf16 x against an int8 payload runs wgmma in
# launch_plan's regime, any other pair runs the CUDA-core body (bm 0)


@pytest.mark.parametrize("x_dtype,quant", [(torch.bfloat16, True), (torch.float32, True),
                                           (torch.bfloat16, False), (torch.float32, False)])
@pytest.mark.parametrize("M", [8, 2032])
def test_wrappers_launch_and_count_the_body_they_pick(x_dtype, quant, M, monkeypatch):
    libs = {}
    monkeypatch.setattr(build, "load", lambda name: libs.setdefault(name, _Lib()))
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(BS, "sm_count", lambda device: H100_SMS)
    gen = torch.Generator().manual_seed(1)
    packs = [pack_block_sparse(torch.randn((256, 256), generator=gen),
                               PlanConfig(q_prune=0.5), quant=quant) for _ in range(2)]
    (b, r, c, s), (ub, ur, uc, us) = [(p.blocks, p.block_rows, p.counts, p.scales)
                                       for p in packs]
    base = torch.zeros(M * 256 + 8, dtype=x_dtype)
    x = base[8:].view(M, 256).as_subclass(_OnCard)
    wgmma = x_dtype == torch.bfloat16 and quant
    want = BS.launch_plan(M, *r.shape, H100_SMS) if wgmma else (0, 1)
    fns = (BS.block_sparse_matmul, BS.block_sparse_matmul_col, FG.fused_gate_up)
    before = [(f.launches, f.fma_launches) for f in fns]
    BS.block_sparse_matmul(x, b, r, c, s)
    BS.block_sparse_matmul_col(x, b, r, c, s)
    FG.fused_gate_up(x, (b, r, c), (ub, ur, uc), s, us)
    (_, a1), = libs["block_sparse"].calls
    (_, a4), = libs["block_sparse_col"].calls
    (_, a2), = libs["fused_gate_up"].calls
    # B1/B4: ..., bm, split, stream; B2: ..., bm, split, n_experts, stream
    assert a1[-3:-1] == a4[-3:-1] == a2[-4:-2] == want
    for f, (n, n_fma) in zip(fns, before):
        assert (f.launches, f.fma_launches) == (n + 1, n_fma + (not wgmma))
