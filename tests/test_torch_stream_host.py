"""Host side of the stream kernels B7 (``csrc/batched_ffn.cu``) and B8
(``q78_matmul`` in ``csrc/quant_matmul.cu``), which share
``csrc/stream_tile.cuh``: ``batched_ffn.stream_plan`` for every layer of
the paper's four FC nets at Table 2's batches, the copy width it reads off
the weight's address and row stride, the shared-memory mirror, and the
refusals the wrappers make before anything is built or launched.  Nothing
here needs a card: every choice comes from dtypes, shapes, the weight's
address and the card's resident-cluster counts, which these tests pass as
an H100 reports them."""

import pytest
import torch

from repro_torch.kernels import batched_ffn as BF
from repro_torch.kernels import build
from repro_torch.kernels import quant_matmul as QM

H100_SMS = 132
# clusters of 1..8 CTAs (one CTA an SM) an H100 SXM keeps resident:
# cudaOccupancyMaxActiveClusters, as chip_smoke.py logs it on the card
H100_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)
# every layer (K, N) of the paper's four FC nets (Table 2)
FCNET_LAYERS = [(784, 800), (800, 800), (800, 10), (561, 1200), (1200, 300), (300, 6),
                (561, 2000), (2000, 1500), (1500, 750), (750, 300)]
KINDS = list(BF.STREAM_KINDS)


def _ctas(plan, N, kind):
    """CTAs of a plan's grid: strips x split x row tiles."""
    return -(-N * BF.STREAM_KINDS[kind][0] // plan.sb) * plan.split * plan.tiles_y


def _check_plan(kind, M, K, N, ldw, addr, plan):
    eb, quantum = BF.STREAM_KINDS[kind]
    assert plan.sb in BF.STRIP_BYTES and 1 <= plan.split <= BF.STREAM_MAX_SPLIT
    # rows: B7 the smallest power of two >= M (at most 32), B8 16 or 32
    want_bm = (16 if M <= 16 else 32) if kind == "q78" else min(32, 1 << (M - 1).bit_length())
    assert plan.bm == want_bm and plan.tiles_y == -(-M // plan.bm)
    # the ranks' slices cover K, each of whole quanta, none empty
    assert plan.ks % quantum == 0 and plan.split * plan.ks >= K
    assert plan.split == 1 or (plan.split - 1) * plan.ks < K
    # one wave of the card's resident clusters, in the shared memory a CTA has
    assert _ctas(plan, N, kind) <= H100_CLUSTERS[plan.split - 1] * plan.split
    assert plan.smem == BF.stream_smem_bytes(kind, plan.bm, plan.sb, plan.ks) <= BF.MAX_SMEM
    # the copy width divides the address and the row stride, and is the widest that does
    row = ldw * eb
    assert addr % plan.width == 0 and row % plan.width == 0
    assert all(addr % w or row % w for w in BF.COPY_WIDTHS if w > plan.width)


@pytest.mark.parametrize("K,N", FCNET_LAYERS)
@pytest.mark.parametrize("kind", KINDS)
def test_stream_plan_fcnet_layers_at_every_batch(kind, K, N):
    for M in range(1, 33):
        plan = BF.stream_plan(kind, M, K, N, N, 0, H100_CLUSTERS)
        _check_plan(kind, M, K, N, N, 0, plan)


def _one_wave_candidates(kind, M, K, N):
    """Every (sb, split) the plan may take: x's slice fits, every rank has
    rows, one wave; with its weight bytes per CTA."""
    eb, quantum = BF.STREAM_KINDS[kind]
    bm = BF.pick_bm(kind, M)
    for sb in BF.STRIP_BYTES:
        for split in range(1, BF.STREAM_MAX_SPLIT + 1):
            ks = max(quantum, -(-(-(-K // split)) // quantum) * quantum)
            if split > 1 and (split - 1) * ks >= K:
                continue
            if BF.stream_smem_bytes(kind, bm, sb, ks) > BF.MAX_SMEM:
                continue
            ctas = -(-N * eb // sb) * split * -(-M // bm)
            if ctas <= H100_CLUSTERS[split - 1] * split:
                yield sb, split, ks * sb, ctas


@pytest.mark.parametrize("M", [1, 16, 32])
@pytest.mark.parametrize("K,N", FCNET_LAYERS)
@pytest.mark.parametrize("kind", KINDS)
def test_stream_plan_takes_the_lightest_one_wave_grid(kind, K, N, M):
    """No one-wave grid streams fewer weight bytes per CTA; among equals the
    plan has the fewest CTAs."""
    plan = BF.stream_plan(kind, M, K, N, N, 0, H100_CLUSTERS)
    cands = list(_one_wave_candidates(kind, M, K, N))
    best = min((b, c) for _, _, b, c in cands)
    assert (plan.ks * plan.sb, _ctas(plan, N, kind)) == best


@pytest.mark.parametrize("kind", KINDS)
def test_stream_plan_spreads_a_large_layer_over_most_sms(kind):
    """Layers of 1 MB of weights or more reach 60% of the SMs or more at
    every batch; the rest stay idle because a strip is 128 bytes or wider, a
    cluster 8 CTAs or fewer, and 3-8 CTA clusters fill only 102-120 SMs."""
    eb = BF.STREAM_KINDS[kind][0]
    large = [(K, N) for K, N in FCNET_LAYERS if K * N * eb >= 1 << 20]
    assert len(large) >= 6
    for K, N in large:
        for M in range(1, 33):
            plan = BF.stream_plan(kind, M, K, N, N, 0, H100_CLUSTERS)
            assert _ctas(plan, N, kind) >= 0.6 * H100_SMS, (K, N, M)


def test_stream_plan_widest_layer_fits_one_wave_of_96_ctas():
    """HAR-6's 2000 x 1500 (the rows PERF.md reports)."""
    for kind, (sb, split) in (("fp32", (128, 2)), ("q78", (128, 4))):
        plan = BF.stream_plan(kind, 16, 2000, 1500, 1500, 0, H100_CLUSTERS)
        assert (plan.sb, plan.split) == (sb, split)
        assert _ctas(plan, 1500, kind) in (94, 96)


def test_stream_plan_refuses_a_slice_that_does_not_fit():
    with pytest.raises(ValueError, match="too deep"):
        BF.stream_plan("fp32", 32, 20000, 1500, 1500, 0, H100_CLUSTERS)
    with pytest.raises(ValueError, match="too deep"):
        BF.stream_plan("q78", 32, 20000, 1500, 1500, 0, H100_CLUSTERS)


def test_stream_plan_tiles_rows_past_32():
    plan = BF.stream_plan("fp32", 33, 130, 65, 65, 0, H100_CLUSTERS)
    assert (plan.bm, plan.tiles_y) == (32, 2)
    plan = BF.stream_plan("q78", 33, 130, 65, 65, 0, H100_CLUSTERS)
    assert (plan.bm, plan.tiles_y) == (32, 2)


# (address mod 16, row stride in bytes, K) -> the copy width
@pytest.mark.parametrize("addr,row,K,width", [
    (0, 6000, 2000, 16),   # fp32 N 1500
    (0, 3000, 1500, 8),    # fp32 N 750, int16 N 1500
    (4, 6016, 300, 4),     # fp32, a section one column in
    (0, 20, 800, 4),       # int16 N 10
    (0, 12, 300, 4),       # int16 N 6
    (8, 3000, 2000, 8),    # int16 section 114 * 2 columns in (456 bytes)
    (4, 3000, 2000, 4),    # int16 section 114 columns in (228 bytes)
    (2, 74, 70, 2),        # int16 N 37, one column in
    (0, 74, 1, 16),        # one row: the stride is never used
])
def test_copy_width_is_the_widest_the_address_and_stride_allow(addr, row, K, width):
    assert BF.copy_width(addr, row, K, 2) == width


@pytest.mark.parametrize("N", [800, 1500, 2000, 750])
def test_copy_width_of_the_sectioned_forward(N):
    """forward_q78_sectioned reads w_q[:, 114 i : 114 (i + 1)] in place: 228 i
    bytes on from a 512-byte aligned allocation."""
    for i in range(-(-N // 114)):
        addr = 228 * i
        w = BF.copy_width(addr, 2 * N, 784, 2)
        assert addr % w == 0 and (2 * N) % w == 0
        if i % 2:
            assert w == 4


def test_fp32_weights_never_copy_below_4_bytes():
    for addr in range(0, 16, 4):
        for N in (6, 10, 300, 750, 800, 1500):
            assert BF.copy_width(addr, 4 * N, 100, 4) >= 4
    with pytest.raises(ValueError):
        BF.copy_width(2, 4 * 10, 100, 4)


def test_smem_grows_with_the_slice_and_the_rows():
    for kind in KINDS:
        for sb in BF.STRIP_BYTES:
            rows = BF.stage_rows(sb)
            base = BF.stream_smem_bytes(kind, 16, sb, rows)
            assert BF.stream_smem_bytes(kind, 16, sb, 4 * rows) > base
            assert BF.stream_smem_bytes(kind, 32, sb, 4 * rows) > \
                BF.stream_smem_bytes(kind, 16, sb, 4 * rows)
    # bf16 x keeps its raw rows beside the fp32 slice
    assert BF.stream_smem_bytes("bf16", 16, 128, 1000) > BF.stream_smem_bytes("fp32", 16, 128,
                                                                               1000)


# -- the wrappers, before any build ----------------------------------------------------


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
    libs = {}
    monkeypatch.setattr(build, "load", lambda name: libs.setdefault(name, _Lib()))
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(BF, "resident_clusters", lambda device: H100_CLUSTERS)
    monkeypatch.setattr(QM, "resident_clusters", lambda device: H100_CLUSTERS)
    return libs


@pytest.fixture
def no_launch(monkeypatch):
    loads = []

    def load(name):
        loads.append(name)
        raise RuntimeError("launch reached")

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(BF, "resident_clusters", lambda device: H100_CLUSTERS)
    monkeypatch.setattr(QM, "resident_clusters", lambda device: H100_CLUSTERS)
    return loads


def _card(t):
    return t.as_subclass(_OnCard)


@pytest.mark.parametrize("case", ["x int32", "w bf16", "b float64", "b short", "w strided",
                                  "K mismatch", "K too deep"])
def test_batched_ffn_refuses_before_any_build(no_launch, case):
    x, w, b = torch.zeros(4, 64), torch.zeros(64, 8), torch.zeros(8)
    if case == "x int32":
        x = x.to(torch.int32)
    elif case == "w bf16":
        w = w.to(torch.bfloat16)
    elif case == "b float64":
        b = b.double()
    elif case == "b short":
        b = torch.zeros(7)
    elif case == "w strided":
        w = torch.zeros(64, 16)[:, ::2]
    elif case == "K mismatch":
        w = torch.zeros(63, 8)
    else:
        x, w = torch.zeros(32, 20000), torch.zeros(20000, 8)
    with pytest.raises(ValueError):
        BF.batched_ffn(_card(x), _card(w), _card(b))
    assert no_launch == []


@pytest.mark.parametrize("case", ["a int32", "w int8", "w strided", "K too deep"])
def test_q78_matmul_refuses_before_any_build(no_launch, case):
    a, w = torch.zeros(4, 64, dtype=torch.int16), torch.zeros(64, 8, dtype=torch.int16)
    if case == "a int32":
        a = a.to(torch.int32)
    elif case == "w int8":
        w = w.to(torch.int8)
    elif case == "w strided":
        w = torch.zeros(64, 16, dtype=torch.int16)[:, ::2]
    else:
        a, w = torch.zeros(32, 20000, dtype=torch.int16), torch.zeros(20000, 8, dtype=torch.int16)
    with pytest.raises(ValueError):
        QM.q78_matmul(_card(a), _card(w))
    assert no_launch == []


@pytest.mark.parametrize("M", [1, 16, 32])
def test_batched_ffn_launches_its_plan_and_counts_the_width(fake_lib, M):
    K, N = 2000, 1500
    x, w, b = _card(torch.zeros(M, K)), _card(torch.zeros(K, N)), _card(torch.zeros(N))
    before = (BF.batched_ffn.launches, dict(BF.batched_ffn.width_launches))
    BF.batched_ffn(x, w, b, activation="relu")
    (entry, args), = fake_lib["batched_ffn"].calls
    plan = BF.stream_plan("fp32", M, K, N, N, w.data_ptr(), H100_CLUSTERS)
    assert entry == "batched_ffn_launch"
    # ..., act, x_dtype, sb, split, width, ks, stream
    assert args[-5:-1] == (plan.sb, plan.split, plan.width, plan.ks)
    assert BF.batched_ffn.launches == before[0] + 1
    assert BF.batched_ffn.width_launches == {**before[1], plan.width: before[1][plan.width] + 1}


@pytest.mark.parametrize("offset,width", [(0, 8), (114, 4), (228, 8)])
def test_q78_matmul_launches_a_section_at_its_width(fake_lib, offset, width):
    """A 2000 x 1500 int16 weight (3000-byte rows) read in place from a
    column section of the sectioned forward."""
    base = torch.zeros(2000, 1500, dtype=torch.int16)
    assert base.data_ptr() % 16 == 0
    w = _card(base[:, offset:offset + 114])
    a = _card(torch.zeros(16, 2000, dtype=torch.int16))
    before = dict(QM.q78_matmul.width_launches)
    QM.q78_matmul(a, w)
    (entry, args), = fake_lib["quant_matmul"].calls
    assert entry == "q78_matmul_launch"
    assert args[-3] == width  # ..., sb, split, width, ks, stream
    assert QM.q78_matmul.width_launches == {**before, width: before[width] + 1}


def test_resident_clusters_asks_the_card_once(monkeypatch):
    lib = _Lib()
    counts = iter(range(1, 100))
    lib.stream_max_clusters = lambda split, smem: next(counts)
    loads = []
    monkeypatch.setattr(build, "load", lambda name: loads.append(name) or lib)
    monkeypatch.setattr(BF, "_RESIDENT", {})
    first = BF.resident_clusters("cuda:0")
    assert first == tuple(range(1, 9)) and BF.resident_clusters("cuda:0") == first
    assert loads == ["batched_ffn"]
    lib.stream_max_clusters = lambda split, smem: -1
    with pytest.raises(RuntimeError, match="cudaOccupancyMaxActiveClusters"):
        BF.resident_clusters("cuda:1")
