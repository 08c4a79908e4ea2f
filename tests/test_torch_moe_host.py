"""Host side of B1, B2 and B4 over a stack of experts (a MoE layer's
``(E, d, f)`` leaves, one launch over a grid z axis of E): the regime
``launch_plan`` picks at granite-moe-1b-a400m's and qwen2-moe-a2.7b's
expert leaves, a cluster's CTAs never leaving their expert, the arguments
a stacked launch hands its C entry and the counters it moves, the
refusals of mismatched stacks before anything is built, and the
weight-plan dispatch of every stacked representation.  Nothing here needs
a card: the wrappers' kernel branch is taken by CPU tensors that claim to
lie on the card, and the libraries are stood in for."""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import weight_plan as TW
from repro_torch.kernels import block_sparse as BS
from repro_torch.kernels import build
from repro_torch.kernels import fused_gate_up as FG
from repro_torch.kernels import ops

H100_SMS = 132
# a 2032-token prefill: G = 508, capacity ceil(508 * K / E * 1.25), 4 groups
PREFILL_M = {"granite-moe-1b-a400m": 4 * 159, "qwen2-moe-a2.7b": 4 * 43}


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
    monkeypatch.setattr(BS, "sm_count", lambda device: H100_SMS)
    return libs


def _expert_stacks(arch: str) -> dict:
    """name -> (E, K, N) of one layer's expert stacks at full width."""
    c = get_config(arch)
    E, d, f = c.moe.n_experts_padded, c.d_model, c.moe.expert_d_ff
    return {"w_gate": (E, d, f), "w_up": (E, d, f), "w_down": (E, f, d)}


def _stack(E, K, N, mb, *, scales=True, on_card=True):
    """Zero operands of a packed stack of E (K, N) weights with mb slots."""
    n_cols = N // 128
    wrap = (lambda t: t.as_subclass(_OnCard)) if on_card else (lambda t: t)
    blocks = wrap(torch.zeros((E, n_cols * mb, 128, 128), dtype=torch.int8))
    rows = wrap(torch.zeros((E, n_cols, mb), dtype=torch.int32))
    counts = wrap(torch.full((E, n_cols), mb, dtype=torch.int32))
    s = wrap(torch.ones((E, N))) if scales else None
    return blocks, rows, counts, s


def _x(E, M, K):
    base = torch.zeros(E * M * K + 8, dtype=torch.bfloat16)
    return base[8:].view(E, M, K).as_subclass(_OnCard)


# ---------------------------------------------------------------------------
# the regime at the experts' leaves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(PREFILL_M))
def test_launch_plan_at_the_expert_stacks(arch):
    """Decode (M 8): one 64-row tile; 32 x 4 (granite) to 64 x 16 (qwen2)
    CTAs already fill three quarters of the card, so no cluster split.
    A 2032-token prefill (M 636 / 172 an expert): 128-row tiles."""
    for E, K, N in _expert_stacks(arch).values():
        n_cols = N // 128
        for mb in sorted({1, K // 256, K // 128}):
            assert BS.launch_plan(8, n_cols, mb, H100_SMS, E) == (64, 1)
            assert BS.launch_plan(PREFILL_M[arch], n_cols, mb, H100_SMS, E) == (128, 1)
            # one expert alone would split its columns over a cluster
            assert (BS.launch_plan(8, n_cols, mb, H100_SMS)[1] > 1) == (mb > 1)


@pytest.mark.parametrize("n_stack", [1, 2, 3, 8, 64])
@pytest.mark.parametrize("n_cols,mb", [(1, 8), (2, 16), (4, 8), (11, 16), (16, 11)])
def test_a_stack_splits_within_the_cards_clusters(n_cols, mb, n_stack):
    """At decode the split counts every expert's columns: a stack's clusters
    fit three quarters of the SMs unless one CTA per column is already
    more, and a larger stack never splits wider."""
    bm, split = BS.launch_plan(8, n_cols, mb, H100_SMS, n_stack)
    assert bm == 64 and 1 <= split <= min(BS.MAX_SPLIT, mb)
    assert n_stack * n_cols * split <= max(3 * H100_SMS // 4, n_stack * n_cols)
    assert split <= BS.launch_plan(8, n_cols, mb, H100_SMS, max(1, n_stack // 2))[1]


@pytest.mark.parametrize("n_stack,n_cols,mb", [(2, 2, 8), (3, 1, 5), (2, 4, 3)])
def test_a_cluster_never_leaves_its_expert(n_stack, n_cols, mb):
    """The stacked grid (n_cols * split, tiles, E) with clusters of (split,
    1, 1), as ``wgmma_column.cuh``'s launch_column builds it and its column
    body indexes it: a cluster's CTAs share one expert (blockIdx.z) and one
    column (x / split), and every slot of every (expert, column) goes to
    exactly one rank (slot % split)."""
    _, split = BS.launch_plan(8, n_cols, mb, H100_SMS, n_stack)
    assert split > 1
    members = {}
    for z in range(n_stack):
        for x in range(n_cols * split):
            members.setdefault((z, x // split), []).append(x % split)
    assert len(members) == n_stack * n_cols
    for (z, j), ranks in members.items():
        assert ranks == list(range(split))
        owners = [[r for r in ranks if s % split == r] for s in range(mb)]
        assert all(len(o) == 1 for o in owners)


# ---------------------------------------------------------------------------
# stacked launches: arguments, counters, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [8, 172])
def test_stacked_b1_b4_b2_launch_once_with_their_stack(fake_lib, M):
    E, K, N, mb = 4, 256, 384, 2
    x = _x(E, M, K)
    w = _stack(E, K, N, mb)
    want = BS.launch_plan(M, N // 128, mb, H100_SMS, E)
    before = {f: (f.launches, f.stacked_launches, f.stacked_experts)
              for f in (BS.block_sparse_matmul, BS.block_sparse_matmul_col, FG.fused_gate_up)}
    y1 = BS.block_sparse_matmul(x, *w)
    y4 = BS.block_sparse_matmul_col(x, *w)
    y2 = FG.fused_gate_up(x, w[:3], w[:3], w[3], w[3])
    assert tuple(y1.shape) == tuple(y4.shape) == tuple(y2.shape) == (E, M, N)
    (e1, a1), = fake_lib["block_sparse"].calls
    (e4, a4), = fake_lib["block_sparse_col"].calls
    (e2, a2), = fake_lib["fused_gate_up"].calls
    # x, blocks, rows, counts, scales, y, M, K, N, mb, n_experts, x_dtype, w_dtype, bm,
    # split, stream
    assert a1[6:11] == (M, K, N, mb, E) and a1[-3:-1] == want
    assert a4[6:] == a1[6:] and a4[:5] == a1[:5]
    # ..., y, M, K, N, mb_g, mb_u, act, x_dtype, w_dtype, bm, split, n_experts, stream
    assert a2[10:15] == (M, K, N, mb, mb) and a2[18:21] == (*want, E)
    for f, (n, sl, se) in before.items():
        assert (f.launches, f.stacked_launches, f.stacked_experts) == (n + 1, sl + 1, se + E)


def test_an_unstacked_launch_covers_one_expert(fake_lib):
    x = _x(1, 8, 256)[0]
    w = [t[0] for t in _stack(1, 256, 128, 2)]
    n, sl, se = (BS.block_sparse_matmul.launches, BS.block_sparse_matmul.stacked_launches,
                 BS.block_sparse_matmul.stacked_experts)
    BS.block_sparse_matmul(x, *w)
    (_, args), = fake_lib["block_sparse"].calls
    assert args[10] == 1
    assert (BS.block_sparse_matmul.launches, BS.block_sparse_matmul.stacked_launches,
            BS.block_sparse_matmul.stacked_experts) == (n + 1, sl, se)


def _mismatches():
    E, K, N, mb = 4, 256, 256, 2
    good = _stack(E, K, N, mb)
    other = _stack(E + 1, K, N, mb)
    yield "blocks", (other[0], *good[1:])
    yield "rows", (good[0], other[1], *good[2:])
    yield "counts", (*good[:2], other[2], good[3])
    yield "scales", (*good[:3], other[3])
    yield "unstacked", tuple(t[0] for t in good)


@pytest.mark.parametrize("case", [c for c, _ in _mismatches()])
@pytest.mark.parametrize("kernel", ["B1", "B4", "B2"])
def test_mismatched_stacks_are_refused_before_any_build(fake_lib, kernel, case):
    ops_ = dict(_mismatches())[case]
    x = _x(4, 8, 256)
    with pytest.raises(ValueError):
        if kernel == "B1":
            BS.block_sparse_matmul(x, *ops_)
        elif kernel == "B4":
            BS.block_sparse_matmul_col(x, *ops_)
        else:
            good = _stack(4, 256, 256, 2)
            FG.fused_gate_up(x, good[:3], ops_[:3], good[3], ops_[3])
    assert fake_lib == {}


def test_b2_refuses_a_pair_whose_stacks_differ(fake_lib):
    x = _x(4, 8, 256)
    g, u = _stack(4, 256, 256, 2), _stack(3, 256, 256, 2)
    with pytest.raises(ValueError):
        FG.fused_gate_up(x, g[:3], u[:3], g[3], u[3])
    assert fake_lib == {}


# ---------------------------------------------------------------------------
# the weight-plan dispatch of stacked experts
# ---------------------------------------------------------------------------


def _packed_stack(E=3, K=256, N=256, walk=True):
    w = torch.randn((E, K, N), generator=torch.Generator().manual_seed(E))
    p = TW.pack_block_sparse(w, TW.PlanConfig(q_prune=0.5), quant=True)
    if not walk:
        p = TW.dataclasses.replace(p, walk=None)
    return w, p


def _on_card(p: TW.PackedLinear) -> TW.PackedLinear:
    wrap = lambda t: None if t is None else t.as_subclass(_OnCard)  # noqa: E731
    return TW.dataclasses.replace(p, blocks=wrap(p.blocks), block_rows=wrap(p.block_rows),
                                  counts=wrap(p.counts), scales=wrap(p.scales))


@pytest.mark.parametrize("walk,entry", [(True, "block_sparse"), (False, "block_sparse_col")])
def test_a_packed_stack_is_one_launch_of_b1_or_b4(fake_lib, walk, entry):
    _, p = _packed_stack(walk=walk)
    x = torch.zeros((3, 2, 5, 256), dtype=torch.bfloat16).as_subclass(_OnCard)
    y = TW.apply_linear(x, _on_card(p))
    assert tuple(y.shape) == (3, 2, 5, 256)
    assert list(fake_lib) == [entry]
    (_, args), = fake_lib[entry].calls
    assert args[6] == 10 and args[10] == 3  # M = 2 * 5 rows an expert, 3 experts


def test_a_packed_pair_stack_is_one_launch_of_b2(fake_lib):
    (_, g), (_, u) = _packed_stack(), _packed_stack()
    x = torch.zeros((3, 7, 256), dtype=torch.bfloat16).as_subclass(_OnCard)
    y = TW.apply_gate_up(x, _on_card(g), _on_card(u), "silu")
    assert tuple(y.shape) == (3, 7, 256)
    (_, args), = fake_lib["fused_gate_up"].calls
    assert args[10] == 7 and args[20] == 3


def test_a_stack_and_a_single_weight_are_not_a_fusable_pair():
    (_, g), (_, u) = _packed_stack(E=1), _packed_stack(E=1)
    single = TW.dataclasses.replace(u, blocks=u.blocks[0], block_rows=u.block_rows[0],
                                    counts=u.counts[0], scales=u.scales[0])
    assert TW._fusable_pair(g, u) and not TW._fusable_pair(g, single)


def test_a_dense_stack_multiplies_each_expert_by_its_own_weight():
    """x (E, nG, C, d) against w (E, d, f): each expert's rows by its own
    weight (``x @ w`` would broadcast (nG, C) against E)."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn((4, 16, 8), generator=g)
    x = torch.randn((4, 3, 5, 16), generator=g)
    y = TW.apply_linear(x, w)
    assert tuple(y.shape) == (4, 3, 5, 8)
    for e in range(4):
        torch.testing.assert_close(y[e], x[e] @ w[e])


def test_an_int8_stack_runs_b5_once_per_expert(monkeypatch):
    w = torch.randn((3, 64, 32), generator=torch.Generator().manual_seed(1))
    q = TW.quantize_leaf(w)
    calls = []
    inner = ops.quant_matmul

    def spy(x2, node, *a, **k):
        calls.append((tuple(x2.shape), tuple(node.q.shape)))
        return inner(x2, node, *a, **k)

    monkeypatch.setattr(ops, "quant_matmul", spy)
    x = torch.randn((3, 2, 4, 64), generator=torch.Generator().manual_seed(2))
    y = TW.apply_linear(x, q)
    assert calls == [((8, 64), (64, 32))] * 3
    for e in range(3):
        want = (x[e] @ q.q[e].float()) * q.s[e]
        torch.testing.assert_close(y[e], want, rtol=1e-5, atol=1e-5)
