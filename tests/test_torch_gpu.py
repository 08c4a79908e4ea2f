"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and the CUDA toolkit (nvcc); they carry the
``gpu`` marker and skip elsewhere.  ``python3 chip_smoke.py`` is the
authoritative check on the card (full-width shapes, timings, the serving
path); these cover the wrappers' contracts at small shapes:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: kernel and plain version both accumulate in fp32 and round to
the output dtype once, in another order -- fp32 outputs agree to 1e-5
relative (1e-4 for the dense B5/B7 products over K up to 2000), bf16
outputs to about one bf16 ulp (held to 1e-2 of the max).  B8 is integer
arithmetic and is held to exact equality."""

import pytest
import torch

from repro_torch.core.weight_plan import PlanConfig, pack_block_sparse
from repro_torch.kernels import batched_ffn as BF
from repro_torch.kernels import block_sparse as BS
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_gate_up as FG
from repro_torch.kernels import quant_matmul as QM

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


# B1 and B2 (csrc/wgmma_column.cuh): bf16 x with an int8 payload runs
# wgmma (exact bf16 products, fp32 sums: about one bf16 ulp of the output,
# held to 1e-2 of the max), in the decode regime up to M = 64 (a cluster
# split of each column's slots) and the prefill regime above (128-row
# tiles); the M edges straddle both tiles.  Pairs with an fp32 operand run
# fp32 FMAs (1e-5 for fp32 x; bf16 x rounds its output to bf16: 1e-2).
# Columns keep 0, 1, ... blocks, some fewer than the split (6 at decode
# here, the largest count), so ranks with no slot occur.
M_EDGES = [1, 8, 63, 64, 65, 127, 128, 129, 2032]
PAIRS = [(torch.bfloat16, True, 1e-2), (torch.float32, True, 1e-5),
         (torch.bfloat16, False, 1e-2), (torch.float32, False, 1e-5)]
GATE_COUNTS = [0, 1, 2, 3, 6, 5, 4, 1]
UP_COUNTS = [2, 0, 4, 4, 1, 3, 0, 1]  # mb 4 against the gate's 6


def _with_counts(counts, K, seed, device, quant):
    """A packed (K, 128 * len(counts)) weight whose block-column c keeps
    counts[c] blocks: the other blocks are zero, and q_prune prunes just
    those."""
    nrb = K // 128
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((K, 128 * len(counts)), generator=g, device=device) / K ** 0.5
    for c, n in enumerate(counts):
        drop = torch.randperm(nrb, generator=g, device=device)[n:]
        for r in drop.tolist():
            w[r * 128:(r + 1) * 128, c * 128:(c + 1) * 128] = 0.0
    q = (nrb * len(counts) - sum(counts)) / (nrb * len(counts))
    p = pack_block_sparse(w, PlanConfig(q_prune=q), quant=quant)
    assert p.counts.tolist() == counts
    return p


@pytest.mark.parametrize("dtype,quant,rtol", PAIRS)
@pytest.mark.parametrize("M", M_EDGES)
def test_b1_regimes_match_plain(cuda, M, dtype, quant, rtol):
    p = _with_counts(GATE_COUNTS, 768, 6, cuda, quant)
    x = torch.randn((M, 768), device=cuda).to(dtype)
    args = (p.blocks, p.block_rows, p.counts, p.scales)
    n = BS.block_sparse_matmul.launches
    y = BS.block_sparse_matmul(x, *args)
    assert BS.block_sparse_matmul.launches == n + 1 and y.dtype == dtype
    ref = BS.block_sparse_matmul(x, *args, use_kernel=False)
    torch.cuda.synchronize()
    _close(y, ref, rtol)
    assert torch.all(y[:, :128] == 0)


@pytest.mark.parametrize("dtype,quant,rtol", PAIRS)
@pytest.mark.parametrize("M", M_EDGES)
def test_b2_regimes_match_plain(cuda, M, dtype, quant, rtol):
    g = _with_counts(GATE_COUNTS, 768, 7, cuda, quant)
    u = _with_counts(UP_COUNTS, 768, 8, cuda, quant)
    assert g.block_rows.shape[1] != u.block_rows.shape[1]
    x = torch.randn((M, 768), device=cuda).to(dtype)
    args = ((g.blocks, g.block_rows, g.counts), (u.blocks, u.block_rows, u.counts),
            g.scales, u.scales)
    n = FG.fused_gate_up.launches
    y = FG.fused_gate_up(x, *args)
    assert FG.fused_gate_up.launches == n + 1 and y.dtype == dtype
    ref = FG.fused_gate_up(x, *args, use_kernel=False)
    torch.cuda.synchronize()
    _close(y, ref, rtol)
    assert torch.all(y[:, :256] == 0)  # gate or up keeps no block


@pytest.mark.parametrize("M", [8, 2032])
def test_b1_b2_launches_are_bitwise_deterministic(cuda, M):
    g = _with_counts(GATE_COUNTS, 768, 9, cuda, True)
    u = _with_counts(UP_COUNTS, 768, 10, cuda, True)
    x = torch.randn((M, 768), device=cuda).to(torch.bfloat16)
    b1 = [BS.block_sparse_matmul(x, g.blocks, g.block_rows, g.counts, g.scales)
          for _ in range(2)]
    pair = ((g.blocks, g.block_rows, g.counts), (u.blocks, u.block_rows, u.counts),
            g.scales, u.scales)
    b2 = [FG.fused_gate_up(x, *pair) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(b1[0], b1[1]) and torch.equal(b2[0], b2[1])


# B4: bf16 x with an int8 payload multiplies on the tensor cores (exact
# bf16 products, fp32 sums): about one bf16 ulp of the output, 1e-2 of the
# max; fp32 pairs run fp32 FMAs (1e-5).  One layer's full-width shapes at
# decode, a ragged M, a multi-tile prefill, and a small ragged weight.
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("M,K,N", [(8, 2048, 2048), (8, 2048, 256), (8, 5632, 2048),
                                   (37, 2048, 2048), (200, 384, 256), (1, 384, 256)])
def test_block_sparse_col_kernel_matches_plain(cuda, M, K, N, quant, dtype, rtol):
    p = _packed(K, N, quant, 4, cuda)
    x = torch.randn((M, K), device=cuda).to(dtype)
    args = (p.blocks, p.block_rows, p.counts, p.scales)
    n = BS.block_sparse_matmul_col.launches
    y = BS.block_sparse_matmul_col(x, *args)
    assert BS.block_sparse_matmul_col.launches == n + 1 and y.dtype == dtype
    ref = BS.block_sparse_matmul_col(x, *args, use_kernel=False)
    assert BS.block_sparse_matmul_col.launches == n + 1
    torch.cuda.synchronize()
    _close(y, ref, rtol)


# B4 runs B1's column body (csrc/wgmma_column.cuh) in B1's regime, so on
# the same operands its output equals B1's bit for bit -- at the decode
# batches, across both regimes' tile edges and at the longest prefill, for
# one layer's wq, wk and w_down shapes; each also within 1e-2 of the plain
# version, and a block-column that keeps no block writes zeros
B4_MS = [1, 8, 40, 63, 64, 65, 127, 128, 129, 2032]


@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 256), (5632, 2048)])
@pytest.mark.parametrize("M", B4_MS)
def test_b4_equals_b1_bit_for_bit(cuda, M, K, N):
    p = _packed(K, N, True, 11, cuda)
    x = torch.randn((M, K), device=cuda).to(torch.bfloat16)
    args = (p.blocks, p.block_rows, p.counts, p.scales)
    y4 = BS.block_sparse_matmul_col(x, *args)
    y1 = BS.block_sparse_matmul(x, *args)
    ref = BS.block_sparse_matmul_col(x, *args, use_kernel=False)
    torch.cuda.synchronize()
    assert torch.equal(y4, y1)
    _close(y4, ref, 1e-2)


@pytest.mark.parametrize("M", B4_MS)
def test_b4_empty_column_writes_zeros_at_every_regime(cuda, M):
    p = _with_counts(GATE_COUNTS, 768, 12, cuda, True)
    x = torch.randn((M, 768), device=cuda).to(torch.bfloat16)
    args = (p.blocks, p.block_rows, p.counts, p.scales)
    y = BS.block_sparse_matmul_col(x, *args)
    ref = BS.block_sparse_matmul_col(x, *args, use_kernel=False)
    torch.cuda.synchronize()
    assert torch.all(y[:, :128] == 0)
    _close(y, ref, 1e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_sparse_col_empty_column_writes_zeros(cuda, dtype):
    w = torch.randn((256, 384), device=cuda)
    w[:, 128:256] = 0.0
    p = pack_block_sparse(w, PlanConfig(q_prune=0.5), quant=True)
    assert int(p.counts[1]) == 0
    x = torch.randn((70, 256), device=cuda).to(dtype)
    y = BS.block_sparse_matmul_col(x, p.blocks, p.block_rows, p.counts, p.scales)
    torch.cuda.synchronize()
    assert torch.all(y[:, 128:256] == 0) and y[:, :128].abs().amax() > 0


def test_block_sparse_col_rejects_what_the_kernel_does_not_take(cuda):
    p = _packed(256, 256, True, 5, cuda)
    x = torch.randn((4, 256), device=cuda).to(torch.bfloat16)
    args = (p.blocks, p.block_rows, p.counts, p.scales)
    misaligned = torch.zeros(4 * 256 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(4, 256)
    for bad_x in (x[:, :128], x.double(), x.t().contiguous().t(), misaligned):
        with pytest.raises(ValueError):
            BS.block_sparse_matmul_col(bad_x, *args)
    small = pack_block_sparse(torch.randn((64, 64), device=cuda),
                              PlanConfig(q_prune=0.5, bk=32, bn=32), quant=True)
    with pytest.raises(ValueError):  # blocks other than 128
        BS.block_sparse_matmul_col(torch.randn((4, 64), device=cuda), small.blocks,
                                   small.block_rows, small.counts, small.scales)
    with pytest.raises(ValueError):
        BS.block_sparse_matmul_col(x, p.blocks.to(torch.int32), *args[1:])


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


# (M, K, N): ragged on every edge, one-row and multi-tile batches, the
# nets' widest layer at B = 1, 16 and 32 (Table 2's batches) and an output
# layer of 6
DENSE_SHAPES = [(5, 70, 37), (1, 561, 300), (33, 130, 65), (16, 2000, 1500), (3, 300, 6),
                (1, 2000, 1500), (32, 2000, 1500)]
# every layer (K, N) of the paper's four FC nets, at B = 1, 16 and 32
FCNET_LAYERS = [(784, 800), (800, 800), (800, 10), (561, 1200), (1200, 300), (300, 6),
                (561, 2000), (2000, 1500), (1500, 750), (750, 300)]


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("activation", ["linear", "relu", "sigmoid", "gelu", "silu"])
@pytest.mark.parametrize("M,K,N", DENSE_SHAPES)
def test_batched_ffn_kernel_matches_plain(cuda, M, K, N, activation, dtype, rtol):
    x = torch.randn((M, K), device=cuda).to(dtype)
    w = torch.randn((K, N), device=cuda) / K ** 0.5
    b = torch.randn((N,), device=cuda)
    n = BF.batched_ffn.launches
    y = BF.batched_ffn(x, w, b, activation=activation)
    assert BF.batched_ffn.launches == n + 1 and y.dtype == dtype and y.shape == (M, N)
    ref = BF.batched_ffn(x, w, b, activation=activation, use_kernel=False)
    torch.cuda.synchronize()
    _close(y, ref, rtol)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("K,N", FCNET_LAYERS)
@pytest.mark.parametrize("M", [1, 16, 32])
def test_batched_ffn_fcnet_layers_match_plain(cuda, M, K, N, dtype, rtol):
    g = torch.Generator(device=cuda).manual_seed(K + N + M)
    x = torch.rand((M, K), generator=g, device=cuda).to(dtype)
    w = torch.randn((K, N), generator=g, device=cuda) * (2.0 / K) ** 0.5
    b = torch.randn((N,), generator=g, device=cuda) * 0.1
    y = BF.batched_ffn(x, w, b, activation="relu")
    torch.cuda.synchronize()
    _close(y, BF.batched_ffn(x, w, b, activation="relu", use_kernel=False), rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 16, 32])
def test_batched_ffn_launches_are_bitwise_deterministic(cuda, M, dtype):
    """Each strip's K sum is split over a cluster and added by rank 0 in
    rank order: two launches give the same bits."""
    x = torch.randn((M, 2000), device=cuda).to(dtype)
    w = torch.randn((2000, 1500), device=cuda) / 2000 ** 0.5
    b = torch.randn((1500,), device=cuda)
    first = BF.batched_ffn(x, w, b, activation="silu")
    second = BF.batched_ffn(x, w, b, activation="silu")
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _stream_plan_of(kind, x, w):
    return BF.stream_plan(kind, x.shape[0], x.shape[1], w.shape[1], w.stride(0), w.data_ptr(),
                          BF.resident_clusters(x.device))


# a weight whose address and row stride allow exactly this copy width:
# (ldw, column offset) for fp32 (N 64) and int16 (N 40) weights
B7_WIDTH_CASES = {16: (1500, 0), 8: (750, 0), 4: (1504, 1)}
B8_WIDTH_CASES = {16: (1600, 0), 8: (1500, 0), 4: (10, 0), 2: (37, 1)}


@pytest.mark.parametrize("width", sorted(B7_WIDTH_CASES))
def test_batched_ffn_counts_its_copy_width(cuda, width):
    ldw, off = B7_WIDTH_CASES[width]
    x = torch.randn((16, 300), device=cuda)
    w = (torch.randn((300, ldw), device=cuda) / 300 ** 0.5)[:, off:off + 64]
    b = torch.randn((64,), device=cuda)
    assert _stream_plan_of("fp32", x, w).width == width
    before = dict(BF.batched_ffn.width_launches)
    y = BF.batched_ffn(x, w, b)
    torch.cuda.synchronize()
    _close(y, BF.batched_ffn(x, w.contiguous(), b, use_kernel=False), 1e-4)
    assert BF.batched_ffn.width_launches == {**before, width: before[width] + 1}


@pytest.mark.parametrize("width", sorted(B8_WIDTH_CASES))
def test_q78_matmul_counts_its_copy_width(cuda, width):
    ldw, off = B8_WIDTH_CASES[width]
    a = torch.randint(-(1 << 15), 1 << 15, (16, 300), device=cuda, dtype=torch.int16)
    w = torch.randint(-(1 << 15), 1 << 15, (300, ldw), device=cuda, dtype=torch.int16)
    w = w[:, off:off + min(40, ldw - off)]
    assert _stream_plan_of("q78", a, w).width == width
    before = dict(QM.q78_matmul.width_launches)
    y = QM.q78_matmul(a, w)
    torch.cuda.synchronize()
    assert torch.equal(y, QM.q78_matmul(a, w.contiguous(), use_kernel=False))
    assert QM.q78_matmul.width_launches == {**before, width: before[width] + 1}


@pytest.mark.parametrize("M,sb,ks", [(1, 128, 196), (16, 256, 400), (32, 512, 252),
                                     (33, 128, 96), (5, 256, 2000)])
def test_stream_smem_matches_the_host_mirror(cuda, M, sb, ks):
    from repro_torch.kernels import build
    lib_b7, lib_b8 = build.load("batched_ffn"), build.load("quant_matmul")
    for kind, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        want = BF.stream_smem_bytes(kind, BF.pick_bm(kind, M), sb, ks)
        assert lib_b7.batched_ffn_smem_bytes(M, sb, ks, build.DTYPE_CODES[dtype]) == want
    want = BF.stream_smem_bytes("q78", BF.pick_bm("q78", M), sb, _round32(ks))
    assert lib_b8.q78_matmul_smem_bytes(M, sb, _round32(ks)) == want


def _round32(k):
    return -(-k // 32) * 32


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("activation", ["linear", "silu"])
@pytest.mark.parametrize("M,K,N", [(5, 70, 37), (8, 2048, 5632), (40, 2048, 1000), (1, 64, 6)])
def test_quant_matmul_kernel_matches_plain(cuda, M, K, N, activation, dtype, rtol):
    x = torch.randn((M, K), device=cuda).to(dtype)
    wq = torch.randint(-127, 128, (K, N), device=cuda, dtype=torch.int8)
    s = torch.rand((N,), device=cuda) * 0.01 + 1e-3
    n = QM.quant_matmul.launches
    y = QM.quant_matmul(x, wq, s, activation=activation)
    assert QM.quant_matmul.launches == n + 1 and y.dtype == dtype
    ref = QM.quant_matmul(x, wq, s, activation=activation, use_kernel=False)
    torch.cuda.synchronize()
    _close(y, ref, rtol)


@pytest.mark.parametrize("M,K,N", DENSE_SHAPES + [(2, 3000, 3)])
def test_q78_matmul_kernel_is_exact(cuda, M, K, N):
    a = torch.randint(-(1 << 15), 1 << 15, (M, K), device=cuda, dtype=torch.int16)
    w = torch.randint(-(1 << 15), 1 << 15, (K, N), device=cuda, dtype=torch.int16)
    n = QM.q78_matmul.launches
    y = QM.q78_matmul(a, w)
    assert QM.q78_matmul.launches == n + 1 and y.dtype == torch.int32
    ref = QM.q78_matmul(a, w, use_kernel=False)
    torch.cuda.synchronize()
    assert torch.equal(y, ref)
    # a column section, read in place through the row stride
    sec = QM.q78_matmul(a, w[:, 1:N - 1]) if N > 2 else None
    if sec is not None:
        torch.cuda.synchronize()
        assert torch.equal(sec, ref[:, 1:N - 1])


@pytest.mark.parametrize("K,N", FCNET_LAYERS)
@pytest.mark.parametrize("M", [1, 16, 32])
def test_q78_matmul_fcnet_layers_are_exact(cuda, M, K, N):
    g = torch.Generator(device=cuda).manual_seed(K * N + M)
    a = torch.randint(-(1 << 15), 1 << 15, (M, K), generator=g, device=cuda, dtype=torch.int16)
    w = torch.randint(-(1 << 15), 1 << 15, (K, N), generator=g, device=cuda, dtype=torch.int16)
    y = QM.q78_matmul(a, w)
    torch.cuda.synchronize()
    assert torch.equal(y, QM.q78_matmul(a, w, use_kernel=False))


@pytest.mark.parametrize("K,N", [(2000, 1500), (561, 2000), (784, 800)])
@pytest.mark.parametrize("M", [1, 16, 32])
def test_q78_matmul_sections_read_in_place(cuda, M, K, N):
    """forward_q78_sectioned's sections w[:, 114 i : 114 (i + 1)], each read
    in place: a base 228 i bytes in (only 4-byte aligned for odd i)."""
    a = torch.randint(-(1 << 15), 1 << 15, (M, K), device=cuda, dtype=torch.int16)
    w = torch.randint(-(1 << 15), 1 << 15, (K, N), device=cuda, dtype=torch.int16)
    ref = QM.q78_matmul(a, w, use_kernel=False)
    for s in range(0, N, 114):
        sec = w[:, s:s + 114]
        if s // 114 % 2:
            assert sec.data_ptr() % 8 == 4
        y = QM.q78_matmul(a, sec)
        torch.cuda.synchronize()
        assert torch.equal(y, ref[:, s:s + 114])


def test_q78_matmul_kernel_wraps_like_int32(cuda):
    """3000 * 32767^2 overflows int32: the kernel wraps modulo 2^32."""
    a = torch.full((2, 3000), 32767, dtype=torch.int16, device=cuda)
    w = torch.full((3000, 3), 32767, dtype=torch.int16, device=cuda)
    y = QM.q78_matmul(a, w)
    torch.cuda.synchronize()
    assert (y == -196605000).all()
    a = torch.where(torch.rand((4, 3000), device=cuda) < 0.5, 32767, -32768).to(torch.int16)
    w = torch.where(torch.rand((3000, 40), device=cuda) < 0.5, 32767, -32768).to(torch.int16)
    got = QM.q78_matmul(a, w)
    torch.cuda.synchronize()
    assert torch.equal(got, QM.q78_matmul(a, w, use_kernel=False))
    assert torch.equal(got.cpu(), a.cpu().to(torch.int32) @ w.cpu().to(torch.int32))


def test_dense_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn((4, 64), device=cuda)
    with pytest.raises(ValueError):
        BF.batched_ffn(x, torch.randn((64, 8), device=cuda).t().contiguous().t()[:, ::2],
                       torch.zeros(4, device=cuda))
    with pytest.raises(ValueError):
        BF.batched_ffn(x, torch.randn((64, 8), device=cuda), torch.zeros(8, device=cuda).double())
    with pytest.raises(ValueError):
        BF.batched_ffn(x, torch.randn((64, 8), device=cuda).to(torch.bfloat16),
                       torch.zeros(8, device=cuda))
    with pytest.raises(ValueError):
        QM.quant_matmul(x, torch.zeros((64, 8), device=cuda), torch.ones(8, device=cuda))
    with pytest.raises(ValueError):
        QM.q78_matmul(x.to(torch.int32), torch.zeros((64, 8), dtype=torch.int16, device=cuda))


def _flash_inputs(B, Sq, Sk, H, KVH, hd, int8, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, Sq, H, hd), generator=g, device=device).to(torch.bfloat16)
    if int8:
        k = torch.randint(-127, 128, (B, Sk, KVH, hd), generator=g, device=device,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, k.shape, generator=g, device=device, dtype=torch.int8)
        ks = torch.rand((B, Sk, KVH), generator=g, device=device) * 0.02 + 0.002
        vs = torch.rand((B, Sk, KVH), generator=g, device=device) * 0.02 + 0.002
        return q, k, v, ks, vs
    k = torch.randn((B, Sk, KVH, hd), generator=g, device=device).to(torch.bfloat16)
    v = torch.randn(k.shape, generator=g, device=device).to(torch.bfloat16)
    return q, k, v, None, None


# B6: bf16 outputs of an fp32 online softmax; the kernel rounds P (and, for
# int8, P * v_scale) to bf16 before PV where the plain version keeps the
# int8 path in fp32: about one bf16 ulp, held to 1e-2 of the max
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,hd,causal,window,int8", [
    (1, 200, 200, 8, 2, 64, True, None, False),     # ragged, one partial key tile
    (2, 300, 300, 32, 4, 64, True, 96, False),      # tinyllama heads, sliding window
    (1, 257, 257, 8, 1, 64, True, None, True),      # MQA, int8 K/V
    (2, 100, 250, 8, 2, 64, False, None, False),    # non-causal, ragged Sk
    (1, 1100, 1100, 32, 4, 64, True, None, True),   # long prefill, int8, ragged tail
    (1, 1100, 1100, 32, 4, 64, True, 256, False),   # long prefill, window 256
])
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Sk, H, KVH, hd, causal, window,
                                              int8):
    q, k, v, ks, vs = _flash_inputs(B, Sq, Sk, H, KVH, hd, int8, cuda)
    kw = dict(causal=causal, window=window, k_scale=ks, v_scale=vs)
    n = FA.flash_attention.launches
    o = FA.flash_attention(q, k, v, **kw)
    assert FA.flash_attention.launches == n + 1 and o.dtype == torch.bfloat16
    ref = FA.flash_attention(q, k, v, use_kernel=False, **kw)
    assert FA.flash_attention.launches == n + 1
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all()
    _close(o, ref, 1e-2)


# B6's bf16 path (TMA + wgmma, 128 folded rows per CTA): lengths around
# the 64-row warpgroup and 128-key tile edges and the long prefills, causal
# and not, G = 8, 1 and 4 (the 128-row tile cuts positions at different
# places), two sequences
B6_LENGTHS = [1, 63, 64, 65, 127, 129, 1100, 2048]
B6_HEADS = [(32, 4), (8, 8), (16, 4)]


@pytest.mark.parametrize("H,KVH", B6_HEADS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", B6_LENGTHS)
def test_flash_attention_bf16_lengths_and_groups(cuda, S, causal, H, KVH):
    q, k, v, _, _ = _flash_inputs(2, S, S, H, KVH, 64, False, cuda, seed=S + H)
    o = FA.flash_attention(q, k, v, causal=causal)
    ref = FA.flash_attention(q, k, v, causal=causal, use_kernel=False)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all()
    _close(o, ref, 1e-2)


@pytest.mark.parametrize("H,KVH", B6_HEADS)
@pytest.mark.parametrize("S", [129, 1100, 2048])
def test_flash_attention_bf16_window(cuda, S, H, KVH):
    q, k, v, _, _ = _flash_inputs(2, S, S, H, KVH, 64, False, cuda, seed=S + 7)
    o = FA.flash_attention(q, k, v, causal=True, window=256)
    ref = FA.flash_attention(q, k, v, causal=True, window=256, use_kernel=False)
    torch.cuda.synchronize()
    _close(o, ref, 1e-2)


def test_flash_attention_bf16_launches_are_bitwise_deterministic(cuda):
    """No atomics and no split over keys: two launches give the same bits."""
    q, k, v, _, _ = _flash_inputs(1, 1100, 1100, 32, 4, 64, False, cuda, seed=5)
    a = FA.flash_attention(q, k, v, causal=True)
    b = FA.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_flash_attention_fully_masked_rows_write_zero(cuda):
    """Sq > Sk under a window: queries past Sk - 1 + window see no key; the
    kernel and its plain version both write 0 there (l = 0, clamped)."""
    q, k, v, _, _ = _flash_inputs(1, 300, 64, 8, 2, 64, False, cuda, seed=1)
    o = FA.flash_attention(q, k, v, causal=True, window=32)
    ref = FA.flash_attention(q, k, v, causal=True, window=32, use_kernel=False)
    torch.cuda.synchronize()
    assert torch.all(o[:, 64 + 31:] == 0) and torch.all(ref[:, 64 + 31:] == 0)
    assert o[:, :64 + 31].abs().amax() > 0
    _close(o, ref, 1e-2)


def test_flash_attention_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v, _, _ = _flash_inputs(1, 64, 64, 8, 2, 64, False, cuda)
    for bad in (dict(q=q.float()), dict(q=q[..., :32].contiguous(), k=k[..., :32].contiguous(),
                                       v=v[..., :32].contiguous()),
                dict(k=k.transpose(1, 2).contiguous().transpose(1, 2)),
                dict(q_offset=8)):
        args = dict(q=q, k=k, v=v)
        args.update(bad)
        with pytest.raises(ValueError):
            FA.flash_attention(**args)


# B5's wgmma regime (bf16 x whose operands TMA can address; the head and
# every --compress quant leaf): exact bf16 products of the converted int8
# weight, fp32 sums, act(sum * scale) rounded to bf16 once -- about one bf16
# ulp of the output, held to 1e-2 of the max.  M at both regimes' tile
# edges and the longest prefill; the head, a gate/up leaf, w_down, and a
# weight whose K is not a multiple of 128 and whose N is a multiple of 16
# but not of 128 (TMA zero-fills both edges; the epilogue masks n >= N)
B5_MS = [1, 8, 63, 64, 65, 127, 128, 129, 2032]
B5_SHAPES = [(2048, 32000), (2048, 5632), (5632, 2048), (1000, 1040)]


def _b5_operands(M, K, N, device, seed, ldx=None, ldw=None):
    """x (M, K) bf16 and w (K, N) int8, each a view into a wider matrix
    when its row stride (ldx, ldw) is given; scales (N,)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, ldx or K), generator=g, device=device).to(torch.bfloat16)[:, :K]
    w = torch.randint(-127, 128, (K, ldw or N), generator=g, device=device,
                      dtype=torch.int8)[:, :N]
    s = torch.rand((N,), generator=g, device=device) * 0.01 + 1e-3
    return x, w, s


def _b5_regime(x, w):
    return QM.regime(x.dtype, x.shape[0], x.shape[1], w.shape[1],
                     x.stride(0) if x.shape[0] > 1 else x.shape[1], w.stride(0),
                     BS.sm_count(x.device))


@pytest.mark.parametrize("activation", ["linear", "silu"])
@pytest.mark.parametrize("K,N", B5_SHAPES)
@pytest.mark.parametrize("M", B5_MS)
def test_b5_wgmma_matches_plain(cuda, M, K, N, activation):
    x, w, s = _b5_operands(M, K, N, cuda, seed=M + N)
    assert _b5_regime(x, w)[0] == "wgmma"
    n, nw = QM.quant_matmul.launches, QM.quant_matmul.wgmma_launches
    y = QM.quant_matmul(x, w, s, activation=activation)
    assert QM.quant_matmul.launches == n + 1 and QM.quant_matmul.wgmma_launches == nw + 1
    assert y.dtype == torch.bfloat16 and y.shape == (M, N)
    ref = QM.quant_matmul(x, w, s, activation=activation, use_kernel=False)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all()
    _close(y, ref, 1e-2)


@pytest.mark.parametrize("M", [8, 65, 300])
def test_b5_wgmma_strided_operands(cuda, M):
    """x with row stride K + 64 and w a column section (row stride 1056,
    odd N = 1037): read in place through the TMA maps' strides; odd N
    stores bf16 one at a time."""
    x, w, s = _b5_operands(M, 1000, 1037, cuda, seed=M, ldx=1064, ldw=1056)
    assert x.stride(0) == 1064 and w.stride(0) == 1056
    assert _b5_regime(x, w)[0] == "wgmma"
    for activation in ("linear", "silu"):
        y = QM.quant_matmul(x, w, s, activation=activation)
        ref = QM.quant_matmul(x.contiguous(), w.contiguous(), s, activation=activation,
                              use_kernel=False)
        torch.cuda.synchronize()
        _close(y, ref, 1e-2)


@pytest.mark.parametrize("M", [8, 2032])
def test_b5_wgmma_launches_are_bitwise_deterministic(cuda, M):
    x, w, s = _b5_operands(M, 2048, 5632, cuda, seed=3)
    a = QM.quant_matmul(x, w, s, activation="silu")
    b = QM.quant_matmul(x, w, s, activation="silu")
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_b5_dense_tile_regime_counts_apart(cuda):
    """fp32 x and a bf16 x whose stride TMA cannot take run the CUDA-core
    kernel, counted under its own regime."""
    x, w, s = _b5_operands(5, 70, 37, cuda, seed=1)
    n, nd = QM.quant_matmul.wgmma_launches, QM.quant_matmul.dense_tile_launches
    for xx in (x, x.float()):
        assert _b5_regime(xx, w)[0] == "dense_tile"
        y = QM.quant_matmul(xx, w, s)
        torch.cuda.synchronize()
        _close(y, QM.quant_matmul(xx, w, s, use_kernel=False), 1e-2)
    assert QM.quant_matmul.wgmma_launches == n
    assert QM.quant_matmul.dense_tile_launches == nd + 2


# B3 (csrc/paged_attention.cu): pages dealt over a cluster of
# ``paged_split`` CTAs, fed by TMA, combined by rank 0 in rank order.  fp32
# scores and softmax: fp32 q with fp32 or int8 pools is held to 1e-5 of the
# max (the existing tolerance), bf16 q with bf16 pools to 1e-2 (one bf16
# ulp of the output).  Contexts (keys the last row sees) at a page's edges
# and at the long phase's 2048, T 1 and 3, window and softcap, every split
# the host picks and forced splits of 1 and 8; sequence 1 shares sequence
# 0's first physical page.
B3_POOLS = [("int8", torch.float32, 1e-5), ("bf16", torch.bfloat16, 1e-2),
            ("fp32", torch.float32, 1e-5)]
B3_CONTEXTS = (1, 15, 16, 17, 2047, 2048)


def _b3_inputs(T, pool, q_dtype, device, seed, hd=64, H=8, KVH=2, ps=16, P=128):
    g = torch.Generator(device=device).manual_seed(seed)
    ctx = [max(c, T) for c in B3_CONTEXTS]
    B = len(ctx)
    pos = torch.tensor([c - T for c in ctx], dtype=torch.int32, device=device)
    num_pages = 1 + B * P
    table = (1 + torch.randperm(B * P, generator=g, device=device)).reshape(B, P)
    table[1, 0] = table[0, 0]
    table = table.to(torch.int32).contiguous()
    q = torch.randn((B, T, H, hd), generator=g, device=device).to(q_dtype)
    shape = (num_pages, ps, KVH, hd)
    ks = vs = None
    if pool == "int8":
        kp = torch.randint(-127, 128, shape, generator=g, device=device, dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device=device, dtype=torch.int8)
        ks = torch.rand(shape[:3], generator=g, device=device) * 0.02 + 0.002
        vs = torch.rand(shape[:3], generator=g, device=device) * 0.02 + 0.002
    else:
        dt = torch.bfloat16 if pool == "bf16" else torch.float32
        kp = torch.randn(shape, generator=g, device=device).to(dt)
        vp = torch.randn(shape, generator=g, device=device).to(dt)
    return q, kp, vp, table, pos, dict(k_scale_pages=ks, v_scale_pages=vs)


@pytest.fixture(params=["plan", 1, 8])
def b3_split(request, monkeypatch):
    """The split B3 launches with: ``paged_split``'s, or forced to 1 or 8."""
    if request.param != "plan":
        monkeypatch.setattr(FA, "paged_split", lambda *args: request.param)
    return request.param


@pytest.mark.parametrize("window,softcap", [(None, 0.0), (20, 30.0), (300, 0.0)])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("pool,q_dtype,rtol", B3_POOLS)
def test_b3_contexts_and_splits_match_plain(cuda, b3_split, pool, q_dtype, rtol, T, window,
                                            softcap):
    q, kp, vp, table, pos, kw = _b3_inputs(T, pool, q_dtype, cuda, seed=T + len(pool))
    kw.update(window=window, softcap=softcap)
    n = FA.paged_decode_attention.launches
    o = FA.paged_decode_attention(q, kp, vp, table, pos, **kw)
    assert FA.paged_decode_attention.launches == n + 1 and o.dtype == q_dtype
    again = FA.paged_decode_attention(q, kp, vp, table, pos, **kw)
    ref = FA.paged_decode_attention(q, kp, vp, table, pos, use_kernel=False, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all()
    assert torch.equal(o, again)
    _close(o, ref, rtol)


@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("pool,q_dtype,rtol", B3_POOLS)
def test_b3_head_dims_match_plain(cuda, hd, pool, q_dtype, rtol):
    q, kp, vp, table, pos, kw = _b3_inputs(2, pool, q_dtype, cuda, seed=hd, hd=hd)
    o = FA.paged_decode_attention(q, kp, vp, table, pos, **kw)
    ref = FA.paged_decode_attention(q, kp, vp, table, pos, use_kernel=False, **kw)
    torch.cuda.synchronize()
    _close(o, ref, rtol)


def test_b3_largest_admitted_rows_match_plain(cuda):
    """T * G at the shared-memory bound (hd 64, int8 pages of 16): as many
    tokens of 8 grouped heads as fit."""
    rows = FA.paged_max_rows(64, 16, torch.int8)
    T = rows // 8
    g = torch.Generator(device=cuda).manual_seed(0)
    B, P, ps, KVH = 2, 8, 16, 1
    q = torch.randn((B, T, 8, 64), generator=g, device=cuda)
    shape = (1 + B * P, ps, KVH, 64)
    kp = torch.randint(-127, 128, shape, generator=g, device=cuda, dtype=torch.int8)
    vp = torch.randint(-127, 128, shape, generator=g, device=cuda, dtype=torch.int8)
    ks = torch.rand(shape[:3], generator=g, device=cuda) * 0.02 + 0.002
    vs = torch.rand(shape[:3], generator=g, device=cuda) * 0.02 + 0.002
    table = (1 + torch.arange(B * P, device=cuda)).reshape(B, P).to(torch.int32)
    pos = torch.tensor([0, 70], dtype=torch.int32, device=cuda)
    kw = dict(k_scale_pages=ks, v_scale_pages=vs)
    o = FA.paged_decode_attention(q, kp, vp, table, pos, **kw)
    ref = FA.paged_decode_attention(q, kp, vp, table, pos, use_kernel=False, **kw)
    torch.cuda.synchronize()
    _close(o, ref, 1e-5)


@pytest.mark.parametrize("pool", ["int8", "bf16", "fp32"])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_b3_smem_layout_matches_the_host_mirror(cuda, hd, pool):
    """The C entry's Layout and ``paged_smem_bytes`` agree."""
    from repro_torch.kernels import build

    dt = {"int8": torch.int8, "bf16": torch.bfloat16, "fp32": torch.float32}[pool]
    lib = build.load("paged_attention")
    for rows in (1, 8, 24, 100):
        for ps in (8, 16, 40):
            for groups in range(1, FA.PAGED_MAX_GROUPS[hd] + 1):
                want = FA.paged_smem_bytes(rows, hd, ps, dt, groups)
                got = lib.paged_decode_smem_bytes(rows, hd, ps, build.DTYPE_CODES[dt],
                                                  FA.paged_stages(hd, ps, dt), groups)
                assert got == want, (rows, ps, groups)


@pytest.mark.parametrize("groups", [1, 2, 3, 4])
@pytest.mark.parametrize("pool,q_dtype,rtol", B3_POOLS)
def test_b3_every_group_count_matches_plain(cuda, monkeypatch, pool, q_dtype, rtol, groups):
    """Each count of consumer-warp groups the hd 64 kernel takes (the host
    picks 4 at long contexts, fewer where shared memory, the stages or the
    pages run short), at the split the host picks and at a forced split of
    1."""
    monkeypatch.setattr(FA, "paged_groups", lambda *args: groups)
    q, kp, vp, table, pos, kw = _b3_inputs(3, pool, q_dtype, cuda, seed=groups)
    kw.update(window=300)
    for split in (None, 1):
        if split is not None:
            monkeypatch.setattr(FA, "paged_split", lambda *args: split)
        o = FA.paged_decode_attention(q, kp, vp, table, pos, **kw)
        ref = FA.paged_decode_attention(q, kp, vp, table, pos, use_kernel=False, **kw)
        torch.cuda.synchronize()
        _close(o, ref, rtol)


def test_b3_refuses_more_groups_than_stages(cuda, monkeypatch):
    """The C entry refuses a launch whose groups outrun its ring."""
    monkeypatch.setattr(FA, "paged_groups", lambda *args: 4)
    monkeypatch.setattr(FA, "paged_stages", lambda *args: 3)
    q, kp, vp, table, pos, kw = _b3_inputs(1, "int8", torch.float32, cuda, seed=0)
    with pytest.raises(RuntimeError, match="CUDA error"):
        FA.paged_decode_attention(q, kp, vp, table, pos, **kw)
