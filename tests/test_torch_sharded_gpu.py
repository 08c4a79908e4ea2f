"""A rank's kernels on its shards, on the card: B1, B2 and B5 on the local
shard of a tinyllama-1.1b-wide leaf (``weight_plan.local_leaf`` at model
axes of 2 and 8) against the matching columns of the whole leaf's launch
and against their plain versions; B3 reading a rank's KV heads of a pool
that holds them all (``kv_heads``, in place) against its plain version on
the narrowed pools, also at a verify step's T = 5; stacked B1 and B2 over
a rank's experts of a granite-moe-wide stack (``local_leaf``'s cut of the
expert axis) against their plain versions and the whole stack's launch;
B3 non-causal over a rank's KV heads of whisper-tiny's frame pool, B6
non-causal on 3 of its 6 heads at 1500 x 1500, and B5's dense_tile at a
rank's 1365 columns of xlstm-350m's sLSTM ``w_up``; and one smoke
training step of granite-moe and whisper at 1x2, two gloo ranks sharing
the card, against the mesh-free step on the card.  These need a CUDA
device and nvcc; they carry the ``gpu`` marker and skip elsewhere (and
import no JAX):

    python -m pytest -q -m gpu tests/test_torch_sharded_gpu.py

bf16 outputs are held to 1e-2 of the max (fp32 sums in another order --
a launch over fewer columns may split its sums otherwise -- rounded once),
as in tests/test_torch_gpu.py; the training step (fp32) to
tests/test_torch_sharded_training.py's tolerances."""

import pytest
import torch

from repro_torch.core import weight_plan as WP
from repro_torch.distributed import shardlib as sl
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import transformer as T

TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL * want.float().abs().max().item(), err


def _meshes(M):
    return [sl.MeshShape({"data": 1, "model": M}, {"data": 0, "model": m}) for m in range(M)]


@pytest.mark.gpu
@pytest.mark.parametrize("M", [2, 8])
def test_b1_b2_on_a_ranks_columns(cuda, M):
    g = torch.Generator(device=cuda).manual_seed(0)
    cfg = WP.PlanConfig(q_prune=0.5)
    wq = WP.pack_block_sparse(torch.randn(2048, 2048, generator=g, device=cuda) / 45.0, cfg, True)
    gate = WP.pack_block_sparse(torch.randn(2048, 5632, generator=g, device=cuda) / 45.0, cfg, True)
    up = WP.pack_block_sparse(torch.randn(2048, 5632, generator=g, device=cuda) / 45.0, cfg, True)
    x = torch.randn(8, 2048, generator=g, device=cuda).to(torch.bfloat16)
    y_q = WP.apply_linear(x, wq)
    y_gu = WP.apply_gate_up(x, gate, up, "silu")
    for mesh in _meshes(M):
        m = mesh.coords["model"]
        loc = WP.local_leaf(wq, ("d", "qkv"), mesh, sl.DEFAULT_RULES)
        assert loc.n_split
        y = WP.apply_linear(x, loc.local)
        n = y.shape[-1]
        _close(y, y_q[:, m * n:(m + 1) * n])
        _close(y, WP.apply_linear(x, WP.with_use_kernel(loc.local, False)))
        lg = WP.local_leaf(gate, ("d", "ff"), mesh, sl.DEFAULT_RULES)
        lu = WP.local_leaf(up, ("d", "ff"), mesh, sl.DEFAULT_RULES)
        if M == 8:  # 44 block columns do not split 8 ways: whole on every rank
            assert lg is gate and lu is up
            continue
        y = WP.apply_gate_up(x, lg.local, lu.local, "silu")
        n = y.shape[-1]
        _close(y, y_gu[:, m * n:(m + 1) * n])
        _close(y, WP.apply_gate_up(x, WP.with_use_kernel(lg.local, False),
                                   WP.with_use_kernel(lu.local, False), "silu"))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [2, 8])
def test_b5_on_a_ranks_columns_and_rows(cuda, M):
    """The head's columns (32000 / M) and wo's rows (a split contraction:
    the rank's partial product against its plain version)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    head = WP.quantize_leaf(torch.randn(2048, 32000, generator=g, device=cuda) / 45.0)
    wo = WP.quantize_leaf(torch.randn(2048, 2048, generator=g, device=cuda) / 45.0)
    x = torch.randn(8, 2048, generator=g, device=cuda).to(torch.bfloat16)
    whole = WP.apply_linear(x, head)
    for mesh in _meshes(M):
        m = mesh.coords["model"]
        loc = WP.local_leaf(head, ("d", "vocab"), mesh, sl.DEFAULT_RULES)
        y = WP.apply_linear(x, loc.local)
        n = y.shape[-1]
        _close(y, whole[:, m * n:(m + 1) * n])
        _close(y, WP.apply_linear(x, WP.with_use_kernel(loc.local, False)))
        lo = WP.local_leaf(wo, ("qkv", "d"), mesh, sl.DEFAULT_RULES)
        assert lo.k_split and not lo.n_split
        k = 2048 // M
        xl = x[:, m * k:(m + 1) * k]  # the rank's columns of o, a strided view
        _close(WP.apply_linear(xl, lo.local),
               WP.apply_linear(xl, WP.with_use_kernel(lo.local, False)))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [2, 4])
def test_stacked_b1_b2_over_a_ranks_experts(cuda, M):
    """granite-moe's 32 experts (d 1024, expert FFN 512), M 8 rows an
    expert: the rank's 32 / M experts of the gate/up pair (one stacked B2)
    and of w_down (one stacked B1), each launch over the sub-stack, equal
    to their plain versions and to the whole stack's launch on those
    experts."""
    from repro_torch.kernels import block_sparse as BS
    from repro_torch.kernels import fused_gate_up as FG

    g = torch.Generator(device=cuda).manual_seed(3)
    cfg = WP.PlanConfig(q_prune=0.5)
    E, d, f = 32, 1024, 512

    def stack(K, N):
        return WP.pack_block_sparse(torch.randn(1, E, K, N, generator=g, device=cuda) / 32.0,
                                    cfg, True)

    gate, up, down = stack(d, f), stack(d, f), stack(f, d)
    axes = {"g": (None, "experts", "d", "expert_ff"), "d": (None, "experts", "expert_ff", "d")}
    x = torch.randn(E, 8, d, generator=g, device=cuda).to(torch.bfloat16)
    h_all = WP.apply_gate_up(x, T._layer_leaf(gate, 0), T._layer_leaf(up, 0), "silu")
    for mesh in _meshes(M):
        m = mesh.coords["model"]
        lg, lu, ld = (WP.local_leaf(w, axes[a], mesh, sl.DEFAULT_RULES)
                      for w, a in ((gate, "g"), (up, "g"), (down, "d")))
        n = E // M
        assert lg.experts == lu.experts == ld.experts == (m * n, n)
        one = [T._layer_leaf(w.local, 0) for w in (lg, lu, ld)]  # layer 0's sub-stacks
        xs = x[m * n:(m + 1) * n]
        launches = (FG.fused_gate_up.stacked_launches, BS.block_sparse_matmul.stacked_launches)
        h = WP.apply_gate_up(xs, one[0], one[1], "silu")
        y = WP.apply_linear(h, one[2])
        assert (FG.fused_gate_up.stacked_launches,
                BS.block_sparse_matmul.stacked_launches) == (launches[0] + 1, launches[1] + 1)
        _close(h, WP.apply_gate_up(xs, WP.with_use_kernel(one[0], False),
                                   WP.with_use_kernel(one[1], False), "silu"))
        _close(h, h_all[m * n:(m + 1) * n])
        _close(y, WP.apply_linear(h, WP.with_use_kernel(one[2], False)))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("kv", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("hd,kvh,hq,off,n", [(64, 4, 4, 1, 1), (64, 4, 16, 2, 2),
                                             (128, 2, 8, 1, 1)])
def test_b3_reads_a_ranks_kv_heads_in_place(cuda, kv, hd, kvh, hq, off, n, T):
    """B3 over ``hq`` q heads against KV heads [off, off + n) of pools of
    ``kvh`` heads equals its plain version on the narrowed pools; T 5 is a
    verify step of speculative decode at k 4."""
    g = torch.Generator(device=cuda).manual_seed(2)
    B, ps, P, pages = 4, 16, 8, 40
    q = torch.randn(B, T, hq, hd, generator=g, device=cuda).to(torch.bfloat16)
    shape = (pages, ps, kvh, hd)
    scales = {}
    if kv == torch.int8:
        kp = torch.randint(-127, 128, shape, generator=g, device=cuda, dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device=cuda, dtype=torch.int8)
        scales = dict(k_scale_pages=torch.rand(shape[:3], generator=g, device=cuda) / 100,
                      v_scale_pages=torch.rand(shape[:3], generator=g, device=cuda) / 100)
    else:
        kp = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
        vp = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
    table = torch.randint(1, pages, (B, P), generator=g, device=cuda, dtype=torch.int32)
    # the last sequence's last query at the table's last slot: a verify
    # step's positions stay inside its pages (admission reserves spec_k of
    # headroom)
    pos = torch.tensor([3, 40, 77, P * ps - T], device=cuda, dtype=torch.int32)
    launches = FA.paged_decode_attention.launches
    got = FA.paged_decode_attention(q, kp, vp, table, pos, kv_heads=(off, n), **scales)
    assert FA.paged_decode_attention.launches == launches + 1
    want = FA.paged_decode_attention(q, kp, vp, table, pos, kv_heads=(off, n), use_kernel=False,
                                     **scales)
    _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("off", [0, 3])
def test_b3_noncausal_reads_a_ranks_kv_heads_of_a_frame_pool(cuda, off):
    """whisper-tiny's frame pool (6 KV heads, hd 64, 94 bf16 pages of 16 a
    sequence, a scrambled table): 3 q heads read KV heads [off, off + 3)
    in place, non-causal at pos 1499, equal to the plain version and to the
    launch over pools that hold those 3 heads only (a rank's piece)."""
    g = torch.Generator(device=cuda).manual_seed(4 + off)
    B, P, ps = 4, 94, 16
    table = (1 + torch.randperm(B * P, generator=g, device=cuda)).reshape(B, P).to(torch.int32)
    shape = (1 + B * P, ps, 6, 64)
    kp = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
    vp = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
    q = torch.randn((B, 1, 3, 64), generator=g, device=cuda).to(torch.bfloat16)
    pos = torch.full((B,), 1499, dtype=torch.int32, device=cuda)
    n = FA.paged_decode_attention.launches_noncausal
    got = FA.paged_decode_attention(q, kp, vp, table, pos, causal=False, kv_heads=(off, 3))
    assert FA.paged_decode_attention.launches_noncausal == n + 1
    _close(got, FA.paged_decode_attention(q, kp, vp, table, pos, causal=False,
                                          kv_heads=(off, 3), use_kernel=False))
    piece = [t[:, :, off:off + 3].contiguous() for t in (kp, vp)]
    _close(got, FA.paged_decode_attention(q, *piece, table, pos, causal=False))


@pytest.mark.gpu
def test_b6_noncausal_on_a_ranks_heads_at_1500_frames(cuda):
    """whisper-tiny's encoder on a rank's 3 of its 6 heads (1500 x 1500,
    hd 64): equal to the plain version and to those heads of the launch
    over all 6."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((1, 1500, 6, 64), generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    whole = FA.flash_attention(q, k, v, causal=False)
    mine = [t[:, :, 3:].contiguous() for t in (q, k, v)]
    n = FA.flash_attention.launches_noncausal
    got = FA.flash_attention(*mine, causal=False)
    assert FA.flash_attention.launches_noncausal == n + 1
    _close(got, FA.flash_attention(*mine, causal=False, use_kernel=False))
    _close(got, whole[:, :, 3:])


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 40])
def test_b5_dense_tile_at_a_ranks_slstm_w_up(cuda, M):
    """xlstm-350m's sLSTM ``w_up`` at 1x2: a rank's 1365 of its 2730
    columns (int8, K 1024) in B5's dense_tile regime, equal to the plain
    version and to those columns of the whole leaf's launch."""
    from repro_torch.kernels import block_sparse as BS
    from repro_torch.kernels import quant_matmul as QM

    g = torch.Generator(device=cuda).manual_seed(6 + M)
    w = WP.quantize_leaf(torch.randn((1024, 2730), generator=g, device=cuda) / 32.0)
    x = torch.randn((M, 1024), generator=g, device=cuda).to(torch.bfloat16)
    whole = WP.apply_linear(x, w)
    for mesh in _meshes(2):
        m = mesh.coords["model"]
        loc = WP.local_leaf(w, ("d", "ff"), mesh, sl.DEFAULT_RULES)
        assert loc.n_split and tuple(loc.local.q.shape) == (1024, 1365)
        assert QM.regime(x.dtype, M, 1024, 1365, 1024, 1365, BS.sm_count(cuda))[0] == \
            "dense_tile"
        n = QM.quant_matmul.dense_tile_launches
        y = QM.quant_matmul(x, loc.local.q, loc.local.s)
        assert QM.quant_matmul.dense_tile_launches == n + 1
        _close(y, QM.quant_matmul(x, loc.local.q, loc.local.s, use_kernel=False))
        _close(y, whole[:, m * 1365:(m + 1) * 1365])


@pytest.mark.gpu
def test_1x2_training_step_of_moe_and_encdec_on_the_card(cuda, tmp_path):
    """One smoke training step of granite-moe (its experts split over the
    model axis) and of whisper (its heads and frames) at 1x2, two gloo
    ranks sharing the card (``tests/_torch_train_ranks``): each rank's
    loss, its pieces of the step's gradients and of the updated params
    equal its slices of the mesh-free step's on the card, and its ZeRO-1
    update a shadow's without ZeRO."""
    import _torch_train_ranks as R
    from repro_torch.models.api import get_api

    cases = ["granite", "whisper"]
    params = {}
    for name in cases:
        cfg = R.case_config(name)
        params[R.params_key(name)] = str(tmp_path / f"{name}.pt")
        torch.save(get_api(cfg).init_params(cfg, 0, device="cpu"), params[R.params_key(name)])
    rows = R.run_mesh((1, 2), {"cases": cases, "params": params, "device": "cuda",
                               "steps": 1, "out": str(tmp_path)})
    for row in rows:
        for name in cases:
            got = row[name]
            assert got["loss_rel"] <= 1e-5, (name, row["coords"], got["losses"])
            assert got["grad_err"] <= 1e-5, (name, row["coords"], got["grad_err"])
            over, n, worst = got["params"]
            assert over == 0, (name, row["coords"], over, n, worst)
            assert got["zero"] == {"moments_equal": True, "params_equal": True}, name
