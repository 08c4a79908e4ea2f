"""PyTorch port vs the JAX reference for each module that holds a kernel.

On the CPU the port's kernel wrappers run their plain PyTorch versions; the
reference's Pallas kernels run in interpret mode (as the reference's own
tests run them).  Both accumulate in fp32 on fp32 inputs, but in another
order, so outputs are held to rtol 1e-5 / atol 2e-4 (matmuls over K <= 128
of O(1) values) and 1e-5 / 1e-4 for attention -- the tolerances the
reference's own kernel tests use.  Same numpy inputs feed both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import weight_plan as RW
from repro.core.pruning import BlockPruneConfig as RBlock
from repro.core.sparse_format import build_walk as ref_build_walk
from repro.kernels import ops as rops
from repro.models import layers as RL

from repro_torch import interop
from repro_torch.core import weight_plan as TW
from repro_torch.kernels import block_sparse as BS
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_gate_up as FG
from repro_torch.kernels import quant_matmul as QM
from repro_torch.models import layers as TL

MM_TOL = dict(rtol=1e-5, atol=2e-4)
ATTN_TOL = dict(rtol=1e-5, atol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _packed_pair(K, N, quant, seed, q=0.5, blk=32):
    """A reference PackedLinear and its port conversion (same payload)."""
    w = _rng(seed).normal(size=(K, N)).astype(np.float32)
    ref = RW.pack_block_sparse(jnp.asarray(w), RW.PlanConfig(q_prune=q, bk=blk, bn=blk),
                               quant=quant)
    return ref, interop.params_from_reference(ref)


def _sparse(ref):
    from repro.core.sparse_format import BlockSparse

    return BlockSparse(ref.blocks, ref.block_rows, ref.counts, ref.shape,
                       RBlock(bk=ref.bk, bn=ref.bn))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("M", [3, 8])
def test_block_sparse_plain_matches_pallas(quant, M):
    ref, tw = _packed_pair(128, 96, quant, seed=1)
    x = _rng(2).normal(size=(M, 128)).astype(np.float32)
    walk = ref_build_walk(np.asarray(ref.block_rows), np.asarray(ref.counts),
                          ref.block_rows.shape[1])
    want = rops.block_sparse_matmul(jnp.asarray(x), _sparse(ref), scales=ref.scales,
                                    interpret=True, walk=walk)
    got = BS.block_sparse_matmul(torch.from_numpy(x), tw.blocks, tw.block_rows, tw.counts,
                                 tw.scales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MM_TOL)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("quant", [False, True])
def test_fused_gate_up_plain_matches_pallas(quant, activation):
    g_ref, g = _packed_pair(64, 128, quant, seed=3, q=0.4)
    u_ref, u = _packed_pair(64, 128, quant, seed=4, q=0.6)  # pruned independently
    x = _rng(5).normal(size=(5, 64)).astype(np.float32)
    want = rops.fused_gate_up(jnp.asarray(x), _sparse(g_ref), _sparse(u_ref),
                              gate_scales=g_ref.scales, up_scales=u_ref.scales,
                              activation=activation, interpret=True)
    got = FG.fused_gate_up(torch.from_numpy(x), (g.blocks, g.block_rows, g.counts),
                           (u.blocks, u.block_rows, u.counts), g.scales, u.scales,
                           activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MM_TOL)


def _paged_inputs(int8: bool, seed=6):
    """B=3 sequences, T=2 queries, 2 KV heads x 4 groups, hd 16, pages of 8;
    a scrambled table whose first page is shared by sequences 0 and 1, and
    positions that straddle page boundaries."""
    r = _rng(seed)
    B, T, KVH, G, hd, ps, P = 3, 2, 2, 4, 16, 8, 4
    num_pages = 1 + B * P
    q = r.normal(size=(B, T, KVH * G, hd)).astype(np.float32)
    table = (1 + r.permutation(B * P)).reshape(B, P).astype(np.int32)
    table[1, 0] = table[0, 0]
    pos = np.asarray([7, 8, 20], np.int32)
    if int8:
        k = r.integers(-127, 128, size=(num_pages, ps, KVH, hd)).astype(np.int8)
        v = r.integers(-127, 128, size=k.shape).astype(np.int8)
        ks = (r.random((num_pages, ps, KVH)) * 0.02 + 0.005).astype(np.float32)
        vs = (r.random((num_pages, ps, KVH)) * 0.02 + 0.005).astype(np.float32)
        return q, k, v, table, pos, ks, vs
    k = r.normal(size=(num_pages, ps, KVH, hd)).astype(np.float32)
    v = r.normal(size=k.shape).astype(np.float32)
    return q, k, v, table, pos, None, None


@pytest.mark.parametrize("window,softcap", [(None, 0.0), (12, 30.0)])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_plain_matches_pallas(int8, window, softcap):
    q, k, v, table, pos, ks, vs = _paged_inputs(int8)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    kw = dict(window=window, softcap=softcap)
    want = rops.paged_decode_attention(j(q), j(k), j(v), j(table), j(pos),
                                       k_scale_pages=j(ks), v_scale_pages=j(vs),
                                       interpret=True, **kw)
    got = FA.paged_decode_attention(t(q), t(k), t(v), t(table), t(pos),
                                    k_scale_pages=t(ks), v_scale_pages=t(vs), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    # the reference's own plain (gather) path agrees as well
    want_plain = RL.paged_decode_attention(j(q), j(k), j(v), j(table), j(pos),
                                           k_scale_pages=j(ks), v_scale_pages=j(vs),
                                           use_kernel=False, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_plain), **ATTN_TOL)


def test_paged_attention_clamps_table():
    """Out-of-range table entries clamp to the pool, as ops.py:251 does."""
    q, k, v, table, pos, _, _ = _paged_inputs(False, seed=7)
    bad = table.copy()
    bad[2, 3] = 10_000
    bad[0, 2] = -5
    t = torch.from_numpy
    got = FA.paged_decode_attention(t(q), t(k), t(v), t(bad), t(pos))
    want = rops.paged_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(bad), jnp.asarray(pos), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def _leaves(kind, seed):
    """A 2-D (64, 96) weight in representation ``kind``: (reference, port)."""
    w = jnp.asarray(_rng(seed).normal(size=(64, 96)).astype(np.float32))
    if kind == "dense":
        ref = w
    elif kind == "quant":
        ref = RW.quantize_leaf(w)
    else:
        ref = RW.pack_block_sparse(w, RW.PlanConfig(q_prune=0.5, bk=16, bn=16),
                                   quant=kind == "quant_sparse")
    conv = jax_tree_numpy(ref)
    return ref, interop.params_from_reference(conv)


def jax_tree_numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("kind", ["dense", "quant", "block_sparse", "quant_sparse"])
def test_apply_linear_matches(kind):
    ref, tw = _leaves(kind, seed=8)
    x = _rng(9).normal(size=(2, 3, 64)).astype(np.float32)
    want = RW.apply_linear(jnp.asarray(x), ref)
    got = TW.apply_linear(torch.from_numpy(x), tw)
    assert got.shape == (2, 3, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MM_TOL)


@pytest.mark.parametrize("kind", ["dense", "quant", "block_sparse", "quant_sparse"])
def test_apply_gate_up_matches(kind):
    """Packed pairs take the fused node (B2), the rest two dispatches."""
    g_ref, g = _leaves(kind, seed=10)
    u_ref, u = _leaves(kind, seed=11)
    x = _rng(12).normal(size=(4, 64)).astype(np.float32)
    want = RW.apply_gate_up(jnp.asarray(x), g_ref, u_ref, "silu")
    got = TW.apply_gate_up(torch.from_numpy(x), g, u, "silu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MM_TOL)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors no wrapper launches (its counter stays put), with or
    without use_kernel; the plain versions compute the result."""
    before = (BS.block_sparse_matmul.launches, FG.fused_gate_up.launches,
              FA.paged_decode_attention.launches)
    ref, tw = _packed_pair(128, 96, True, seed=13)
    x = torch.from_numpy(_rng(14).normal(size=(2, 128)).astype(np.float32))
    BS.block_sparse_matmul(x, tw.blocks, tw.block_rows, tw.counts, tw.scales)
    FG.fused_gate_up(x, (tw.blocks, tw.block_rows, tw.counts),
                     (tw.blocks, tw.block_rows, tw.counts), tw.scales, tw.scales)
    q, k, v, table, pos, _, _ = _paged_inputs(False)
    FA.paged_decode_attention(*(torch.from_numpy(a) for a in (q, k, v, table, pos)))
    TL.paged_decode_attention(*(torch.from_numpy(a) for a in (q, k, v, table, pos)),
                              use_kernel=True)
    after = (BS.block_sparse_matmul.launches, FG.fused_gate_up.launches,
             FA.paged_decode_attention.launches)
    assert after == before


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_apply_quant_takes_the_b5_plain_version_and_matches(lead):
    """A 2-D QuantLinear runs through ops.quant_matmul (B5's plain version
    on the CPU, no launch) and equals the reference's _apply_quant; a
    stack of experts (x's lead dim is the stack's) runs it once per
    expert, as the reference vmaps _apply_quant."""
    ref, tw = _leaves("quant", seed=15)
    x = _rng(16).normal(size=(*lead, 64)).astype(np.float32)
    n = QM.quant_matmul.launches
    got = TW._apply_quant(torch.from_numpy(x), tw)
    assert QM.quant_matmul.launches == n
    assert got.shape == (*lead, 96) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(RW._apply_quant(jnp.asarray(x), ref)),
                               **MM_TOL)
    plain = QM.quant_matmul_plain(torch.from_numpy(x).reshape(-1, 64), tw.q, tw.s)
    assert torch.equal(got.reshape(-1, 96), plain)
    stacked = TW.QuantLinear(q=torch.stack([tw.q, tw.q]), s=torch.stack([tw.s, tw.s]))
    xs = torch.from_numpy(np.stack([x, 2 * x]))
    got_s = TW._apply_quant(xs, stacked)
    assert got_s.shape == (2, *lead, 96) and QM.quant_matmul.launches == n
    assert torch.equal(got_s[0], got)
    assert torch.equal(got_s[1], TW._apply_quant(xs[1], tw))


def test_with_use_kernel_reaches_quant_leaves():
    """with_use_kernel switches PackedLinear and QuantLinear nodes alike and
    shares their tensors; the flag survives moving and unstacking, and the
    plan config sets it when the tree is compressed or converted."""
    from repro_torch.models import transformer as TT

    ref, q = _leaves("quant", seed=17)
    _, p = _leaves("quant_sparse", seed=18)
    tree = {"a": q, "b": [p, torch.ones(3)]}
    off = TW.with_use_kernel(tree, False)
    assert off["a"].use_kernel is False and off["b"][0].use_kernel is False
    assert off["a"].q is q.q and off["b"][1] is tree["b"][1]
    on = TW.with_use_kernel(off, True)
    assert on["a"].use_kernel is True and on["b"][0].use_kernel is True
    moved = TW.tree_to(off, "cpu")
    assert moved["a"].use_kernel is False
    stacked = TW.QuantLinear(q=torch.stack([q.q, q.q]), s=torch.stack([q.s, q.s]),
                             use_kernel=False)
    layer = TT._layer_leaf(stacked, 1)
    assert layer.use_kernel is False and torch.equal(layer.q, q.q)
    plan = TW.compress({"w": torch.randn(64, 512)}, TW.PlanConfig(default="quant",
                                                                 use_kernel=False))
    assert plan.params["w"].use_kernel is False
    assert interop.params_from_reference(jax_tree_numpy(ref), use_kernel=False).use_kernel is False
    x = torch.from_numpy(_rng(19).normal(size=(4, 64)).astype(np.float32))
    assert torch.equal(TW.apply_linear(x, off["a"]), TW.apply_linear(x, q))
