"""PyTorch port vs the JAX reference: block pruning, int8 quantization and
block-sparse packing.  Every comparison here is exact equality: payloads,
row indices, counts, walks, scales and masks are integers or the same
IEEE fp32 operations in both packages.  The same numpy inputs (seeded)
feed both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as RP
from repro.core import sparse_format as RS
from repro.core import weight_plan as RW
from repro.models import layers as RL
from repro.models.api import get_api as ref_get_api

import jax

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import pruning as TP
from repro_torch.core import sparse_format as TS
from repro_torch.core import weight_plan as TW
from repro_torch.models import layers as TL


def _w(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("score", ["l1", "l2", "max"])
@pytest.mark.parametrize("q", [0.0, 0.3, 0.5, 0.9])
def test_block_mask_matches(score, q):
    w = _w((64, 96), seed=1)
    rc = RP.BlockPruneConfig(bk=16, bn=16, score=score)
    tc = TP.BlockPruneConfig(bk=16, bn=16, score=score)
    ref = np.asarray(RP.block_mask(jnp.asarray(w), q, rc)).astype(bool)
    got = TP.block_mask(torch.from_numpy(w), q, tc).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_pack_block_sparse_matches(quant, lead):
    """Stacked leaves share mb and a padded walk; every child is equal."""
    w = _w(lead + (64, 160), seed=2)
    rcfg = RW.PlanConfig(q_prune=0.5, bk=16, bn=16)
    tcfg = TW.PlanConfig(q_prune=0.5, bk=16, bn=16)
    ref = RW.pack_block_sparse(jnp.asarray(w), rcfg, quant=quant)
    got = TW.pack_block_sparse(torch.from_numpy(w), tcfg, quant=quant)
    assert got.kind == ref.kind and got.shape == ref.shape
    for name in ("blocks", "block_rows", "counts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    assert got.blocks.dtype == (torch.int8 if quant else torch.float32)
    for k in ("idx", "rows", "cols", "flags"):
        np.testing.assert_array_equal(got.walk[k].numpy(), np.asarray(ref.walk[k]), err_msg=k)
    if quant:
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref.scales))
    else:
        assert got.scales is None and ref.scales is None


def test_quantize_leaf_matches():
    w = _w((4, 96, 64), seed=3)
    ref = RW.quantize_leaf(jnp.asarray(w))
    got = TW.quantize_leaf(torch.from_numpy(w))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(ref["s"]))


def test_quantize_kv_matches():
    x = _w((2, 5, 3, 16), seed=4) * 3.0
    x[0, 0, 0] = 0.0  # the 1e-8 / 127 floor
    qr, sr = RL.quantize_kv(jnp.asarray(x))
    qt, st = TL.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sr))


@pytest.mark.parametrize("q", [0.0, 0.6, 0.95])
def test_walk_and_dense_round_trip(q):
    """build_walk equals the reference's (q=0.95 leaves empty columns), and
    to_block_sparse -> block_sparse_to_dense gives the masked matrix."""
    w = _w((128, 128), seed=5)
    cfg = TP.BlockPruneConfig(bk=32, bn=32)
    sp = TS.to_block_sparse(torch.from_numpy(w), q, cfg)
    rsp = RS.to_block_sparse(jnp.asarray(w), q, RP.BlockPruneConfig(bk=32, bn=32))
    np.testing.assert_array_equal(sp.block_rows.numpy(), np.asarray(rsp.block_rows))
    walk = TS.build_walk(sp.block_rows, sp.counts, sp.max_blocks)
    rwalk = RS.build_walk(np.asarray(rsp.block_rows), np.asarray(rsp.counts), rsp.max_blocks)
    for k in walk:
        np.testing.assert_array_equal(walk[k], rwalk[k])
    dense = TS.block_sparse_to_dense(sp).numpy()
    np.testing.assert_array_equal(dense, np.asarray(RS.block_sparse_to_dense(rsp)))
    mask = TP.expand_block_mask(TP.block_mask(torch.from_numpy(w), q, cfg), cfg).numpy()
    np.testing.assert_array_equal(dense, w * mask)


@pytest.mark.parametrize("default", ["dense", "quant", "block_sparse", "quant_sparse"])
def test_compress_smoke_model_matches(default):
    """The port's compress of the reference's own params gives the same
    representation per leaf and the same packed payload."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    from repro.configs import get_config as ref_get_config

    rcfg = ref_get_config("tinyllama-1.1b", smoke=True)
    params = ref_get_api(rcfg).init_params(rcfg, jax.random.key(0))
    ref = RW.compress(params, RW.PlanConfig(default=default, q_prune=0.5, bk=16, bn=16))
    tparams = interop.params_from_reference(jax.tree_util.tree_map(np.asarray, params))
    got = TW.compress(tparams, TW.PlanConfig(default=default, q_prune=0.5, bk=16, bn=16))
    assert sorted(got.leaves) == sorted(ref.leaves)
    for path, lp in ref.leaves.items():
        assert got.leaves[path].kind == lp.kind, path
        assert got.leaves[path].surviving == lp.surviving, path
        assert got.leaves[path].bytes == lp.bytes, path
    assert got.weight_bytes == ref.weight_bytes
    assert got.fused_pairs == ref.fused_pairs
    conv = interop.plan_from_reference(ref)
    for path in ref.leaves:
        a, b = got._by_path[path], conv._by_path[path]
        if isinstance(a, TW.PackedLinear):
            for name in ("blocks", "block_rows", "counts", "scales"):
                x, y = getattr(a, name), getattr(b, name)
                assert (x is None) == (y is None)
                if x is not None:
                    assert torch.equal(x, y), (path, name)
        elif isinstance(a, TW.QuantLinear):
            assert torch.equal(a.q, b.q) and torch.equal(a.s, b.s), path
        else:
            assert torch.equal(a, b), path
    assert cfg.n_layers == rcfg.n_layers
