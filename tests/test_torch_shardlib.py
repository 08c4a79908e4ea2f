"""The port's sharding placement (``distributed/shardlib``, ``launch/mesh``,
``distributed/elastic``, the plan's axes) against the reference's.

The reference resolves specs on meshes of one CPU device repeated
(``_fake_mesh``, as its own tests do); the port on ``MeshShape``s of the
same axis sizes.  Specs are compared entry for entry, padded with None to
the leaf's rank (a PartitionSpec may drop trailing Nones)."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import repro.configs as RCF
from repro.checkpoint import store as RCS
from repro.core import weight_plan as RW
from repro.distributed import elastic as RE
from repro.distributed import shardlib as RS
from repro.launch import mesh as RM
from repro.models import layers as RL  # noqa: F401 -- registers the cache kinds
from repro.models import transformer as RT
from repro.models.api import get_api as ref_get_api

from repro_torch import interop
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.core import weight_plan as WP
from repro_torch.distributed import elastic as E
from repro_torch.distributed import shardlib as sl
from repro_torch.kernels import block_sparse as BS
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.models.api import get_api

MESHES = [(2, 2), (1, 4), (1, 8), (4, 2)]
PLAN_CFG = dict(q_prune=0.5, bk=16, bn=16, min_size=1024)


def _fake_mesh(shape, axes=("data", "model")):
    n = int(np.prod(shape))
    return Mesh(np.asarray([jax.devices()[0]] * n).reshape(shape), axes)


def _port_mesh(shape, axes=("data", "model"), coords=None):
    return sl.MeshShape(dict(zip(axes, shape)), coords)


def _norm(spec, rank):
    """A spec as a tuple of ``rank`` entries, UNCONSTRAINED as the port's."""
    out = [sl.UNCONSTRAINED if e is P.UNCONSTRAINED else e for e in tuple(spec)]
    return tuple(out) + (None,) * (rank - len(out))


def _ref_specs(shardings, leaves):
    return [_norm(ns.spec, leaf.ndim) for ns, leaf in zip(jax.tree.leaves(shardings), leaves)]


@functools.lru_cache(maxsize=None)
def _plans(arch: str, compress: str):
    """(reference plan with axes, the port's plan of the same payload)."""
    rcfg = RCF.get_config(arch, smoke=True)
    rapi = ref_get_api(rcfg)
    params = rapi.init_params(rcfg, jax.random.key(0))
    rplan = rapi.compress(rcfg, params, RW.PlanConfig(default=compress, **PLAN_CFG))
    return rplan, interop.plan_from_reference(rplan)


@pytest.mark.parametrize("shape", MESHES + [(16,), (2, 16, 16)])
@pytest.mark.parametrize("unconstrained", [False, True])
def test_resolve_matches_reference(shape, unconstrained):
    axes = {1: ("model",), 2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
    ref, port = _fake_mesh(shape, axes), _port_mesh(shape, axes)
    cases = [(("batch", "seq", "kv_heads", None), (8, 16, 4, 64)),
             (("batch", None), (6, 3)), (("vocab", "d"), (256, 64)), (("d", "ff"), (64, 160)),
             (("kv_heads",), (6,)), (("heads", "qkv"), (32, 2048)), ((None, "d", "qkv"), (2, 64, 16)),
             (("zero", "d"), (32, 8)), (("experts", "d", "expert_ff"), (60, 8, 16))]
    for rules in (RS.DEFAULT_RULES, RM.rules_for(None, None, mesh=ref)):
        prules = dict(rules)
        for logical, dims in cases:
            want = _norm(RS._resolve(ref, rules, logical, dims, unconstrained), len(dims))
            assert sl._resolve(port, prules, logical, dims, unconstrained) == want, logical


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("compress", ["quant_sparse", "quant"])
def test_plan_specs_match_reference(shape, compress):
    """Every leaf of a compressed plan (packed children and walks, int8
    payloads and scales, the dense leaves) gets the reference's spec."""
    rplan, pplan = _plans("tinyllama-1.1b", compress)
    rules = RM.rules_for(RCF.get_config("tinyllama-1.1b", smoke=True), None,
                         mesh=_fake_mesh(shape))
    leaves = WP.flatten_leaves(pplan.params)
    want = _ref_specs(rplan.param_shardings(mesh=_fake_mesh(shape), rules=rules), leaves)
    got = [s.spec for s in WP.flatten_leaves(pplan.param_specs(mesh=_port_mesh(shape),
                                                               rules=dict(rules)))]
    assert got == want


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-4b"])
def test_port_compress_records_the_reference_axes(arch):
    """``api.compress`` in the port records each leaf's dense axes as the
    reference's does, and dense params resolve through ``param_axes``."""
    rplan, _ = _plans(arch, "quant_sparse")
    rcfg, cfg = RCF.get_config(arch, smoke=True), get_config(arch, smoke=True)
    rparams = ref_get_api(rcfg).init_params(rcfg, jax.random.key(0))
    params = interop.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams))
    plan = get_api(cfg).compress(cfg, params, WP.PlanConfig(default="quant_sparse", **PLAN_CFG))
    assert {p: l.axes for p, l in plan.leaves.items()} == \
        {p: tuple(l.axes) for p, l in rplan.leaves.items()}
    mesh, rmesh = _port_mesh((2, 2)), _fake_mesh((2, 2))
    want = _ref_specs(RS.tree_shardings(rparams, ref_get_api(rcfg).param_axes(rcfg), mesh=rmesh,
                                        rules=RS.DEFAULT_RULES), WP.flatten_leaves(params))
    got = sl.tree_specs(params, get_api(cfg).param_axes(cfg), mesh=mesh, rules=sl.DEFAULT_RULES)
    assert [s.spec for s in WP.flatten_leaves(got)] == want


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-4b"])
@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("shape", MESHES)
def test_cache_specs_match_reference(arch, paged, shape):
    """An int8 cache's per-layer leaves (pools and scale pools, or rings and
    their scales) and the page table resolve as the reference's stacked
    leaves do, without their leading layer axis."""
    rcfg, cfg = RCF.get_config(arch, smoke=True), get_config(arch, smoke=True)
    kw = dict(page_size=8, num_pages=9) if paged else {}
    rcache = jax.eval_shape(functools.partial(RT.init_cache, rcfg, 4, 16, jnp.float32,
                                              kv_dtype=jnp.int8, **kw))
    rules = RS.DEFAULT_RULES
    rsh = RS.tree_shardings(rcache, RT.cache_axes(rcfg, quantized_kv=True, paged=paged),
                            mesh=_fake_mesh(shape), rules=rules)
    cache = T.init_cache(cfg, 4, 16, torch.float32, kv_dtype=torch.int8, device="meta", **kw)
    got = sl.tree_specs(cache, T.cache_axes(cfg, quantized_kv=True, paged=paged),
                        mesh=_port_mesh(shape), rules=rules)
    unit, n_units, rem = T.find_unit(cfg.layer_kinds)
    ref_layers = [rsh["unit"][pi] for _ in range(n_units) for pi in range(len(unit))]
    ref_layers += [rsh["rem"][ri] for ri, (_, c) in enumerate(T.rem_runs(rem)) for _ in range(c)]
    assert len(ref_layers) == len(got["layers"])
    for i, (layer, ref_layer) in enumerate(zip(got["layers"], ref_layers)):
        for k, spec in layer.items():
            assert spec.spec == _norm(ref_layer[k].spec, cache["layers"][i][k].dim() + 1)[1:], k
    if paged:
        assert got["page_table"].spec == _norm(rsh["page_table"].spec, 2)


@pytest.mark.parametrize("shape", MESHES + [(16, 1), (1, 16)])
def test_degrees_match_reference(shape):
    ref, port = _fake_mesh(shape), _port_mesh(shape)
    for kvh in (0, 1, 2, 4, 6, 8):
        assert sl.parallelism_degrees(port, sl.DEFAULT_RULES, kvh) == \
            RS.parallelism_degrees(ref, RS.DEFAULT_RULES, kvh)
    for logical, dims in ((RS.axes_for("attn.kv"), (8, 16, 4, 8)), (("vocab", "d"), (256, 64))):
        for dim in (None, 0, 2):
            assert sl.shard_degree(port, sl.DEFAULT_RULES, logical, dims, dim=dim) == \
                RS.shard_degree(ref, RS.DEFAULT_RULES, logical, dims, dim=dim)
    assert sl.parallelism_degrees(None, sl.DEFAULT_RULES, 2) == (1, 1, 1)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b", "granite-moe-1b-a400m"])
@pytest.mark.parametrize("shape", MESHES + [(1, 16), (1, 3)])
def test_rules_for_matches_reference(arch, shape):
    rcfg, cfg = RCF.get_config(arch, smoke=True), get_config(arch, smoke=True)
    ref, port = _fake_mesh(shape), _port_mesh(shape)
    cells = [None, types.SimpleNamespace(kind="decode", global_batch=32),
             types.SimpleNamespace(kind="decode", global_batch=4),
             types.SimpleNamespace(kind="prefill", global_batch=4),
             types.SimpleNamespace(kind="train", global_batch=64)]
    for cell in cells:
        for sp in (False, True):
            want = RM.rules_for(rcfg, cell, sequence_parallel=sp, mesh=ref)
            assert M.rules_for(cfg, cell, sequence_parallel=sp, mesh=port) == want
    assert M.rules_for(cfg, None) == RM.rules_for(rcfg, None)
    assert M.opt_rules(dict(RS.DEFAULT_RULES)) == RM.opt_rules(RS.DEFAULT_RULES)
    assert M.make_production_mesh().shape == dict(
        zip(("data", "model"), (16, 16)))
    assert M.make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("n,mp", [(8, 2), (7, 2), (16, 4), (5, 5)])
def test_replan_mesh_matches_reference(n, mp):
    devs = [jax.devices()[0]] * ((n // mp) * mp)
    ref = RE.replan_mesh(n, model_parallel=mp, devices=devs)
    assert E.replan_mesh(n, model_parallel=mp).shape == dict(ref.shape)
    with pytest.raises(ValueError, match="cannot sustain"):
        E.replan_mesh(mp - 1, model_parallel=mp)


def test_registry_tables_match_reference():
    ref, port = RS.registry_table(), sl.registry_table()
    shared = set(ref) & set(port)
    assert {"attn.kv", "attn.kv_scale", "attn.kv_pages", "attn.kv_scale_pages", "page_table",
            "rec.state.h", "mlstm.state.C", "slstm.state.m", "encdec.xkv_pages"} <= shared
    assert all(port[k] == ref[k] for k in shared if k != "node_kinds")
    assert port["node_kinds"] == ("packed", "quant")
    rk, pk = RS.cache_kind_table(), sl.cache_kind_table()
    assert set(pk) <= set(rk)
    for k in pk:
        assert (pk[k].positional, pk[k].paged, pk[k].family) == \
            (rk[k].positional, rk[k].paged, rk[k].family), k


def test_plan_axes_survive_save_load_both_ways(tmp_path):
    """A directory either package wrote gives the other the same axes, and
    so the same specs."""
    rplan, pplan = _plans("tinyllama-1.1b", "quant_sparse")
    cfg = get_config("tinyllama-1.1b", smoke=True)
    dense = T.init_params(cfg, 0, device="cpu")
    mesh, rmesh = _port_mesh((1, 4)), _fake_mesh((1, 4))
    RW.save_plan(str(tmp_path / "ref"), rplan)
    loaded = WP.load_plan(str(tmp_path / "ref"), dense)
    assert {p: l.axes for p, l in loaded.leaves.items()} == \
        {p: tuple(l.axes) for p, l in rplan.leaves.items()}
    want = _ref_specs(rplan.param_shardings(mesh=rmesh, rules=RS.DEFAULT_RULES),
                      WP.flatten_leaves(loaded.params))
    got = loaded.param_specs(mesh=mesh, rules=sl.DEFAULT_RULES)
    assert [s.spec for s in WP.flatten_leaves(got)] == want
    # the other way: the reference's reader takes each leaf's axes from the
    # manifest as ``tuple(d.get("axes") or ())`` (its load_plan then stops at
    # its treedef check, which no port directory passes: ROADMAP C1c)
    WP.save_plan(str(tmp_path / "port"), pplan)
    meta = RCS.restore_flat(str(tmp_path / "port"))[1]["metadata"]
    assert {p: tuple(d.get("axes") or ()) for p, d in meta["leaves"].items()} == \
        {p: tuple(l.axes) for p, l in rplan.leaves.items()}
    back = WP.load_plan(str(tmp_path / "port"), dense)
    assert {p: l.axes for p, l in back.leaves.items()} == \
        {p: l.axes for p, l in pplan.leaves.items()}


def _coords(shape):
    return [dict(zip(("data", "model"), divmod(r, shape[1]))) for r in range(shape[0] * shape[1])]


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_pieces_tile_the_whole_leaf(shape, tmp_path):
    """The ranks' pieces (``local_piece``, ``elastic.reshard_tree``,
    ``store.restore(shardings=)``) put together give the whole leaf."""
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32)),
            "c": torch.from_numpy(rng.standard_normal((4, 6, 8)).astype(np.float32))}
    axes = {"w": ("d", "ff"), "c": ("batch", None, "kv_heads")}
    store.save(str(tmp_path), 0, tree)
    pieces = []
    for co in _coords(shape):
        mesh = _port_mesh(shape, coords=co)
        local = E.reshard_tree(tree, axes, mesh, sl.DEFAULT_RULES)
        specs = sl.tree_specs(tree, axes, mesh=mesh, rules=sl.DEFAULT_RULES)
        restored, _ = store.restore(str(tmp_path), tree, shardings=specs)
        for k in tree:
            assert torch.equal(restored[k], local[k])
        pieces.append((co, local))
    D, Mm = shape
    w = torch.cat([pieces[r][1]["w"] for r in range(Mm)], dim=1)
    assert torch.equal(w, tree["w"])
    c = torch.cat([torch.cat([pieces[d * Mm + m][1]["c"] for m in range(Mm)], dim=2)
                   for d in range(D)], dim=0)
    assert torch.equal(c, tree["c"])
    with pytest.raises(TypeError, match="Spec"):
        store.restore(str(tmp_path), tree, shardings={"w": None, "c": None})


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_local_packed_leaf_runs_its_columns(shape):
    """A packed leaf whose block columns divide the model axis splits into
    whole columns with their row blocks, counts, scales and a walk of their
    own (B1's plain version on them gives the whole product's columns);
    one whose counts do not divide stays whole, where the reference's spec
    still shards its blocks (ROADMAP C1)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 64, generator=g)
    for N in (64, 160):
        w = torch.randn(64, N, generator=g)
        node = WP.pack_block_sparse(w, WP.PlanConfig(q_prune=0.5, bk=16, bn=16), quant=True)
        full = BS.block_sparse_matmul(x, node.blocks, node.block_rows, node.counts, node.scales)
        ncb = N // 16
        for co in _coords(shape):
            mesh = _port_mesh(shape, coords=co)
            leaf = WP.local_leaf(node, ("d", "ff"), mesh, sl.DEFAULT_RULES)
            if ncb % shape[1]:
                assert leaf is node
                continue
            assert isinstance(leaf, WP.ShardedLeaf) and leaf.n_split and not leaf.k_split
            loc = leaf.local
            n = N // shape[1]
            assert loc.shape == (64, n) and loc.walk is not None
            y = BS.block_sparse_matmul(x, loc.blocks, loc.block_rows, loc.counts, loc.scales)
            torch.testing.assert_close(y, full[:, co["model"] * n:(co["model"] + 1) * n],
                                       rtol=0, atol=0)
            from repro_torch.core.sparse_format import build_walk
            wk = build_walk(loc.block_rows.numpy(), loc.counts.numpy(), loc.block_rows.shape[-1])
            assert all(np.array_equal(loc.walk[k].numpy(), wk[k]) for k in wk)


class _OnCard(torch.Tensor):
    @property
    def is_cuda(self):
        return True


def test_b3_reads_a_ranks_kv_heads(monkeypatch):
    """B3's ``kv_heads`` (offset, count): the plain version equals attention
    over a sliced copy of the pools, and the C entry gets the pools' KV
    heads, the offset and the count read (the grid's KV heads)."""
    from repro_torch.kernels import build

    g = torch.Generator().manual_seed(0)
    B, hd, kvh, ps, pages = 2, 64, 4, 16, 9
    q = torch.randn(B, 1, 4, hd, generator=g)
    kp, vp = (torch.randn(pages, ps, kvh, hd, generator=g) for _ in range(2))
    table = torch.randint(1, pages, (B, 4), generator=g, dtype=torch.int32)
    pos = torch.tensor([5, 50], dtype=torch.int32)
    got = FA.paged_decode_attention(q, kp, vp, table, pos, kv_heads=(2, 1))
    want = FA.paged_decode_attention(q, kp[:, :, 2:3].clone(), vp[:, :, 2:3].clone(), table, pos)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    calls = []
    lib = types.SimpleNamespace(paged_decode_launch=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(build, "check", lambda lib, code, what: None)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(BS, "sm_count", lambda device: 132)
    monkeypatch.setattr(FA.paged_decode_attention, "launches", 0)
    monkeypatch.setattr(FA.paged_decode_attention, "launches_by_t", {})
    card = [t.to(torch.bfloat16).as_subclass(_OnCard) for t in (q, kp, vp)]
    FA.paged_decode_attention(card[0], card[1], card[2], table.as_subclass(_OnCard),
                              pos.as_subclass(_OnCard), kv_heads=(2, 1))
    (args,) = calls
    # ..., B, T, H, KVH, hd, ..., q_dtype, kv_dtype, pool_kvh, kv_off, split, stages, groups
    assert args[8:13] == (B, 1, 4, 1, hd)
    assert args[22:24] == (kvh, 2)
    with pytest.raises(ValueError, match="outside"):
        FA.paged_decode_attention(card[0], card[1], card[2], table.as_subclass(_OnCard),
                                  pos.as_subclass(_OnCard), kv_heads=(3, 2))


def test_shard_takes_a_ranks_piece_only_under_a_mesh():
    """``shard`` / ``shard_pinned``: the whole tensor without a mesh; under
    one, this rank's piece by the logical axes (a dropped mapping keeps
    its dimension whole), as ``data_rows`` says for the batch."""
    x = torch.arange(24.0).reshape(4, 6)
    assert sl.shard(x, "batch", "ff") is x and sl.data_rows(4) is None
    mesh = _port_mesh((2, 2), coords={"data": 1, "model": 0})
    with sl.use_mesh(mesh):
        assert torch.equal(sl.shard(x, "batch", "ff"), x[2:, :3])
        assert torch.equal(sl.shard_pinned(x, "batch", None), x[2:])
        assert torch.equal(sl.shard(x[:3], "batch", None), x[:3])  # 3 rows: whole
        assert sl.data_rows(4) == slice(2, 4) and sl.data_rows(3) is None
        assert (sl.axis_size("model"), sl.axis_index("data")) == (2, 1)
        with pytest.raises(ValueError, match="axes"):
            sl.shard(x, "batch")
    assert sl.current_mesh() is None


def test_mesh_specs_backends_and_the_host_mesh(monkeypatch):
    """``--mesh``'s forms; NCCL where each rank owns a card, gloo on the
    CPU or for ranks that share a card (only when asked: refused otherwise,
    as the reference refuses more ranks than devices); "host" on the CPU is
    a 1 x 1 DeviceMesh over a group of one."""
    import torch.distributed as dist

    assert M.parse_mesh("none") is None and M.parse_mesh("4x2") == (4, 2)
    assert M.parse_mesh("host") == (1, 1)
    for bad in ("4by2", "0x2"):
        with pytest.raises(ValueError):
            M.parse_mesh(bad)
    assert M.choose_backend(8, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert M.choose_backend(2, "cuda") == "nccl"
    with pytest.raises(ValueError, match="--share-card"):
        M.choose_backend(4, "cuda")
    assert M.choose_backend(4, "cuda", share_card=True) == "gloo"
    mesh = M.make_host_mesh()
    try:
        assert sl.axis_sizes(mesh) == {"data": 1, "model": 1}
        assert sl.mesh_coords(mesh) == {"data": 0, "model": 0}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh, joins", [("2x8", True), ("none", False), ("1x1", False)])
def test_torchrun_ranks_choose_the_backend_per_host(monkeypatch, mesh, joins):
    """Under ``torchrun`` a rank joins the group only when ``--mesh`` asks
    for more than one rank, and chooses its backend from the ranks on its
    own host: 2 hosts x 8 cards (world 16) is NCCL, not refused."""
    from repro_torch.launch import serve

    env = {"WORLD_SIZE": "16", "LOCAL_WORLD_SIZE": "8", "RANK": "9", "LOCAL_RANK": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(serve, "_device_type", lambda args: "cuda")
    cards, joined = [], []
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setattr(M, "init_rank", lambda *a: joined.append(a))
    args = serve.build_parser().parse_args(["--arch", "tinyllama-1.1b", "--mesh", mesh])
    assert serve._join_torchrun(args) is joins
    assert joined == ([(9, 16, "nccl")] if joins else [])
    assert cards == ([torch.device("cuda", 1)] if joins else [])
