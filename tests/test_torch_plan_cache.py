"""PyTorch port vs the JAX reference for the plan cache (``--plan-cache``)
and kernel B4, the per-column block-sparse sweep that serves packed leaves
without a walk (tinyllama smoke config, fp32, 16-blocks).

A plan directory is the reference's ``checkpoint/store`` layout: one
``.npy`` per leaf in ``jax.tree_util`` flatten order plus a manifest.  The
port reads directories the reference writes (leaves equal exactly), writes
its own in the same layout, and routes a walk-less packed leaf to B4 as
the reference's jitted engine does.  Integer payloads, rows, counts, walks,
scales and greedy streams are held to exact equality; fp32 logits to 1e-5
(both packages run the same weights in fp32, summed in another order); B4's
plain version to the Pallas kernel in interpret mode at rtol 1e-5 / atol
2e-4, the tolerance of the reference's own kernel tests."""

import dataclasses
import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import weight_plan as RW
from repro.core.sparse_format import BlockSparse as RBlockSparse
from repro.core.pruning import BlockPruneConfig as RBlock
from repro.kernels import block_sparse as rbs
from repro.launch import serve as ref_serve
from repro.models import transformer as RT
from repro.models.api import get_api as ref_get_api
from repro.serving.engine import ServingEngine as RServingEngine

from repro_torch import interop
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.core import weight_plan as TW
from repro_torch.kernels import block_sparse as BS
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServingEngine

MM_TOL = dict(rtol=1e-5, atol=2e-4)
SMOKE_FLAGS = ["--arch", "tinyllama-1.1b", "--smoke", "--requests", "4", "--max-new", "5",
               "--compress", "quant_sparse", "--q-prune", "0.5", "--block", "16",
               "--kv-dtype", "int8", "--page-size", "16", "--share-prefix"]


# -- B4: plain version vs the Pallas per-column kernel ------------------------

def _packed(quant: bool, seed: int):
    """A reference PackedLinear (96 x 128 in 32-blocks at q 0.5): block
    column 0 is all zero, so it keeps no block (counts 0), and the other
    columns keep uneven counts."""
    w = np.random.default_rng(seed).normal(size=(96, 128)).astype(np.float32)
    w[:, :32] = 0.0
    ref = RW.pack_block_sparse(jnp.asarray(w), RW.PlanConfig(q_prune=0.5, bk=32, bn=32),
                               quant=quant)
    counts = np.asarray(ref.counts)
    assert counts[0] == 0 and len(set(counts[1:].tolist())) > 1, counts
    return ref


@pytest.mark.parametrize("M", [1, 8, 37])
@pytest.mark.parametrize("quant", [True, False])
def test_b4_plain_matches_pallas(quant, M):
    """int8 payload with scales and fp32 payload without, against
    ``block_sparse_matmul(..., interpret=True)`` with the batch padded to
    ``block_b = min(128, max(8, M))`` as the reference's ``ops`` pads it."""
    ref = _packed(quant, seed=M)
    x = np.random.default_rng(100 + M).normal(size=(M, 96)).astype(np.float32)
    block_b = min(128, max(8, M))
    xp = np.zeros((-(-M // block_b) * block_b, 96), np.float32)
    xp[:M] = x
    sparse = RBlockSparse(ref.blocks, ref.block_rows, ref.counts, ref.shape,
                          RBlock(bk=ref.bk, bn=ref.bn))
    want = np.asarray(rbs.block_sparse_matmul(jnp.asarray(xp), sparse, scales=ref.scales,
                                              block_b=block_b, interpret=True))[:M]
    args = [torch.from_numpy(np.array(a)) for a in (ref.blocks, ref.block_rows, ref.counts)]
    scales = None if ref.scales is None else torch.from_numpy(np.array(ref.scales))
    n = BS.block_sparse_matmul_col.launches
    got = BS.block_sparse_matmul_col(torch.from_numpy(x), *args, scales)
    assert BS.block_sparse_matmul_col.launches == n  # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == (M, 128)
    np.testing.assert_allclose(got.numpy(), want, **MM_TOL)
    assert not got[:, :32].any()  # the empty column


# -- leaf order and the store -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_plan(q_prune: float = 0.5):
    rcfg = ref_get_config("tinyllama-1.1b", smoke=True)
    api = ref_get_api(rcfg)
    params = api.init_params(rcfg, jax.random.key(0))
    return rcfg, params, api.compress(rcfg, params, RW.PlanConfig(
        default="quant_sparse", q_prune=q_prune, bk=16, bn=16))


def _walkless_ref_plan(rplan):
    params = jax.tree_util.tree_map(
        lambda n: dataclasses.replace(n, walk=None) if isinstance(n, RW.PackedLinear) else n,
        rplan.params, is_leaf=lambda n: isinstance(n, RW.PackedLinear))
    return RW.WeightPlan(cfg=rplan.cfg, leaves=rplan.leaves, params=params,
                         _by_path=RW._index_nodes(params))


def _dense():
    return T.init_params(get_config("tinyllama-1.1b", smoke=True), 0, device="cpu")


def _assert_leaves_equal(got: list, want: list):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, i
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(i))
        assert g.numpy().dtype == w.dtype, i


def test_flatten_leaves_matches_jax_order(tmp_path):
    """The port's flatten order equals ``jax.tree_util.tree_leaves`` on a
    smoke plan, leaf for leaf (sorted dict keys, PackedLinear fields, walk
    keys, q/s of int8 leaves), and ``unflatten_leaves`` inverts it."""
    _, _, rplan = _ref_plan()
    RW.save_plan(str(tmp_path), rplan)
    plan = TW.load_plan(str(tmp_path), _dense())
    flat = TW.flatten_leaves(plan.params)
    _assert_leaves_equal(flat, jax.tree_util.tree_leaves(rplan.params))
    again = TW.unflatten_leaves(plan.params, flat)
    assert TW.flatten_leaves(again) == flat
    with pytest.raises(ValueError):
        TW.unflatten_leaves(plan.params, flat + [flat[0]])


def test_store_round_trip_with_bf16(tmp_path):
    leaves = [torch.randn(3, 5).to(torch.bfloat16), torch.arange(7, dtype=torch.int32),
              torch.randint(-127, 128, (4, 2), dtype=torch.int8), torch.randn(6)]
    store.save(str(tmp_path), 4, leaves, metadata={"k": [1, 2]})
    got, manifest = store.restore_flat(str(tmp_path))
    assert manifest["step"] == 4 and manifest["n_leaves"] == 4
    assert manifest["metadata"] == {"k": [1, 2]}
    assert [e["dtype"] for e in manifest["leaves"]] == ["bfloat16", "int32", "int8", "float32"]
    for g, w in zip(got, leaves):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_store_reads_reference_bf16_leaves(tmp_path):
    """``np.save`` writes the reference's bf16 arrays as 2-byte void records;
    the manifest's dtype turns them back into bfloat16."""
    arr = np.asarray(jnp.asarray([[1.5, -2.25], [3.0, 0.1]], jnp.bfloat16))
    path = tmp_path / "step_000000000"
    path.mkdir()
    np.save(path / "leaf_00000.npy", arr)
    (path / "MANIFEST.json").write_text(json.dumps(
        {"step": 0, "n_leaves": 1, "treedef": "*", "metadata": {},
         "leaves": [{"dtype": "bfloat16", "shape": [2, 2]}]}))
    got, _ = store.restore_flat(str(tmp_path))
    assert got[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(got[0].float().numpy(), arr.astype(np.float32))


def test_store_ignores_incomplete_steps_and_keeps_one(tmp_path):
    base = str(tmp_path)
    with pytest.raises(FileNotFoundError):
        store.restore_flat(base)
    (tmp_path / "step_000000009.tmp").mkdir()  # a save that never finished
    (tmp_path / "step_000000008").mkdir()      # a step without its manifest
    assert store.all_steps(base) == [] and store.latest_step(base) is None
    with pytest.raises(FileNotFoundError):
        store.restore_flat(base)
    store.save(base, 1, [torch.zeros(2)], keep=1)
    store.save(base, 2, [torch.ones(2)], keep=1)
    assert store.all_steps(base) == [2]
    assert not (tmp_path / "step_000000001").exists()
    got, manifest = store.restore_flat(base)
    assert manifest["step"] == 2 and torch.equal(got[0], torch.ones(2))


# -- reference directories in the port ---------------------------------------

def test_reference_plan_loads_exactly_and_prefills_alike(tmp_path):
    rcfg, _, rplan = _ref_plan()
    RW.save_plan(str(tmp_path), rplan)
    cfg = get_config("tinyllama-1.1b", smoke=True)
    plan = TW.load_plan(str(tmp_path), _dense(), use_kernel=False)
    assert plan.cfg == TW.PlanConfig(default="quant_sparse", q_prune=0.5, bk=16, bn=16,
                                     use_kernel=False)
    assert set(plan.leaves) == set(rplan.leaves) and plan.fused_pairs == rplan.fused_pairs
    assert plan.weight_bytes == rplan.weight_bytes
    _assert_leaves_equal(TW.flatten_leaves(plan.params), jax.tree_util.tree_leaves(rplan.params))
    w = plan.params["unit"][0]["mlp"]["w_down"]
    assert isinstance(w, TW.PackedLinear) and w.walk is not None and not w.use_kernel
    assert isinstance(plan.params["embed"]["head"], TW.QuantLinear)

    prompt = np.random.default_rng(7).integers(0, 256, size=(2, 9)).astype(np.int32)
    rcache = RT.init_cache(rcfg, 2, 16, jnp.float32)
    rl, _ = jax.jit(functools.partial(RT.prefill, rcfg))(rplan.params, jnp.asarray(prompt),
                                                         rcache)
    tl, _ = T.prefill(cfg, T.unstack(cfg, plan.params), torch.from_numpy(prompt),
                      T.init_cache(cfg, 2, 16, torch.float32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=1e-5, atol=1e-5)


def _spy(monkeypatch, name):
    calls = []
    fn = getattr(BS, name)

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return fn(*a, **kw)

    monkeypatch.setattr(BS, name, spy)
    return calls


def _prompts():
    r = np.random.default_rng(0)
    prefix = r.integers(0, 256, 12).astype(np.int32)
    out = [prefix] + [np.concatenate([prefix, r.integers(0, 256, 4).astype(np.int32)])
                      for _ in range(2)]
    return out + [r.integers(0, 256, 16).astype(np.int32)]


@pytest.mark.parametrize("walks", ["kept", "dropped"])
def test_dispatch_follows_the_walk(walks, tmp_path, monkeypatch):
    """A reference plan saved with its walks loads with them, and every
    packed projection runs B1; saved without (``has_walk: false``) it loads
    walk-less and every one runs B4, as the reference's jitted engine runs
    it.  Either way the greedy streams equal the reference engine's on the
    same plan."""
    from repro.serving.config import CacheConfig as RCacheConfig
    from repro.serving.config import EngineConfig as REngineConfig
    from repro.serving.engine import Request as RRequest

    from repro_torch.serving.config import CacheConfig, EngineConfig
    from repro_torch.serving.engine import Request

    rcfg, _, rplan = _ref_plan()
    if walks == "dropped":
        rplan = _walkless_ref_plan(rplan)
    RW.save_plan(str(tmp_path), rplan)
    meta = store.restore_flat(str(tmp_path))[1]["metadata"]["packed"]
    assert {m["has_walk"] for m in meta.values() if m["repr"] == "packed"} == \
        {walks == "kept"}
    plan = TW.load_plan(str(tmp_path), _dense())
    packed = [n for n in plan._by_path.values() if isinstance(n, TW.PackedLinear)]
    assert packed and all((n.walk is not None) == (walks == "kept") for n in packed)
    converted = interop.plan_from_reference(rplan)  # the in-memory route agrees
    assert all((n.walk is not None) == (walks == "kept")
               for n in converted._by_path.values() if isinstance(n, TW.PackedLinear))

    b1, b4 = _spy(monkeypatch, "block_sparse_matmul"), _spy(monkeypatch, "block_sparse_matmul_col")
    page = dict(kv_dtype="int8", page_size=8, share_prefix=True)
    ref = RServingEngine(rcfg, rplan.params, plan=rplan,
                         config=REngineConfig(max_len=32, max_batch=4, cache=RCacheConfig(**page)))
    eng = ServingEngine(get_config("tinyllama-1.1b", smoke=True), None, plan=plan, device="cpu",
                        config=EngineConfig(max_len=32, max_batch=4, cache=CacheConfig(**page)))
    rreqs = [RRequest(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(_prompts())]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(_prompts())]
    for r, rr in zip(reqs, rreqs):
        eng.submit(r)
        ref.submit(rr)
    ref.run_until_done()
    eng.run_until_done()
    assert [r.output for r in reqs] == [r.output for r in rreqs]
    # the smoke plan packs only w_down per layer for apply_linear (wq..wo
    # are too small to pack; gate/up go to B2): one launch per layer and
    # model step
    steps = eng.stats.prefills + eng.stats.decode_steps
    want = steps * get_config("tinyllama-1.1b", smoke=True).n_layers
    assert (len(b1), len(b4)) == ((want, 0) if walks == "kept" else (0, want))


# -- the port's own directories -----------------------------------------------

def test_port_round_trip_is_exact(tmp_path):
    plan = TW.compress(_dense(), TW.PlanConfig(q_prune=0.5, bk=16, bn=16))
    TW.save_plan(str(tmp_path), plan)
    got = TW.load_plan(str(tmp_path), _dense())
    assert got.cfg == plan.cfg and got.leaves == plan.leaves
    assert got.fused_pairs == plan.fused_pairs == 1  # the stacked unit's gate/up
    a, b = TW.flatten_leaves(got.params), TW.flatten_leaves(plan.params)
    assert len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                    for x, y in zip(a, b))
    assert set(got._by_path) == set(plan._by_path)
    # saving another plan over it replaces it (keep=1)
    TW.save_plan(str(tmp_path), TW.compress(_dense(), TW.PlanConfig(q_prune=0.25, bk=16,
                                                                    bn=16)))
    assert store.all_steps(str(tmp_path)) == [0]
    assert TW.load_plan(str(tmp_path), _dense()).cfg.q_prune == 0.25


def test_bf16_plan_round_trip(tmp_path):
    """A bf16 model (the full-width dtype) keeps its bf16 dense leaves
    through the store."""
    dense = TW.map_tree(lambda _, t: t.to(torch.bfloat16), _dense())
    plan = TW.compress(dense, TW.PlanConfig(q_prune=0.5, bk=16, bn=16))
    TW.save_plan(str(tmp_path), plan)
    got = TW.load_plan(str(tmp_path), dense)
    a, b = TW.flatten_leaves(got.params), TW.flatten_leaves(plan.params)
    assert any(x.dtype == torch.bfloat16 for x in b)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def test_load_rejects_another_shape(tmp_path):
    cfg = get_config("tinyllama-1.1b", smoke=True)
    for other in (dataclasses.replace(cfg, d_ff=192), dataclasses.replace(cfg, n_layers=3),
                  dataclasses.replace(cfg, vocab=320)):
        d = tmp_path / f"{other.d_ff}-{other.n_layers}-{other.vocab}"
        TW.save_plan(str(d), TW.compress(T.init_params(other, 0, device="cpu"),
                                         TW.PlanConfig(q_prune=0.5, bk=16, bn=16)))
        with pytest.raises(ValueError, match="plan cache"):
            TW.load_plan(str(d), _dense())


def test_cli_outcomes(tmp_path, capsys):
    """missing -> packs and saves; hit; a changed --q-prune is stale and
    re-packs; a directory saved for another shape is incompatible and
    re-packs."""
    d = str(tmp_path / "plan")

    def run(*extra):
        serve.main(SMOKE_FLAGS + ["--requests", "2", "--max-new", "2", "--device", "cpu",
                                  "--plan-cache", d, *extra])
        return capsys.readouterr().out

    out = run()
    assert "plan cache missing" in out and "packed weights" in out and "plan cached to" in out
    assert "plan cache hit" in run()
    out = run("--q-prune", "0.25")
    assert "plan cache stale" in out and "packed weights" in out
    assert TW.load_plan(d, _dense()).cfg.q_prune == 0.25
    other = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True), d_ff=192)
    TW.save_plan(d, TW.compress(T.init_params(other, 0, device="cpu"),
                                TW.PlanConfig(q_prune=0.5, bk=16, bn=16)))
    out = run()
    assert "plan cache incompatible" in out and "packed weights" in out
    assert "plan cache hit" in run()


def _recording(cls):
    class Recording(cls):
        submitted: list = []

        def submit(self, req):
            Recording.submitted.append(req)
            return super().submit(req)

    return Recording


def test_clis_share_one_directory(tmp_path, monkeypatch, capsys):
    """The reference CLI packs and saves with the quickstart smoke flags;
    the port's CLI, same flags plus --device cpu, hits that directory and
    emits the reference run's greedy tokens."""
    d = str(tmp_path / "plan")
    rec_ref = _recording(RServingEngine)
    monkeypatch.setattr(ref_serve, "ServingEngine", rec_ref)
    ref_serve.main(SMOKE_FLAGS + ["--plan-cache", d])
    assert "plan cached to" in capsys.readouterr().out
    rec = _recording(ServingEngine)
    monkeypatch.setattr(serve, "ServingEngine", rec)
    eng = serve.main(SMOKE_FLAGS + ["--plan-cache", d, "--device", "cpu"])
    assert "plan cache hit" in capsys.readouterr().out
    assert len(rec.submitted) == len(rec_ref.submitted) == 4
    for r, rr in zip(rec.submitted, rec_ref.submitted):
        np.testing.assert_array_equal(r.prompt, rr.prompt)
        assert len(r.output) == 5 and r.output == rr.output
    eng.audit_pages()
    assert eng.pages_in_use == 0


def test_reference_cli_repacks_a_port_directory(tmp_path, capsys):
    """The port's CLI packs and saves; the reference's CLI on that directory
    finds it incompatible (its treedef check), re-packs and serves without
    raising; the port's directory, kept aside, still hits in the port."""
    d, kept = tmp_path / "plan", tmp_path / "kept"
    serve.main(SMOKE_FLAGS + ["--plan-cache", str(d), "--device", "cpu"])
    assert "plan cache missing" in capsys.readouterr().out
    meta = store.restore_flat(str(d))[1]["metadata"]
    assert all(m["interpret"] is False for m in meta["packed"].values() if m["repr"] == "packed")
    shutil.copytree(d, kept)
    ref_serve.main(SMOKE_FLAGS + ["--plan-cache", str(d)])
    out = capsys.readouterr().out
    assert "plan cache incompatible" in out and "packed weights" in out
    # both CLIs record each leaf's logical axes (``api.compress``), the same
    ref_meta = store.restore_flat(str(d))[1]["metadata"]
    assert {p: leaf["axes"] for p, leaf in meta["leaves"].items()} == \
        {p: leaf["axes"] for p, leaf in ref_meta["leaves"].items()}
    assert any(leaf["axes"] for leaf in meta["leaves"].values())
    assert TW.load_plan(str(kept), _dense()).cfg.q_prune == 0.5
    serve.main(SMOKE_FLAGS + ["--plan-cache", str(kept), "--device", "cpu"])
    assert "plan cache hit" in capsys.readouterr().out
