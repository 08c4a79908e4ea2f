"""The port's dry run (``repro_torch/launch/dryrun.py``) and the pieces it
stands on, against the reference where the reference has them.

- ``configs.shapes_for`` / ``all_cells`` / ``SUBQUADRATIC`` and
  ``api.input_specs`` equal the reference's for every arch at full width
  (the cells as sets: the two registries list the archs in other orders;
  the caches leaf for leaf, the reference's stacked layers unstacked).
- ``quantize_for_serving``'s int8 payloads and scales equal the
  reference's, exactly.
- ``lower_cell`` traces every arch and kind on a fake 2 x 2 mesh at smoke
  width (small shapes): the reference's record keys, argument bytes equal
  to the rank's share by its placement, collectives counted where the
  model axis is 2 and none on a 1 x 1 mesh; the records' n_params,
  n_active_params and model_flops_global equal the reference's formulas.
- ``main`` traces whisper-tiny's decode_32k cell at full width on the
  16 x 16 mesh and writes its JSON; a process group already up and an
  unknown variant are refused; the bf16 and int8 variants shrink the
  weight stream; the reference's ``kv8`` / ``int8_kv8`` (an e4m3 KV
  cache) and ``sp`` (sequence parallelism, train and prefill) run and
  move the bytes they should.
- The card's check at smoke width: a train step's traced matmul FLOPs
  equal ``FlopCounterMode``'s count of the same step run for real.

The reference's ``repro.launch.dryrun`` is not imported: it sets XLA_FLAGS
for 512 host devices at import."""

import collections
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as RC
from repro.models import layers as RL
from repro.models.api import get_api as ref_get_api
from repro.models.api import input_specs as ref_input_specs

import repro_torch.configs as C
from repro_torch import interop
from repro_torch.core import weight_plan as WP
from repro_torch.distributed import shardlib as sl
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.models.api import get_api, input_specs
from repro_torch.models.ssm import placement_axes
from repro_torch.training import optimizer as O
from repro_torch.training.trainer import make_train_step

# repro/launch/dryrun.py:324-357, the keys of analyze_cell's record
REF_RECORD_KEYS = {
    "arch", "shape", "mode", "mesh", "hlo_flops_per_device", "hlo_bytes_per_device",
    "hlo_bytes_by_category", "collectives", "memory", "n_params", "n_active_params",
    "xla_flops_unweighted", "model_flops_global", "model_flops_per_device",
    "useful_flops_ratio", "t_compute_s", "t_memory_s", "t_collective_s", "t_roofline_s",
    "dominant", "roofline_fraction", "seconds_lower", "seconds_compile"}
KINDS = ("train", "prefill", "decode")


# ---------------------------------------------------------------------------
# the registry's cells and the inputs of each cell
# ---------------------------------------------------------------------------


def _cells(mod):
    return {(a, s.name, runs) for a, s, runs in mod.all_cells()}


def test_cells_and_shapes_match_reference():
    assert set(C.ARCH_IDS) == set(RC.ARCH_IDS)
    assert C.SUBQUADRATIC == RC.SUBQUADRATIC
    assert [dataclasses.astuple(s) for s in C.ALL_SHAPES] == \
        [dataclasses.astuple(s) for s in RC.ALL_SHAPES]
    for arch in C.ARCH_IDS:
        assert [dataclasses.astuple(s) for s in C.shapes_for(arch)] == \
            [dataclasses.astuple(s) for s in RC.shapes_for(arch)]
    assert _cells(C) == _cells(RC)
    assert len(C.all_cells()) == 40 and sum(r for *_, r in C.all_cells()) == 33


def _leaves_by_name(tree, stacked: bool) -> collections.Counter:
    """(leaf name, shape, dtype) of every leaf, the reference's stacked
    cache leaves counted once a layer."""
    out = collections.Counter()
    if stacked:
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = getattr(path[-1], "key", str(path[-1]))
            out[(name, tuple(leaf.shape[1:]), str(jnp.dtype(leaf.dtype)))] += leaf.shape[0]
        return out

    def one(path, t):
        out[(path.rsplit("/", 1)[-1], tuple(t.shape), str(t.dtype).replace("torch.", ""))] += 1
        return t

    WP.map_tree(one, tree)
    return out


def _batch_leaves(tree, torch_side: bool) -> dict:
    conv = (lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", ""))) if torch_side else \
        (lambda s: (tuple(s.shape), str(jnp.dtype(s.dtype))))
    return {k: conv(v) for k, v in tree.items()}


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_input_specs_match_reference(arch):
    cfg, rcfg = C.get_config(arch), RC.get_config(arch)
    for shape in C.shapes_for(arch):
        got, want = input_specs(cfg, shape), ref_input_specs(rcfg, shape)
        assert set(got) == set(want)
        if "batch" in got:
            assert got["batch"]["tokens"].device.type == "meta"
            assert _batch_leaves(got["batch"], True) == _batch_leaves(want["batch"], False)
        for k in ("tokens", "pos"):
            if k in got:
                assert _batch_leaves({k: got[k]}, True) == _batch_leaves({k: want[k]}, False)
        if "cache" in got:
            assert _leaves_by_name(got["cache"], False) == \
                _leaves_by_name(want["cache"], True), shape.name


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-1b-a400m", "xlstm-350m"])
def test_quantize_for_serving_matches_reference(arch):
    rcfg = RC.get_config(arch, smoke=True)
    rparams = ref_get_api(rcfg).init_params(rcfg, jax.random.key(0))
    want = RL.quantize_for_serving(rparams, min_size=1024)
    got = L.quantize_for_serving(interop.params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams)), min_size=1024)
    wl = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda n: isinstance(n, dict) and set(n) == {"q", "s"})[0]
    n_quant = 0
    for path, leaf in wl:
        node = got
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        if isinstance(leaf, dict):
            assert isinstance(node, WP.QuantLinear)
            np.testing.assert_array_equal(node.q.numpy(), np.asarray(leaf["q"]))
            np.testing.assert_array_equal(node.s.numpy(), np.asarray(leaf["s"]))
            n_quant += 1
        else:
            assert isinstance(node, torch.Tensor)
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert n_quant > 0


# ---------------------------------------------------------------------------
# lower_cell on a fake 2 x 2 mesh
# ---------------------------------------------------------------------------

SMALL = {"train": C.ShapeSpec("train_small", 16, 4, "train"),
         "prefill": C.ShapeSpec("prefill_small", 24, 4, "prefill"),
         "decode": C.ShapeSpec("decode_small", 40, 4, "decode")}
MESH = sl.MeshShape({"data": 2, "model": 2}, coords={"data": 0, "model": 0})


def _bytes(tree) -> int:
    from repro_torch.launch.op_analysis import tensors

    return sum(t.numel() * t.element_size() for t in tensors(tree))


def _expected_argument_bytes(cfg, shape, variant: str = "baseline") -> int:
    """Rank 0's share of a cell's arguments by its placement under the
    reference's rules for the cell (``rules_for(cfg, shape)``: a decode
    cell's cache cut along its sequence), from the whole smoke tree cut
    with a MeshShape (no process group): its param pieces (ZeRO-1 moments
    and the int32 step at train), the global batch (train, prefill: every
    rank holds it), or its cache pieces plus tokens and pos (decode); a
    variant's params and cache leaves in its dtypes."""
    api = get_api(cfg)
    specs = input_specs(cfg, shape)
    batch = specs.get("batch", {})
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, remat=True)
        place = M.train_placement(cfg, MESH, sequence_parallel=variant == "sp")
        params = WP.map_tree(place.piece, api.init_params(cfg, 0, device="cpu"))
        return _bytes(params) + _bytes(O.init_opt_state(O.OptimizerConfig(), params,
                                                        placement=place)) + _bytes(batch)
    rules = M.rules_for(cfg, shape, sequence_parallel=variant == "sp", mesh=MESH)
    whole = api.init_params(cfg, 0, device="cpu")
    if variant.startswith("int8"):
        whole = L.quantize_for_serving(whole)
    params = WP.local_params(whole, placement_axes(api.param_axes(cfg)), MESH, rules)
    cache = specs["cache"] if not variant.endswith("kv8") else D._kv8(specs["cache"])
    cache = sl.local_zeros(cache, api.cache_axes(cfg), MESH, rules, "meta")
    inputs = [specs[k] for k in ("tokens", "pos") if k in specs]
    return _bytes(params) + _bytes(cache) + _bytes(batch) + _bytes(inputs)


@pytest.mark.parametrize("arch", C.ARCH_IDS)
@pytest.mark.parametrize("kind", KINDS)
def test_lower_cell_on_a_fake_2x2(arch, kind):
    cfg, shape = C.get_config(arch, smoke=True), SMALL[kind]
    cell = D.lower_cell(arch, shape, cfg=cfg, mesh=(2, 2))
    assert not dist.is_initialized()
    rec = D.analyze_cell(cell, cfg, shape)
    assert REF_RECORD_KEYS <= set(rec)
    assert (rec["mesh"], rec["mode"]) == ("2x2", kind)
    assert rec["memory"]["argument_bytes"] == _expected_argument_bytes(cfg, shape)
    assert 0 < rec["dot_flops_per_device"] <= rec["hlo_flops_per_device"]
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["collectives"]["counts"]["all-reduce"] + \
        rec["collectives"]["counts"]["all-gather"] > 0
    assert rec["fits"] and rec["peak_bytes_per_device"] > rec["memory"]["argument_bytes"]


@pytest.mark.parametrize("kind", KINDS)
def test_no_collectives_on_a_1x1_mesh(kind):
    cfg = C.get_config("granite-moe-1b-a400m", smoke=True)
    rec = D.analyze_cell(D.lower_cell("granite-moe-1b-a400m", SMALL[kind], cfg=cfg,
                                      mesh=(1, 1)), cfg, SMALL[kind])
    assert rec["collectives"]["total_bytes"] == 0
    assert sum(rec["collectives"]["counts"].values()) == 0
    assert rec["hlo_bytes_by_category"]["collective"] == 0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b", "whisper-tiny"])
def test_record_params_and_model_flops_match_reference(arch):
    """n_params / n_active_params exact against the reference's registry at
    full width; model_flops_global by the reference's formulas."""
    cfg, rcfg = C.get_config(arch), RC.get_config(arch)
    n = ref_get_api(rcfg).n_params_exact(rcfg)
    active = rcfg.n_active_params() if rcfg.moe is not None else n
    for shape in C.shapes_for(arch):
        cell = D.LoweredCell(arch, shape.name, shape.kind, "16x16", 256,
                             D.OA.Costs(flops=1.0), D.OA.Memory(), 0.0)
        rec = D.analyze_cell(cell, cfg, shape)
        B, S = shape.global_batch, shape.seq_len
        want = {"train": 6.0 * active * B * S, "prefill": 2.0 * active * B * S,
                "decode": 2.0 * active * B}[shape.kind]
        assert (rec["n_params"], rec["n_active_params"]) == (n, active)
        assert rec["model_flops_global"] == want
        assert rec["model_flops_per_device"] == want / 256


def test_main_writes_whisper_decode_at_full_width(tmp_path, capsys):
    D.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[dryrun] all cells OK" in out and "whisper-tiny" in out and "dom=" in out
    rec = json.loads((tmp_path / "whisper-tiny_decode_32k_16-16.json").read_text())
    assert REF_RECORD_KEYS <= set(rec)
    assert rec["mesh"] == "16x16" and rec["fits"]
    assert rec["n_params"] == get_api(C.get_config("whisper-tiny")).n_params_exact(
        C.get_config("whisper-tiny"))
    assert rec["collectives"]["total_bytes"] > 0 and rec["t_roofline_s"] > 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("variant,kind", [("kv8", "decode"), ("int8_kv8", "decode"),
                                          ("sp", "train"), ("sp", "prefill")])
def test_reference_variants_run_and_move_their_bytes(variant, kind):
    """The reference's ``kv8`` / ``int8_kv8`` (the attention caches' K/V in
    e4m3) and ``sp`` (``seq_sp``: the residual stream cut on its sequence)
    run on a fake 2 x 2 mesh at smoke width.  An e4m3 cache holds 1/4 of
    the fp32 cache's bytes (the arguments the rank's share, exactly);
    ``int8_kv8`` also quantizes the weights as ``int8`` does.  ``sp``
    places the same pieces and replaces the row-parallel all-reduces with
    reduce-scatters: fewer all-reduce bytes, reduce-scatters where the
    baseline has none."""
    cfg, shape = C.get_config("tinyllama-1.1b", smoke=True), SMALL[kind]
    base = D.lower_cell("tinyllama-1.1b", shape, cfg=cfg, mesh=(2, 2),
                        variant="int8" if variant == "int8_kv8" else "baseline")
    cell = D.lower_cell("tinyllama-1.1b", shape, cfg=cfg, mesh=(2, 2), variant=variant)
    assert not dist.is_initialized()
    assert cell.memory.argument_bytes == _expected_argument_bytes(cfg, shape, variant)
    coll, base_coll = cell.costs.collective_bytes, base.costs.collective_bytes
    if variant.endswith("kv8"):
        api = get_api(cfg)
        mine = sl.local_zeros(input_specs(cfg, shape)["cache"], api.cache_axes(cfg), MESH,
                              M.rules_for(cfg, shape, mesh=MESH), "meta")
        kv = sum(t.numel() for layer in mine["layers"] for k, t in layer.items()
                 if k in ("k", "v"))  # the rank's K/V elements: a quarter at 2 x 2
        assert kv * 4 == sum(t.numel() for layer in input_specs(cfg, shape)["cache"]["layers"]
                             for k, t in layer.items() if k in ("k", "v"))
        assert base.memory.argument_bytes - cell.memory.argument_bytes == 3 * kv
        assert cell.costs.bytes_by_cat["dot"] < base.costs.bytes_by_cat["dot"]
    else:
        assert cell.memory.argument_bytes == base.memory.argument_bytes
        assert base_coll["reduce-scatter"] == 0 < coll["reduce-scatter"]
        assert coll["all-reduce"] < base_coll["all-reduce"]


def test_refuses_beside_a_process_group(tmp_path):
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            D.lower_cell("tinyllama-1.1b", SMALL["decode"],
                         cfg=C.get_config("tinyllama-1.1b", smoke=True), mesh=(1, 1))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("variant", ["bf16", "int8"])
def test_serving_variants_shrink_the_weight_stream(variant):
    cfg, shape = C.get_config("tinyllama-1.1b", smoke=True), SMALL["decode"]
    base = D.lower_cell("tinyllama-1.1b", shape, cfg=cfg, mesh=(2, 2))
    cell = D.lower_cell("tinyllama-1.1b", shape, cfg=cfg, mesh=(2, 2), variant=variant)
    assert cell.memory.argument_bytes < base.memory.argument_bytes
    assert cell.costs.bytes_by_cat["dot"] < base.costs.bytes_by_cat["dot"]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-1b-a400m", "whisper-tiny"])
def test_traced_matmul_flops_equal_a_real_steps_flop_counter(arch):
    """The card's check, on the CPU at smoke width: the trace of a train
    step on a 1 x 1 mesh (meta tensors, no remat) counts the matmul FLOPs
    that ``FlopCounterMode`` counts for the same step run for real."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg, shape = C.get_config(arch, smoke=True), SMALL["train"]
    cell = D.lower_cell(arch, shape, cfg=cfg, mesh=(1, 1), remat=False)
    api = get_api(cfg)
    params = api.init_params(cfg, 0, device="cpu")
    oc = O.OptimizerConfig()
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in input_specs(cfg, shape)["batch"].items()}
    with FlopCounterMode(display=False) as counter:
        make_train_step(cfg, api.loss_fn, oc)(params, O.init_opt_state(oc, params), batch)
    assert cell.costs.dot_flops == counter.get_total_flops() > 0

