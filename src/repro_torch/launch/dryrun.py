"""Multi-pod dry run on the port (counterpart of ``repro/launch/dryrun.py``):
trace each (architecture x input shape) step on the production meshes as
one rank runs it, prove that its memory fits a card, and extract the
roofline terms.

Run:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--out DIR]

The reference lowers and compiles one SPMD program over 256 or 512 host
devices and analyzes its HLO.  The port runs one process a rank, so the
dry run traces rank 0 of the mesh in this one process: a fake process
group of 256 (16 x 16) or 512 (2 x 16 x 16) ranks
(``torch.testing._internal.distributed.fake_pg``), a ``DeviceMesh`` over
it, the rank's pieces of the params, optimizer state and caches placed by
``launch.mesh`` (``rules_for``, ``opt_rules``, ``train_placement``) and
``shardlib``, all of them tensors on the meta device: nothing is
allocated and the collectives send nothing.  The step runs eagerly under
``op_analysis.OpAnalysis``, which charges every op and collective the rank
dispatches.  The tensors are not CUDA tensors, so the plain versions of
the kernels run and no kernel launches -- as the reference lowers its jnp
paths on the CPU: the dry run counts the program's work, not a kernel's
speed.  The flash attention's chunk rows (``layers.flash_rows``) and the
sLSTM's token step (``ssm.slstm_step``) repeat with one signature a
layer; outside autograd their repeats replay the first call's costs
(``OpAnalysis.repeated``), which keeps a 32k-token prefill's trace to
seconds.

The step of each kind is the port's: ``make_train_step`` over the rank's
placement (the global batch on every rank, cut to the replica's rows),
``api.prefill`` and ``api.decode_step`` (each cuts its replica's rows, runs
them on its piece of a contiguous cache and gathers the logits).
Each cell runs under the reference's rules for its shape,
``rules_for(cfg, shape, sequence_parallel=(variant == "sp"))``: a decode
cell's contiguous cache is cut along its sequence (``cache_seq``: over
"model", or over ("data", "model") at long_500k's batch of 1) and read by
flash decoding (``layers.decode_attention``), an ``sp`` cell's residual
stream along its sequence (``seq_sp``), and the vocab-split logits of a
train step meet the vocab-parallel loss (``shardlib.vocab_nll``).  A rule
the port does not run raises (a prompt's sequence split over "data" at a
prefill below batch 16, which no cell of the registry has); none falls
back to a whole layout.

Variants, the reference's: ``baseline`` fp32 params; at prefill and decode
``bf16`` halves the weight stream, ``int8`` is ``layers.quantize_for_serving``,
``kv8`` an fp8 (e4m3) KV cache -- the attention caches' ``k`` / ``v``
leaves, recurrent states keep their dtypes -- and ``int8_kv8`` both;
``sp`` (train and prefill) adds sequence parallelism.  A train step takes
the fp32 params of every variant, as the reference's does.

Hardware constants are the H100's data sheet (not measured): bf16 peak and
HBM rate from ``core/perf_model.py``, 80 GB a card, and one NVLink 4
direction (450 GB/s) as the link rate in place of the reference's ICI.  A
16-wide model axis spans two 8-card nodes, whose link to each other is
slower; one link constant does not see that.

Nothing happens at import: the process group and the mesh exist only
inside ``lower_cell``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import torch
import torch.distributed as dist

import repro_torch.configs as C
from repro_torch.core.perf_model import H100_HBM_BW, H100_PEAK_FLOPS
from repro_torch.core.weight_plan import local_params, map_tree
from repro_torch.distributed import shardlib as sl
from repro_torch.launch import mesh as M
from repro_torch.launch import op_analysis as OA
from repro_torch.models import layers as ML
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.api import get_api, input_specs
from repro_torch.training import optimizer as O
from repro_torch.training.trainer import make_train_step

# ---------------------------------------------------------------------------
# hardware constants (NVIDIA H100 SXM data sheet; not measured)
# ---------------------------------------------------------------------------

PEAK_FLOPS = H100_PEAK_FLOPS  # bf16 per card
HBM_BW = H100_HBM_BW  # bytes/s per card
LINK_BW = 450e9  # bytes/s: one direction of a card's NVLink 4
HBM_BYTES = 80e9  # a card's memory

# loop bodies whose repeated calls replay their costs (``OpAnalysis.repeated``):
# the flash attention's chunk rows, 64 x 64 a layer at 32k tokens, and the
# sLSTM's token step, 32768 a layer
REPEATED = ((ML, "flash_rows"), (SSM, "slstm_step"))
VARIANTS = ("baseline", "bf16", "int8", "kv8", "int8_kv8", "sp")


@dataclasses.dataclass
class LoweredCell:
    """One traced (arch, shape, mesh) cell: rank 0's step costs and memory.
    ``seconds_lower`` is the trace; nothing is compiled (``seconds_compile``
    0.0, the reference's field)."""

    arch: str
    shape_name: str
    mode: str
    mesh_desc: str
    n_ranks: int
    costs: OA.Costs
    memory: OA.Memory
    seconds_lower: float
    seconds_compile: float = 0.0


# ---------------------------------------------------------------------------
# a rank's arguments, on the meta device
# ---------------------------------------------------------------------------


def _own(node):
    """``node`` with every tensor in a storage of its own (a rank holds its
    pieces, not views of whole leaves); plan nodes rebuilt field by field."""
    if isinstance(node, torch.Tensor):
        return torch.empty(node.shape, dtype=node.dtype, device="meta")
    if isinstance(node, dict):
        return {k: _own(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_own(v) for v in node]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return dataclasses.replace(node, **{f.name: _own(getattr(node, f.name))
                                            for f in dataclasses.fields(node) if f.init})
    return node


def _serving_params(cfg, mesh, rules, variant: str):
    """The rank's pieces of the serving params (``weight_plan.local_params``
    by the family's axes), in the variant's representation, as the
    ``unstack`` view."""
    api = get_api(cfg)
    params = T.meta_tree(api.param_shapes(cfg))
    if variant == "bf16":
        params = map_tree(lambda _, t: t.to(torch.bfloat16), params)
    elif variant.startswith("int8"):
        params = ML.quantize_for_serving(params)
    params = _own(local_params(params, SSM.placement_axes(api.param_axes(cfg)), mesh, rules))
    return api.unstack(cfg, params)


def _kv8(cache):
    """The cache with every attention layer's ``k`` / ``v`` leaf in fp8
    (e4m3), as the reference's ``kv8`` variant casts them; recurrent states
    and the enc-dec's cross-attention frames keep their dtypes."""
    return {**cache, "layers": [
        {k: t.to(torch.float8_e4m3fn) if k in ("k", "v") else t for k, t in layer.items()}
        for layer in cache["layers"]]}


def build_step(cfg, shape, mesh, rules, variant: str = "baseline"):
    """(step, args, donate) of one cell for rank 0 of ``mesh``: ``step(*args)``
    runs the rank's program; ``donate`` names the arguments it updates in
    place (params and optimizer state at train, the cache otherwise).  Every
    tensor is on the meta device (the batch, tokens and positions are
    ``input_specs``' own); call with the mesh's process group up."""
    api = get_api(cfg)
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        opt_cfg = O.OptimizerConfig()
        placement = M.train_placement(cfg, mesh, sequence_parallel=variant == "sp")
        params = map_tree(placement.piece, T.meta_tree(api.param_shapes(cfg)))
        opt_state = O.init_opt_state(opt_cfg, params, placement=placement)
        batch = specs["batch"]
        step = make_train_step(cfg, api.loss_fn, opt_cfg, placement=placement)
        return step, (params, opt_state, batch), (0, 1)

    params = _serving_params(cfg, mesh, rules, variant)
    axes = api.cache_axes(cfg, quantized_kv=False, paged=False)
    whole = _kv8(specs["cache"]) if variant.endswith("kv8") else specs["cache"]
    cache = sl.local_zeros(whole, axes, mesh, rules, "meta")

    if shape.kind == "prefill":
        batch = specs["batch"]

        def prefill_step(params, batch, cache):
            with sl.use_mesh(mesh, rules):
                return api.prefill(cfg, params, batch, cache)

        return prefill_step, (params, batch, cache), (2,)

    tokens, pos = specs["tokens"], specs["pos"]

    def serve_step(params, cache, tokens, pos):
        with sl.use_mesh(mesh, rules):
            return api.decode_step(cfg, params, cache, tokens, pos)

    return serve_step, (params, cache, tokens, pos), (1,)


# ---------------------------------------------------------------------------
# tracing a cell
# ---------------------------------------------------------------------------


def check_variant(variant: str) -> None:
    """Raise ValueError for a variant the reference does not name."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown dry-run variant {variant!r} (one of {VARIANTS})")


def check_rules(shape, mesh, rules) -> None:
    """Raise NotImplementedError where the cell's rules cut a prompt's
    sequence (``seq``: a prefill below batch 16 on a data axis its batch
    does not fill), which the port does not run."""
    spec = sl._resolve(mesh, rules, ("batch", "seq"), (shape.global_batch, shape.seq_len))
    if spec[1] is not None:
        raise NotImplementedError(f"{shape.name}: the rules cut the prompt's sequence over "
                                  f"{spec[1]}, which the port does not run")


def lower_cell(arch: str, shape, *, multi_pod: bool = False, remat: bool | None = None,
               variant: str = "baseline", cfg=None, mesh: tuple | None = None) -> LoweredCell:
    """Trace one (arch, shape, mesh) cell as rank 0 runs it.  ``mesh``, a
    (data, model) tuple such as (2, 2), replaces the production mesh (tests);
    else (16, 16), or (2, 16, 16) with ``multi_pod``.  Makes its fake
    process group and destroys it again; refuses to run beside a real one."""
    check_variant(variant)
    if dist.is_initialized():
        raise RuntimeError("lower_cell makes a fake process group of its own: a process "
                           "group is already initialized in this process")
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if cfg is None:
        cfg = C.get_config(arch)
    if remat is None:
        remat = shape.kind == "train"
    if remat and cfg.family not in ("audio",):
        cfg = dataclasses.replace(cfg, remat=True)
    sizes = (dict(zip(M.AXES, mesh)) if mesh is not None
             else dict(M.make_production_mesh(multi_pod=multi_pod).shape))
    desc = "x".join(str(n) for n in sizes.values())
    world = math.prod(sizes.values())
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        dm = init_device_mesh("cpu", tuple(sizes.values()), mesh_dim_names=tuple(sizes))
        rules = M.rules_for(cfg, shape, sequence_parallel=variant == "sp", mesh=dm)
        check_rules(shape, dm, rules)
        fn, args, donate = build_step(cfg, shape, dm, rules, variant)
        t0 = time.perf_counter()
        _, costs, memory = OA.analyze(fn, *args, donate=donate, repeated=REPEATED)
        seconds = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    return LoweredCell(arch=arch, shape_name=shape.name, mode=shape.kind, mesh_desc=desc,
                       n_ranks=world, costs=costs, memory=memory, seconds_lower=seconds)


# ---------------------------------------------------------------------------
# roofline extraction
# ---------------------------------------------------------------------------


def analyze_cell(cell: LoweredCell, cfg, shape) -> dict:
    """The reference's record of one cell (its keys; ``hlo_*`` and
    ``xla_flops_unweighted`` hold the op analysis's counts -- an eager trace
    has no loop body to count once), plus the dots' FLOPs, the peak bytes a
    card holds (arguments + temporaries) and whether they fit."""
    hc, mem = cell.costs, cell.memory
    api = get_api(cfg)
    n_params = api.n_params_exact(cfg)
    n_active = cfg.n_active_params() if cfg.moe is not None else n_params
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        model_flops = 6.0 * n_active * B * S
    elif shape.kind == "prefill":
        model_flops = 2.0 * n_active * B * S
    else:  # decode: one token per sequence
        model_flops = 2.0 * n_active * B
    coll = {"bytes_by_type": dict(hc.collective_bytes), "counts": dict(hc.collective_counts),
            "total_bytes": hc.total_collective_bytes}
    t_compute = hc.flops / PEAK_FLOPS
    t_memory = hc.bytes / HBM_BW
    t_collective = coll["total_bytes"] / LINK_BW
    t_roof = max(t_compute, t_memory, t_collective)
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_collective), key=lambda kv: kv[1])[0]
    peak = mem.argument_bytes + mem.temp_bytes
    return {
        "arch": cell.arch,
        "shape": cell.shape_name,
        "mode": cell.mode,
        "mesh": cell.mesh_desc,
        "hlo_flops_per_device": hc.flops,
        "hlo_bytes_per_device": hc.bytes,
        "hlo_bytes_by_category": dict(hc.bytes_by_cat),
        "collectives": coll,
        "memory": {"argument_bytes": mem.argument_bytes, "output_bytes": mem.output_bytes,
                   "temp_bytes": mem.temp_bytes, "generated_code_bytes": 0},
        "n_params": n_params,
        "n_active_params": n_active,
        "xla_flops_unweighted": hc.flops,
        "model_flops_global": model_flops,
        "model_flops_per_device": model_flops / cell.n_ranks,
        "useful_flops_ratio": (model_flops / cell.n_ranks) / hc.flops if hc.flops else 0.0,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "t_roofline_s": t_roof,
        "dominant": dominant,
        "roofline_fraction": t_roof and t_compute / t_roof,
        "seconds_lower": cell.seconds_lower,
        "seconds_compile": cell.seconds_compile,
        "dot_flops_per_device": hc.dot_flops,
        "peak_bytes_per_device": peak,
        "hbm_bytes_per_device": HBM_BYTES,
        "fits": peak <= HBM_BYTES,
        "hardware": "H100 SXM data sheet: 989 TFLOP/s bf16, 3.35 TB/s HBM, 80 GB, NVLink 4 "
                    "450 GB/s a direction (not measured)",
    }


def run_cell(arch: str, shape, multi_pod: bool, out_dir: str | None, **kw) -> dict:
    """Trace and analyze one cell, print its line, write its JSON to
    ``out_dir`` (None: no file; a variant's file is tagged with it)."""
    cfg = kw.pop("cfg", None) or C.get_config(arch)
    cell = lower_cell(arch, shape, multi_pod=multi_pod, cfg=cfg, **kw)
    rec = analyze_cell(cell, cfg, shape)
    rec["variant"] = variant = kw.get("variant", "baseline")
    print(
        f"[dryrun] {arch:24s} {shape.name:12s} {rec['mesh']:8s} {variant:8s} "
        f"flops/dev={rec['hlo_flops_per_device']:.3e} "
        f"bytes/dev={rec['hlo_bytes_per_device']:.3e} "
        f"coll={rec['collectives']['total_bytes']:.3e}B "
        f"dom={rec['dominant']:10s} "
        f"t={rec['t_roofline_s'] * 1e3:.2f}ms "
        f"peak={rec['peak_bytes_per_device'] / 1e9:.2f}GB fits={rec['fits']} "
        f"(trace {rec['seconds_lower']:.1f}s)",
        flush=True,
    )
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}_{shape.name}_{rec['mesh'].replace('x', '-')}"
        tag += "" if variant == "baseline" else f"_{variant}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="trace every (arch x shape) step on the "
                                             "production meshes; FLOPs, bytes, memory a card")
    ap.add_argument("--arch", default=None, choices=C.ARCH_IDS)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    if args.all:
        pairs = [(a, s) for a in C.ARCH_IDS for s in C.shapes_for(a)]
    else:
        if not args.arch:
            ap.error("--arch or --all")
        shapes = {s.name: s for s in C.shapes_for(args.arch)}
        if args.shape and args.shape not in shapes:
            ap.error(f"--shape {args.shape}: {args.arch} runs {sorted(shapes)}")
        pairs = ([(args.arch, shapes[args.shape])] if args.shape else
                 [(args.arch, s) for s in C.shapes_for(args.arch)])
    for arch, shape in pairs:
        for mp in meshes:
            try:
                run_cell(arch, shape, mp, args.out)
            except Exception as e:  # noqa: BLE001 -- report, go on, exit 1 at the end
                failures.append((arch, shape.name, mp, repr(e)[:200]))
                print(f"[dryrun] FAIL {arch} {shape.name} mp={mp}: {e!r}", flush=True)
    if failures:
        print(f"[dryrun] {len(failures)} failures")
        sys.exit(1)
    print("[dryrun] all cells OK")


if __name__ == "__main__":
    main()
