"""The rank side of tests/test_torch_sharded_*.py.

It imports the port only: a spawned rank imports this module, never the
test modules (which import jax).  ``run_path`` spawns the ranks of one mesh
over gloo on the CPU (they meet at a FileStore in a fresh directory, one
torch thread each); each rank loads the plan (or the dense params) a test
saved, serves the requests through a meshed engine in lockstep with an
unsharded one on the same weights, holds its caches to its slices of the
unsharded engine's after every step, and writes what the test compares to
``out/rank<r>.json``; ``run_mixed`` does the same for a mixed-family engine
whose members carry the mesh."""

import json
import os

import numpy as np
import torch

ARCH = "tinyllama-1.1b"
FLAT = dict(max_len=64, max_batch=4, kv_dtype="int8", page_size=8, share_prefix=True)


def prompts(vocab: int) -> list:
    """Five prompts: a 12-token prompt, two that extend it by 4 (one full
    page of 8 shared, the boundary page copied on write), two of their
    own; five requests on four slots, so one waits for a slot."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, size=12).astype(np.int32)
    out = [prefix] + [np.concatenate([prefix, rng.integers(0, vocab, 4).astype(np.int32)])
                      for _ in range(2)]
    return out + [rng.integers(0, vocab, size=8).astype(np.int32) for _ in range(2)]


def _cache_pieces(whole, mine, axes, mesh, rules) -> tuple:
    """(max |d| of this rank's pieces against its slices of the whole
    cache, relative to the largest whole value for floats and absolute for
    int8; whether all are equal bit for bit) over the layers' leaves."""
    import torch

    from repro_torch.distributed import shardlib as sl

    err, exact = 0.0, True
    layers = [(w, m, a) for key in ("layers", "x") if key in whole
              for w, m, a in zip(whole[key], mine[key], axes[key])]
    for w_layer, m_layer, a_layer in layers:
        for k, t in w_layer.items():
            spec = sl.spec_for(t.shape, *a_layer[k], mesh=mesh, rules=rules)
            piece = sl.local_piece(t, spec, mesh)
            got = m_layer[k]
            if tuple(piece.shape) != tuple(got.shape):
                return float("inf"), False
            exact &= bool(torch.equal(piece, got))
            d = (piece.double() - got.double()).abs().max().item() if piece.numel() else 0.0
            if t.is_floating_point():
                d /= max(t.double().abs().max().item(), 1e-30)
            err = max(err, d)
    return err, exact


def _path_rank(rank: int, shape: tuple, job: dict) -> None:
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.core.batching import BatchSizer
    from repro_torch.core.weight_plan import ShardedLeaf, load_plan
    from repro_torch.distributed import shardlib as sl
    from repro_torch.launch import mesh as M
    from repro_torch.models import moe as MOE
    from repro_torch.models.api import get_api
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config(job["arch"], smoke=True)
    api = get_api(cfg)
    params = plan = None
    if job.get("plan_dir"):
        plan = load_plan(job["plan_dir"], api.init_params(cfg, 0, device="cpu"))
    else:
        params = torch.load(job["params"])
    flat = dict(job["flat"])
    if job.get("draft"):
        flat.update(draft_cfg=get_config(job["draft"]["arch"], smoke=True),
                    draft_params=torch.load(job["draft"]["params"]))
    mesh = M.make_serving_mesh(shape, "gloo")
    rules = M.rules_for(cfg, None, mesh=mesh) if job.get("rules") == "rules_for" else None
    solo = ServingEngine(cfg, params, plan=plan, device="cpu", config=EngineConfig.of(**flat))
    meshed = ServingEngine(cfg, params, plan=plan, device="cpu",
                           config=EngineConfig.of(**flat, mesh=mesh, rules=rules))
    rules = meshed.rules
    # every decode (or verify) step's logits, and the all-reduces its
    # meshed step issued
    logits = {"solo": [], "mesh": []}
    reduces = {"n": 0}
    real_reduce = sl.all_reduce

    def counted(x, axis):
        reduces["n"] += 1
        return real_reduce(x, axis)

    sl.all_reduce = counted
    step_reduces = []
    for name, eng in (("solo", solo), ("mesh", meshed)):
        real = eng._decode

        def spy(tokens, pos, poison, real=real, name=name):
            before = reduces["n"]
            lg = real(tokens, pos, poison)
            if name == "mesh":
                step_reduces.append(reduces["n"] - before)
            logits[name].append(lg.float().clone())
            return lg

        eng._decode = spy
    reqs = {}
    extras = job.get("extras") or [None] * len(job["prompts"])
    for name, eng in (("solo", solo), ("mesh", meshed)):
        reqs[name] = [Request(uid=i, prompt=np.asarray(p, np.int32),
                              max_new_tokens=job["max_new"], extras=e)
                      for i, (p, e) in enumerate(zip(job["prompts"], extras))]
        for r in reqs[name]:
            eng.submit(r)
    quantized = flat.get("kv_dtype") == "int8"
    axes = api.cache_axes(cfg, quantized_kv=quantized, paged=meshed.paged)
    chunk_axes = api.cache_axes(cfg, quantized_kv=quantized)
    draft_axes = (meshed.draft_api.cache_axes(meshed.draft_cfg) if meshed.spec_k else None)
    cache_err, cache_exact, draft_err, steps, chunk_checks = 0.0, True, 0.0, 0, 0
    while not all(r.terminal for r in reqs["mesh"]) and steps < 400:
        solo.step()
        meshed.step()
        meshed.audit_pages()
        steps += 1
        pairs = [(solo.cache, meshed.cache, axes)]
        for a, b in zip(solo.slot_prefill, meshed.slot_prefill):
            if a is not None and a.cache1 is not None:
                pairs.append((a.cache1, b.cache1, chunk_axes))
                chunk_checks += 1
        for whole, mine, ax in pairs:
            e, x = _cache_pieces(whole, mine, ax, mesh, rules)
            cache_err, cache_exact = max(cache_err, e), cache_exact and x
        if meshed.spec_k:
            e, _ = _cache_pieces(solo.draft_cache, meshed.draft_cache, draft_axes, mesh, rules)
            draft_err = max(draft_err, e)
    sl.all_reduce = real_reduce
    logit_err = 0.0
    for a, b in zip(logits["solo"], logits["mesh"]):
        logit_err = max(logit_err, (a - b).abs().max().item() / a.abs().max().item())
    layer0 = meshed.params["layers"][0]
    experts = None
    if "moe" in layer0:
        experts = list(MOE.expert_range(layer0["moe"], cfg.moe.n_experts_padded))
    kinds = {}
    firsts = {kind: meshed.params["layers"][cfg.layer_kinds.index(kind)]
              for kind in ("mlstm", "slstm") if kind in cfg.layer_kinds}
    for name, leaf in (("rec.w_x", layer0.get("rec", {}).get("w_x")),
                       ("rec.w_out", layer0.get("rec", {}).get("w_out")),
                       *((f"{kind}.{k}", v) for kind, layer in firsts.items()
                         for k, v in layer["cell"].items() if k.startswith("w_"))):
        if leaf is not None:
            kinds[name] = ("k_split" if isinstance(leaf, ShardedLeaf) and leaf.k_split else
                           "n_split" if isinstance(leaf, ShardedLeaf) and leaf.n_split else
                           "whole")
    if "slstm" in firsts:
        kinds["slstm.r_gates"] = list(firsts["slstm"]["cell"]["r_gates"].shape)
    # max_batch: the sizer's n_opt balances one model group, so a default
    # max_batch feeds every data replica its own
    sizer = BatchSizer(n_params=10**6, hbm_bw=3.35e12 * 20)
    scaled = ServingEngine(cfg, params, plan=plan, device="cpu", sizer=sizer,
                           config=EngineConfig.of(max_len=64, mesh=mesh, rules=rules))
    result = {
        "rank": rank,
        "coords": sl.mesh_coords(mesh),
        "free": [int(p) for p in meshed.allocator._free] if meshed.paged else None,
        "solo_free": [int(p) for p in solo.allocator._free] if solo.paged else None,
        "pages_shared": meshed.stats.pages_shared,
        "cow_copies": meshed.stats.cow_copies,
        "degrees": [meshed.data_parallel, meshed.model_parallel, meshed.kv_parallel],
        "max_batch": [scaled.max_batch, sizer.n_opt],
        "streams": [[int(t) for t in r.output] for r in reqs["mesh"]],
        "solo_streams": [[int(t) for t in r.output] for r in reqs["solo"]],
        "states": [r.state.value for r in reqs["mesh"]],
        "tables": meshed._table.tolist() if meshed.paged else None,
        "solo_tables": solo._table.tolist() if solo.paged else None,
        "cache_err": cache_err,
        "cache_exact": bool(cache_exact),
        "draft_err": draft_err,
        "chunk_checks": chunk_checks,
        "logit_err": logit_err,
        "logit_steps": [len(logits["solo"]), len(logits["mesh"])],
        "step_reduces": step_reduces,
        "steps": steps,
        "stats": [meshed.stats.draft_accepted, meshed.stats.verified_positions,
                  meshed.stats.prefill_chunks],
        "solo_stats": [solo.stats.draft_accepted, solo.stats.verified_positions,
                       solo.stats.prefill_chunks],
        "experts": experts,
        "kinds": kinds,
        "weight_bytes": [meshed.weight_bytes(), solo.weight_bytes()],
        "pages_in_use": meshed.pages_in_use,
        "degraded": dict(meshed.degraded),
    }
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _spawn(target, shape: tuple, job: dict) -> list:
    """Run ``target`` on the gloo ranks of a (data, model) mesh; their
    results, in rank order."""
    from repro_torch.launch import mesh as M

    world = shape[0] * shape[1]
    M.spawn_ranks(target, (tuple(shape), job), world, "gloo")
    out = []
    for r in range(world):
        with open(os.path.join(job["out"], f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def run_path(shape: tuple, job: dict) -> list:
    """Spawn the ranks of a (data, model) mesh for one path ``job`` (arch,
    flat engine settings, a plan directory or a saved dense params tree, an
    optional draft, the rules -- "rules_for" or the defaults -- prompts,
    their extras (frames or patches), max_new, out) and return their
    results."""
    return _spawn(_path_rank, shape, job)


def _mixed_rank(rank: int, shape: tuple, job: dict) -> None:
    """One rank of a mixed-family mesh: a MixedServingEngine whose members
    carry the mesh (each with its ``rules_for``) in lockstep with an
    unmeshed one over the same weights; after every tick each member's
    caches are held to their slices of the unmeshed member's, the union
    audit runs and the shared allocator's free list is recorded."""
    import warnings

    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.distributed import shardlib as sl
    from repro_torch.launch import mesh as M
    from repro_torch.models.api import get_api
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import Request
    from repro_torch.serving.mixed import MixedServingEngine, WorkloadSpec

    mesh = M.make_serving_mesh(shape, "gloo")
    engines = {}
    for name, on_mesh in (("solo", False), ("mesh", True)):
        specs = []
        for arch, params_path in job["members"]:
            cfg = get_config(arch, smoke=True)
            flat = dict(job["flat"])
            if on_mesh:
                flat.update(mesh=mesh, rules=M.rules_for(cfg, None, mesh=mesh))
            specs.append(WorkloadSpec(name=arch, cfg=cfg, params=torch.load(params_path),
                                      config=EngineConfig.of(**flat)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the contiguous families' paging warning
            engines[name] = MixedServingEngine(specs, device="cpu")
    reqs = {name: [] for name in engines}
    for name, eng in engines.items():
        for arch, uid, prompt, extras in job["requests"]:
            r = Request(uid=uid, prompt=np.asarray(prompt, np.int32),
                        max_new_tokens=job["max_new"], extras=extras)
            reqs[name].append((arch, r))
            eng.submit(arch, r)
    solo, meshed = engines["solo"], engines["mesh"]
    cache_err, frees, ticks = 0.0, [], 0
    while meshed._busy() and ticks < 400:
        solo.step()
        meshed.step()
        meshed.audit_pages()
        ticks += 1
        frees.append([int(p) for p in meshed.allocator._free])
        if frees[-1] != [int(p) for p in solo.allocator._free]:
            frees[-1] = None  # the unmeshed allocator's free list differs
        for arch, eng in meshed.engines.items():
            whole = solo.engines[arch]
            axes = get_api(eng.cfg).cache_axes(eng.cfg, quantized_kv=eng.kv_dtype is not None,
                                               paged=eng.paged)
            e, _ = _cache_pieces(whole.cache, eng.cache, axes, mesh, eng.rules)
            cache_err = max(cache_err, e)
    streams = {name: {} for name in engines}
    for name in engines:
        for arch, r in reqs[name]:
            streams[name].setdefault(arch, []).append([int(t) for t in r.output])
    result = {
        "rank": rank,
        "coords": sl.mesh_coords(mesh),
        "streams": streams["mesh"],
        "solo_streams": streams["solo"],
        "frees": frees,
        "ticks": ticks,
        "cache_err": cache_err,
        "degrees": {a: [e.data_parallel, e.model_parallel, e.kv_parallel]
                    for a, e in meshed.engines.items()},
        "paged": sorted(a for a, e in meshed.engines.items() if e.paged),
        "used_pages": meshed.allocator.used_pages,
        "weight_bytes": {a: [e.weight_bytes(), solo.engines[a].weight_bytes()]
                         for a, e in meshed.engines.items()},
    }
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def run_mixed(shape: tuple, job: dict) -> list:
    """Spawn the ranks of a (data, model) mesh for one mixed-family ``job``
    (members [(arch, saved dense params)], flat member settings, requests
    [(arch, uid, prompt, extras)], max_new, out) and return their results."""
    return _spawn(_mixed_rank, shape, job)
