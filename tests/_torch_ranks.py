"""The rank side of tests/test_torch_sharded_serving.py.

It imports the port only: a spawned rank imports this module, never the
test module (which imports jax).  ``run`` spawns the ranks of one mesh over
gloo on the CPU (they meet at a FileStore in a fresh directory, one torch
thread each); each rank loads the plan a test saved, serves the requests
through a meshed engine in lockstep with an unsharded one on the same
plan, holds its pools to its slices of the unsharded pools after every
step, and writes what the test compares to ``out_dir/rank<r>.json``."""

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


def _pools(engine) -> list:
    return [{k: t for k, t in layer.items()} for layer in engine.cache["layers"]]


def _serve_rank(rank: int, shape: tuple, plan_dir: str, out_dir: str, max_new: int) -> None:
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.core.batching import BatchSizer
    from repro_torch.core.weight_plan import load_plan
    from repro_torch.distributed import shardlib as sl
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config(ARCH, smoke=True)
    plan = load_plan(plan_dir, T.init_params(cfg, 0, device="cpu"))
    mesh = M.make_serving_mesh(shape, "gloo")
    rules = M.rules_for(cfg, None, mesh=mesh)
    solo = ServingEngine(cfg, None, plan=plan, device="cpu", config=EngineConfig.of(**FLAT))
    meshed = ServingEngine(cfg, None, plan=plan, device="cpu",
                           config=EngineConfig.of(**FLAT, mesh=mesh, rules=rules))
    reqs = {}
    for name, eng in (("solo", solo), ("mesh", meshed)):
        reqs[name] = [Request(uid=i, prompt=p, max_new_tokens=max_new)
                      for i, p in enumerate(prompts(cfg.vocab))]
        for r in reqs[name]:
            eng.submit(r)
    axes = L.paged_attn_cache_axes(quantized=True)
    pools_equal, steps = True, 0
    while not all(r.terminal for r in reqs["mesh"]):
        solo.step()
        meshed.step()
        meshed.audit_pages()
        steps += 1
        for whole, mine in zip(_pools(solo), _pools(meshed)):
            for k, t in whole.items():
                spec = sl.spec_for(t.shape, *axes[k], mesh=mesh, rules=rules)
                pools_equal &= torch.equal(sl.local_piece(t, spec, mesh), mine[k])
    # max_batch: the sizer's n_opt balances one model group, so a default
    # max_batch feeds every data replica its own
    sizer = BatchSizer(n_params=10**6, hbm_bw=3.35e12 * 20)
    scaled = ServingEngine(cfg, None, plan=plan, device="cpu", sizer=sizer,
                           config=EngineConfig.of(max_len=64, mesh=mesh, rules=rules))
    result = {
        "rank": rank,
        "coords": sl.mesh_coords(mesh),
        "streams": [[int(t) for t in r.output] for r in reqs["mesh"]],
        "solo_streams": [[int(t) for t in r.output] for r in reqs["solo"]],
        "tables": meshed._table.tolist(),
        "solo_tables": solo._table.tolist(),
        "free": [int(p) for p in meshed.allocator._free],
        "solo_free": [int(p) for p in solo.allocator._free],
        "pages_shared": meshed.stats.pages_shared,
        "cow_copies": meshed.stats.cow_copies,
        "pools_equal": bool(pools_equal),
        "steps": steps,
        "degrees": [meshed.data_parallel, meshed.model_parallel, meshed.kv_parallel],
        "max_batch": [scaled.max_batch, sizer.n_opt],
        "weight_bytes": [meshed.weight_bytes(), solo.weight_bytes()],
        "pages_in_use": meshed.pages_in_use,
    }
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def run(shape: tuple, plan_dir: str, out_dir: str, max_new: int = 6) -> list:
    """Spawn the ranks of a (data, model) mesh and return their results."""
    from repro_torch.launch import mesh as M

    world = shape[0] * shape[1]
    M.spawn_ranks(_serve_rank, (tuple(shape), plan_dir, out_dir, max_new), world, "gloo")
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out
