"""The rank side of tests/test_torch_seq_parallel.py and
tests/test_torch_vocab_parallel.py: the reference's production layouts on
the port's gloo ranks.

It imports the port only: a spawned rank imports this module (and
``_torch_train_ranks``), never the test modules, which import jax.
``run_mesh`` spawns the ranks of one (data, model) mesh on the CPU, one
torch thread each, and every rank runs the job's cases:

- ``decode``: a prompt prefilled and ``STEPS`` tokens decoded
  teacher-forced, unsharded and then on the mesh under the rules of the
  case's shape (``launch.mesh.rules_for``: ``cache_seq`` over "model", or
  over ("data", "model") at a batch of 1), the rank's cache its pieces of
  the whole one (``shardlib.local_zeros``); the logits of every step and
  the rank's cache pieces are held to the unsharded run's;
- ``sp_prefill``: a prefill under ``rules_for(sequence_parallel=True)``
  (``seq_sp``), held to the unsharded prefill;
- ``sp_train``: ``_torch_train_ranks``' training cases, the meshed step
  under sequence parallelism;
- ``vocab``: the loss and the gradients of a train step whose vocabulary
  the model axis splits (the vocab-parallel cross entropy), each
  gradient gathered whole, written for the test to hold to the
  reference's.

Rank 0 writes the unsharded logits of each decode case and every rank
its results to ``out/``."""

import json
import os

import numpy as np
import torch

import _torch_train_ranks as TR

PROMPT, STEPS, LENGTH = 12, 8, 32

# name -> (arch, KV dtype (None: the compute dtype), batch, the rules' shape)
DECODE = {
    "tinyllama": ("tinyllama-1.1b", None, 2, "decode_32k"),
    "tinyllama_int8": ("tinyllama-1.1b", "int8", 2, "decode_32k"),
    "tinyllama_kv8": ("tinyllama-1.1b", "kv8", 2, "decode_32k"),
    "gemma3": ("gemma3-4b", None, 2, "decode_32k"),
    "tinyllama_b1": ("tinyllama-1.1b", None, 1, "long_500k"),
    "gemma3_b1_int8": ("gemma3-4b", "int8", 1, "long_500k"),
}
KV_DTYPES = {None: None, "int8": torch.int8, "kv8": torch.float8_e4m3fn}

# name -> (arch, logit softcap)
VOCAB = {
    "untied": ("tinyllama-1.1b", 0.0),
    "untied_capped": ("tinyllama-1.1b", 30.0),
    "tied_capped": ("llama3.2-1b", 30.0),
}
VOCAB_B, VOCAB_S = 4, 16


def decode_tokens(batch: int) -> np.ndarray:
    """The decode cases' prompt and continuation (batch, PROMPT + STEPS)."""
    return np.random.default_rng(0).integers(0, 256, size=(batch, PROMPT + STEPS)).astype(
        np.int32)


def shape_spec(name: str):
    from repro_torch import configs as C

    return {s.name: s for s in C.ALL_SHAPES}[name]


def run_decode(cfg, params, cache, tokens) -> torch.Tensor:
    """The prefill's logits and ``STEPS`` teacher-forced steps', (B, 1 +
    STEPS, V), through ``api.prefill`` and ``api.decode_step``."""
    from repro_torch.models.api import get_api

    api = get_api(cfg)
    B = tokens.shape[0]
    out = [api.prefill(cfg, params, {"tokens": tokens[:, :PROMPT]}, cache)[0]]
    for i in range(STEPS):
        pos = torch.full((B,), PROMPT + i, dtype=torch.int32)
        out.append(api.decode_step(cfg, params, cache, tokens[:, PROMPT + i:PROMPT + i + 1],
                                   pos)[0])
    return torch.cat(out, dim=1)


def _cache_err(whole, mine, axes, mesh, rules) -> tuple:
    """(the largest |d| of this rank's cache pieces against its slices of
    the whole cache, relative to each leaf's largest value; the fewest
    slots a piece of a ring holds)."""
    from repro_torch.core.weight_plan import flatten_leaves
    from repro_torch.distributed import shardlib as sl

    specs = flatten_leaves(sl.tree_specs(whole, axes, mesh=mesh, rules=rules))
    err, slots = 0.0, LENGTH
    for spec, w, m in zip(specs, flatten_leaves(whole), flatten_leaves(mine)):
        piece = sl.local_piece(w, spec.spec, mesh).double()
        if tuple(piece.shape) != tuple(m.shape):
            return float("inf"), 0
        if m.dim() >= 3:
            slots = min(slots, m.shape[1])
        d = (piece - m.double()).abs().max().item()
        err = max(err, d / max(w.double().abs().max().item(), 1e-30))
    return err, slots


def _decode_case(name: str, mesh, job: dict) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.weight_plan import local_params
    from repro_torch.distributed import shardlib as sl
    from repro_torch.launch import mesh as M
    from repro_torch.models import ssm as SSM
    from repro_torch.models.api import get_api

    arch, kv, B, shape = DECODE[name]
    cfg = get_config(arch, smoke=True)
    api = get_api(cfg)
    whole = torch.load(job["params"][arch])
    tokens = torch.from_numpy(decode_tokens(B))
    kw = dict(kv_dtype=KV_DTYPES[kv])
    solo = api.init_cache(cfg, B, LENGTH, torch.float32, device="cpu", **kw)
    want = run_decode(cfg, api.unstack(cfg, whole), solo, tokens)
    rules = M.rules_for(cfg, shape_spec(shape), mesh=mesh)
    axes = api.cache_axes(cfg, quantized_kv=kv == "int8")
    mine = sl.local_zeros(api.init_cache(cfg, B, LENGTH, torch.float32, device="meta", **kw),
                          axes, mesh, rules, "cpu")
    params = api.unstack(cfg, local_params(whole, SSM.placement_axes(api.param_axes(cfg)),
                                           mesh, rules))
    with sl.use_mesh(mesh, rules):
        got = run_decode(cfg, params, mine, tokens)
    if sl.mesh_coords(mesh) == {a: 0 for a in sl.axis_sizes(mesh)}:
        np.save(os.path.join(job["out"], f"decode_{name}.npy"), want.numpy())
    cache_err, slots = _cache_err(solo, mine, axes, mesh, rules)
    return {"err": (got - want).abs().max().item() / want.abs().max().item(),
            "cache_err": cache_err, "slots": slots, "finite": bool(torch.isfinite(got).all())}


def _sp_prefill(mesh, job: dict) -> dict:
    """tinyllama-1.1b's 16-token prefill under ``seq_sp`` against the
    unsharded one: the logits and the rank's cache pieces."""
    from repro_torch.configs import get_config
    from repro_torch.core.weight_plan import local_params
    from repro_torch.distributed import shardlib as sl
    from repro_torch.launch import mesh as M
    from repro_torch.models import ssm as SSM
    from repro_torch.models.api import get_api

    cfg = get_config("tinyllama-1.1b", smoke=True)
    api = get_api(cfg)
    whole = torch.load(job["params"]["tinyllama-1.1b"])
    tokens = torch.from_numpy(decode_tokens(2))[:, :16]
    solo = api.init_cache(cfg, 2, LENGTH, torch.float32, device="cpu")
    want = api.prefill(cfg, api.unstack(cfg, whole), {"tokens": tokens}, solo)[0]
    rules = M.rules_for(cfg, shape_spec("prefill_32k"), sequence_parallel=True, mesh=mesh)
    axes = api.cache_axes(cfg)
    mine = sl.local_zeros(api.init_cache(cfg, 2, LENGTH, torch.float32, device="meta"),
                          axes, mesh, rules, "cpu")
    params = api.unstack(cfg, local_params(whole, SSM.placement_axes(api.param_axes(cfg)),
                                           mesh, rules))
    gathers = {"n": 0}
    real = sl.gather_seq

    def counted(x):
        gathers["n"] += 1
        return real(x)

    sl.gather_seq = counted
    try:
        with sl.use_mesh(mesh, rules):
            split = sl.seq_split(tokens.shape[1])
            got = api.prefill(cfg, params, {"tokens": tokens}, mine)[0]
    finally:
        sl.gather_seq = real
    return {"err": (got - want).abs().max().item() / want.abs().max().item(),
            "cache_err": _cache_err(solo, mine, axes, mesh, rules)[0], "split": split,
            "gathers": gathers["n"]}


class WholeVocab:
    """Counts the ops (forward and backward) whose result's last dimension
    is the whole vocabulary ``V`` (a (rows, S, V) logits tensor or its
    gradient), as a dispatch mode."""

    def __init__(self, V: int):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in (out if isinstance(out, (tuple, list)) else (out,)):
                    if isinstance(t, torch.Tensor) and t.dim() >= 2 and t.shape[-1] == V:
                        outer.n += 1
                return out

        self.n, self._mode = 0, Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def _vocab_case(name: str, mesh, job: dict) -> dict:
    """The loss and every gradient leaf, gathered whole, of one train step's
    loss on the mesh (``train_placement``), rank 0 writing them."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.weight_plan import flatten_leaves, map_tree
    from repro_torch.data import LMDataConfig, synthetic_lm_batch
    from repro_torch.distributed import shardlib as sl
    from repro_torch.launch import mesh as M
    from repro_torch.models.api import get_api

    arch, cap = VOCAB[name]
    cfg = dataclasses.replace(get_config(arch, smoke=True), logit_softcap=cap)
    api = get_api(cfg)
    place = M.train_placement(cfg, mesh)
    whole = torch.load(job["params"][arch])
    mine = map_tree(lambda path, t: place.piece(path, t).clone().requires_grad_(True), whole)
    b = synthetic_lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=VOCAB_S,
                                        global_batch=VOCAB_B), 0)
    b = {k: torch.from_numpy(v) for k, v in b.items()}
    calls = {"n": 0}
    real = sl.vocab_nll

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    sl.vocab_nll = counted
    try:
        with WholeVocab(cfg.vocab) as seen:
            with sl.use_mesh(mesh, place.rules):
                loss, _ = api.loss_fn(cfg, place.views(mine), b)
            grads = torch.autograd.grad(loss, flatten_leaves(mine))
    finally:
        sl.vocab_nll = real
    # each data replica's term of the gradients, summed as the trainer sums them
    whole_g = [sl.gather_whole(sl.reduce_over(g, ("data",), mesh), s, mesh)
               for g, s in zip(grads, place.param_specs)]
    if sl.mesh_coords(mesh) == {a: 0 for a in sl.axis_sizes(mesh)}:
        np.savez(os.path.join(job["out"], f"vocab_{name}.npz"), loss=loss.detach().numpy(),
                 **{f"g{i}": g.numpy() for i, g in enumerate(whole_g)})
    return {"loss": float(loss), "vocab_nll_calls": calls["n"], "whole_vocab_ops": seen.n}


def _rank(rank: int, shape: tuple, job: dict) -> None:
    torch.set_num_threads(1)
    from repro_torch.distributed import shardlib as sl
    from repro_torch.launch import mesh as M

    mesh = M.make_serving_mesh(shape, "gloo")
    result = {"rank": rank, "coords": sl.mesh_coords(mesh)}
    for name in job.get("decode", ()):
        result[name] = _decode_case(name, mesh, job)
    if job.get("sp_prefill"):
        result["sp_prefill"] = _sp_prefill(mesh, job)
    if job.get("sp_train"):
        whole = {arch: torch.load(path) for arch, path in job["params"].items()}
        whole["roundoff"] = {}
        for name in job["sp_train"]:
            result[f"sp {name}"] = TR._run_case(name, mesh, whole, 2, sp=True)
    for name in job.get("vocab", ()):
        result[f"vocab {name}"] = _vocab_case(name, mesh, job)
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def run_mesh(shape: tuple, job: dict) -> list:
    """Spawn the gloo ranks of a (data, model) mesh for ``job`` ("params":
    {arch: a saved whole params file}, "decode", "sp_prefill", "sp_train",
    "vocab", "out") and return their results in rank order."""
    from repro_torch.launch import mesh as M

    world = shape[0] * shape[1]
    M.spawn_ranks(_rank, (tuple(shape), job), world, "gloo")
    out = []
    for r in range(world):
        with open(os.path.join(job["out"], f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out
