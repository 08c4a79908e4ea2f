"""The rank side of tests/test_torch_sharded_training.py and
tests/test_torch_sharded_training_families.py.

It imports the port only: a spawned rank imports this module, never the
test module (which imports jax).  ``run_mesh`` spawns the gloo ranks of one
(data, model) mesh on the CPU, one torch thread each; every rank trains
each case of ``CASES`` through the meshed ``make_train_step`` in lockstep
with the mesh-free one on the same whole params and batches, holds its
pieces (losses, every gradient leaf, params, ZeRO-1 moments) to its slices
of the mesh-free run's, and writes what the test compares to
``out/rank<r>.json``.  A job can also train through the launcher
(``launch.train.run(args, mesh=)``) and write its checkpoints, or resume
from another mesh's checkpoint and hold the result to a mesh-free run the
test made.

Tolerances are the test's (fp32 compute): this module records the worst
errors and the counts of elements past them."""

import json
import math
import os

import torch

B, S, STEPS = 4, 16, 3
OPT = dict(lr=1e-3, grad_clip=1.0, warmup_steps=0, decay_steps=10**9, min_lr_ratio=1.0)
PARAM_ATOL = 1e-4  # lr / 10
ROUNDOFF = 1e-5  # of a leaf's max |g|: an element held to 3 lr instead

# name -> (arch, make_train_step options, remat)
CASES = {
    "adamw": ("tinyllama-1.1b", {}, False),
    "accum2": ("tinyllama-1.1b", {"accum_steps": 2}, False),
    "int8": ("tinyllama-1.1b", {"compression": "int8"}, False),
    "topk": ("tinyllama-1.1b", {"compression": "topk"}, False),
    "remat": ("tinyllama-1.1b", {}, True),
    "tied": ("llama3.2-1b", {}, False),
    "glm4": ("glm4-9b", {}, False),
    "gemma3": ("gemma3-4b", {}, False),
}

# the other families: name -> (arch, make_train_step options, remat, the
# MoE config's changes, (B, S)); a case with changes has params of its own
FAMILY_CASES = {
    "granite": ("granite-moe-1b-a400m", {}, False, {}, (B, S)),
    "qwen2": ("qwen2-moe-a2.7b", {}, False, {}, (B, S)),
    "recurrentgemma": ("recurrentgemma-2b", {}, False, {}, (B, S)),
    "xlstm": ("xlstm-350m", {}, False, {}, (B, S)),
    "whisper": ("whisper-tiny", {}, False, {}, (B, S)),
    "internvl": ("internvl2-2b", {}, False, {}, (B, S)),
    # 512 tokens, 256 a replica at 2x1: capacity on (dropped assignments)
    "granite_512": ("granite-moe-1b-a400m", {}, False, {"capacity_factor": 0.5}, (8, 64)),
    # 5 experts on a model axis of 2: the "expert_ff" rule
    "qwen2_expert_ff": ("qwen2-moe-a2.7b", {}, False, {"n_experts": 5}, (B, S)),
    "xlstm_remat": ("xlstm-350m", {}, True, {}, (B, S)),
}


def case(name: str) -> tuple:
    """(arch, options, remat, MoE changes, (B, S)) of a case of either table."""
    if name in CASES:
        return CASES[name] + ({}, (B, S))
    return FAMILY_CASES[name]


def params_key(name: str) -> str:
    """The key of a case's whole params in a job: its arch, or its own name
    where it changes the config's params."""
    arch, _, _, changes, _ = case(name)
    return name if "n_experts" in changes else arch


def case_config(name: str):
    """The smoke config of case ``name``, its changes and remat applied."""
    import dataclasses

    from repro_torch.configs import get_config

    arch, _, remat, changes, _ = case(name)
    cfg = get_config(arch, smoke=True)
    if changes:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **changes))
    return dataclasses.replace(cfg, remat=remat)


def batch(cfg, step: int, b: int = B, s: int = S) -> dict:
    """Step ``step``'s global synthetic batch (b x s) with the family's
    frames or patches (``launch.train.extras``), as torch tensors."""
    from repro_torch.data import LMDataConfig, synthetic_lm_batch
    from repro_torch.launch.train import extras
    from repro_torch.models.api import get_api

    out = synthetic_lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b), step)
    out.update(extras(cfg, get_api(cfg), b, step))
    return {k: torch.from_numpy(v) for k, v in out.items()}


def launcher_args(*flags, arch: str = "tinyllama-1.1b"):
    """The train CLI's args at smoke size on the CPU, lr 1e-3."""
    from repro_torch.launch import train

    return train.build_parser().parse_args(
        ["--arch", arch, "--smoke", "--batch", str(B), "--seq", str(S),
         "--lr", "1e-3", "--log-every", "100", "--device", "cpu", *flags])


def _clone(tree):
    from repro_torch.core.weight_plan import map_tree

    return map_tree(lambda _, t: t.detach().clone(), tree)


def _pieces(whole, place):
    from repro_torch.core.weight_plan import map_tree

    return map_tree(lambda path, t: place.piece(path, t.detach()).clone(), whole)


def _grad_err(want: list, got: list, place) -> float:
    """The worst leaf's max |d| of this rank's gradient pieces against its
    slices of the whole gradients, relative to the whole leaf's max."""
    from repro_torch.distributed import shardlib as sl

    err = 0.0
    for i, (w, g) in enumerate(zip(want, got)):
        piece = sl.local_piece(w.detach(), place.param_specs[i], place.mesh)
        if tuple(piece.shape) != tuple(g.shape):
            return float("inf")
        err = max(err, (piece - g.detach()).abs().max().item() / max(w.abs().max().item(), 1e-30))
    return err


def _param_over(want: list, got: list, place, roundoff: list) -> tuple:
    """(elements of this rank's param pieces past PARAM_ATOL -- 3 lr where
    the step-0 gradient was roundoff --, elements compared, the worst |d|
    outside the roundoff)."""
    from repro_torch.distributed import shardlib as sl

    over, n, worst = 0, 0, 0.0
    for i, (w, g) in enumerate(zip(want, got)):
        spec = place.param_specs[i]
        piece = sl.local_piece(w.detach(), spec, place.mesh)
        mask = sl.local_piece(roundoff[i], spec, place.mesh)
        d = (piece - g.detach()).abs()
        tol = torch.where(mask, torch.full_like(d, 3 * OPT["lr"]), torch.full_like(d, PARAM_ATOL))
        over += int((d > tol).sum())
        n += d.numel()
        worst = max(worst, float(torch.where(mask, 0.0, d).max()))
    return over, n, worst


def _roundoff(grads: list) -> list:
    return [g.abs() <= ROUNDOFF * g.abs().max() for g in grads]


def _run_case(name: str, mesh, whole: dict, steps: int = STEPS, sp: bool = False) -> dict:
    """One case: ``steps`` steps mesh-free and meshed from the same params
    ``whole[params_key(name)]`` (on their device), the meshed one under
    sequence parallelism with ``sp`` (``train_placement(sequence_parallel=
    True)``: the ``seq_sp`` rule); the meshed step's every
    optimizer update is shadowed by one whose moments stay the params'
    pieces (no ZeRO), whose moments and params a ZeRO-1 rank must equal bit
    for bit.  Every
    ``moe.route`` call's dropped assignments are counted (the mesh-free
    run's, and the rank's own replica's on the mesh)."""
    import dataclasses

    from repro_torch.core.weight_plan import flatten_leaves
    from repro_torch.distributed import shardlib as sl
    from repro_torch.launch import mesh as M
    from repro_torch.models import moe as MOE
    from repro_torch.models.api import get_api
    from repro_torch.training import optimizer as O
    from repro_torch.training import trainer as TR

    _, opts, _, _, (b_rows, s_len) = case(name)
    cfg = case_config(name)
    key = params_key(name)
    api = get_api(cfg)
    oc = O.OptimizerConfig(**OPT)
    ef = opts.get("compression") is not None
    place = M.train_placement(cfg, mesh, sequence_parallel=sp)
    # the same leaves with the moments as the params' pieces (no ZeRO)
    plain = dataclasses.replace(place, moment_specs=place.param_specs)
    solo_p = _clone(whole[key])
    solo_o = O.init_opt_state(oc, solo_p, error_feedback=ef)
    mine = _pieces(whole[key], place)
    opt = O.init_opt_state(oc, mine, error_feedback=ef, placement=place)
    shadow_p = _clone(mine)
    shadow_o = O.init_opt_state(oc, shadow_p, error_feedback=ef, placement=plain)
    solo_step = TR.make_train_step(cfg, api.loss_fn, oc, **opts)
    mesh_step = TR.make_train_step(cfg, api.loss_fn, oc, placement=place, **opts)

    seen = {"solo": [], "mesh": []}
    zero = {"moments_equal": True, "params_equal": True}
    real = O.apply_updates

    def spy(cfg_, params, grads, state, placement=None):
        nonlocal shadow_p, shadow_o
        seen["mesh" if placement is not None else "solo"].append(
            [g.detach().clone() for g in flatten_leaves(grads)])
        out = real(cfg_, params, grads, state, placement)
        if placement is not None:
            shadow_p, shadow_o, _ = real(cfg_, shadow_p, grads, shadow_o, plain)
            zero["params_equal"] &= all(
                torch.equal(a, b) for a, b in zip(flatten_leaves(shadow_p), flatten_leaves(params)))
            for key in ("mu", "nu"):
                for i, (w, z) in enumerate(zip(flatten_leaves(shadow_o[key]),
                                               flatten_leaves(out[1][key]))):
                    want = sl.local_piece(w, place.moment_cut(i), mesh)
                    zero["moments_equal"] &= bool(torch.equal(want, z))
        return out

    real_route, side = MOE.route, ["solo"]
    drops = {"solo": [], "mesh": []}

    def count(*a, **k):
        r = real_route(*a, **k)
        drops[side[0]][-1] += int((~r.keep).sum())
        return r

    O.apply_updates, MOE.route = spy, count
    losses, norms = {"solo": [], "mesh": []}, {"solo": [], "mesh": []}
    aux = {"solo": [], "mesh": []}
    try:
        device = flatten_leaves(whole[key])[0].device
        for s in range(steps):
            b = {k: v.to(device) for k, v in batch(cfg, s, b_rows, s_len).items()}
            for k in drops:
                drops[k].append(0)
            side[0] = "solo"
            solo_p, solo_o, m0 = solo_step(solo_p, solo_o, b)
            side[0] = "mesh"
            mine, opt, m1 = mesh_step(mine, opt, b)
            for k, m in (("solo", m0), ("mesh", m1)):
                losses[k].append(float(m["loss"]))
                norms[k].append(float(m["grad_norm"]))
                aux[k].append(float(m.get("aux", 0.0)))
    finally:
        O.apply_updates, MOE.route = real, real_route
    # a rank holds 1/D of each moment whose d_model dimension D divides
    data = sl.axis_sizes(mesh)["data"]
    shares = []
    for i, (p, m) in enumerate(zip(flatten_leaves(mine), flatten_leaves(opt["mu"]))):
        cut = any(e is not None for e in place.moment_cut(i))
        shares.append([p.numel(), m.numel(), cut])
    out = {
        "losses": losses, "grad_norms": norms, "aux": aux, "drops": drops,
        "loss_rel": max(abs(a - b) / abs(a) for a, b in zip(losses["solo"], losses["mesh"])),
        "norm_rel": max(abs(a - b) / abs(a) for a, b in zip(norms["solo"], norms["mesh"])),
        "zero": zero, "shares": shares, "data": data,
        "moment_cuts": sum(s[2] for s in shares),
        "paths": list(place.paths), "whole": [math.prod(s) for s in place.shapes],
    }
    if not ef:  # step 0's: later steps start from params that differ by roundoff
        out["grad_err"] = _grad_err(seen["solo"][0], seen["mesh"][0], place)
    roundoff = _roundoff(seen["solo"][0]) if not ef else whole["roundoff"][key]
    out["params"] = _param_over(flatten_leaves(solo_p), flatten_leaves(mine), place, roundoff)
    if name == "adamw":
        whole["roundoff"][key] = roundoff
    return out


def _train_rank(rank: int, shape: tuple, job: dict) -> None:
    torch.set_num_threads(1)
    if job.get("device") == "cuda":  # ranks sharing card 0 over gloo
        torch.cuda.set_device(0)
    from repro_torch.distributed import shardlib as sl
    from repro_torch.distributed.elastic import replan_mesh
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train

    if job.get("replan"):  # the survivors' mesh: the same model-parallel degree
        planned = replan_mesh(job["replan"], model_parallel=shape[1])
        shape = (planned.shape["data"], planned.shape["model"])
    mesh = M.make_serving_mesh(shape, "gloo")
    result = {"rank": rank, "coords": sl.mesh_coords(mesh), "shape": list(shape)}
    whole = {arch: torch.load(path, map_location=job.get("device", "cpu"))
             for arch, path in job["params"].items()}
    whole["roundoff"] = {}
    for name in job["cases"]:
        result[name] = _run_case(name, mesh, whole, job.get("steps", STEPS))
    arch = job.get("arch", "tinyllama-1.1b")
    for other in job.get("launch", ()):  # the launcher's two steps on the mesh
        out = train.run(launcher_args("--steps", "2", arch=other), mesh=mesh)
        result[f"launch {other}"] = {"losses": out["losses"]}
    if job.get("save"):  # the launcher on the mesh, checkpoints after every step
        out = train.run(launcher_args("--steps", "2", "--ckpt-dir", job["save"],
                                      "--ckpt-every", "1", arch=arch), mesh=mesh)
        result["save"] = {"losses": out["losses"]}
    if job.get("resume"):  # resume another mesh's checkpoint, hold it to the mesh-free run
        from repro_torch.configs import get_config
        from repro_torch.core.weight_plan import flatten_leaves

        out = train.run(launcher_args("--steps", "3", "--ckpt-dir", job["resume"], arch=arch),
                        mesh=mesh)
        want = torch.load(job["uninterrupted"])
        cfg = get_config(arch, smoke=True)
        place = M.train_placement(cfg, mesh)
        roundoff = [r.bool() for r in flatten_leaves(want["roundoff"])]
        result["resume"] = {
            "losses": out["losses"],
            "params": _param_over(flatten_leaves(want["params"]), flatten_leaves(out["params"]),
                                  place, roundoff),
        }
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def run_mesh(shape: tuple, job: dict) -> list:
    """Spawn the gloo ranks of a (data, model) mesh for ``job`` (cases,
    saved whole params by ``params_key``, optional "launch": archs to train
    two steps through the launcher, "save" / "resume" checkpoint
    directories of the launcher's "arch" (tinyllama-1.1b without one),
    "uninterrupted": the mesh-free run to hold a resume to, "replan": the
    ranks left to re-plan the mesh for, "device": "cuda" for ranks sharing
    card 0, "steps", out) and return their results in rank order."""
    from repro_torch.launch import mesh as M

    world = shape[0] * shape[1]
    M.spawn_ranks(_train_rank, (tuple(shape), job), world, "gloo")
    out = []
    for r in range(world):
        with open(os.path.join(job["out"], f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out
