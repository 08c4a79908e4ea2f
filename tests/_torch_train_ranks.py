"""The rank side of tests/test_torch_sharded_training.py.

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


def batch(vocab: int, step: int) -> dict:
    """Step ``step``'s global synthetic batch (B x S), as torch tensors."""
    from repro_torch.data import LMDataConfig, synthetic_lm_batch

    b = synthetic_lm_batch(LMDataConfig(vocab=vocab, seq_len=S, global_batch=B), step)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def launcher_args(*flags):
    """The train CLI's args at smoke size on the CPU, lr 1e-3."""
    from repro_torch.launch import train

    return train.build_parser().parse_args(
        ["--arch", "tinyllama-1.1b", "--smoke", "--batch", str(B), "--seq", str(S),
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


def _run_case(name: str, mesh, whole: dict) -> dict:
    """One case: three steps mesh-free and meshed from the same params
    ``whole[arch]``; the meshed step's every optimizer update is shadowed
    by one whose moments stay the params' pieces (no ZeRO), whose moments
    and params a ZeRO-1 rank must equal bit for bit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.weight_plan import flatten_leaves
    from repro_torch.distributed import shardlib as sl
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.models.api import get_api
    from repro_torch.training import optimizer as O
    from repro_torch.training import trainer as TR

    arch, opts, remat = CASES[name]
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=remat)
    api = get_api(cfg)
    oc = O.OptimizerConfig(**OPT)
    ef = opts.get("compression") is not None
    place = M.train_placement(cfg, mesh)
    # the same leaves with the moments as the params' pieces (no ZeRO)
    plain = O.Placement.of(T.meta_tree(api.param_shapes(cfg)), api.param_axes(cfg), mesh,
                           place.rules, place.rules)
    solo_p = _clone(whole[arch])
    solo_o = O.init_opt_state(oc, solo_p, error_feedback=ef)
    mine = _pieces(whole[arch], place)
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

    O.apply_updates = spy
    losses, norms = {"solo": [], "mesh": []}, {"solo": [], "mesh": []}
    try:
        for s in range(STEPS):
            b = batch(cfg.vocab, s)
            solo_p, solo_o, m0 = solo_step(solo_p, solo_o, b)
            mine, opt, m1 = mesh_step(mine, opt, b)
            for k, m in (("solo", m0), ("mesh", m1)):
                losses[k].append(float(m["loss"]))
                norms[k].append(float(m["grad_norm"]))
    finally:
        O.apply_updates = real
    # a rank holds 1/D of each moment whose d_model dimension D divides
    data = sl.axis_sizes(mesh)["data"]
    shares = []
    for i, (p, m) in enumerate(zip(flatten_leaves(mine), flatten_leaves(opt["mu"]))):
        cut = any(e is not None for e in place.moment_cut(i))
        shares.append([p.numel(), m.numel(), cut])
    out = {
        "losses": losses, "grad_norms": norms,
        "loss_rel": max(abs(a - b) / abs(a) for a, b in zip(losses["solo"], losses["mesh"])),
        "norm_rel": max(abs(a - b) / abs(a) for a, b in zip(norms["solo"], norms["mesh"])),
        "zero": zero, "shares": shares, "data": data,
        "moment_cuts": sum(s[2] for s in shares),
    }
    if not ef:  # step 0's: later steps start from params that differ by roundoff
        out["grad_err"] = _grad_err(seen["solo"][0], seen["mesh"][0], place)
    roundoff = _roundoff(seen["solo"][0]) if not ef else whole["roundoff"][arch]
    out["params"] = _param_over(flatten_leaves(solo_p), flatten_leaves(mine), place, roundoff)
    if name == "adamw":
        whole["roundoff"][arch] = roundoff
    return out


def _train_rank(rank: int, shape: tuple, job: dict) -> None:
    torch.set_num_threads(1)
    from repro_torch.distributed import shardlib as sl
    from repro_torch.distributed.elastic import replan_mesh
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train

    if job.get("replan"):  # the survivors' mesh: the same model-parallel degree
        planned = replan_mesh(job["replan"], model_parallel=shape[1])
        shape = (planned.shape["data"], planned.shape["model"])
    mesh = M.make_serving_mesh(shape, "gloo")
    result = {"rank": rank, "coords": sl.mesh_coords(mesh), "shape": list(shape)}
    whole = {arch: torch.load(path) for arch, path in job["params"].items()}
    whole["roundoff"] = {}
    for name in job["cases"]:
        result[name] = _run_case(name, mesh, whole)
    if job.get("save"):  # the launcher on the mesh, checkpoints after every step
        out = train.run(launcher_args("--steps", "2", "--ckpt-dir", job["save"],
                                      "--ckpt-every", "1"), mesh=mesh)
        result["save"] = {"losses": out["losses"]}
    if job.get("resume"):  # resume another mesh's checkpoint, hold it to the mesh-free run
        from repro_torch.configs import get_config
        from repro_torch.core.weight_plan import flatten_leaves

        out = train.run(launcher_args("--steps", "3", "--ckpt-dir", job["resume"]), mesh=mesh)
        want = torch.load(job["uninterrupted"])
        cfg = get_config("tinyllama-1.1b", smoke=True)
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
    saved whole params by arch, optional "save" / "resume" checkpoint
    directories, "uninterrupted": the mesh-free run to hold a resume to,
    "replan": the ranks left to re-plan the mesh for, out) and return
    their results in rank order."""
    from repro_torch.launch import mesh as M

    world = shape[0] * shape[1]
    M.spawn_ranks(_train_rank, (tuple(shape), job), world, "gloo")
    out = []
    for r in range(world):
        with open(os.path.join(job["out"], f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out
