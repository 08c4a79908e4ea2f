"""Meshed training of the MoE, recurrent, xLSTM, enc-dec and VLM families on
the port (``make_train_step(placement=)``, ``launch.train.run(mesh=)``)
against the port's mesh-free trainer, at smoke size (fp32 compute).

As for the dense family (tests/test_torch_sharded_training.py), a meshed
step is held to the port's mesh-free step on the same params and global
batches, and the mesh-free step to the reference's ``make_train_step``
(tests/test_torch_train_moe.py, test_torch_train_recurrent.py,
test_torch_train_encdec.py); granite-moe's and whisper's 2x2 losses are
also held to the reference directly.  Each mesh's gloo ranks run every
case of ``_torch_train_ranks.FAMILY_CASES`` in one spawn: granite-moe,
qwen2-moe (shared experts), recurrentgemma (RG-LRU, MQA local attention),
xlstm (mLSTM and sLSTM, also with remat), whisper (frames) and internvl
(patches), plus the MoE's routing cases -- granite at 512 tokens with
capacity factor 0.5 (at 2x1 each replica holds 256 tokens of one dispatch
group, and the mesh-free run drops assignments) and qwen2-moe with 5
experts (the "expert_ff" rule at model 2).  The 2x2 mesh also trains
internvl through the launcher and writes xlstm checkpoints, which the 1x2
mesh resumes.  granite's and whisper's params are the reference's
(``interop``), the other cases' the port's own draw (the comparison is
the port against itself; a JAX init costs ~5 s a config).

Tolerances are tests/test_torch_sharded_training.py's: losses 1e-5
relative; step 0's gradient leaves 1e-5 of each leaf's max; params after
three steps 1e-4 absolute, roundoff elements 3 lr; ZeRO-1 moments and the
params they update equal to a shadow without ZeRO bit for bit; a MoE's
dropped assignments equal, its aux loss to 1e-5 relative."""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import _torch_train_ranks as R
from _torch_train import configs, port_params, ref_steps
from repro_torch import configs as C
from repro_torch.configs import get_config
from repro_torch.core.weight_plan import flatten_leaves, map_tree, unflatten_leaves
from repro_torch.distributed import shardlib as sl
from repro_torch.launch import mesh as M
from repro_torch.launch import train
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.api import get_api

MESHES = [(1, 2), (2, 1), (2, 2)]
CASES = list(R.FAMILY_CASES)
MOE_CASES = [c for c in CASES if R.case(c)[0] in ("granite-moe-1b-a400m", "qwen2-moe-a2.7b")]
# held to the reference at 2x2, so their params are the reference's
REF_HELD = ("granite", "whisper")
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
AUX_RTOL = 1e-5
XLSTM, INTERNVL = "xlstm-350m", "internvl2-2b"


def _ref_config(name: str):
    """(reference config, port config) of a case, its MoE changes applied to
    both."""
    arch, _, _, changes, _ = R.case(name)
    rcfg, cfg = configs(arch)
    if changes:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe, **changes))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **changes))
    return rcfg, cfg


def _uninterrupted(path: str, arch: str) -> dict:
    """The launcher's mesh-free three steps of ``arch`` (the run a resumed
    mesh must equal) and the roundoff elements of its step-0 gradients."""
    out = train.run(R.launcher_args("--steps", "3", arch=arch))
    cfg = get_config(arch, smoke=True)
    api = get_api(cfg)
    params = api.init_params(cfg, 0, device="cpu")
    leaves = [p.requires_grad_(True) for p in flatten_leaves(params)]
    loss, _ = api.loss_fn(cfg, params, R.batch(cfg, 0))
    grads = torch.autograd.grad(loss, leaves)
    roundoff = unflatten_leaves(params, [g.abs() <= R.ROUNDOFF * g.abs().max() for g in grads])
    want = {"params": map_tree(lambda _, t: t.detach(), out["params"]), "roundoff": roundoff,
            "losses": out["losses"]}
    torch.save(want, path)
    return want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: its ranks' results}, the 2x2 mesh first (it writes the xlstm
    launcher's checkpoints that the 1x2 mesh resumes), the mesh-free
    launcher runs of xlstm (three steps) and internvl (two)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        d = tmp_path_factory.mktemp("sharded_training_families")
        params, ref_keys = {}, {R.params_key(c) for c in REF_HELD}
        for name in CASES:
            key = R.params_key(name)
            if key not in params:
                params[key] = str(d / f"{key}.pt")
                rcfg, cfg = _ref_config(name)
                torch.save(port_params(rcfg) if key in ref_keys
                           else get_api(cfg).init_params(cfg, 0, device="cpu"), params[key])
        out = {"uninterrupted": _uninterrupted(str(d / "uninterrupted.pt"), XLSTM),
               "internvl": train.run(R.launcher_args("--steps", "2", arch=INTERNVL))["losses"]}
        ckpt = str(d / "ckpt")
        for shape in [(2, 2), (1, 2), (2, 1)]:
            job = {"cases": CASES, "params": params, "arch": XLSTM,
                   "out": str(d / "x".join(map(str, shape)))}
            os.makedirs(job["out"])
            if shape == (2, 2):
                job.update(save=ckpt, launch=[INTERNVL])
            if shape == (1, 2):
                job.update(resume=ckpt, uninterrupted=str(d / "uninterrupted.pt"), replan=2)
            out[shape] = R.run_mesh(shape, job)
        return out
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", CASES)
def test_meshed_steps_match_the_mesh_free_trainer(runs, case, shape):
    """Three AdamW steps of every family on the mesh: every rank's losses,
    its pieces of step 0's gradients and of the params after the steps
    equal its slices of the mesh-free run's."""
    for row in runs[shape]:
        got = row[case]
        assert got["loss_rel"] <= LOSS_RTOL, (row["coords"], got["losses"])
        assert got["grad_err"] <= GRAD_RTOL, (row["coords"], got["grad_err"])
        over, n, worst = got["params"]
        assert over == 0, (row["coords"], over, n, worst)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", CASES)
def test_zero1_moments_are_slices_of_the_whole(runs, case, shape):
    """A rank's moment pieces (and the params they update) equal its slices
    of an update without ZeRO on the same gradients, bit for bit; each
    moment the data axis cuts holds 1/D of its param piece.  The sLSTM's
    ``r_gates`` is whole on every rank and its moments split over the data
    axis; an expert stack's moments are cut on d_model as well."""
    for row in runs[shape]:
        got = row[case]
        assert got["zero"] == {"moments_equal": True, "params_equal": True}, row["coords"]
        D = got["data"]
        for path, whole, (p, m, cut) in zip(got["paths"], got["whole"], got["shares"]):
            assert m * (D if cut else 1) == p, (path, p, m, cut)
            if path.endswith("r_gates"):
                assert p == whole and cut == (D > 1), (path, p, whole, cut)
            if path.endswith("moe/w_gate"):
                assert cut == (D > 1), path
        assert (got["moment_cuts"] > 0) == (D > 1)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", CASES)
def test_ranks_report_the_global_metrics(runs, case, shape):
    """``loss``, ``aux`` and ``grad_norm`` are the whole batch's and the
    whole tree's: equal on every rank, step 0's grad norm (the same params
    on both sides) within 1e-5 of the mesh-free one.  Later steps start
    from params that differ where a gradient was near roundoff: AdamW's
    normalised update turns its roundoff into a step of up to lr (seen:
    internvl's params 5.5e-5 apart after two steps, its step-2 gradients
    1e-3 of a leaf's max and its norm 3.2e-5 relative at 1x2, with losses
    2.5e-7 apart); the losses and params after them are held above."""
    rows = runs[shape]
    first = rows[0][case]
    for row in rows[1:]:
        for key in ("losses", "grad_norms", "aux"):
            assert row[case][key]["mesh"] == first[key]["mesh"], (key, row["coords"])
    solo, mesh = first["grad_norms"]["solo"][0], first["grad_norms"]["mesh"][0]
    assert abs(mesh - solo) <= 1e-5 * solo, first["grad_norms"]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_routes_the_global_batch(runs, case, shape):
    """Each step's dropped assignments, summed over the data replicas (the
    ranks of model index 0), equal the mesh-free run's, and the Switch aux
    loss is the global batch's.  At 512 tokens and capacity factor 0.5 the
    mesh-free run drops assignments: at 2x1 each replica holds 256 tokens,
    half of the one dispatch group, and routes at the global capacity."""
    rows = [r for r in runs[shape] if r["coords"]["model"] == 0]
    got = rows[0][case]
    drops = [sum(r[case]["drops"]["mesh"][s] for r in rows) for s in range(R.STEPS)]
    assert drops == got["drops"]["solo"], (drops, got["drops"]["solo"])
    if case == "granite_512":
        assert min(drops) > 0
    np.testing.assert_allclose(got["aux"]["mesh"], got["aux"]["solo"], rtol=AUX_RTOL, atol=0)
    assert min(got["aux"]["solo"]) > 0


def test_expert_ff_rule_splits_every_experts_width():
    """qwen2-moe with 5 experts on a model axis of 2: the experts do not
    divide, so ``train_placement`` keeps each stack's experts whole and
    splits their FFN width (gate/up columns, down rows), the shared
    experts by "ff"; with the smoke config's 6 experts the stacks split on
    their expert axis."""
    mesh = sl.MeshShape({"data": 1, "model": 2}, {"data": 0, "model": 1})
    for name, want in (("qwen2_expert_ff", {"w_gate": (None, None, None, "model"),
                                            "w_down": (None, None, "model", None)}),
                       ("qwen2", {"w_gate": (None, "model", None, None),
                                  "w_down": (None, "model", None, None)})):
        place = M.train_placement(R.case_config(name), mesh)
        specs = dict(zip(place.paths, place.param_specs))
        for leaf, spec in want.items():
            assert specs[f"unit/0/moe/{leaf}"] == spec, (name, leaf)
        assert specs["unit/0/moe/shared/w_gate"] == (None, None, "model")


@pytest.mark.parametrize("tokens, replicas, want", [
    (64, 1, (1, 1)), (1024, 1, (2, 1)), (512, 1, (1, 1)), (256, 2, (1, 2)),
    (128, 4, (1, 4)), (512, 2, (1, 1)), (768, 2, None), (384, 4, None)])
def test_dispatch_groups_of_a_replica(tokens, replicas, want):
    """A replica's T tokens of a global batch of ``replicas`` * T: whole
    groups of the global count's group size, or one part of a group the
    next replicas share; any other cut is refused by name."""
    if want is None:
        with pytest.raises(ValueError, match="straddle the data replicas' rows"):
            MOE.dispatch_groups(tokens, replicas)
    else:
        assert MOE.dispatch_groups(tokens, replicas) == want


def test_straddling_dispatch_groups_are_refused():
    """granite-moe at B 4 x S 384 on two data replicas: 1536 tokens make
    groups of 512, and a replica's 768 tokens cut the second one; the loss
    refuses the batch before any expert runs."""
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    params = get_api(cfg).init_params(cfg, 0, device="cpu")
    b = R.batch(cfg, 0, 4, 384)
    mesh = sl.MeshShape({"data": 2, "model": 1}, {"data": 1, "model": 0})
    with sl.use_mesh(mesh, M.rules_for(cfg, None, mesh=mesh)):
        with pytest.raises(ValueError, match="groups of 512 tokens straddle .* 768 tokens"):
            T.loss_fn(cfg, params, b)


@pytest.mark.parametrize("case", REF_HELD)
def test_2x2_losses_match_the_reference(runs, case):
    """The 2x2 mesh's losses against the reference's mesh-free, jitted
    ``make_train_step`` on the same params and batches."""
    rcfg, cfg = _ref_config(case)
    _, want = ref_steps(rcfg, cfg, R.STEPS)
    got = runs[(2, 2)][0][case]["losses"]["mesh"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)


def test_xlstm_2x2_checkpoint_resumes_at_1x2(runs):
    """The launcher trains xlstm at 2x2 and writes whole-leaf checkpoints
    (``r_gates`` whole, its moments gathered over the data axis) after
    steps 1 and 2; at 1x2 (``elastic.replan_mesh`` of two ranks) it resumes
    from step 2 and runs step 3 only: its loss and its params equal the
    mesh-free uninterrupted run's."""
    want = runs["uninterrupted"]
    for row in runs[(2, 2)]:
        np.testing.assert_allclose(row["save"]["losses"], want["losses"][:2], rtol=LOSS_RTOL)
    for row in runs[(1, 2)]:
        assert row["shape"] == [1, 2]
        got = row["resume"]
        np.testing.assert_allclose(got["losses"], want["losses"][2:], rtol=LOSS_RTOL)
        over, n, worst = got["params"]
        assert over == 0, (row["coords"], over, n, worst)


def test_internvl_trains_through_the_launcher_at_2x2(runs):
    """``launch.train.run(args, mesh=)`` at 2x2 for internvl: the patches
    drawn for the global batch on every rank, each replica projecting its
    rows'; two steps' losses equal the mesh-free launcher's."""
    for row in runs[(2, 2)]:
        np.testing.assert_allclose(row[f"launch {INTERNVL}"]["losses"], runs["internvl"],
                                   rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_every_arch_has_a_training_placement(arch):
    """No family is refused on a mesh: ``train_placement`` places every
    arch of the registry at 2x2 (full width, shapes only), each param spec
    over the model axis at most, each moment spec splitting what its param's
    does; an sLSTM's ``r_gates`` is whole with its moments over the data
    axis."""
    assert not hasattr(T, "check_meshable")
    cfg = get_config(arch)
    mesh = sl.MeshShape({"data": 2, "model": 2}, {"data": 1, "model": 1})
    place = M.train_placement(cfg, mesh)
    assert len(place.paths) == len(flatten_leaves(T.meta_tree(get_api(cfg).param_shapes(cfg))))
    for path, spec, mom in zip(place.paths, place.param_specs, place.moment_specs):
        assert set(sl.spec_axes(spec)) <= {"model"}, (path, spec)
        assert all(p is None or p == m for p, m in zip(spec, mom)), (path, spec, mom)
        if path.endswith("r_gates"):  # (layers, 4, H, hd, hd)
            assert spec == (None,) * 5 and mom == (None, None, "data", None, None), (path, mom)
    assert sum(math.prod(s) for s in place.shapes) == T.count_params(
        get_api(cfg).param_shapes(cfg))
