"""Meshed training on the port (``make_train_step(placement=)``,
``launch.train.run(mesh=)``) against the port's mesh-free trainer, for the
dense family at smoke size (fp32 compute).

The reference's own meshed training is red under JAX 0.9 (ROADMAP C2), so
a meshed step is held to the port's mesh-free step on the same params and
batches, and the mesh-free step to the reference's ``make_train_step``
(``tests/test_torch_training.py``); one test holds the 2x2 losses to the
reference directly.  Each mesh's gloo ranks run every check in one spawn
(``tests/_torch_train_ranks``, which imports the port only): tinyllama's
three AdamW steps, ``accum 2``, int8 and top-k compression, remat,
llama3.2-1b's tied table, and glm4-9b's and gemma3-4b's layers (gemma3's
sliding windows and scaled embedding), each with every optimizer update
shadowed by one without ZeRO; the 2x2 mesh also trains through the launcher and writes
checkpoints, which the 1x2 mesh resumes.

Tolerances: losses to 1e-5 relative; step 0's gradient leaves (the same
params on both sides) to 1e-5 of each leaf's max; params after three steps
to 1e-4 absolute (lr / 10), an element whose step-0 gradient is below 1e-5
of its leaf's max to 3 lr (AdamW turns its roundoff into a step of up to lr,
``tests/_torch_train.py``); compressed steps may put 0.1% of the elements
past that (an int8 rounding tie flips with the sum's order).  ZeRO-1
moments and the params they update equal the shadow's bit for bit."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_train_ranks as R
from _torch_train import configs, port_params, ref_steps
from repro_torch.configs import get_config
from repro_torch.core.weight_plan import flatten_leaves, map_tree, unflatten_leaves
from repro_torch.data import LMDataConfig, synthetic_lm_batch
from repro_torch.distributed import shardlib as sl
from repro_torch.launch import mesh as M
from repro_torch.launch import train
from repro_torch.models import transformer as T

MESHES = [(1, 2), (2, 1), (2, 2)]
ARCHS = ("tinyllama-1.1b", "llama3.2-1b")  # held to the reference at 2x2
DENSE = ARCHS + ("glm4-9b", "gemma3-4b")
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
COMPRESSED_SHARE = 1e-3


def _uninterrupted(path: str) -> dict:
    """The launcher's mesh-free three steps (the run a resumed mesh must
    equal) and the roundoff elements of its step-0 gradients."""
    out = train.run(R.launcher_args("--steps", "3"))
    cfg = get_config("tinyllama-1.1b", smoke=True)
    params = T.init_params(cfg, 0, device="cpu")
    b = synthetic_lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=R.S, global_batch=R.B), 0)
    leaves = [p.requires_grad_(True) for p in flatten_leaves(params)]
    loss, _ = T.loss_fn(cfg, params, {k: torch.from_numpy(v) for k, v in b.items()})
    grads = torch.autograd.grad(loss, leaves)
    roundoff = unflatten_leaves(params, [g.abs() <= R.ROUNDOFF * g.abs().max() for g in grads])
    want = {"params": map_tree(lambda _, t: t.detach(), out["params"]), "roundoff": roundoff,
            "losses": out["losses"]}
    torch.save(want, path)
    return want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: its ranks' results}, the 2x2 mesh first (it writes the
    launcher's checkpoints that the 1x2 mesh resumes), and the mesh-free
    launcher run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        d = tmp_path_factory.mktemp("sharded_training")
        params = {}
        for arch in DENSE:
            params[arch] = str(d / f"{arch}.pt")
            torch.save(port_params(configs(arch)[0]), params[arch])
        uninterrupted = _uninterrupted(str(d / "uninterrupted.pt"))
        ckpt = str(d / "ckpt")
        out = {}
        for shape in [(2, 2), (1, 2), (2, 1)]:
            job = {"cases": list(R.CASES), "params": params,
                   "out": str(d / "x".join(map(str, shape)))}
            os.makedirs(job["out"])
            if shape == (2, 2):
                job["save"] = ckpt
            if shape == (1, 2):
                job.update(resume=ckpt, uninterrupted=str(d / "uninterrupted.pt"), replan=2)
            out[shape] = R.run_mesh(shape, job)
        out["uninterrupted"] = uninterrupted
        return out
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", ["adamw", "accum2", "remat", "tied", "glm4", "gemma3"])
def test_meshed_steps_match_the_mesh_free_trainer(runs, case, shape):
    """Three AdamW steps (also with two microbatches of the global batch,
    with remat, llama3.2-1b's tied table, glm4-9b and gemma3-4b): every
    rank's losses, its pieces of step 0's gradients and of the params after
    the steps equal its slices of the mesh-free run's."""
    for row in runs[shape]:
        got = row[case]
        assert got["loss_rel"] <= LOSS_RTOL, (row["coords"], got["losses"])
        assert got["grad_err"] <= GRAD_RTOL, (row["coords"], got["grad_err"])
        over, n, worst = got["params"]
        assert over == 0, (row["coords"], over, n, worst)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", ["int8", "topk"])
def test_compressed_steps_keep_whole_leaf_codecs(runs, case, shape):
    """int8 (the scale a MAX over the whole leaf) and top-k (the threshold
    of the gathered whole leaf) with error feedback on the rank's pieces:
    losses as above, at most 0.1% of the param elements past the
    tolerance."""
    for row in runs[shape]:
        got = row[case]
        assert got["loss_rel"] <= LOSS_RTOL, (row["coords"], got["losses"])
        over, n, worst = got["params"]
        assert over <= COMPRESSED_SHARE * n, (row["coords"], over, n, worst)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_zero1_moments_are_slices_of_the_whole(runs, shape):
    """A rank's moment pieces equal its slices of the moments an update
    without ZeRO keeps on the same gradients, bit for bit, and so do the
    params; each moment whose d_model dimension the data axis divides holds
    1/D of the param piece's elements, the others all of them."""
    for row in runs[shape]:
        for case in R.CASES:
            got = row[case]
            assert got["zero"] == {"moments_equal": True, "params_equal": True}, (case, row)
            D = got["data"]
            for p, m, cut in got["shares"]:
                assert m * (D if cut else 1) == p, (case, p, m, cut)
            # every leaf has a d_model dimension, which the data axis divides
            assert got["moment_cuts"] == (len(got["shares"]) if D > 1 else 0), case


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ranks_report_the_global_metrics(runs, shape):
    """``loss`` and ``grad_norm`` are the whole batch's and the whole
    tree's: equal on every rank, and the grad norm within 1e-5 of the
    mesh-free one."""
    rows = runs[shape]
    for case in R.CASES:
        first = rows[0][case]
        for row in rows[1:]:
            assert row[case]["losses"]["mesh"] == first["losses"]["mesh"], case
            assert row[case]["grad_norms"]["mesh"] == first["grad_norms"]["mesh"], case
        if case not in ("int8", "topk"):
            assert first["norm_rel"] <= 1e-5, (case, first["grad_norms"])


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_losses_match_the_reference(runs, arch):
    """The 2x2 mesh's losses against the reference's mesh-free, jitted
    ``make_train_step`` on the same params and batches."""
    rcfg, cfg = configs(arch)
    _, want = ref_steps(rcfg, cfg, R.STEPS)
    case = "adamw" if arch == "tinyllama-1.1b" else "tied"
    got = runs[(2, 2)][0][case]["losses"]["mesh"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)


def test_2x2_checkpoint_resumes_at_1x2(runs):
    """The launcher at 2x2 writes whole-leaf checkpoints after steps 1 and
    2; at 1x2 (``elastic.replan_mesh`` of two ranks at model degree 2) it
    resumes from step 2 and runs step 3 only: its loss and its params equal
    the mesh-free uninterrupted run's."""
    want = runs["uninterrupted"]
    for row in runs[(2, 2)]:
        np.testing.assert_allclose(row["save"]["losses"], want["losses"][:2], rtol=LOSS_RTOL)
    for row in runs[(1, 2)]:
        assert row["shape"] == [1, 2]
        got = row["resume"]
        np.testing.assert_allclose(got["losses"], want["losses"][2:], rtol=LOSS_RTOL)
        over, n, worst = got["params"]
        assert over == 0, (row["coords"], over, n, worst)


@pytest.mark.parametrize("spec, need", [("pod", 256), ("multipod", 512)])
def test_train_mesh_shapes(spec, need):
    """``--mesh`` as the train CLI resolves it over a world of ranks:
    ``host`` alone is the mesh-free step and 1 x the ranks under torchrun;
    the production meshes take exactly their ranks (the CLI's refusal
    outside torchrun: tests/test_torch_train_cli.py)."""
    assert M.train_mesh_sizes("host", 1) is None
    assert M.train_mesh_sizes("host", 4) == {"data": 1, "model": 4}
    assert M.train_mesh_sizes(spec, need) == M.make_production_mesh(
        multi_pod=spec == "multipod").shape
    with pytest.raises(ValueError, match=f"needs {need} ranks under torchrun, this run has 4"):
        M.train_mesh_sizes(spec, 4)


@pytest.mark.parametrize("case", ["2x8 cards", "one host, cpu", "one card shared",
                                  "one card", "pod on 16"])
def test_train_torchrun_ranks_choose_the_backend_per_host(monkeypatch, case):
    """Under ``torchrun`` the train CLI joins the group with the backend
    for the ranks on its own host (``launch.mesh.join_torchrun``, which the
    serve CLI shares): 2 hosts x 8 cards is NCCL on the rank's card, ranks
    on the CPU or sharing a card (``--share-card``) gloo, more ranks than
    cards without it refused; ``--mesh host`` is then 1 x WORLD_SIZE, and
    ``--mesh pod`` over 16 ranks is refused before joining."""
    world, local, device, flags, card = {
        "2x8 cards": (16, 8, "cuda", ["--mesh", "host"], 1),
        "one host, cpu": (2, 2, "cpu", ["--mesh", "host", "--device", "cpu"], None),
        "one card shared": (2, 2, "cuda", ["--mesh", "host", "--share-card"], 0),
        "one card": (2, 2, "cuda", ["--mesh", "host"], None),
        "pod on 16": (16, 8, "cuda", ["--mesh", "pod"], None),
    }[case]
    env = {"WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(local), "RANK": "1",
           "LOCAL_RANK": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8 if world == 16 else 1)
    monkeypatch.setattr(train, "resolve_device", lambda d: torch.device(d or device))
    cards, joined, meshes = [], [], []
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setattr(M, "init_rank", lambda *a: joined.append(a))
    monkeypatch.setattr(M, "make_mesh", lambda sizes, backend: meshes.append((sizes, backend)))
    args = train.build_parser().parse_args(["--arch", "tinyllama-1.1b", *flags])
    if case in ("one card", "pod on 16"):
        match = "--mesh needs 2 cards, have 1" if case == "one card" else "needs 256 ranks"
        with pytest.raises(ValueError, match=match):
            train._join_torchrun(args)
        assert joined == [] and cards == []
        return
    backend = "nccl" if case == "2x8 cards" else "gloo"
    assert train._join_torchrun(args) is True
    assert joined == [(1, world, backend)]
    assert cards == ([] if card is None else [torch.device("cuda", card)])
    monkeypatch.setattr(train.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(train.dist, "get_world_size", lambda: world)
    monkeypatch.setattr(train.dist, "get_backend", lambda: backend)
    train.train_mesh(args, torch.device(device))
    assert meshes == [({"data": 1, "model": world}, backend)]


def test_train_cli_under_torchrun_trains_at_1x2(runs, tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.train --mesh host`` on the CPU: two gloo ranks at
    1 x 2, whose logged losses (4 decimals) are the mesh-free run's, and
    whose whole-leaf checkpoint restores mesh-free to the mesh-free run's
    params (the tolerances above)."""
    from repro_torch.checkpoint import store

    flags = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "2", "--batch", str(R.B),
             "--seq", str(R.S), "--lr", "1e-3", "--log-every", "1", "--device", "cpu"]
    ckpt = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(__file__)), "src"),
         os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.train", *flags, "--mesh", "host", "--ckpt-dir", ckpt],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[train] mesh {'data': 1, 'model': 2} over gloo" in proc.stdout, proc.stdout
    got = [float(x) for x in re.findall(r"\[train\] step \d+ loss ([0-9.]+)", proc.stdout)]
    want = train.run(train.build_parser().parse_args(flags))
    assert len(got) == 2
    np.testing.assert_allclose(got, want["losses"], rtol=0, atol=1e-4)
    like = (want["params"], want["opt_state"])
    (params, _), meta = store.restore(ckpt, like)
    assert meta["step"] == 2
    roundoff = flatten_leaves(runs["uninterrupted"]["roundoff"])
    for a, b, r in zip(flatten_leaves(params), flatten_leaves(want["params"]), roundoff):
        assert a.shape == b.shape
        tol = torch.where(r, 3 * R.OPT["lr"], R.PARAM_ATOL)
        assert bool(((a - b.detach()).abs() <= tol).all())
