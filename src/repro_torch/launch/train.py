"""Training launcher (port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke \
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Runs on the CUDA device (``--device cpu`` trains on the CPU; without a GPU
and without it, it raises).  It trains every arch of the registry: the
dense and MoE decoder-only transformers, recurrentgemma-2b and xlstm-350m,
the VLM (internvl2-2b) and the enc-dec (whisper-tiny).  Params come
from the port's ``init_params(cfg, --seed)``, tokens from ``synthetic_lm_batch`` (a pure
function of (seed, step)) and a VLM's patches or an enc-dec's frames from
``extras`` (N(0, 1) from ``np.random.default_rng(step)``, the reference's
draws).  The warmup is ``min(20, max(1, steps // 4))`` steps, as in the
reference.

Fault tolerance: every ``--ckpt-every`` steps an ``AsyncCheckpointer``
writes ``(params, opt_state)``; on start the latest complete checkpoint is
restored, and a ``RestartSupervisor`` restores it again and resumes after
a ``RuntimeError`` (at most 2 times).  A checkpoint is labelled with the
number of steps it holds, so a resume starts at the first step it has not
run: the reference labels a mid-run checkpoint with the step it has just
run and so runs that step twice after a restore (ROADMAP C7).

Meshes.  ``--mesh`` keeps the reference's three choices: ``host`` is 1 x
the ranks there are -- the mesh-free step alone, (1, WORLD_SIZE) under
``torchrun`` --, and ``pod`` / ``multipod`` are the production meshes
(16, 16) and (2, 16, 16), which need 256 / 512 ranks under ``torchrun``
and are refused otherwise.  ``run(args, mesh=)`` takes a ``DeviceMesh``
whose process group the caller made (``launch.mesh.spawn_ranks``; NCCL
where each rank owns a card, gloo for ranks that share one:
``choose_backend``).  Every family trains on a mesh.  Each rank draws
the whole tree on its device, leaf by leaf, and keeps its pieces (the
one-card run's params); each draws the whole global batch with its
frames or patches (``extras``), and the loss takes its replica's rows of
all of them; the moments are ZeRO-1 pieces
(``launch.mesh.train_placement``; an sLSTM's ``r_gates`` whole, its
moments over the data axes).  A
checkpoint holds whole leaves: every rank takes part in gathering them,
rank 0 writes, and the others wait at a barrier; a restore cuts each
rank's pieces on the host, so a checkpoint of one mesh resumes on another
(``distributed.elastic.replan_mesh``); the last step's save is not
written twice.  The step-time record and the
restart supervisor run on every rank in lockstep: every rank records every
rank's step time.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.configs as C
from repro_torch.checkpoint import store
from repro_torch.data import LMDataConfig, synthetic_lm_batch
from repro_torch.device import resolve_device
from repro_torch.distributed import shardlib as sl
from repro_torch.distributed.fault import RestartSupervisor, StragglerDetector
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.models.api import get_api
from repro_torch.training import optimizer as O
from repro_torch.training.trainer import make_train_step


def extras(cfg, api, host_batch: int, step: int) -> dict:
    """The frontend-stub inputs of step ``step``'s batch, as the reference's
    launcher draws them: a VLM's ``patches`` (host_batch, n_patches, d) or an
    enc-dec's ``frames`` (host_batch, n_frames, d), fp32 N(0, 1) from
    ``np.random.default_rng(step)``; {} for the other families."""
    out = {}
    rng = np.random.default_rng(step)
    if "patches" in api.extra_keys:
        out["patches"] = rng.normal(size=(host_batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if "frames" in api.extra_keys:
        out["frames"] = rng.normal(size=(host_batch, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def train_mesh(args, device: torch.device):
    """The DeviceMesh ``--mesh`` asks for over this process's group (None
    for ``host`` alone: the mesh-free step); raises ValueError for
    ``pod`` / ``multipod`` over any other number of ranks than theirs."""
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    sizes = M.train_mesh_sizes(args.mesh, world)
    if sizes is None:
        return None
    backend = dist.get_backend() if dist.is_initialized() else M.choose_backend(1, device.type)
    return M.make_mesh(sizes, backend)


def _step_times(dt: float, world: int, device) -> list:
    """Every rank's step time (one all-gather over the world)."""
    if world == 1:
        return [dt]
    mine = torch.tensor([dt], dtype=torch.float32, device=device)
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    return [float(t) for t in parts]


def run(args, cfg=None, mesh=None, sequence_parallel: bool = False) -> dict:
    """Train ``args.steps`` steps (from the latest checkpoint in
    ``args.ckpt_dir`` where there is one).  Returns {"final_loss",
    "losses", "grad_norms", "params", "opt_state", "restarts", "step_s"}:
    the losses, global grad norms and wall times (host clock, each step
    ending in the loss's read) of the steps this call ran, and the
    supervisor's restart count.  ``mesh``: train on it, this process one
    of its ranks (``params`` and ``opt_state`` are then the rank's pieces);
    without one, ``--mesh`` picks it (``train_mesh``).  ``sequence_parallel``
    runs the meshed steps under the ``seq_sp`` rule (Megatron's sequence
    parallelism, ``launch.mesh.train_placement``); the CLI has no flag for
    it, as the reference's has none."""
    if cfg is None:
        cfg = C.get_config(args.arch, smoke=args.smoke)
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=True)
    api = get_api(cfg)
    device = resolve_device(args.device)
    if mesh is None:
        mesh = train_mesh(args, device)
    # warmup scales with the run, so a short run does not stay in the ramp
    opt_cfg = O.OptimizerConfig(
        lr=args.lr,
        warmup_steps=min(20, max(1, args.steps // 4)),
        decay_steps=max(100, args.steps),
    )
    data_cfg = LMDataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                            seed=args.seed)
    place, rank, world = None, 0, 1
    if mesh is None:
        params = api.init_params(cfg, args.seed, device=device)
    else:
        place = M.train_placement(cfg, mesh, sequence_parallel=sequence_parallel)
        rank, world = dist.get_rank(), dist.get_world_size()
        params = T.make_params(api.param_shapes(cfg), args.seed, device, leaf_fn=place.piece)
        if rank == 0:
            sp = ", sequence parallel over model" if sequence_parallel else ""
            print(f"[train] mesh {sl.axis_sizes(mesh)} over {dist.get_backend()}: tensor "
                  f"parallel over model{sp}, data parallel over data, ZeRO-1 moments", flush=True)
    opt_state = O.init_opt_state(opt_cfg, params, error_feedback=args.compression is not None,
                                 placement=place)
    step_fn = make_train_step(cfg, api.loss_fn, opt_cfg, accum_steps=args.accum,
                              compression=args.compression, placement=place)
    specs = None if place is None else place.state_specs(params, opt_state)
    saver = store.AsyncCheckpointer(args.ckpt_dir, keep=3) if args.ckpt_dir and rank == 0 else None
    straggler = StragglerDetector(n_hosts=world)
    losses, norms, step_s = [], [], []
    saved = []  # the labels this call wrote

    def save(step: int):
        saved.append(step)
        meta = {"step": step, "arch": args.arch}
        if place is None:
            saver.save(step, (params, opt_state), meta)
            return
        host = store.gather_state((params, opt_state), specs, rank)
        if saver:
            saver.save_host(step, host, meta)
        dist.barrier()

    def loop(start: int) -> int:
        nonlocal params, opt_state
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            batch = synthetic_lm_batch(data_cfg, step)
            batch.update(extras(cfg, api, data_cfg.host_batch, step))
            batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            norms.append(float(metrics["grad_norm"]))
            step_s.append(dt)
            for r, t in enumerate(_step_times(dt, world, device)):
                straggler.record(r, t)
            if step % args.log_every == 0 and rank == 0:
                print(
                    f"[train] step {step} loss {loss:.4f} "
                    f"lr {float(metrics['lr']):.2e} gnorm {norms[-1]:.2f} "
                    f"({dt:.2f}s)",
                    flush=True,
                )
            if args.ckpt_dir and step > 0 and step % args.ckpt_every == 0:
                save(step + 1)
        return args.steps

    def restore_fn() -> int:
        nonlocal params, opt_state
        if saver:
            saver.wait()  # a save in flight completes first
        if world > 1:
            dist.barrier()
        if args.ckpt_dir and store.latest_step(args.ckpt_dir) is not None:
            (params, opt_state), meta = store.restore(args.ckpt_dir, (params, opt_state),
                                                      shardings=specs)
            step = int(meta.get("step", 0))
            if rank == 0:
                print(f"[train] restored step {step} from {args.ckpt_dir}", flush=True)
            return step
        return 0

    supervisor = RestartSupervisor(max_restarts=2)
    supervisor.run(loop, restore_fn)
    if args.ckpt_dir and saved[-1:] != [args.steps]:  # the last step's save holds it already
        save(args.steps)
    if saver:
        saver.wait()
    return {"final_loss": losses[-1] if losses else float("nan"), "losses": losses,
            "grad_norms": norms, "params": params, "opt_state": opt_state,
            "restarts": supervisor.restarts, "step_s": step_s}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=C.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--compression", default=None, choices=[None, "int8", "topk"])
    ap.add_argument("--mesh", default="host", choices=["host", "pod", "multipod"],
                    help="'host': 1 x the ranks there are (mesh-free alone, 1 x WORLD_SIZE "
                         "under torchrun); 'pod' / 'multipod': 16x16 / 2x16x16 under torchrun")
    ap.add_argument("--share-card", action="store_true",
                    help="under torchrun, let more ranks than cards share them (over gloo)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' trains on the CPU)")
    return ap


def _join_torchrun(args) -> bool:
    """Join ``torchrun``'s group when this process is one of its ranks and
    there is more than one (``launch.mesh.join_torchrun``), after refusing
    a ``--mesh`` the world does not fit.  Returns whether it joined."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world == 1 or dist.is_initialized():
        return False
    M.train_mesh_sizes(args.mesh, world)
    M.join_torchrun(resolve_device(args.device).type, args.share_card)
    return True


def main(argv=None):
    args = build_parser().parse_args(argv)
    joined = _join_torchrun(args)
    try:
        out = run(args)
        if not joined or dist.get_rank() == 0:
            print(f"[train] done; final loss {out['final_loss']:.4f}")
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
