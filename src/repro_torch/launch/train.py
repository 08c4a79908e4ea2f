"""Training launcher (port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke \
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Runs on the CUDA device (``--device cpu`` trains on the CPU; without a GPU
and without it, it raises).  It trains every arch of the registry: the
dense and MoE decoder-only transformers, recurrentgemma-2b and xlstm-350m,
the VLM (internvl2-2b) and the enc-dec (whisper-tiny); ``--mesh
pod|multipod`` is refused (meshed training is ROADMAP A13c).  Params come
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
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.checkpoint import store
from repro_torch.data import LMDataConfig, synthetic_lm_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import RestartSupervisor, StragglerDetector
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


def run(args, cfg=None) -> dict:
    """Train ``args.steps`` steps (from the latest checkpoint in
    ``args.ckpt_dir`` where there is one).  Returns {"final_loss",
    "losses", "params", "opt_state", "restarts", "step_s"}: the losses and
    wall times (host clock, each step ending in the loss's read) of the
    steps this call ran, and the supervisor's restart count."""
    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh} is not trained by the port yet: ROADMAP A13c (meshed training)")
    if cfg is None:
        cfg = C.get_config(args.arch, smoke=args.smoke)
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=True)
    api = get_api(cfg)
    device = resolve_device(args.device)
    # warmup scales with the run, so a short run does not stay in the ramp
    opt_cfg = O.OptimizerConfig(
        lr=args.lr,
        warmup_steps=min(20, max(1, args.steps // 4)),
        decay_steps=max(100, args.steps),
    )
    params = api.init_params(cfg, args.seed, device=device)
    opt_state = O.init_opt_state(opt_cfg, params, error_feedback=args.compression is not None)
    data_cfg = LMDataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                            seed=args.seed)
    step_fn = make_train_step(cfg, api.loss_fn, opt_cfg, accum_steps=args.accum,
                              compression=args.compression)
    saver = store.AsyncCheckpointer(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    straggler = StragglerDetector(n_hosts=1)
    losses, step_s = [], []

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
            step_s.append(dt)
            straggler.record(0, dt)
            if step % args.log_every == 0:
                print(
                    f"[train] step {step} loss {loss:.4f} "
                    f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.2f} "
                    f"({dt:.2f}s)",
                    flush=True,
                )
            if saver and step > 0 and step % args.ckpt_every == 0:
                saver.save(step + 1, (params, opt_state), {"step": step + 1, "arch": args.arch})
        return args.steps

    def restore_fn() -> int:
        nonlocal params, opt_state
        if saver:
            saver.wait()  # a save in flight completes first
        if args.ckpt_dir and store.latest_step(args.ckpt_dir) is not None:
            (params, opt_state), meta = store.restore(args.ckpt_dir, (params, opt_state))
            step = int(meta.get("step", 0))
            print(f"[train] restored step {step} from {args.ckpt_dir}", flush=True)
            return step
        return 0

    supervisor = RestartSupervisor(max_restarts=2)
    supervisor.run(loop, restore_fn)
    if saver:
        saver.save(args.steps, (params, opt_state), {"step": args.steps, "arch": args.arch})
        saver.wait()
    return {"final_loss": losses[-1] if losses else float("nan"), "losses": losses,
            "params": params, "opt_state": opt_state, "restarts": supervisor.restarts,
            "step_s": step_s}


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
    ap.add_argument("--mesh", default="host", choices=["host", "pod", "multipod"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' trains on the CPU)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = run(args)
    print(f"[train] done; final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
