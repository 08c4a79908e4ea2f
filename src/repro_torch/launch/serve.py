"""Serving CLI (port of ``repro/launch/serve.py``, closed-loop only).

    python -m repro_torch.launch.serve --arch tinyllama-1.1b --requests 8 \
        --max-new 16 --compress quant_sparse --q-prune 0.5 --block 128 \
        --kv-dtype int8 --page-size 16 --share-prefix --plan-cache /tmp/plan

Runs on the CUDA device (``--device cpu`` runs the plain versions on the
CPU).  Takes the reference's flags; those the port does not serve yet exit
with an error naming their ROADMAP item.  ``--plan-cache DIR`` stores the
packed tree (``weight_plan.save_plan``) so that later boots skip packing;
it also reads a directory the reference's CLI wrote.  Reports the
machine-balance n_opt
from the H100 data-sheet constants, the plan summary, and throughput next
to the device's name.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.core.batching import UNBOUNDED_NOPT, BatchSizer, mean_decode_context
from repro_torch.core.perf_model import HARDWARE_LABEL, paged_pool_pages
from repro_torch.core.weight_plan import PlanConfig, compress, load_plan, save_plan
from repro_torch.device import resolve_device
from repro_torch.models.api import get_api, kv_bytes_per_token, supports_paged_kv
from repro_torch.serving.config import config_from_args
from repro_torch.serving.engine import Request, ServingEngine

# flag -> (is it set?, the ROADMAP item that ports it)
_UNSERVED_FLAGS = {
    "--autotune-plan": (lambda a: a.autotune_plan is not None, "A12 (autotuner)"),
    "--mesh": (lambda a: a.mesh != "none", "A13 (sharding)"),
    "--draft-config": (lambda a: a.draft_config is not None, "A7 (speculative decode)"),
    "--spec-k": (lambda a: a.spec_k != 0, "A7 (speculative decode)"),
    "--prefill-chunk": (lambda a: a.prefill_chunk != 0, "A7 (chunked prefill)"),
    "--prefill-budget": (lambda a: a.prefill_budget != 0, "A7 (chunked prefill)"),
    "--arrival-rate": (lambda a: a.arrival_rate != 0, "A7 (open-loop load generator)"),
    "--trace": (lambda a: a.trace is not None, "A7 (open-loop load generator)"),
    "--workload-mix": (lambda a: a.workload_mix is not None, "A10 (mixed serving)"),
    "--request-timeout": (lambda a: a.request_timeout != 0, "A7 (deadlines)"),
    "--ttft-deadline": (lambda a: a.ttft_deadline != 0, "A7 (deadlines)"),
    "--evict-policy": (lambda a: a.evict_policy != "fifo", "A7 (eviction)"),
}


def _fmt_nopt(n: int) -> str:
    return "inf (memory-bound at any batch)" if n >= UNBOUNDED_NOPT else str(n)


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _build_plan(params, pc: PlanConfig, cache_dir):
    """Compress (or restore) the serving plan.  With a cache directory: a
    hit when the stored plan's payload config equals ``pc`` (``use_kernel``
    is the run's, whatever the file says); stale when it differs, and
    incompatible when the directory was saved for another arch or shape:
    both re-pack and overwrite; missing: pack and save."""
    if cache_dir:
        try:
            t0 = time.perf_counter()
            plan = load_plan(cache_dir, params, use_kernel=pc.use_kernel)
            if plan.cfg == pc:
                print(f"[serve] plan cache hit: {cache_dir} (loaded in "
                      f"{time.perf_counter() - t0:.2f}s)")
                return plan
            print("[serve] plan cache stale (config changed); re-packing")
        except FileNotFoundError:
            print(f"[serve] plan cache missing: {cache_dir}; packing")
        except ValueError as e:
            # saved for a different arch/shape: re-pack rather than abort
            print(f"[serve] plan cache incompatible ({e}); re-packing")
    t0 = time.perf_counter()
    plan = compress(params, pc)
    print(f"[serve] packed weights in {time.perf_counter() - t0:.2f}s")
    if cache_dir:
        t0 = time.perf_counter()
        save_plan(cache_dir, plan)
        print(f"[serve] plan cached to {cache_dir} in {time.perf_counter() - t0:.2f}s")
    return plan


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=C.ARCH_IDS)
    ap.add_argument("--workload-mix", default=None, metavar="SPEC")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compress", default="none",
                    choices=("none", "quant", "block_sparse", "quant_sparse"),
                    help="weight representation for the serving plan")
    ap.add_argument("--q-prune", type=float, default=0.0,
                    help="block-pruned fraction for the sparse representations")
    ap.add_argument("--block", type=int, default=128, help="sparse block edge (bk=bn)")
    ap.add_argument("--kv-dtype", default="fp", choices=("fp", "int8"),
                    help="KV cache dtype (int8 = quantized cache)")
    ap.add_argument("--page-size", type=int, default=0, metavar="N",
                    help="serve with the paged KV cache of N-token pages (0 = contiguous)")
    ap.add_argument("--pool-pages", type=int, default=0, metavar="P",
                    help="paged pool capacity in pages (0 = size for the workload)")
    ap.add_argument("--share-prefix", action="store_true",
                    help="paged mode: map common prompt prefixes copy-on-write")
    ap.add_argument("--plan-cache", default=None, metavar="DIR")
    ap.add_argument("--autotune-plan", default=None, metavar="PATH")
    ap.add_argument("--mesh", default="none", metavar="SPEC")
    ap.add_argument("--draft-config", default=None, metavar="ARCH")
    ap.add_argument("--spec-k", type=int, default=0, metavar="K")
    ap.add_argument("--request-timeout", type=float, default=0.0, metavar="S")
    ap.add_argument("--ttft-deadline", type=float, default=0.0, metavar="S")
    ap.add_argument("--max-retries", type=int, default=1, metavar="N",
                    help="bounded retries per request on non-finite logits")
    ap.add_argument("--evict-policy", default="fifo", choices=("fifo", "priority"))
    ap.add_argument("--prefill-chunk", type=int, default=0, metavar="C")
    ap.add_argument("--prefill-budget", type=int, default=0, metavar="T")
    ap.add_argument("--arrival-rate", type=float, default=0.0, metavar="R")
    ap.add_argument("--trace", default=None, metavar="PATH")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the "
                         "kernels' plain versions on the CPU)")
    return ap


def build_engine(args, ap=None):
    """Model, plan and engine for parsed ``args``; prints the sizing lines.
    Returns (cfg, engine, plan)."""
    ap = ap or build_parser()
    for flag, (is_set, item) in _UNSERVED_FLAGS.items():
        if is_set(args):
            ap.error(f"{flag} is not served by the port yet: ROADMAP {item}")
    if not args.arch:
        ap.error("--arch is required")
    device = resolve_device(args.device)
    cfg = C.get_config(args.arch, smoke=args.smoke)
    api = get_api(cfg)
    n_params = api.n_params_exact(cfg)
    kv_dtype = "int8" if args.kv_dtype == "int8" else None
    paged = args.page_size > 0 and supports_paged_kv(cfg)
    ctx = mean_decode_context(args.prompt_len, args.max_new) if paged else args.max_len
    kv_tok = kv_bytes_per_token(cfg, kv_dtype)
    sizer = BatchSizer(n_params=n_params, kv_bytes_per_token=kv_tok, context_len=ctx)
    print(f"[serve] {cfg.name}: n_params={n_params:,} machine-balance "
          f"n_opt={_fmt_nopt(sizer.n_opt)} ({HARDWARE_LABEL}, kv={kv_tok:.0f} B/tok "
          f"@ ctx {ctx})")
    params = api.init_params(cfg, args.seed, device=device)
    plan = None
    if args.compress != "none":
        plan = _build_plan(params, PlanConfig(default=args.compress, q_prune=args.q_prune,
                                              bk=args.block, bn=args.block), args.plan_cache)
        params = plan.params
    if paged and not args.pool_pages:
        # size the pool for the workload: max_batch sequences at their
        # allocated context (prompt + max_new), plus the null page
        args.pool_pages = 1 + paged_pool_pages(
            args.max_batch, args.prompt_len + args.max_new, args.page_size)
    engine = ServingEngine(cfg, params, plan=plan, device=device, config=config_from_args(
        args, expected_context=ctx if paged else None))
    if engine.paged:
        print(f"[serve] paged KV cache: {engine.num_pages} pages x {engine.page_size} tok "
              f"(pool {engine.num_pages * engine.page_size} tok vs contiguous reservation "
              f"{engine.max_batch * args.max_len} tok), prefix sharing "
              f"{'on' if args.share_prefix else 'off'}")
    if plan is not None:
        print(f"[serve] {plan.summary(kv_bytes_per_token=kv_tok, context_len=args.max_len, batch=engine.max_batch)}")
        n_corr = plan.sizer(n_params=n_params, kv_bytes_per_token=kv_tok,
                            context_len=args.max_len).n_opt
        print(f"[serve] plan-corrected n_opt={_fmt_nopt(n_corr)} ({HARDWARE_LABEL})")
    return cfg, engine, plan


def run_requests(engine, reqs) -> float:
    """Submit ``reqs``, serve them to completion; returns wall seconds."""
    for r in reqs:
        engine.submit(r)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    t0 = time.perf_counter()
    engine.run_until_done()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return time.perf_counter() - t0


def report(engine, dt: float) -> None:
    stats = engine.stats
    print(f"[serve] completed {stats.completed} requests in {dt:.2f}s; "
          f"decode steps {stats.decode_steps}, tokens {stats.decode_tokens}, "
          f"mean batch {stats.mean_batch:.2f} "
          f"({stats.decode_tokens / max(dt, 1e-9):.1f} tok/s on {device_name(engine.device)})")
    if engine.paged:
        print(f"[serve] paged: mean admitted context {stats.mean_context:.1f} tok, "
              f"{stats.pages_shared} prefix pages shared, {stats.cow_copies} "
              f"copy-on-write copies")
    if stats.failed or stats.retried:
        print(f"[serve] failure model: {stats.failed} failed, {stats.retried} retries")


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    cfg, engine, _ = build_engine(args, ap)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=uid,
                    prompt=rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new)
            for uid in range(args.requests)]
    dt = run_requests(engine, reqs)
    report(engine, dt)
    return engine


if __name__ == "__main__":
    main()
