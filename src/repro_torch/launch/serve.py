"""Serving CLI (port of ``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch tinyllama-1.1b --requests 8 \
        --max-new 16 --compress quant_sparse --q-prune 0.5 --block 128 \
        --kv-dtype int8 --page-size 16 --share-prefix --plan-cache /tmp/plan

Runs on the CUDA device (``--device cpu`` runs the plain versions on the
CPU).  Takes the reference's flags.
``--mesh DxM`` serves sharded over D data replicas of M tensor-parallel
ranks (``--mesh host``: 1 x every visible card, 1 x 1 on the CPU): the
command starts D*M ranks itself (or runs as one rank of ``torchrun``), each
holds its shards of the plan and the caches (``serving/engine.py``), and
rank 0 prints the reference's lines plus the ``[serve] mesh`` line.  Ranks
meet over NCCL when each owns a card, over gloo on the CPU (one torch
thread each) or, with ``--share-card``, when more ranks than cards share
them; without it more ranks than cards is refused, as the reference
refuses more ranks than devices.  A mesh serves every arch: the dense
decoder families, the MoE family (each rank holds its share of the
experts, or under ``rules_for``'s "expert_ff" rule its share of every
expert's FFN width), recurrentgemma-2b (the RG-LRU's channels split),
xlstm-350m (the mLSTM's heads split, the sLSTM whole on every rank),
whisper-tiny (the encoder and both attentions on the rank's heads, its
frame pages on its KV heads) and internvl2-2b (the projector replicated),
with speculative decode (``--draft-config``/``--spec-k``), chunked prefill
(``--prefill-chunk``) and ``--workload-mix`` too (every rank runs the
mixed engine over its members' shards; the shared allocator stays on the
host); it refuses nothing.
``--autotune-plan PATH`` serves a TunedPlan artifact (``core/autotune``,
written by ``python -m repro_torch.launch.autotune`` or the reference's
tool): its plan replaces ``--compress`` (refused beside it), its serving
knobs (KV dtype, page size, pool, max batch, max length) override the
flags, and the plan summary lists every leaf's kind.  ``--plan-cache DIR``
stores the packed tree
(``weight_plan.save_plan``) so that later boots skip packing; it also reads
a directory the reference's CLI wrote.  ``--draft-config ARCH --spec-k K``
serves speculative decode (a dense draft from ``--seed`` + 1 proposes K
tokens a tick, verified in one (B, K+1) target step); ``--prefill-chunk C
--prefill-budget T`` chunked prefill; ``--arrival-rate R`` or ``--trace
PATH`` an open-loop run on simulated time (one tick = one time unit), with
TTFT and latency percentiles; ``--request-timeout``, ``--ttft-deadline``,
``--max-retries`` and ``--evict-policy`` the failure model.  Reports the
machine-balance n_opt from the H100 data-sheet constants, the plan summary,
and throughput next to the device's name.

``--arch whisper-tiny`` and ``--arch internvl2-2b`` draw each request's
frames or patches after its prompt from the ``--seed`` stream, as the
reference's CLI does.  The default pool holds each request's decoder
pages, a VLM's patch positions included, but not an enc-dec's frame pages,
as in the reference: at full width whisper-tiny needs ``--pool-pages``
(1 + max_batch x (decoder pages + 94 frame pages)).  ``--arch
recurrentgemma-2b`` and ``--arch xlstm-350m`` have no global attention
layer to page: with ``--page-size`` they serve on the contiguous cache, as
the reference does (the engine warns), and xlstm-350m, which has no KV at
all, serves ``--kv-dtype int8`` in the compute dtype.

``--workload-mix ARCH:W,ARCH:W,...`` (instead of ``--arch``) serves the
families through one ``MixedServingEngine``: one tick runs each family's
own step, the paged families draw from one shared page pool, and
``--requests`` splits by weight.  It is closed-loop and uncompressed, as in
the reference: ``--arch``, ``--autotune-plan``, ``--compress``,
``--draft-config``, ``--trace`` and ``--arrival-rate`` are refused, and an
enc-dec member serves an fp cache under ``--kv-dtype int8`` while the
others serve int8.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.configs as C
from repro_torch.core import autotune as AT
from repro_torch.core.batching import UNBOUNDED_NOPT, BatchSizer, mean_decode_context
from repro_torch.core.perf_model import HARDWARE_LABEL, paged_pool_pages
from repro_torch.core.weight_plan import PlanConfig, load_plan, map_tree, save_plan
from repro_torch.device import resolve_device
from repro_torch.distributed import shardlib as sl
from repro_torch.launch import mesh as M
from repro_torch.models.api import (
    get_api,
    kv_bytes_per_token,
    supports_int8_kv,
    supports_paged_kv,
)
from repro_torch.serving.config import config_from_args
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.faultinject import TickClock
from repro_torch.serving.loadgen import (
    LengthMixture,
    load_trace,
    make_requests,
    poisson_trace,
    run_open_loop,
)
from repro_torch.serving.mixed import MixedServingEngine, WorkloadSpec

def _fmt_nopt(n: int) -> str:
    return "inf (memory-bound at any batch)" if n >= UNBOUNDED_NOPT else str(n)


def _open_loop_mixture(p: int, n: int, cap: int) -> LengthMixture:
    """Chat-style mixture anchored at the CLI lengths: 70% of arrivals at
    the --prompt-len scale, 25% up to 2x, 5% at ~4x (the long-prefill tail
    continuous batching exists for), every component clamped so that
    prompt + max_new fits the engine's admission bound ``cap``."""
    n_rng = (max(1, n // 2), max(1, n))

    def pr(a, b):
        hi = max(1, cap - n_rng[1])
        a = max(1, min(a, hi))
        return (a, max(a, min(b, hi)))

    return LengthMixture((
        (0.70, pr(max(1, p // 2), p), n_rng),
        (0.25, pr(p, 2 * p), n_rng),
        (0.05, pr(4 * p, 4 * p), n_rng),
    ))


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _build_plan(cfg, params, pc: PlanConfig, cache_dir):
    """Compress (or restore) the serving plan, with the family's param axes
    recorded (``api.compress``).  With a cache directory: a hit when the
    stored plan's payload config equals ``pc`` (``use_kernel`` is the run's,
    whatever the file says); stale when it differs, and incompatible when
    the directory was saved for another arch or shape: both re-pack and
    overwrite; missing: pack and save.  Among several ranks, rank 0 does
    that first and the others then load its directory."""
    if cache_dir and dist.is_initialized() and dist.get_world_size() > 1:
        plan = None
        if dist.get_rank() == 0:
            plan = _build_plan_once(cfg, params, pc, cache_dir)
        dist.barrier()
        return plan or _build_plan_once(cfg, params, pc, cache_dir)
    return _build_plan_once(cfg, params, pc, cache_dir)


def _build_plan_once(cfg, params, pc: PlanConfig, cache_dir):
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
    plan = get_api(cfg).compress(cfg, params, pc)
    print(f"[serve] packed weights in {time.perf_counter() - t0:.2f}s")
    if cache_dir:
        t0 = time.perf_counter()
        save_plan(cache_dir, plan)
        print(f"[serve] plan cached to {cache_dir} in {time.perf_counter() - t0:.2f}s")
    return plan


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=C.ARCH_IDS)
    ap.add_argument("--workload-mix", default=None, metavar="SPEC",
                    help="heterogeneous serving: 'arch:weight,...' through one mixed "
                         "engine with one shared page pool (closed-loop, replaces --arch)")
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
    ap.add_argument("--mesh", default="none", metavar="SPEC",
                    help="sharded serving: 'none', 'host' (1 x every card) or 'DxM' "
                         "(D data replicas of M tensor-parallel ranks); serves every arch "
                         "and --workload-mix, plain, speculative or chunked")
    ap.add_argument("--share-card", action="store_true",
                    help="let more --mesh ranks than cards share them (over gloo)")
    ap.add_argument("--draft-config", default=None, choices=C.ARCH_IDS, metavar="ARCH",
                    help="speculative decode: the draft model proposing --spec-k tokens "
                         "a tick (same vocab as --arch)")
    ap.add_argument("--spec-k", type=int, default=0, metavar="K",
                    help="draft tokens proposed and verified a tick (0 = plain decode)")
    ap.add_argument("--request-timeout", type=float, default=0.0, metavar="S",
                    help="total-latency deadline per request (0 = none)")
    ap.add_argument("--ttft-deadline", type=float, default=0.0, metavar="S",
                    help="queue-to-first-token deadline (0 = none)")
    ap.add_argument("--max-retries", type=int, default=1, metavar="N",
                    help="bounded retries per request on transient faults")
    ap.add_argument("--evict-policy", default="fifo", choices=("fifo", "priority"),
                    help="admission under pressure: queue (fifo) or preempt the "
                         "lowest-priority slot (priority)")
    ap.add_argument("--prefill-chunk", type=int, default=0, metavar="C",
                    help="prefill prompts in C-token chunks between decode ticks "
                         "(0 = synchronous prefill at admission)")
    ap.add_argument("--prefill-budget", type=int, default=0, metavar="T",
                    help="prompt tokens advanced a tick across chunked prefills "
                         "(0 = one chunk)")
    ap.add_argument("--arrival-rate", type=float, default=0.0, metavar="R",
                    help="open-loop load: seeded Poisson arrivals at R requests a tick")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="open-loop load: replay a JSONL arrival trace (wins over "
                         "--arrival-rate)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the "
                         "kernels' plain versions on the CPU)")
    return ap


def _device_type(args) -> str:
    return resolve_device(args.device).type


def serving_mesh(args):
    """The run's (data, model) mesh over its ranks, None without ``--mesh``."""
    shape = M.parse_mesh(args.mesh, _device_type(args))
    if shape is None:
        return None
    backend = (dist.get_backend() if dist.is_initialized()
               else M.choose_backend(1, _device_type(args)))
    return M.make_serving_mesh(shape, backend)


def build_mesh(args, ap, cfg):
    """The run's mesh, its rules and (data, model, kv) degrees; prints the
    reference's ``[serve] mesh`` line.  (None, None, (1, 1, 1)) without one."""
    mesh = serving_mesh(args)
    if mesh is None:
        return None, None, (1, 1, 1)
    rules = M.rules_for(cfg, None, mesh=mesh)
    degrees = sl.parallelism_degrees(mesh, rules, int(getattr(cfg, "n_kv_heads", 0) or 0))
    print(f"[serve] mesh {sl.axis_sizes(mesh)}: data-parallel {degrees[0]}, model-parallel "
          f"{degrees[1]}, kv shard degree {degrees[2]}")
    return mesh, rules, degrees


# EngineConfig flat name -> the serve flag it overrides, and the flag's
# value where a TunedPlan leaves the knob out (AT.engine_kwargs)
_TUNED_FLAGS = {"kv_dtype": ("kv_dtype", "fp"), "page_size": ("page_size", 0),
                "num_pages": ("pool_pages", 0), "max_batch": ("max_batch", None),
                "max_len": ("max_len", None)}


def load_autotune_plan(args, ap, cfg) -> tuple:
    """The ``--autotune-plan`` artifact and its ``AT.engine_kwargs``, the one
    mapping of its serving knobs: they overwrite the flags in ``args`` and
    the sizer's expected context comes from them.  Flags they do not cover
    stay as given: speculative decode needs ``--draft-config``, so the
    artifact's spec_k is dropped, as ``AT.engine_config`` drops it without a
    draft.  Refused beside ``--compress`` and for another arch, as the
    reference's CLI refuses them."""
    if args.compress != "none":
        ap.error("--autotune-plan carries its own plan; drop --compress")
    tuned = AT.load_tuned(args.autotune_plan)
    if tuned["arch"] != cfg.name:
        ap.error(f"--autotune-plan was searched for {tuned['arch']!r}, "
                 f"this run serves {cfg.name!r}")
    kw = AT.engine_kwargs(tuned)
    for name, (flag, unset) in _TUNED_FLAGS.items():
        setattr(args, flag, kw.get(name, unset))
    pr = tuned.get("predicted", {})
    print(f"[serve] autotune plan {args.autotune_plan}: "
          f"strategy={tuned['strategy']} trials={tuned['trials']} "
          f"seed={tuned['seed']}; predicted "
          f"{pr.get('tokens_per_s') or 0:.0f} tok/s "
          f"({pr.get('speedup') or 1:.2f}x uniform), accuracy budget "
          f"{tuned['accuracy']['budget']:.1%} at max "
          f"q={tuned['accuracy']['max_q']:.2f}")
    return tuned, kw


def build_engine(args, ap=None):
    """Model, plan and engine for parsed ``args``; prints the sizing lines.
    Returns (cfg, engine, plan)."""
    ap = ap or build_parser()
    if not args.arch:
        ap.error("one of --arch / --workload-mix is required")
    device = resolve_device(args.device)
    cfg = C.get_config(args.arch, smoke=args.smoke)
    mesh, rules, (data_parallel, model_parallel, kv_parallel) = build_mesh(args, ap, cfg)
    tuned, tuned_kw = load_autotune_plan(args, ap, cfg) if args.autotune_plan else (None, {})
    api = get_api(cfg)
    n_params = api.n_params_exact(cfg)
    kv_dtype = "int8" if args.kv_dtype == "int8" and supports_int8_kv(cfg) else None
    paged = args.page_size > 0 and supports_paged_kv(cfg)
    # a VLM's sequence starts with its patches: they take positions and pages
    prefix = api.prefix_len(cfg)
    ctx = mean_decode_context(args.prompt_len + prefix, args.max_new) if paged else args.max_len
    ctx = tuned_kw.get("expected_context", ctx)
    kv_tok = kv_bytes_per_token(cfg, kv_dtype, context_len=ctx)
    sizer = BatchSizer(n_params=n_params, kv_bytes_per_token=kv_tok, context_len=ctx,
                       model_parallel=model_parallel, kv_parallel=kv_parallel,
                       spec_k=max(0, args.spec_k))
    print(f"[serve] {cfg.name}: n_params={n_params:,} machine-balance "
          f"n_opt={_fmt_nopt(sizer.n_opt)}"
          + (" per model group" if mesh is not None else "")
          + (f" (x{data_parallel} data replicas for the global batch)"
             if data_parallel > 1 else "")
          + f" ({HARDWARE_LABEL}, kv={kv_tok:.0f} B/tok @ ctx {ctx})")
    spec_k = args.spec_k
    draft_cfg = draft_params = None
    if args.draft_config and spec_k <= 0:
        ap.error("--draft-config needs --spec-k > 0 (it would otherwise be silently ignored)")
    if spec_k > 0:
        if not args.draft_config:
            ap.error("--spec-k needs --draft-config")
        draft_cfg = C.get_config(args.draft_config, smoke=args.smoke)
        if draft_cfg.vocab != cfg.vocab:
            ap.error(f"--draft-config vocab {draft_cfg.vocab} != target vocab {cfg.vocab}")
        # a dense copy in the draft's compute dtype (norm scales stay fp32),
        # cast once instead of in every draft matmul
        dtype = getattr(torch, draft_cfg.compute_dtype)
        draft_params = map_tree(
            lambda _, t: t.to(dtype) if t.dim() >= 2 else t,
            get_api(draft_cfg).init_params(draft_cfg, args.seed + 1, device=device))
        print(f"[serve] speculative decode: {draft_cfg.name} drafts {spec_k} tokens/tick, "
              f"verified in one (B, {spec_k + 1}) target step")
    params = api.init_params(cfg, args.seed, device=device)
    plan = None
    if tuned is not None:
        plan = _build_plan(cfg, params, AT.plan_config(tuned), args.plan_cache)
        params = plan.params
    elif args.compress != "none":
        plan = _build_plan(cfg, params, PlanConfig(default=args.compress, q_prune=args.q_prune,
                                                   bk=args.block, bn=args.block),
                           args.plan_cache)
        params = plan.params
    if paged and not args.pool_pages:
        # size the pool for the workload: max_batch sequences at their
        # allocated context (prefix + prompt + max_new), plus the null page.
        # As in the reference, an enc-dec request's frame pages are not
        # counted: at full width such a pool admits nothing (pass
        # --pool-pages)
        args.pool_pages = 1 + paged_pool_pages(
            args.max_batch, args.prompt_len + prefix + args.max_new, args.page_size)
    if paged and model_parallel > 1 and kv_parallel != model_parallel:
        # the pools' KV heads cannot split this model axis: every rank holds
        # (and streams) the whole pool, whatever a per-rank budget assumed
        warnings.warn(
            f"{cfg.name}: paged pools do not shard across the {model_parallel}-way model "
            f"axis (n_kv_heads={cfg.n_kv_heads} -> kv shard degree {kv_parallel}); per-shard "
            f"pool bytes equal the global pool -- budget --pool-pages accordingly",
            stacklevel=1)
    open_loop = bool(args.trace) or args.arrival_rate > 0
    engine = ServingEngine(cfg, params, plan=plan, device=device, config=config_from_args(
        args, expected_context=ctx if paged else None,
        # open-loop time is simulated: one tick is one unit of the arrival
        # schedule, so deadlines, TTFT and latency are seed-reproducible
        clock=TickClock() if open_loop else None,
        draft_cfg=draft_cfg, draft_params=draft_params, mesh=mesh, rules=rules))
    if engine.prefill_chunk is not None:
        print(f"[serve] continuous batching: {engine.prefill_chunk}-token prefill chunks, "
              f"{engine.prefill_budget} tok/tick budget")
    if engine.paged:
        print(f"[serve] paged KV cache: {engine.num_pages} pages x {engine.page_size} tok "
              f"(pool {engine.num_pages * engine.page_size} tok vs contiguous reservation "
              f"{engine.max_batch * args.max_len} tok"
              + (f"; {engine.kv_parallel}-way kv shard -> 1/{engine.kv_parallel} of each "
                 f"page's bytes per rank" if engine.kv_parallel > 1 else "")
              + f"), prefix sharing {'on' if engine.registry is not None else 'off'}")
    if plan is not None:
        # a tuned plan lists every leaf's kind and q_prune (what the search
        # picked, also when the plan came from a cache)
        summary = plan.summary(kv_bytes_per_token=kv_tok, context_len=args.max_len,
                               batch=engine.max_batch, per_leaf=tuned is not None)
        print(f"[serve] {summary}")
        n_corr = plan.sizer(n_params=n_params, kv_bytes_per_token=kv_tok,
                            context_len=args.max_len, model_parallel=model_parallel,
                            kv_parallel=kv_parallel).n_opt
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


def open_loop_arrivals(args, engine) -> list:
    """The run's arrivals: ``--trace``, else seeded Poisson arrivals at
    ``--arrival-rate`` over the chat-style mixture (clamped so that prefix +
    prompt + max_new + spec_k fits ``--max-len``)."""
    if args.trace:
        arrivals = load_trace(args.trace)
        print(f"[serve] replaying {len(arrivals)} arrivals from {args.trace}")
        return arrivals
    cap = args.max_len - engine.api.prefix_len(engine.cfg) - engine.spec_k
    mix = _open_loop_mixture(args.prompt_len, args.max_new, cap)
    arrivals = poisson_trace(args.arrival_rate, args.requests, mix, seed=args.seed)
    print(f"[serve] poisson arrivals: {args.arrival_rate}/tick, n={len(arrivals)}, "
          f"seed={args.seed}")
    return arrivals


def run_open_loop_timed(engine, arrivals, reqs, seed: int = 0):
    """``loadgen.run_open_loop`` between two device syncs; returns (report,
    wall seconds)."""
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    t0 = time.perf_counter()
    rep = run_open_loop(engine, arrivals, reqs, seed=seed)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return rep, time.perf_counter() - t0


def report(engine, dt: float, load=None) -> None:
    """The run's report lines; ``load`` is an open-loop run's LoadReport."""
    stats = engine.stats
    card = device_name(engine.device)
    if load is None:
        print(f"[serve] completed {stats.completed} requests in {dt:.2f}s; "
              f"decode steps {stats.decode_steps}, tokens {stats.decode_tokens}, "
              f"mean batch {stats.mean_batch:.2f} "
              f"({stats.decode_tokens / max(dt, 1e-9):.1f} tok/s on {card})")
    else:
        s = load.summary()
        print(f"[serve] open-loop: {s['completed']}/{s['n_requests']} completed in "
              f"{s['ticks']} ticks ({dt:.2f}s wall on {card}); p50/p99 TTFT "
              f"{s['p50_ttft_s']:.1f}/{s['p99_ttft_s']:.1f} ticks, p50/p99 latency "
              f"{s['p50_latency_s']:.1f}/{s['p99_latency_s']:.1f} ticks, "
              f"{s['tokens_per_s']:.2f} committed tok/tick (sizer n_opt "
              f"{_fmt_nopt(engine.sizer.n_opt)}), mean batch {s['mean_batch']:.2f}, "
              f"leaked pages {s['leaked_pages']}")
    if engine.paged:
        print(f"[serve] paged: mean admitted context {stats.mean_context:.1f} tok, "
              f"{stats.pages_shared} prefix pages shared, {stats.cow_copies} "
              f"copy-on-write copies")
    if engine.spec_k:
        print(f"[serve] speculative: {stats.verified_positions} verified positions -> "
              f"{stats.decode_tokens} committed tokens "
              f"({stats.decode_tokens / max(1, stats.verified_positions):.2f} "
              f"committed/verified), draft accept rate {stats.accept_rate:.2f}, "
              f"{stats.mean_batch:.2f} committed tokens/tick")
    # failure-model outcomes: anything nonzero means the engine served
    # through faults or pressure rather than at steady state
    if (stats.failed or stats.evicted or stats.timed_out or stats.retried
            or stats.fallback_ticks or engine.degraded):
        print(f"[serve] failure model: {stats.failed} failed, {stats.timed_out} timed out, "
              f"{stats.evicted} evictions, {stats.retried} retries, "
              f"{stats.fallback_ticks} degraded ticks"
              + (f"; degraded: {engine.degraded}" if engine.degraded else ""))


def request_extras(cfg, rng):
    """One request's frontend-stub inputs, drawn from ``rng`` as the
    reference's CLI draws them: a VLM's patches (n_patches, d), an
    enc-dec's frames (n_frames, d), float32 normals; None for the other
    families."""
    keys = get_api(cfg).extra_keys
    extras = {}
    if "patches" in keys:
        extras["patches"] = rng.normal(size=(cfg.n_patches, cfg.d_model)).astype(np.float32)
    if "frames" in keys:
        extras["frames"] = rng.normal(size=(cfg.n_frames, cfg.d_model)).astype(np.float32)
    return extras or None


def parse_mix(spec: str, ap) -> list:
    """'arch:weight,arch:weight' -> [(arch, weight)] (weight 1 when left out)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        arch, _, w = part.partition(":")
        if arch not in C.ARCH_IDS:
            ap.error(f"--workload-mix: unknown arch {arch!r} (choose from "
                     f"{', '.join(C.ARCH_IDS)})")
        try:
            weight = float(w) if w else 1.0
        except ValueError:
            ap.error(f"--workload-mix: bad weight {w!r} for {arch}")
        out.append((arch, weight))
    if not out:
        ap.error("--workload-mix: empty spec")
    return out


# flags a mixed run refuses, as the reference's CLI does: it is closed-loop
# and uncompressed, and one --arch does not apply
_MIX_REFUSED = (
    ("--arch", lambda a: not a.arch),
    ("--autotune-plan", lambda a: not a.autotune_plan),
    ("--compress", lambda a: a.compress == "none"),
    ("--draft-config", lambda a: not a.draft_config),
    ("--trace", lambda a: not a.trace),
    ("--arrival-rate", lambda a: a.arrival_rate == 0),
)


def check_mix_flags(args, ap) -> None:
    """Exit 2 for a flag ``--workload-mix`` refuses, as the reference's CLI
    does (before any rank starts)."""
    for flag, ok in _MIX_REFUSED:
        if not ok(args):
            ap.error(f"--workload-mix is closed-loop heterogeneous serving; drop {flag}")


def build_mixed(args, ap):
    """The mixed engine for ``--workload-mix``: each family's params from
    ``--seed`` and its EngineConfig from the flags (the sizer charged the
    mean decode context of a paged family, ``--max-len`` of a contiguous
    one; an enc-dec member's int8 KV downgraded to fp).  Under ``--mesh``
    every member carries the mesh and its own ``rules_for``, as the
    reference's members do, and this rank holds each member's shards.
    Returns (the mix, {arch: (cfg, api)}, the engine)."""
    check_mix_flags(args, ap)
    mix = parse_mix(args.workload_mix, ap)
    device = resolve_device(args.device)
    mesh = serving_mesh(args)
    specs, apis = [], {}
    for arch, weight in mix:
        cfg = C.get_config(arch, smoke=args.smoke)
        api = get_api(cfg)
        params = api.init_params(cfg, args.seed, device=device)
        paged = args.page_size > 0 and supports_paged_kv(cfg)
        ctx = mean_decode_context(args.prompt_len + api.prefix_len(cfg), args.max_new)
        rules = M.rules_for(cfg, None, mesh=mesh) if mesh is not None else None
        ec = config_from_args(args, expected_context=ctx if paged else None, mesh=mesh,
                              rules=rules)
        if ec.cache.kv_dtype and not supports_int8_kv(cfg):
            # per family, not per run: whisper keeps an fp cache while the
            # text member of the same mix serves int8
            ec = dataclasses.replace(ec, cache=dataclasses.replace(ec.cache, kv_dtype=None))
        specs.append(WorkloadSpec(name=arch, cfg=cfg, params=params, config=ec, weight=weight))
        apis[arch] = (cfg, api)
    engine = MixedServingEngine(specs, num_pages=args.pool_pages or None, device=device)
    print("[serve] workload mix: " + ", ".join(f"{a}:{w:g}" for a, w in mix)
          + f" (one engine, {len(mix)} families' steps)")
    if mesh is not None:
        first = next(iter(engine.engines.values()))
        print(f"[serve] mesh {sl.axis_sizes(mesh)}: data-parallel {first.data_parallel}, "
              f"model-parallel {first.model_parallel}, kv shard degree "
              + ", ".join(f"{a} {e.kv_parallel}" for a, e in engine.engines.items()))
    if engine.allocator is not None:
        print(f"[serve] shared page pool: {engine.num_pages} pages x {args.page_size} tok "
              f"across {sum(e.paged for e in engine.engines.values())} paged families")
    return mix, apis, engine


def mixed_requests(args, mix, apis, engine) -> list:
    """(arch, Request) pairs: each family's share of ``--requests`` (at
    least 1), in mix order, each request's frames or patches drawn before
    its prompt from one ``--seed`` stream, as the reference's CLI draws
    them."""
    rng = np.random.default_rng(args.seed)
    out = []
    for arch, _ in mix:
        cfg, _api = apis[arch]
        for _ in range(max(1, round(args.requests * engine.sizer.share(arch)))):
            extras = request_extras(cfg, rng)
            prompt = rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32)
            out.append((arch, Request(uid=len(out), prompt=prompt,
                                      max_new_tokens=args.max_new, extras=extras)))
    return out


def main_mixed(args, ap):
    """Closed-loop heterogeneous serving; the page audit runs once the
    requests are done and raises on a leak in any family."""
    mix, apis, engine = build_mixed(args, ap)
    reqs = mixed_requests(args, mix, apis, engine)
    for arch, r in reqs:
        engine.submit(arch, r)
    sync = engine.device.type == "cuda"
    if sync:
        torch.cuda.synchronize(engine.device)
    t0 = time.perf_counter()
    stats = engine.run_until_done()
    if sync:
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    engine.audit_pages()
    for arch, s in stats.items():
        print(f"[serve]   {arch}: {s.completed} completed, {s.decode_tokens} tokens, mean "
              f"batch {s.mean_batch:.2f} (n_opt {_fmt_nopt(engine.sizer.n_opt[arch])})")
    agg = engine.aggregate_stats()
    print(f"[serve] mixed: {agg.completed}/{len(reqs)} requests in {dt:.2f}s; "
          f"{agg.decode_tokens} tokens ({agg.decode_tokens / max(dt, 1e-9):.1f} tok/s on "
          f"{device_name(engine.device)}), {engine.tick} ticks, page audit clean")
    return engine


@contextlib.contextmanager
def _stdout_off(off: bool):
    """Nothing printed to stdout inside, where ``off`` (a rank other than 0)."""
    if not off:
        yield
        return
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


def _rank_main(rank: int, argv, device_type: str) -> None:
    """One spawned rank of ``--mesh``: its own card (or the CPU, on one
    torch thread), ``main`` again; rank 0 alone prints."""
    if device_type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(M.rank_device(rank, device_type))
    with _stdout_off(rank != 0):
        main(argv)


def launch_ranks(argv, args, ap) -> bool:
    """Start the ranks of ``--mesh DxM`` (D*M > 1) unless this process is
    one already (spawned, or under torchrun).  Returns whether it did."""
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        return False
    device_type = _device_type(args)
    shape = M.parse_mesh(args.mesh, device_type)
    if shape is None or shape[0] * shape[1] == 1:
        return False
    world = shape[0] * shape[1]
    try:
        backend = M.choose_backend(world, device_type, args.share_card)
    except ValueError as e:
        ap.error(str(e))
    print(f"[serve] mesh {args.mesh}: starting {world} ranks over {backend} "
          + ("on the CPU" if device_type == "cpu" else
             f"on {min(world, torch.cuda.device_count())} card(s)"), flush=True)
    M.spawn_ranks(_rank_main, (list(sys.argv[1:] if argv is None else argv), device_type),
                  world, backend)
    return True


def _join_torchrun(args) -> bool:
    """Join ``torchrun``'s group when this process is one of its ranks and
    ``--mesh`` asks for more than one rank: its card, the backend chosen
    from the ranks on this host (LOCAL_WORLD_SIZE) and its cards.  Returns
    whether it joined."""
    if "WORLD_SIZE" not in os.environ:
        return False
    device_type = _device_type(args)
    shape = M.parse_mesh(args.mesh, device_type)
    if shape is None or shape[0] * shape[1] == 1:
        return False
    M.join_torchrun(device_type, args.share_card)
    return True


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.workload_mix:
        check_mix_flags(args, ap)
    if launch_ranks(argv, args, ap):
        return None
    own = not dist.is_initialized()  # a group this call joins, it leaves
    if own:
        _join_torchrun(args)
    try:
        with _stdout_off(own and dist.is_initialized() and dist.get_rank() != 0):
            return main_mixed(args, ap) if args.workload_mix else serve_args(args, ap)
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()


def serve_args(args, ap):
    """Build the engine for parsed ``args``, serve their requests (closed
    or open loop) and print the report; returns the engine."""
    cfg, engine, _ = build_engine(args, ap)
    rng = np.random.default_rng(args.seed)
    if bool(args.trace) or args.arrival_rate > 0:
        arrivals = open_loop_arrivals(args, engine)
        reqs = make_requests(arrivals, cfg.vocab, seed=args.seed)
        for r in reqs:
            r.extras = request_extras(cfg, rng)
        load, dt = run_open_loop_timed(engine, arrivals, reqs, seed=args.seed)
        report(engine, dt, load)
        return engine
    # each request's prompt, then its extras, from one stream: the
    # reference's order, so that both CLIs serve the same requests
    reqs = []
    for uid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32)
        reqs.append(Request(uid=uid, prompt=prompt, max_new_tokens=args.max_new,
                            extras=request_extras(cfg, rng)))
    dt = run_requests(engine, reqs)
    report(engine, dt)
    return engine


if __name__ == "__main__":
    main()
