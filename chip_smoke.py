#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # every phase, on one CUDA device
    python3 chip_smoke.py --profile  # then a torch.profiler decode step

Phases, in order; any failure raises and the script exits non-zero:

1. device   -- the card's name and power limit; TF32 off for matmul/cuDNN.
2. build    -- nvcc builds the three kernels from src/repro_torch/csrc.
3. kernels  -- each kernel against its plain PyTorch version on the card at
               full-width tinyllama-1.1b shapes and at the M the serve phase
               gives it (decode batch, and prompt length at prefill), with
               timings (CUDA events, median of single launches after an L2
               flush), the bound and a PyTorch library call as a yardstick.
4. serve    -- full-width tinyllama-1.1b (22 layers, d 2048, random weights
               from a seed) with the quickstart flags: quant_sparse
               q_prune 0.5, 128-blocks, paged int8 KV, prefix sharing.
               Every request must finish, the page audit must be clean,
               prefix pages must be shared, and every kernel's launch
               counter must rise during the run.
5. parity   -- prefill of the serve phase's prompt lengths, then
               teacher-forced decode, through the kernels and through the
               plain versions (use_kernel=False) on the same tokens; the
               logits must agree within the stated bf16 tolerance.
6. summary  -- one JSON line of per-kernel numbers, then the result line.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet (dense, 700 W): the bound of each kernel is the larger
# of bytes over the memory rate and operations over the bf16 tensor rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# Kernel vs plain version: both accumulate in fp32 and round to bf16 at
# the output, in a different order, so outputs differ by about one bf16 ulp
# (2^-8 relative).  Held to max |kernel - plain| <= KERNEL_RTOL * max |plain|.
KERNEL_RTOL = 1e-2
# Whole path: those one-ulp differences enter the residual stream of every
# layer and compound over 22 layers; held to max |dlogit| <= PATH_RTOL *
# max |logit| at every teacher-forced step.
PATH_RTOL = 5e-2

KERNEL_META = {
    "block_sparse_matmul": ("src/repro_torch/csrc/block_sparse.cu",
                            "src/repro/kernels/block_sparse.py:221"),
    "fused_gate_up": ("src/repro_torch/csrc/fused_gate_up.cu",
                      "src/repro/kernels/fused_gate_up.py:91"),
    "paged_decode_attention": ("src/repro_torch/csrc/paged_attention.cu",
                               "src/repro/kernels/flash_attention.py:273"),
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Median device time of single launches, each after an L2 flush (the
    main path streams its weights cold: 50 MB of L2 hold none of them).
    A spin kernel queued before the start event keeps the card busy while
    the host enqueues the call, so the events bracket device work only,
    not the wrapper's Python."""

    SPIN_CYCLES = 4_000_000  # about 2 ms at the H100's clocks

    def __init__(self, torch, reps: int = 25):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def rel_err(torch, got, want) -> tuple:
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return diff, diff / max(scale, 1e-30)


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi.splitlines()[0]


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    out = build.build()
    log(f"build: {time.perf_counter() - t0:.1f}s wall for {len(out)} kernels "
        + ", ".join(f"{k} {v['seconds']:.1f}s" for k, v in out.items()))
    for name, info in out.items():
        regs = sorted(set(re.findall(r"Used (\d+) registers", info["log"])), key=int)
        spill = max(map(int, re.findall(r"(\d+) bytes spill stores", info["log"])), default=0)
        log(f"ptxas {name}: registers per thread {', '.join(regs)}; "
            f"largest spill {spill} bytes")


def _packed(torch, K, N, gen):
    from repro_torch.core.weight_plan import PlanConfig, pack_block_sparse

    w = torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5
    return pack_block_sparse(w, PlanConfig(q_prune=0.5), quant=True)


def _dense_bf16(torch, p):
    """The dequantized dense weight of a packed leaf (library yardstick)."""
    from repro_torch.core.sparse_format import block_sparse_to_dense

    w = block_sparse_to_dense(p.to_block_sparse()) * p.scales[None, :]
    return w.to(torch.bfloat16)


def phase_kernels(torch, results: dict) -> None:
    from repro_torch.kernels import block_sparse as BS
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_gate_up as FG

    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    # B1 at every K x N of one tinyllama layer (wq, wk, wv, wo, w_down)
    # at M = 8 and 12 (decode batches: one M-tile, ragged) and M = 40 (the
    # serve phase's prefill: three M-tiles, the last ragged)
    shapes = {"wq": (2048, 2048), "wk": (2048, 256), "wv": (2048, 256),
              "wo": (2048, 2048), "w_down": (5632, 2048)}
    agg = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "err": 0.0,
           "rel": 0.0, "bytes": 0.0, "flops": 0.0}
    for name, (K, N) in shapes.items():
        p = _packed(torch, K, N, gen)
        wd = _dense_bf16(torch, p)
        args = (p.blocks, p.block_rows, p.counts, p.scales)
        for M in (8, 12, 40):
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            y = BS.block_sparse_matmul(x, *args)
            ref = BS.block_sparse_matmul(x, *args, use_kernel=False)
            torch.cuda.synchronize()
            diff, rel = rel_err(torch, y, ref)
            log(f"B1 {name} {K}x{N} M={M}: max|diff| {diff:.3e} rel {rel:.3e}")
            if not rel <= KERNEL_RTOL:
                raise AssertionError(f"B1 {name} M={M}: rel err {rel:.3e} > {KERNEL_RTOL}")
            agg["err"], agg["rel"] = max(agg["err"], diff), max(agg["rel"], rel)
            if M != 8:
                continue
            surv = int(p.counts.sum())
            nbytes = (M * K * 2 + surv * 128 * 128 + surv * 4 + p.counts.numel() * 4
                      + N * 4 + M * N * 2)
            flops = 2.0 * M * surv * 128 * 128
            b_ms, _ = bound(nbytes, flops)
            ms = timer(lambda: BS.block_sparse_matmul(x, *args))
            plain_ms = timer(lambda: BS.block_sparse_matmul(x, *args, use_kernel=False))
            lib_ms = timer(lambda: torch.matmul(x, wd))
            log(f"B1 {name} M=8: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"torch.matmul(dense bf16) {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({surv} of {(K // 128) * (N // 128)} blocks)")
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                         ("library_ms", lib_ms), ("bytes", nbytes), ("flops", flops)):
                agg[k] += v
    results["block_sparse_matmul"] = {
        "max_abs_err": agg["err"], "max_rel_err": agg["rel"], "ms": agg["ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": agg["bound_ms"], "bound_by": bound(agg["bytes"], agg["flops"])[1],
        "library_ms": agg["library_ms"],
        "shape": "sum of one layer's wq, wk, wv, wo, w_down at M=8"}

    # B2: gate/up 2048 x 5632 at M = 40 (prefill), then M = 8 (decode, timed)
    K, N = 2048, 5632
    g, u = _packed(torch, K, N, gen), _packed(torch, K, N, gen)
    wgu = torch.cat([_dense_bf16(torch, g), _dense_bf16(torch, u)], dim=1)
    ga, ua = (g.blocks, g.block_rows, g.counts), (u.blocks, u.block_rows, u.counts)
    b2_err = b2_rel = 0.0
    for M in (40, 8):
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        y = FG.fused_gate_up(x, ga, ua, g.scales, u.scales)
        ref = FG.fused_gate_up(x, ga, ua, g.scales, u.scales, use_kernel=False)
        torch.cuda.synchronize()
        diff, rel = rel_err(torch, y, ref)
        log(f"B2 {K}x{N} M={M}: max|diff| {diff:.3e} rel {rel:.3e}")
        if not rel <= KERNEL_RTOL:
            raise AssertionError(f"B2 M={M}: rel err {rel:.3e} > {KERNEL_RTOL}")
        b2_err, b2_rel = max(b2_err, diff), max(b2_rel, rel)
    surv = int(g.counts.sum() + u.counts.sum())
    nbytes = M * K * 2 + surv * (128 * 128 + 4) + 2 * (N // 128) * 4 + 2 * N * 4 + M * N * 2
    b_ms, b_by = bound(nbytes, 2.0 * M * surv * 128 * 128)
    ms = timer(lambda: FG.fused_gate_up(x, ga, ua, g.scales, u.scales))
    plain_ms = timer(lambda: FG.fused_gate_up(x, ga, ua, g.scales, u.scales, use_kernel=False))
    lib_ms = timer(lambda: torch.matmul(x, wgu))
    log(f"B2 M=8: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul(dense "
        f"[Wg|Wu] bf16) {lib_ms:.4f} ms, bound {b_ms:.4f} ms")
    results["fused_gate_up"] = {
        "max_abs_err": b2_err, "max_rel_err": b2_rel, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms, "shape": "2048x5632 gate+up at M=8"}

    # B3: B = 8 sequences, 32 heads over 4 KV heads (G = 8), hd 64, 16-token
    # pages, 8 pages per sequence; positions straddle page boundaries and
    # sequences 1-3 read sequence 0's first physical page (a shared prefix)
    B, H, KVH, hd, ps, P = 8, 32, 4, 64, 16, 8
    num_pages = 1 + B * P
    pos = torch.tensor([15, 16, 17, 31, 32, 47, 63, 100], dtype=torch.int32, device="cuda")
    table = (1 + torch.randperm(B * P, generator=gen, device="cuda")).reshape(B, P)
    table[1:4, 0] = table[0, 0]
    table = table.to(torch.int32).contiguous()
    q = torch.randn((B, 1, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
    n_pages = (pos // ps + 1).clamp(max=P)
    b3_err = b3_rel = 0.0
    for kv in ("int8", "bf16"):
        if kv == "int8":
            kp = torch.randint(-127, 128, (num_pages, ps, KVH, hd), generator=gen,
                               device="cuda", dtype=torch.int8)
            vp = torch.randint(-127, 128, kp.shape, generator=gen, device="cuda",
                               dtype=torch.int8)
            ks = torch.rand((num_pages, ps, KVH), generator=gen, device="cuda") * 0.02 + 0.005
            vs = torch.rand(ks.shape, generator=gen, device="cuda") * 0.02 + 0.005
            elem, scale_bytes = 1, 4
        else:
            kp = torch.randn((num_pages, ps, KVH, hd), generator=gen,
                             device="cuda").to(torch.bfloat16)
            vp = torch.randn(kp.shape, generator=gen, device="cuda").to(torch.bfloat16)
            ks = vs = None
            elem, scale_bytes = 2, 0
        kw = dict(k_scale_pages=ks, v_scale_pages=vs)
        o = FA.paged_decode_attention(q, kp, vp, table, pos, **kw)
        ref = FA.paged_decode_attention(q, kp, vp, table, pos, use_kernel=False, **kw)
        torch.cuda.synchronize()
        diff, rel = rel_err(torch, o, ref)
        log(f"B3 {kv} pools: max|diff| {diff:.3e} rel {rel:.3e}")
        if not rel <= KERNEL_RTOL:
            raise AssertionError(f"B3 {kv}: rel err {rel:.3e} > {KERNEL_RTOL}")
        b3_err, b3_rel = max(b3_err, diff), max(b3_rel, rel)
        if kv != "int8":
            continue
        pages_read = int(n_pages.sum()) * KVH  # (page, kv head) tiles
        nbytes = (pages_read * ps * (2 * hd * elem + 2 * scale_bytes)
                  + 2 * q.numel() * 2 + table.numel() * 4 + B * 4)
        flops = 4.0 * int((pos + 1).sum()) * H * hd
        b_ms, b_by = bound(nbytes, flops)
        ms = timer(lambda: FA.paged_decode_attention(q, kp, vp, table, pos, **kw))
        plain_ms = timer(lambda: FA.paged_decode_attention(q, kp, vp, table, pos,
                                                           use_kernel=False, **kw))
        # yardstick: SDPA on the gathered, dequantized K/V (expanded to H heads)
        from repro_torch.models import layers as L

        kd = (L.gather_pages(kp, table).float() * L.gather_pages(ks, table)[..., None])
        vd = (L.gather_pages(vp, table).float() * L.gather_pages(vs, table)[..., None])
        kd = kd.to(torch.bfloat16).repeat_interleave(H // KVH, dim=2).transpose(1, 2)
        vd = vd.to(torch.bfloat16).repeat_interleave(H // KVH, dim=2).transpose(1, 2)
        mask = (torch.arange(P * ps, device="cuda")[None, :] <= pos[:, None])[:, None, None]
        qt = q.transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = timer(lambda: sdpa(qt, kd, vd, attn_mask=mask))
        log(f"B3 int8 B=8: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"SDPA(gathered bf16) {lib_ms:.4f} ms, bound {b_ms:.4f} ms")
        results["paged_decode_attention"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "shape": "B=8 T=1 H=32 KVH=4 hd=64 int8 pages of 16, pos 15..100"}
    results["paged_decode_attention"].update(max_abs_err=b3_err, max_rel_err=b3_rel)


def _serve_args():
    from repro_torch.launch import serve

    ap = serve.build_parser()
    args = ap.parse_args([
        "--arch", "tinyllama-1.1b", "--requests", "8", "--max-new", "16",
        "--prompt-len", "40", "--max-batch", "8", "--max-len", "128",
        "--compress", "quant_sparse", "--q-prune", "0.5", "--block", "128",
        "--kv-dtype", "int8", "--page-size", "16", "--share-prefix"])
    return serve, ap, args


def phase_serve(torch, results: dict):
    import numpy as np

    from repro_torch.kernels import block_sparse as BS
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_gate_up as FG
    from repro_torch.serving.engine import Request, RequestState

    serve, ap, args = _serve_args()
    t0 = time.perf_counter()
    cfg, engine, plan = serve.build_engine(args, ap)
    torch.cuda.synchronize()
    log(f"serve: model + plan + engine built in {time.perf_counter() - t0:.1f}s "
        f"({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} kv, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.compute_dtype})")
    rng = np.random.default_rng(0)
    # requests 0-3 share a prefix: request 0's 36-token prompt is the
    # prefix that requests 1-3 extend (2 full pages shared by refcount, the
    # partial third page copied on write); requests 4-7 are independent
    prefix = rng.integers(0, cfg.vocab, size=36).astype(np.int32)
    prompts = [prefix] + [np.concatenate([prefix, rng.integers(0, cfg.vocab, 4)
                                          .astype(np.int32)]) for _ in range(3)]
    prompts += [rng.integers(0, cfg.vocab, size=40).astype(np.int32) for _ in range(4)]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=args.max_new) for i, p in enumerate(prompts)]
    counters = (BS.block_sparse_matmul, FG.fused_gate_up, FA.paged_decode_attention)
    for c in counters:
        c.launches = 0
    dt = serve.run_requests(engine, reqs)
    launches = {c.__name__: c.launches for c in counters}
    serve.report(engine, dt)
    log(f"serve: launches during the run {launches}")
    engine.audit_pages()
    bad = [r.uid for r in reqs if r.state is not RequestState.FINISHED
           or len(r.output) != args.max_new]
    if bad:
        raise AssertionError(f"requests not finished with {args.max_new} tokens: {bad}")
    if any(not (0 <= t < cfg.vocab) for r in reqs for t in r.output):
        raise AssertionError("a sampled token is outside the vocabulary")
    if engine.pages_in_use != 0:
        raise AssertionError(f"{engine.pages_in_use} pages leaked")
    if engine.stats.pages_shared <= 0:
        raise AssertionError("no prefix page was shared")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    for name, n in launches.items():
        results.setdefault(name, {})["launches"] = n
    tok_s = engine.stats.decode_tokens / dt
    log(f"serve: {engine.stats.completed}/8 FINISHED, audit clean, "
        f"{engine.stats.pages_shared} pages shared, {engine.stats.cow_copies} COW copies, "
        f"{tok_s:.1f} tok/s on {torch.cuda.get_device_name(0)}")
    return cfg, engine


def phase_parity(torch, cfg, engine) -> None:
    from repro_torch.core.weight_plan import with_use_kernel
    from repro_torch.models import transformer as T

    B, steps, ps = 4, 24, 16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (steps, B), generator=gen, device="cuda")
    paths = {"kernels": (engine.params, True),
             "plain": (with_use_kernel(engine.params, False), False)}

    # prefill at the serve phase's prompt lengths (B1/B2 at M = 36 and 40)
    for S in (36, 40):
        prompt = torch.randint(0, cfg.vocab, (1, S), generator=gen, device="cuda")
        lg = {}
        for name, (params, _) in paths.items():
            cache = T.init_cache(cfg, 1, S, torch.bfloat16, kv_dtype=torch.int8, device="cuda")
            lg[name] = T.prefill(cfg, params, prompt, cache)[0][0, -1].float()
        torch.cuda.synchronize()
        a, b = lg["kernels"], lg["plain"]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError("non-finite prefill logits")
        worst = float((a - b).abs().max() / b.abs().max())
        log(f"parity: prefill of {S} tokens, max |dlogit| / max |logit| = {worst:.3e} "
            f"(tolerance {PATH_RTOL}), same greedy token {bool(a.argmax() == b.argmax())}")
        if not worst <= PATH_RTOL:
            raise AssertionError(f"kernel prefill logits differ from the plain path: {worst:.3e}")

    logits = {}
    for name, (params, use_kernel) in paths.items():
        P = -(-steps // ps)
        cache = T.init_cache(cfg, B, P * ps, torch.bfloat16, kv_dtype=torch.int8,
                             page_size=ps, num_pages=1 + B * P, device="cuda")
        cache["page_table"].copy_(1 + torch.arange(B * P, device="cuda").reshape(B, P))
        out = []
        for t in range(steps):
            pos = torch.full((B,), t, dtype=torch.int32, device="cuda")
            lg, cache = T.decode_step(cfg, params, cache, tokens[t][:, None], pos,
                                      use_kernel=use_kernel)
            out.append(lg[:, 0].float())
        logits[name] = torch.stack(out)
    torch.cuda.synchronize()
    a, b = logits["kernels"], logits["plain"]
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite logits")
    diff = (a - b).abs().amax(dim=(1, 2))
    scale = b.abs().amax(dim=(1, 2))
    worst = float((diff / scale).max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"parity: {steps} teacher-forced steps x {B} sequences, max |dlogit| / max |logit| "
        f"= {worst:.3e} (tolerance {PATH_RTOL}), greedy agreement {agree:.4f}")
    if not worst <= PATH_RTOL:
        raise AssertionError(f"kernel path logits differ from the plain path: {worst:.3e}")


def phase_profile(torch, cfg, engine, steps: int = 6) -> None:
    """Where a decode step's time goes: ``steps`` decode steps at batch 8
    (paged int8 KV, kernels on) timed on the host clock, then the same
    number under torch.profiler for device time per kernel name.  The
    device-busy share is the profiled device time over the unprofiled wall
    time (the profiler slows the host, not the kernels)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T

    B, ps = 8, 16
    P = -(-(2 + 2 * steps) // ps)
    cache = T.init_cache(cfg, B, P * ps, torch.bfloat16, kv_dtype=torch.int8,
                         page_size=ps, num_pages=1 + B * P, device="cuda")
    cache["page_table"].copy_(1 + torch.arange(B * P, device="cuda").reshape(B, P))
    tok = torch.zeros((B, 1), dtype=torch.long, device="cuda")

    def step(t):
        pos = torch.full((B,), t, dtype=torch.int32, device="cuda")
        return T.decode_step(cfg, engine.params, cache, tok, pos)[0]

    for t in range(2):
        step(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(2, 2 + steps):
        step(t)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(2 + steps, 2 + 2 * steps):
            step(t)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []  # kernels only: operator rows would count their kernels twice
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows)
    log(f"profile: {steps} decode steps at batch {B}: wall {wall_ms / steps:.3f} ms/step "
        f"({prof_wall_ms / steps:.3f} under the profiler), device busy "
        f"{dev_ms / steps:.3f} ms/step ({dev_ms / wall_ms:.3f} of the unprofiled wall)")
    for ms, n, name in rows[:12]:
        log(f"profile:   {ms / steps:9.4f} ms/step  {n // steps:5d} calls/step  {name[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="on-card smoke test of the CUDA port")
    ap.add_argument("--profile", action="store_true",
                    help="after every phase, profile decode steps with torch.profiler")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"[chip_smoke] FAIL: no src/repro_torch next to {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, src)

    t_start = time.perf_counter()
    results: dict = {}
    phase_device(torch)
    phase_build()
    phase_kernels(torch, results)
    cfg, engine = phase_serve(torch, results)
    phase_parity(torch, cfg, engine)
    if args.profile:
        phase_profile(torch, cfg, engine)
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        r = results[name]
        ok = r["max_rel_err"] <= KERNEL_RTOL and r["launches"] > 0
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                        "max_rel_err": r["max_rel_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": r["shape"], "pass": ok})
    if not all(k["pass"] for k in kernels):
        raise AssertionError(f"a kernel failed: {kernels}")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
