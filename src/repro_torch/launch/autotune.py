"""Offline plan autotuner CLI (port of ``tools/autotune.py``).

    python -m repro_torch.launch.autotune --arch tinyllama-1.1b \
        --strategy anneal --trials 64 --seed 0 --out /tmp/tuned.json

Searches per-leaf (kind, q_prune) assignments plus block size, kv_dtype and
page size: objective the modeled tokens/s (``core/perf_model``'s roofline
at the H100 data-sheet constants), constraint the paper's 1.5%
accuracy-drop budget, evaluated lazily with ``pruning.iterative_prune`` on
a seeded calibration task (``core/autotune``), trained on the CUDA device
(``--device cpu`` trains on the CPU).  Writes a TunedPlan JSON artifact
that ``python -m repro_torch.launch.serve --autotune-plan`` loads (so does
the reference's ``serve.py``); ``--plan-cache DIR`` also packs the winning
weights (``init_params(cfg, 0)``) through ``weight_plan.save_plan``, so
that a serving boot skips the pack.  The kernels B1, B2 and B4 take 128
blocks only: with CUDA, ``--blocks`` other than 128 is refused here.
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch.kernels.block_sparse import BLOCK


def _floats(s: str) -> tuple:
    return tuple(float(v) for v in s.split(",") if v != "")


def _ints(s: str) -> tuple:
    return tuple(int(v) for v in s.split(",") if v != "")


def _strs(s: str) -> tuple:
    return tuple(v for v in s.split(",") if v != "")


def build_parser() -> argparse.ArgumentParser:
    import repro_torch.configs as C

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=C.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", required=True, metavar="PATH",
                    help="TunedPlan JSON artifact to write")
    ap.add_argument("--strategy", default="anneal", choices=("anneal", "random"))
    ap.add_argument("--trials", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    # design space (first value of each list = the uniform default)
    ap.add_argument("--q-prunes", type=_floats, default=(0.0, 0.25, 0.5, 0.75),
                    metavar="Q,Q,...", help="sparsity levels (default first)")
    ap.add_argument("--kinds", type=_strs,
                    default=("quant_sparse", "block_sparse", "quant", "dense"),
                    metavar="K,K,...", help="representations (default first)")
    ap.add_argument("--blocks", type=_ints, default=(128,), metavar="B,B,...",
                    help="sparse block edges bk=bn (default first)")
    ap.add_argument("--kv-dtypes", type=_strs, default=("fp", "int8"), metavar="D,D,...")
    ap.add_argument("--page-sizes", type=_ints, default=(0, 16), metavar="P,P,...",
                    help="0 = contiguous KV cache")
    ap.add_argument("--min-size", type=int, default=16384)
    ap.add_argument("--min-contract", type=int, default=64)
    # constraints / workload
    ap.add_argument("--budget", type=float, default=0.015,
                    help="accuracy-drop budget (paper Section 6.4)")
    ap.add_argument("--no-accuracy", action="store_true",
                    help="skip the calibration oracle (perf screening only)")
    ap.add_argument("--calib-smoke", action="store_true",
                    help="tiny calibration task (CI-scale oracle)")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--pool-gb", type=float, default=16.0,
                    help="KV pool budget per card (GB)")
    ap.add_argument("--smem-kb", type=float, default=227.0,
                    help="shared memory of one CTA of the block-sparse kernels (KB)")
    ap.add_argument("--plan-cache", default=None, metavar="DIR",
                    help="pack the winning plan and persist it via weight_plan.save_plan")
    ap.add_argument("--device", default=None,
                    help="torch device of the calibration oracle and the packing "
                         "(default: the CUDA device; 'cpu' runs on the CPU)")
    return ap


def main(argv=None):
    import repro_torch.configs as C
    from repro_torch.core import autotune as AT
    from repro_torch.device import resolve_device

    ap = build_parser()
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and any(b != BLOCK for b in args.blocks):
        ap.error(f"--blocks {','.join(map(str, args.blocks))}: the kernels B1, B2 and B4 "
                 f"take {BLOCK}-blocks only")

    cfg = C.get_config(args.arch, smoke=args.smoke)
    space = AT.SearchSpace(
        q_prunes=args.q_prunes, kinds=args.kinds, blocks=args.blocks,
        kv_dtypes=args.kv_dtypes, page_sizes=args.page_sizes,
        min_size=args.min_size, min_contract=args.min_contract)
    cons = AT.Constraints(
        max_acc_drop=args.budget, pool_bytes=args.pool_gb * 1e9,
        smem_bytes=args.smem_kb * 1024, max_batch=args.max_batch,
        max_len=args.max_len, prompt_len=args.prompt_len, max_new=args.max_new)
    accuracy = None
    if not args.no_accuracy:
        calib = AT.CalibrationConfig.smoke() if args.calib_smoke else AT.CalibrationConfig()
        accuracy = AT.CalibrationEvaluator(calib, max_acc_drop=args.budget, device=device)

    t0 = time.time()
    result = AT.search(cfg, space=space, constraints=cons, strategy=args.strategy,
                       trials=args.trials, seed=args.seed, accuracy=accuracy)
    dt = time.time() - t0
    p, u = result.prediction, result.uniform
    print(f"[autotune] {cfg.name}: {args.strategy} x{args.trials} "
          f"(seed {args.seed}) in {dt:.1f}s; "
          f"{len(result.acc_evals)} accuracy evals")
    print(f"[autotune] best {p.tokens_per_s:.0f} tok/s @ batch {p.batch} "
          f"(uniform {u.tokens_per_s:.0f}, "
          f"{p.tokens_per_s / max(u.tokens_per_s, 1e-9):.2f}x); "
          f"balance={p.balance:.2f} max_q={p.stats.max_q:.2f}")
    for g, k, q in result.best.assign:
        print(f"[autotune]   {g}: {k} q={q:.2f}")
    print(f"[autotune]   block={result.best.block} "
          f"kv={result.best.kv_dtype} page={result.best.page_size} "
          f"spec_k={result.best.spec_k} mesh={result.best.mesh}")

    doc = AT.tuned_plan_doc(cfg, result, space=space, constraints=cons)
    AT.save_tuned(args.out, doc)
    print(f"[autotune] wrote {args.out}")
    # the artifact through the serving adapter now (the EngineConfig route
    # serve --autotune-plan takes), so that a knob the engine cannot route
    # fails at tune time
    ec = AT.engine_config(doc)
    print(f"[autotune] serving surface: max_batch={ec.max_batch} "
          f"max_len={ec.max_len} kv={ec.cache.kv_dtype or 'fp'} "
          f"page_size={ec.cache.page_size or 0} "
          f"pool_pages={ec.cache.num_pages or 0} "
          f"expected_context={ec.cache.expected_context or 0}")

    if args.plan_cache:
        from repro_torch.core.weight_plan import compress, save_plan
        from repro_torch.models.api import get_api

        params = get_api(cfg).init_params(cfg, 0, device=device)
        plan = compress(params, AT.plan_config(doc))
        save_plan(args.plan_cache, plan)
        print(f"[autotune] packed plan cached to {args.plan_cache}")
        print(f"[autotune] {plan.summary(per_leaf=True)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
