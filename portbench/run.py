#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, from the checkout's root:

    python3 portbench/run.py --workload glm4-chat-decode --seed 7 --seconds 30 --trace 0

Progress goes to standard error; the last line of standard output is the
result: {"correct", "attempted", "failed", "metrics", "device"[,
"breakdown"], "check"}.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones.  The run needs as many CUDA
devices as the cell asks for and exits 2 without a result otherwise; it
exits 3 without a result if JAX or the JAX package was loaded in the
process.  The port's kernels build on first use into
``src/repro_torch/_build`` inside the checkout.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The process's start on ``time.monotonic`` (from /proc; now where
    that cannot be read)."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def _number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

    import torch

    from portbench import spec as SPEC

    bench = SPEC.load_benchmark()
    wl = SPEC.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"[portbench] {args.workload} needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2

    from portbench import bench as B
    from portbench import trace as TRACE

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = B.run(args.workload, args.seed, args.seconds, bool(args.trace), started=started,
                log=log)
    run = out["run"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(wl["chips"]),
              "memory_peak_bytes": out["memory_peak"]}
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": B.metrics(run, bench, bool(args.trace)), "device": device}
    if args.trace and run.profile is not None:
        device["busy_s"] = run.profile.busy_s
        device["window_s"] = run.profile.window_s
        result["breakdown"] = TRACE.breakdown(run.profile)
    check = {k: {"value": _number(out["check"][k]), "limit": lim}
             for k, lim in out["limits"].items()}
    check["failed_requests"] = {"value": out["failed"], "limit": 0}
    result["check"] = check
    found = forbidden_modules()
    if found:
        log(f"[portbench] refused: the process loaded {found}")
        return 3
    for k, lim in out["limits"].items():
        log(f"[portbench] check: {k} {out['check'][k]!r} (limit {lim!r}) over "
            f"{out['check']['tokens']} served tokens")
    log(f"[portbench] check: failed_requests {out['failed']} (limit 0) of {out['attempted']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
