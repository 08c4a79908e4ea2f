#!/usr/bin/env python3
"""Readings for a cell's output-check limit, several seeds in one process:

    python3 portbench/control.py --workload glm4-chat-decode --seeds 1,2,3 --seconds 30

For each seed it runs the cell as ``run.py`` does (window, output check)
and prints one JSON line: the port's readings (``max_logit_gap``,
``mean_logit_gap``), the control's (``fp8_max_gap``, ``fp8_mean_gap``:
the reference in float8 e4m3 put in the port's place, the gap of the
token it puts first at each position of the same sample), those of any
other precision named by ``--others`` (``bf16``: the configurations'
stated compute type), the served tokens read and the run's metrics.  The
benchmark's own runs never run the control.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--others", default="fp8", help="comma-separated: fp8, bf16")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

    import torch

    from portbench import bench as B
    from portbench import spec as SPEC

    if not torch.cuda.is_available():
        print("control.py needs the card", file=sys.stderr)
        return 2
    bench = SPEC.load_benchmark()
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        out = B.run(args.workload, seed, args.seconds, bool(args.trace), started=time.monotonic(),
                    others=tuple(args.others.split(",")),
                    log=lambda m: print(m, file=sys.stderr, flush=True))
        line = {"workload": args.workload, "seed": seed, **out["check"],
                "correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
                "memory_peak_bytes": out["memory_peak"],
                "metrics": B.metrics(out["run"], bench, bool(args.trace))}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
