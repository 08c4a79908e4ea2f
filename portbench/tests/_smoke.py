"""Smoke-size stand-ins for a cell's configuration and traffic: the same
files with every width cut to a few dozen and the lengths to tens of
tokens, so that the whole harness path runs on the CPU in seconds."""

from __future__ import annotations

import copy

import torch

from portbench import spec as SPEC


def smoke_config(config: dict) -> dict:
    c = copy.deepcopy(config)
    p = c["port"]
    if p.get("moe"):
        p.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, vocab=256,
                 compute_dtype="float32")
        p["moe"].update(n_experts=6, top_k=2, expert_d_ff=32, n_shared_experts=2, shared_d_ff=32,
                        pad_to=8)
    else:
        p.update(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8, d_ff=192,
                 vocab=256, compute_dtype="float32")
    # blocks of 16 and a low size floor, so that the smoke leaves pack
    c["serving"].update(block=16, min_size=1024, min_contract=16)
    return c


def smoke_traffic(traffic: dict) -> dict:
    t = dict(traffic)
    t.update(clients=4, max_batch=4, prompt={"dist": "loguniform", "lo": 4, "hi": 40},
             output={"dist": "loguniform", "lo": 4, "hi": 16}, open_after_completions=2,
             trace_seconds=0.3, check_tokens=40)
    return t


def cell(workload_name: str) -> tuple:
    """(bench, smoke config, smoke traffic) of a cell of BENCHMARK.json."""
    torch.set_num_threads(1)
    bench = SPEC.load_benchmark()
    wl = SPEC.workload(bench, workload_name)
    config = smoke_config(SPEC.load_config(bench, wl["config"]))
    return bench, config, smoke_traffic(SPEC.load_traffic(wl["traffic"]))
