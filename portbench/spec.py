"""Finds a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names the cells; a cell names its
configuration (``configs[].file``) and its traffic mix
(``portbench/traffic/<traffic>.json``); the limit of its output check is
``portbench/checks/<workload>.json``; each metric is read by
``portbench/metrics/<metric>.py``, whose ``read(run)`` returns a number or
None.  A later cell, mix or metric is a new file: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _load_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str) -> dict:
    return _load_json(BENCH_DIR / "traffic" / f"{name}.json")


def load_checks(workload_name: str) -> dict:
    return _load_json(BENCH_DIR / "checks" / f"{workload_name}.json")


def applies(metric: dict, workload_name: str) -> bool:
    return "workloads" not in metric or workload_name in metric["workloads"]


def cell_metrics(bench: dict, workload_name: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: its end-to-end ones
    with ``--trace 0``, its per-layer ones with ``--trace 1``."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if applies(m, workload_name)]


def metric_reader(name: str):
    """``read`` of ``portbench/metrics/<name>.py`` (names may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
