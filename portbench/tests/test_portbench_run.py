"""The command itself: no result without the card, none from a checkout
that holds only the benchmark, and the refusal of JAX or the JAX package
in the process by whole top-level names."""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
ARGS = ["--workload", "glm4-chat-decode", "--seed", "3000000023", "--seconds", "1",
        "--trace", "0"]


def _run(cwd: Path):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_result_without_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(ROOT)
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "needs 1 CUDA device" in p.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_by_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(ROOT / "portbench"))
    try:
        import run as RUN
    finally:
        sys.path.pop(0)
    monkeypatch.setitem(sys.modules, "repro_torch_fake.sub", object())
    assert "repro" not in RUN.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.kernels", object())
    assert "repro" in RUN.forbidden_modules()


@pytest.mark.gpu
def test_weights_and_plan_on_the_card():
    """On the card: the seed's weights draw the same twice, and the
    reference's worked-out plan equals the port's packed weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench import bench as B
    from portbench import weights as W
    from portbench.reference import model as REF

    from _smoke import cell

    bench, config, traffic = cell("qwen2moe-chat-decode")
    port = config["port"]
    a = W.draw_layer(port, 3_000_000_025, 1, "cuda")
    b = W.draw_layer(port, 3_000_000_025, 1, "cuda")
    assert all(torch.equal(a[k], b[k]) for k in a)
    cfg = B.port_config(config)
    _, plan = B.build_engine(cfg, config, traffic, 3_000_000_025, "cuda")
    node = plan.params["embed"]["head"]
    ref = REF.served_weight("embed/head", W.draw_global(port, 3_000_000_025, "embed/head", "cuda"),
                            1, config["serving"])
    torch.testing.assert_close(node.q.float() * node.s, ref, rtol=1e-6, atol=1e-7)
