"""What the benchmark may import and read: no module under portbench/
imports JAX or the JAX package (top-level names compared whole, so the
port, ``repro_torch``, is allowed where the harness drives it), the
reference imports nothing of the port, and a run reads nothing under the
JAX package's ``benchmarks/``."""

from __future__ import annotations

import ast
import builtins
import os
from pathlib import Path

from portbench import bench as B

from _smoke import cell

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                tops.add(str(node.args[0].value).split(".", 1)[0])
    return tops


def sources(sub: str = "") -> list:
    return sorted((BENCH_DIR / sub).rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    assert sources(), "no sources found"
    for path in sources():
        bad = imported_tops(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_top_level_names_are_compared_whole():
    # the port's name begins with the JAX package's: it is not the JAX package
    assert "repro_torch".split(".", 1)[0] not in FORBIDDEN
    assert "repro.kernels".split(".", 1)[0] in FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for path in sources("reference"):
        tops = imported_tops(path)
        assert "repro_torch" not in tops and not (tops & FORBIDDEN), (path, tops)
    # nor does what it draws its weights with
    assert "repro_torch" not in imported_tops(BENCH_DIR / "weights.py")


def test_no_source_names_the_jax_benchmarks():
    for path in sources():
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "import benchmarks" not in text, path
        assert "benchmarks" not in imported_tops(path), path


def test_a_run_reads_nothing_under_benchmarks(monkeypatch):
    opened = []
    real_open = builtins.open

    def spy(file, *a, **kw):
        opened.append(os.path.abspath(str(file)))
        return real_open(file, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy)
    bench, config, traffic = cell("glm4-chat-decode")
    B.run("glm4-chat-decode", 5, 0.5, False, started=0.0, device="cpu", bench=bench,
          config=config, traffic=traffic, limits={"max_logit_gap": 1e-3})
    jax_bench = str(ROOT / "benchmarks")
    assert opened, "the spy saw no file opened"
    assert not [p for p in opened if p.startswith(jax_bench + os.sep)]
