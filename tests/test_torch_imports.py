"""Import rules and device rules of the PyTorch port.

The port (``src/repro_torch``) and ``chip_smoke.py`` import torch and numpy
only: nothing of ``jax`` and nothing of the JAX package ``repro``.  Its
entry points run on the CUDA device unless asked for the CPU, and raise
without a GPU instead of falling back."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def test_import_leaves_jax_and_repro_out():
    """Importing repro_torch and every submodule (and chip_smoke) in a fresh
    interpreter loads neither jax nor repro, and sets up no process group
    (the dry run's fake group exists inside ``lower_cell`` only)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert len(mods) >= 20, mods\n"
        "new = {'repro_torch.core.quantization', 'repro_torch.models.fcnet',\n"
        "       'repro_torch.kernels.batched_ffn', 'repro_torch.kernels.quant_matmul',\n"
        "       'repro_torch.checkpoint.store', 'repro_torch.serving.scheduler',\n"
        "       'repro_torch.serving.loadgen', 'repro_torch.serving.faultinject',\n"
        "       'repro_torch.distributed.fault', 'repro_torch.models.encdec',\n"
        "       'repro_torch.models.vlm', 'repro_torch.configs.whisper_tiny',\n"
        "       'repro_torch.configs.internvl2_2b', 'repro_torch.models.recurrent',\n"
        "       'repro_torch.models.ssm', 'repro_torch.serving.mixed',\n"
        "       'repro_torch.configs.recurrentgemma_2b', 'repro_torch.configs.xlstm_350m',\n"
        "       'repro_torch.data.pipeline', 'repro_torch.training.optimizer',\n"
        "       'repro_torch.training.trainer', 'repro_torch.distributed.compression',\n"
        "       'repro_torch.launch.train', 'repro_torch.core.autotune',\n"
        "       'repro_torch.launch.autotune', 'repro_torch.distributed.shardlib',\n"
        "       'repro_torch.distributed.elastic', 'repro_torch.launch.mesh',\n"
        "       'repro_torch.launch.dryrun', 'repro_torch.launch.op_analysis'}\n"
        "assert new <= set(mods), new - set(mods)\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()  # the dry run makes its group in lower_cell only\n"
        "assert 'torch.testing._internal.distributed.fake_pg' not in sys.modules\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$|,)|from\s+repro(\.|\s+import))",
    re.M)


def test_sources_name_no_jax_or_reference_imports():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not offenders, offenders
    assert _FORBIDDEN.search("from repro.core import x") and _FORBIDDEN.search("import jax.numpy")
    assert not _FORBIDDEN.search("from repro_torch.core import x")


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu(monkeypatch):
    """No GPU and no explicit CPU request: every entry point raises."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.mixed import MixedServingEngine, WorkloadSpec

    _no_cuda(monkeypatch)
    cfg = get_config("tinyllama-1.1b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, 0)
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "tinyllama-1.1b", "--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--workload-mix", "tinyllama-1.1b:1", "--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps", "1"])
    eng = ServingEngine(cfg, params, device="cpu")
    assert eng.device.type == "cpu"
    spec = [WorkloadSpec(name="t", cfg=cfg, params=params, config=EngineConfig(max_batch=1))]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MixedServingEngine(spec)
    assert MixedServingEngine(spec, device="cpu").engine("t").device.type == "cpu"
    for arch in ("recurrentgemma-2b", "xlstm-350m"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_params(get_config(arch, smoke=True), 0)


def test_kernel_library_is_not_built_at_import():
    """Importing the kernel modules builds and loads nothing."""
    code = ("import repro_torch.kernels.ops as o, repro_torch.kernels.build as b, sys\n"
            "sys.exit(1 if b._LIBS else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without CUDA,
    and likewise from a directory that holds nothing else of the repo."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for where in (ROOT, tmp_path):
        script = where / "chip_smoke.py"
        if where is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        r = subprocess.run([sys.executable, str(script)], cwd=where, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
