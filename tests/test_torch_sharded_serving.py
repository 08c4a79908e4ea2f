"""Sharded serving on the port (``--mesh``, the engine's mesh path) against
the reference's unmeshed engine.

The reference's own meshed parity tests are red under JAX 0.9 (ROADMAP
C8) and skip without ``XLA_FLAGS``; its test requires of a meshed engine
the greedy tokens of the unmeshed one, bit for bit, and so does this.
Each mesh's ranks run as gloo processes on the CPU (``tests/_torch_ranks``,
which imports the port only); they serve smoke tinyllama-1.1b with the
reference test's settings (quant_sparse, blocks of 16, int8 pages of 8,
prefix sharing) from a plan directory the reference packed."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import repro.configs as RCF
from repro.core import weight_plan as RW
from repro.models.api import get_api as ref_get_api
from repro.serving.config import EngineConfig as REngineConfig
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine

import _torch_ranks as R
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core.weight_plan import save_plan
from repro_torch.distributed import shardlib as sl
from repro_torch.models.transformer import init_params
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import ServingEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(the reference's unmeshed streams, a plan directory of its packed
    weights with their axes, as the port saves it)."""
    rcfg = RCF.get_config(R.ARCH, smoke=True)
    rapi = ref_get_api(rcfg)
    rplan = rapi.compress(rcfg, rapi.init_params(rcfg, jax.random.key(0)), RW.PlanConfig(
        default="quant_sparse", q_prune=0.5, bk=16, bn=16, min_size=1024))
    eng = RServingEngine(rcfg, None, plan=rplan, config=REngineConfig.of(**R.FLAT))
    reqs = [RRequest(uid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(R.prompts(rcfg.vocab))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    plan_dir = str(tmp_path_factory.mktemp("plan"))
    save_plan(plan_dir, interop.plan_from_reference(rplan))
    return [[int(t) for t in r.output] for r in reqs], plan_dir


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_meshed_streams_equal_the_reference(reference, shape, tmp_path):
    """Every rank's greedy streams equal the reference's unmeshed engine's;
    every rank's pools equal its slices of the unsharded port engine's after
    every step; the host state (tables, free list) is the same on every
    rank and equals the unsharded engine's; a default max_batch is data x
    n_opt."""
    want, plan_dir = reference
    res = R.run(shape, plan_dir, str(tmp_path))
    D, M = shape
    kv = M if 2 % M == 0 else 1  # smoke tinyllama: 2 KV heads
    for r in res:
        assert r["streams"] == want, r["rank"]
        assert r["solo_streams"] == want
        assert r["pools_equal"], r["rank"]
        assert r["tables"] == r["solo_tables"] and r["free"] == r["solo_free"]
        assert r["degrees"] == [D, M, kv]
        assert r["pages_in_use"] == 0
        assert r["pages_shared"] >= 2 and r["cow_copies"] >= 2
        scaled, n_opt = r["max_batch"]
        assert 1 < n_opt < 16 and scaled == min(64, D * n_opt)
    first = res[0]
    assert all((r["streams"], r["tables"], r["free"], r["steps"]) ==
               (first["streams"], first["tables"], first["free"], first["steps"]) for r in res)
    # each rank holds its shards: fewer weight bytes than the whole plan
    assert all(r["weight_bytes"][0] < r["weight_bytes"][1] for r in res)


def _cli(*flags):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "tinyllama-1.1b", "--smoke",
         "--requests", "6", "--max-new", "4", "--compress", "quant_sparse", "--q-prune", "0.5",
         "--block", "16", "--kv-dtype", "int8", "--page-size", "16", "--share-prefix",
         "--device", "cpu", *flags], env=env, capture_output=True, text=True, timeout=300)


def test_serve_cli_mesh_lines():
    """The CLI starts the ranks itself; rank 0 prints the reference's lines:
    the mesh line, the paged line's kv-shard clause at 1x2; at 1x4 (2 KV
    heads on 4 ranks) the kv fallback's pool warning."""
    two = _cli("--mesh", "1x2")
    assert two.returncode == 0, two.stderr
    out = two.stdout
    assert "[serve] mesh 1x2: starting 2 ranks over gloo on the CPU" in out
    assert "[serve] mesh {'data': 1, 'model': 2}: data-parallel 1, model-parallel 2, " \
           "kv shard degree 2" in out
    assert "2-way kv shard -> 1/2 of each page's bytes per rank" in out
    assert out.count("[serve] completed 6 requests") == 1  # rank 0 alone prints
    four = _cli("--mesh", "1x4")
    assert four.returncode == 0, four.stderr
    assert "kv shard degree 1" in four.stdout
    assert "paged pools do not shard across the 4-way model axis" in four.stderr


@pytest.mark.parametrize("flags,what", [
    (["--spec-k", "2", "--draft-config", "tinyllama-1.1b"], "speculative decode"),
    (["--prefill-chunk", "8"], "chunked prefill"),
    (["--arch", "granite-moe-1b-a400m"], "MoE layers"),
])
def test_serve_cli_refuses_what_a_mesh_does_not_serve(flags, what, capsys):
    """Refused by name before any rank starts, with exit code 2."""
    from repro_torch.launch import serve

    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--mesh", "1x2",
                    *flags])
    assert e.value.code == 2
    cap = capsys.readouterr()
    assert f"{what} under a mesh is not served yet (ROADMAP A13b)" in cap.err
    assert "starting" not in cap.out


@pytest.mark.parametrize("arch,flat,what", [
    ("tinyllama-1.1b", dict(spec_k=1), "speculative decode"),
    ("tinyllama-1.1b", dict(prefill_chunk=4), "chunked prefill"),
    ("qwen2-moe-a2.7b", {}, "MoE layers"),
    ("recurrentgemma-2b", {}, "recurrent and xLSTM layers"),
    ("xlstm-350m", {}, "recurrent and xLSTM layers"),
    ("whisper-tiny", {}, "the audio family"),
    ("internvl2-2b", {}, "the vlm family"),
    ("tinyllama-1.1b", dict(allocator=object()), "a shared page allocator"),
])
def test_engine_refuses_what_a_mesh_does_not_serve(arch, flat, what):
    cfg = get_config(arch, smoke=True)
    mesh = sl.MeshShape({"data": 1, "model": 2})
    if "spec_k" in flat:
        flat = dict(flat, draft_cfg=cfg, draft_params=init_params(cfg, 1, device="cpu"))
    with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP A13b"):
        ServingEngine(cfg, None, device="cpu", config=EngineConfig.of(mesh=mesh, **flat))
