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
from repro_torch.core.weight_plan import save_plan

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
    res = R.run_path(shape, dict(arch=R.ARCH, flat=R.FLAT, plan_dir=plan_dir, rules="rules_for",
                                 prompts=[p.tolist() for p in R.prompts(256)], max_new=6,
                                 out=str(tmp_path)))
    D, M = shape
    kv = M if 2 % M == 0 else 1  # smoke tinyllama: 2 KV heads
    for r in res:
        assert r["streams"] == want, r["rank"]
        assert r["solo_streams"] == want
        assert r["cache_exact"], r["rank"]
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


_MIX = ("--workload-mix", "tinyllama-1.1b:2,recurrentgemma-2b:1,whisper-tiny:1")


@pytest.mark.parametrize("flags,line", [
    (["--spec-k", "2", "--draft-config", "tinyllama-1.1b"],
     "[serve] speculative: "),
    (["--prefill-chunk", "8", "--prefill-budget", "16"],
     "[serve] continuous batching: 8-token prefill chunks, 16 tok/tick budget"),
    (["--arch", "granite-moe-1b-a400m"], "[serve] granite-moe-smoke: n_params=90,944"),
    (["--arch", "recurrentgemma-2b", "--page-size", "0"],
     "[serve] recurrentgemma-smoke: n_params=201,664"),
    (["--arch", "xlstm-350m"], "[serve] xlstm-smoke: n_params=159,184"),
    (["--arch", "whisper-tiny"], "[serve] whisper-smoke: n_params=108,672"),
    (["--arch", "internvl2-2b"], "[serve] internvl2-smoke: n_params=110,976"),
    (list(_MIX), "[serve] shared page pool: 137 pages x 16 tok across 2 paged families"),
])
def test_serve_cli_serves_the_new_paths_on_a_mesh(flags, line):
    """--mesh 1x2 with speculative decode, chunked prefill, a MoE arch,
    recurrentgemma-2b, xlstm-350m, whisper-tiny (its frames), internvl2-2b
    (its patches) and a --workload-mix: the ranks start, rank 0 prints the
    reference's lines (the mesh line, the path's own line) and every
    request completes (the mix: its 7 requests by weight, audit clean)."""
    if flags[0] == "--workload-mix":
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *flags, "--smoke", "--requests",
             "6", "--max-new", "4", "--kv-dtype", "int8", "--page-size", "16", "--device",
             "cpu", "--mesh", "1x2"], env=env, capture_output=True, text=True, timeout=300)
    else:
        run = _cli("--mesh", "1x2", *flags)
    assert run.returncode == 0, run.stderr
    out = run.stdout
    assert "[serve] mesh 1x2: starting 2 ranks over gloo on the CPU" in out
    assert "[serve] mesh {'data': 1, 'model': 2}: data-parallel 1, model-parallel 2" in out
    assert line in out
    if flags[0] == "--workload-mix":
        assert out.count("[serve] mixed: 7/7 requests") == 1 and "page audit clean" in out
    else:
        assert out.count("[serve] completed 6 requests") == 1
