"""Greedy streams of the MoE family (granite-moe-1b-a400m, qwen2-moe-a2.7b
and qwen2-moe with 8 padded experts, smoke, fp32) through the reference's
engine and the port's over the same packed quant_sparse plan (every expert
stack packed, blocks of 16), with the quickstart flags (paged int8 KV,
prefix sharing) and under self-draft speculation at k 2: identical
streams, page tables and slot maps every tick; and the serve CLI on the
CPU, which prints the reference's parameter count."""

import pytest

import _torch_families as F
import _torch_moe as MF
from repro.models import transformer as RT


@pytest.mark.parametrize("spec_k", [0, 2])
@pytest.mark.parametrize("variant", MF.VARIANTS)
def test_greedy_streams_match_reference(variant, spec_k):
    ref, eng = MF.engines(variant, spec_k=spec_k, **F.QUICKSTART)
    F.serve_both(ref, eng, MF.prompts(), max_new=6)
    assert eng.stats.pages_shared == ref.stats.pages_shared > 0
    if spec_k:
        assert eng.stats.draft_accepted == ref.stats.draft_accepted
        assert eng.stats.verified_positions == ref.stats.verified_positions > 0


@pytest.mark.parametrize("arch", MF.ARCHS)
def test_serve_cli_quickstart_on_cpu(arch, capsys):
    from repro_torch.launch import serve

    eng = serve.main(["--arch", arch, "--smoke", "--requests", "8", "--max-new", "6",
                      "--compress", "quant_sparse", "--q-prune", "0.5", "--block", "16",
                      "--kv-dtype", "int8", "--page-size", "16", "--share-prefix",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    rcfg, _ = MF.configs(arch)
    assert f"n_params={RT.n_params_exact(rcfg):,} " in out
    assert "[serve] completed 8 requests" in out and "tok/s on cpu" in out
    eng.audit_pages()
    assert eng.pages_in_use == 0
