"""Greedy streams of the dense families (llama3.2-1b, glm4-9b, gemma3-4b
smoke, fp32) through the reference's engine and the port's over the same
packed quant_sparse plan, with the quickstart flags at --block 16 (paged
int8 KV, prefix sharing): identical streams, page tables and slot maps
every tick; gemma3's local rings beside its paged global layer, written
per slot under a shared prefix; and the serve CLI on the CPU."""

import pytest

import _torch_families as F
from repro_torch.configs import get_config


@pytest.mark.parametrize("arch", F.FAMILIES)
def test_greedy_streams_match_reference_quickstart(arch):
    ref, eng = F.engines(arch, **F.QUICKSTART)
    F.serve_both(ref, eng, F.prompts(), max_new=6)
    assert eng.stats.pages_shared == ref.stats.pages_shared > 0
    assert eng.stats.cow_copies == ref.stats.cow_copies


def test_gemma3_rings_are_written_per_slot_under_paging():
    """Local layers keep a (max_batch, ring, KVH, hd) ring beside the
    global layers' pools; a shared-prefix admission maps the pools' pages
    and still writes the new slot's rings whole."""
    ref, eng = F.engines("gemma3-4b", **F.QUICKSTART)
    cfg = get_config("gemma3-4b", smoke=True)
    for kind, c in zip(cfg.layer_kinds, eng.cache["layers"]):
        if kind == "local":
            assert set(c) == {"k", "v", "k_scale", "v_scale"}
            assert tuple(c["k"].shape) == (5, cfg.local_window, cfg.n_kv_heads, cfg.hd)
        else:
            assert "k_pages" in c
    prompts = F.prompts()
    F.serve_both(ref, eng, prompts[:2], max_new=4)
    # request 1 shares request 0's full page: its rings come from its own prefill
    assert eng.stats.pages_shared == 1


@pytest.mark.parametrize("arch", F.FAMILIES)
def test_serve_cli_quickstart_on_cpu(arch, capsys):
    from repro_torch.launch import serve

    eng = serve.main(["--arch", arch, "--smoke", "--requests", "8", "--max-new", "6",
                      "--compress", "quant_sparse", "--q-prune", "0.5", "--block", "16",
                      "--kv-dtype", "int8", "--page-size", "16", "--share-prefix",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] completed 8 requests" in out and "tok/s on cpu" in out
    eng.audit_pages()
    assert eng.pages_in_use == 0
