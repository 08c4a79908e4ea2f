"""gemma3-smoke (window 8, 5 local + 1 global + 2 local layers) through
the reference's engine and the port's under the paths that manage its
rings: speculation at k 2 (rings widened by k, for target and draft),
chunked prefill (chunks clamped to the window) and an 1100-token prompt
(past dense_threshold: the flash path's plain version, windowed on the
local layers).  Greedy streams and the speculation counters must be
identical."""

import numpy as np
import pytest

import _torch_families as F
from repro_torch.configs import get_config


@pytest.mark.parametrize("draft", ["self", "seed1"])
def test_gemma3_speculative_streams_match_reference(draft):
    """k = 2: rings widen to window + k (target and draft), a verify step
    writes 3 positions, rejected ones stay masked until overwritten."""
    ref, eng = F.engines("gemma3-4b", spec=(draft, 2), **F.QUICKSTART)
    cfg = get_config("gemma3-4b", smoke=True)
    for kind, c in zip(cfg.layer_kinds, eng.cache["layers"]):
        if kind == "local":
            assert c["k"].shape[1] == cfg.local_window + 2
    assert eng.draft_cache["layers"][0]["k"].shape[1] == cfg.local_window + 2
    F.serve_both(ref, eng, F.prompts(), max_new=7)
    for name in ("draft_proposed", "draft_accepted", "verified_positions", "decode_steps"):
        assert getattr(eng.stats, name) == getattr(ref.stats, name), name


def test_gemma3_chunked_prefill_clamps_to_the_window():
    ref, eng = F.engines("gemma3-4b", prefill_chunk=16, prefill_budget=16, **F.QUICKSTART)
    assert eng.prefill_chunk == ref.prefill_chunk == 8
    F.serve_both(ref, eng, F.prompts(), max_new=5)
    assert eng.stats.prefill_chunks == ref.stats.prefill_chunks > len(F.prompts())


def test_gemma3_long_prompt_takes_the_windowed_flash_path():
    """An 1100-token prompt crosses dense_threshold: every layer prefills
    through the flash path's plain version, windowed on the local layers."""
    ref, eng = F.engines("gemma3-4b", max_len=1120, max_batch=2, **F.QUICKSTART)
    r = np.random.default_rng(3)
    prompts = [r.integers(0, 256, 1100).astype(np.int32), r.integers(0, 256, 9).astype(np.int32)]
    F.serve_both(ref, eng, prompts, max_new=4)
    assert eng.stats.prefill_tokens == 1109
