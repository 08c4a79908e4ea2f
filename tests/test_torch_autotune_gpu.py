"""A tuned plan's forward on the card against its plain versions: tinyllama
at full width cut to 2 layers, the plan of a hand-made autotuner
``Candidate`` that gives every representation a group (w_gate/w_up
quant_sparse: B2; wq block_sparse: B1 on its fp32-payload FMA body; wo
quant_sparse: B1 on wgmma; wk/wv/head quant: B5; w_down dense).  A prefill
of 40 tokens and one decode step through the kernels and through the plain
versions (``with_use_kernel(params, False)``, ``use_kernel=False``), the
logits held to 5e-2 of their largest magnitude (bf16 roundings compound
over the layers, as chip_smoke.py's PATH_RTOL holds them).  These need a
CUDA device and nvcc; they carry the ``gpu`` marker and skip elsewhere
(and import no JAX, which the card's machine lacks):

    python -m pytest -q -m gpu tests/test_torch_autotune_gpu.py"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import autotune as AT
from repro_torch.core.weight_plan import compress, with_use_kernel
from repro_torch.kernels import block_sparse as BS
from repro_torch.kernels import fused_gate_up as FG
from repro_torch.kernels import quant_matmul as QM
from repro_torch.models.api import get_api

PATH_RTOL = 5e-2
KINDS = {"w_gate": ("quant_sparse", 0.5), "w_up": ("quant_sparse", 0.5),
         "wq": ("block_sparse", 0.5), "wo": ("quant_sparse", 0.5), "w_down": ("dense", 0.0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= PATH_RTOL, float(err)


@pytest.mark.gpu
def test_tuned_plan_forward_matches_plain(cuda):
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=2)
    space = AT.SearchSpace()
    uni = AT.uniform_candidate(cfg, space)
    cand = dataclasses.replace(uni, assign=tuple(
        (g,) + KINDS.get(g, ("quant", 0.0)) for g, _, _ in uni.assign))
    api = get_api(cfg)
    plan = compress(api.init_params(cfg, 0, device=cuda), AT.candidate_plan_config(cand, space))
    kinds = {p.rsplit("/", 1)[-1]: l.kind for p, l in plan.leaves.items()}
    assert kinds["wq"] == "block_sparse" and kinds["w_gate"] == "quant_sparse"
    assert kinds["head"] == "quant" and kinds["w_down"] == "dense"
    want = AT.predict_plan_stats(AT.model_leaves(cfg), cand, space)
    assert (want.n_weights, want.surviving, want.weight_bytes) == \
        (plan.n_weights, plan.surviving_weights, plan.weight_bytes)

    dtype = getattr(torch, cfg.compute_dtype)
    kern = api.unstack(cfg, plan.params)
    plain = with_use_kernel(kern, False)
    g = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (1, 40), generator=g, device=cuda)
    out = {}
    for name, params, use in (("kernel", kern, True), ("plain", plain, False)):
        for f in (BS.block_sparse_matmul, FG.fused_gate_up):
            BS.zero_counts(f)
        QM.quant_matmul.launches = 0
        cache = api.init_cache(cfg, 1, 64, dtype, device=cuda)
        logits, cache = api.prefill(cfg, params, {"tokens": tokens}, cache, use_kernel=use)
        step, _ = api.decode_step(cfg, params, cache, logits[:, -1].argmax(-1)[:, None],
                                  torch.tensor([40], dtype=torch.int32, device=cuda),
                                  use_kernel=use)
        out[name] = (logits[:, -1], step[:, -1])
        counts = (BS.block_sparse_matmul.launches, BS.block_sparse_matmul.fma_launches,
                  FG.fused_gate_up.launches, QM.quant_matmul.launches)
        if use:
            # a prefill and a step: per layer wq (FMA body) and wo (wgmma),
            # the gate/up pair (B2), wk/wv (B5); the head once each
            L = cfg.n_layers
            assert counts == (2 * 2 * L, 2 * L, 2 * L, 2 * (2 * L + 1)), counts
        else:
            assert counts == (0, 0, 0, 0), counts
    for a, b in zip(out["kernel"], out["plain"]):
        _close(a, b)
