"""Training on the card: the port's training step on CUDA tensors against
its CPU run, the flash-attention backward against dense attention's
autograd, and the launcher on the card (B6, forward-only, never launches
in training).  These need a CUDA device; they carry the ``gpu`` marker
and skip elsewhere (and import no JAX, which the card's machine lacks):

    python -m pytest -q -m gpu tests/test_torch_train_gpu.py

Tolerances, fp32 with TF32 off: the loss to 1e-4 relative, a gradient to
1e-3 of its leaf's max (the card sums in other orders), the flash
gradients to 1e-4 of their max, ``apply_updates`` on equal gradients to
1e-6."""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.weight_plan import flatten_leaves, unflatten_leaves
from repro_torch.data import LMDataConfig, synthetic_lm_batch
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as O


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _grads(cfg, params, batch, dev):
    leaves = flatten_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = T.loss_fn(cfg, params, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-4b"])
def test_step_on_card_matches_cpu(cuda, arch):
    """A 2-layer model at a quarter of the arch's width, fp32 compute: loss
    and gradients on the card and on the CPU, then apply_updates on equal
    gradients on both."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=2, d_model=full.d_model // 4,
                              d_ff=full.d_ff // 4, compute_dtype="float32",
                              pattern=None if full.pattern is None else ("local", "global"))
    cpu = T.init_params(cfg, 0, device="cpu")
    gpu = unflatten_leaves(cpu, [t.to(cuda) for t in flatten_leaves(cpu)])
    batch = synthetic_lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=48, global_batch=2), 0)
    l_cpu, g_cpu = _grads(cfg, cpu, batch, "cpu")
    l_gpu, g_gpu = _grads(cfg, gpu, batch, cuda)
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    for g, w in zip(g_gpu, g_cpu):
        assert float((g.cpu() - w).abs().max()) <= 1e-3 * float(w.abs().max().clamp_min(1e-30))
    oc = O.OptimizerConfig(lr=1e-3)
    O.apply_updates(oc, cpu, unflatten_leaves(cpu, list(g_cpu)), O.init_opt_state(oc, cpu))
    O.apply_updates(oc, gpu, unflatten_leaves(gpu, [g.to(cuda) for g in g_cpu]),
                    O.init_opt_state(oc, gpu))
    for a, b in zip(flatten_leaves(gpu), flatten_leaves(cpu)):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 256])
def test_flash_function_grads_match_dense_autograd(cuda, window):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn(s, generator=gen, device=cuda)
                   for s in ((1, 2048, 32, 64), (1, 2048, 4, 64), (1, 2048, 4, 64),
                             (1, 2048, 32, 64)))
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    b0 = L.FlashAttention.backward_calls
    got = torch.autograd.grad(L.train_attention(*xs, causal=True, window=window), xs, do)
    assert L.FlashAttention.backward_calls == b0 + 1
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(L.dense_attention(*xs, causal=True, window=window), xs, do)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.gpu
def test_launcher_trains_on_card_without_b6(cuda):
    """The smoke config past the dense threshold (1100 tokens): every layer
    through the flash Function, B6's launch count unchanged, finite losses,
    no restart."""
    b6 = FA.flash_attention.launches
    f0 = L.FlashAttention.forward_calls
    args = train.build_parser().parse_args(
        ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "3", "--batch", "2", "--seq", "1100"])
    out = train.run(args)
    assert out["restarts"] == 0 and all(x == x for x in out["losses"])
    assert L.FlashAttention.forward_calls - f0 == 3 * get_config("tinyllama-1.1b", smoke=True).n_layers
    assert FA.flash_attention.launches == b6
    assert flatten_leaves(out["params"])[0].is_cuda
