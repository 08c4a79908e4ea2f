"""Training the MoE, recurrent, xLSTM, enc-dec and VLM families on the
card at smoke size: one launcher step each, with finite losses, and kernel
B6 (forward-only) never launched.  They need a CUDA device; they carry
the ``gpu`` marker and skip elsewhere (and import no JAX, which the card's
machine lacks):

    python -m pytest -q -m gpu tests/test_torch_train_families_gpu.py

The full-width runs and the card-vs-CPU parity of each family are
``chip_smoke.py``'s train phase."""

import math

import pytest
import torch

from repro_torch.core.weight_plan import flatten_leaves
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import train

ARCHS = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b", "recurrentgemma-2b", "xlstm-350m",
         "whisper-tiny", "internvl2-2b"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_on_card(cuda, arch):
    b6 = FA.flash_attention.launches
    args = train.build_parser().parse_args(
        ["--arch", arch, "--smoke", "--steps", "1", "--batch", "4", "--seq", "32"])
    out = train.run(args)
    assert out["restarts"] == 0 and len(out["losses"]) == 1
    assert math.isfinite(out["losses"][0])
    assert FA.flash_attention.launches == b6
    assert all(t.is_cuda for t in flatten_leaves(out["params"]))
