"""The paper's fully-connected networks (port of ``repro/models/fcnet.py``).

Four evaluation networks (the paper's Table 2), at their published widths:
    MNIST 4-layer: 784 x 800 x 800 x 10
    MNIST 8-layer: 784 x 800 x 800 x 800 x 800 x 800 x 800 x 10
    HAR   4-layer: 561 x 1200 x 300 x 6
    HAR   6-layer: 561 x 2000 x 1500 x 750 x 300 x 6

Three inference datapaths, as in the reference:
  * ``forward_fp32``   -- the software baseline: one launch of kernel B7
                          (weight-stationary ``act(x @ w + b)``) per layer.
  * ``forward_q78``    -- the bit-exact Q7.8 datapath of the FPGA design
                          (Section 5.3): int16 weights and activations, the
                          wrapping int32 (Q15.16) accumulator of kernel B8,
                          ReLU / sigmoid-PLAN in fixed point.  Like the
                          reference it encodes the fp32 weights on every
                          call, so a timed forward includes that pass.
  * ``forward_pruned`` -- masked inference (the pruning design's semantics);
                          the (w, z)^3 codec of ``core.sparse_format`` is
                          its storage format.
``forward_q78_sectioned`` evaluates the Q7.8 datapath in the paper's
section-by-section order (Section 5.5) and equals ``forward_q78`` bit for
bit: batch processing changes the schedule, never the numbers.

Params are the reference's layout: a list of {"w": (s_in, s_out), "b":
(s_out,)} fp32 dicts.  Every forward takes ``use_kernel``: True launches
the kernels for CUDA tensors (the plain versions run for CPU tensors),
False runs the plain versions on the card too.  ``loss_fn`` is the
training loss (a softmax classifier over the last layer's pre-activation,
masked weights for pruning's refinement), in plain torch: B7 and B8 are
inference kernels without a backward.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import quantization as Q
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class FCNetConfig:
    name: str
    sizes: tuple  # (s_0, ..., s_{L-1})
    hidden_act: str = "relu"
    out_act: str = "sigmoid"

    @property
    def n_params(self) -> int:
        return sum(a * b + b for a, b in zip(self.sizes[:-1], self.sizes[1:]))

    def act(self, j: int) -> str:
        """The activation of layer j (of len(sizes) - 1)."""
        return self.hidden_act if j < len(self.sizes) - 2 else self.out_act


MNIST_4 = FCNetConfig("mnist-4layer", (784, 800, 800, 10))
MNIST_8 = FCNetConfig("mnist-8layer", (784, 800, 800, 800, 800, 800, 800, 10))
HAR_4 = FCNetConfig("har-4layer", (561, 1200, 300, 6))
HAR_6 = FCNetConfig("har-6layer", (561, 2000, 1500, 750, 300, 6))

PAPER_FCNETS = {c.name: c for c in (MNIST_4, MNIST_8, HAR_4, HAR_6)}


def init_params(cfg: FCNetConfig, generator: torch.Generator, device=None):
    """He-normal weights (std sqrt(2 / s_in)) drawn from ``generator`` on its
    own device, zero biases; placed on ``device`` (the CUDA device unless
    ``device="cpu"``).  The numbers differ from the reference's
    ``jax.random`` draws: tests carry reference params across with
    ``interop.params_from_reference``."""
    dev = resolve_device(device)
    params = []
    for a, b in zip(cfg.sizes[:-1], cfg.sizes[1:]):
        w = torch.randn((a, b), generator=generator, device=generator.device) * math.sqrt(2.0 / a)
        params.append({"w": w.to(dev), "b": torch.zeros((b,), dtype=torch.float32, device=dev)})
    return params


def forward_fp32(cfg: FCNetConfig, params, x: torch.Tensor, *,
                 use_kernel: bool = True) -> torch.Tensor:
    """Software-baseline inference: one B7 launch per layer, the layer's
    activation in the kernel's epilogue."""
    for j, p in enumerate(params):
        x = ops.batched_ffn(x, p["w"], p["b"], cfg.act(j), use_kernel=use_kernel)
    return x


def forward_pruned(cfg: FCNetConfig, params, masks, x: torch.Tensor, *,
                   use_kernel: bool = True) -> torch.Tensor:
    """Masked (pruned) fp32 inference: B7 on ``w * m`` per layer."""
    for j, (p, m) in enumerate(zip(params, masks)):
        x = ops.batched_ffn(x, p["w"] * m["w"], p["b"], cfg.act(j), use_kernel=use_kernel)
    return x


def _q78_layer(params, j: int):
    """Layer j's Q7.8 weights and its bias moved to Q15.16."""
    p = params[j]
    return Q.q78_encode(p["w"]), Q.q78_encode(p["b"]).to(torch.int32) << Q.Q78_FRAC_BITS


def _q78_activation(cfg: FCNetConfig, j: int, acc: torch.Tensor) -> torch.Tensor:
    """Requantize the Q15.16 accumulator, then ReLU (combinational) or
    sigmoid-PLAN in fixed point."""
    z_q = Q.q78_requantize(acc)
    act = cfg.act(j)
    if act == "relu":
        return Q.q78_relu(z_q)
    if act == "sigmoid":
        return Q.q78_sigmoid_plan(z_q)
    return z_q


def forward_q78(cfg: FCNetConfig, params, x: torch.Tensor, *,
                use_kernel: bool = True) -> torch.Tensor:
    """Bit-exact Q7.8 inference; returns the float32 decode of the output."""
    a_q = Q.q78_encode(x)
    for j in range(len(params)):
        w_q, b_q = _q78_layer(params, j)
        acc = ops.q78_matmul(a_q, w_q, use_kernel=use_kernel) + b_q[None, :]
        a_q = _q78_activation(cfg, j, acc)
    return Q.q78_decode(a_q)


def forward_q78_sectioned(cfg: FCNetConfig, params, x: torch.Tensor, m: int = 114,
                          n: int | None = None, *, use_kernel: bool = True) -> torch.Tensor:
    """Q7.8 inference in the paper's TDM order (Section 5.5): per layer, m
    output neurons (a weight section) at a time across each group of n
    samples.  One B8 launch per (section, group); the section is a column
    slice of the layer's codes, read in place.  Equal to ``forward_q78``."""
    n = n if n is not None else x.shape[0]
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of the group size {n}")
    a_q = Q.q78_encode(x)
    for j in range(len(params)):
        w_q, b_q = _q78_layer(params, j)
        cols = []
        for s in range(0, w_q.shape[1], m):  # section sweep (weight reuse)
            outs = [ops.q78_matmul(a_q[bi:bi + n], w_q[:, s:s + m], use_kernel=use_kernel)
                    for bi in range(0, a_q.shape[0], n)]  # all samples per section
            cols.append(torch.cat(outs, dim=0) + b_q[None, s:s + m])
        a_q = _q78_activation(cfg, j, torch.cat(cols, dim=1))
    return Q.q78_decode(a_q)


def loss_fn(cfg: FCNetConfig, params, batch, masks=None):
    """Softmax cross entropy of the hidden-activated layers' logits (the
    output activation is left out), on weights times ``masks`` where given
    (a list of {"w": mask} per layer).  batch: {"x": (B, s_0), "y": (B,)
    int}.  Returns (nll, {"loss": nll})."""
    x, y = batch["x"], batch["y"]
    L = len(params)
    for j, p in enumerate(params):
        w = p["w"] if masks is None else p["w"] * masks[j]["w"]
        x = x @ w + p["b"]
        if j < L - 1:
            x = _ACT[cfg.hidden_act](x)
    logp = torch.log_softmax(x, dim=-1)
    nll = -logp.gather(-1, y.long()[:, None]).mean()
    return nll, {"loss": nll}


_ACT = {"relu": torch.relu, "sigmoid": torch.sigmoid, "linear": lambda x: x}


@torch.no_grad()
def accuracy(cfg: FCNetConfig, params, x, y, masks=None) -> float:
    """Top-1 accuracy of the fp32 (or masked) forward on labels ``y``."""
    if masks is None:
        logits = forward_fp32(cfg, params, x)
    else:
        logits = forward_pruned(cfg, params, masks, x)
    return float((logits.argmax(-1) == y).to(torch.float32).mean())


def n_params_exact(cfg: FCNetConfig) -> int:
    """Parameter count (weights and biases) of ``init_params``' tree."""
    return cfg.n_params
