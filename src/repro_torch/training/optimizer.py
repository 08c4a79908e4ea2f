"""Optimizers (port of ``repro/training/optimizer.py``): AdamW and
momentum SGD over the params tree, no torch.optim.

The optimizer state mirrors the params tree ({"step", "mu", "nu"} for
AdamW, {"step", "mom"} for SGD, plus "ef" for gradient compression), so a
``(params, opt_state)`` checkpoint has the reference's leaves in the
reference's order and carries over both ways (``checkpoint.store``).

``apply_updates`` keeps the reference's signature and return value, but it
updates params and moments IN PLACE under ``torch.no_grad()`` (the
reference donates its buffers instead): the returned params tree holds the
same tensors it was given.  Weight decay applies to every leaf with
``ndim >= 2`` of the tree it is given -- the STACKED tree, whose
``unit``/``rem`` leaves carry a leading layer axis, so a stacked norm scale
(layers, d) is decayed as in the reference.  The schedule and the bias
corrections are computed in fp32 from the int32 step, as the reference's
are.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.weight_plan import flatten_leaves, map_tree


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # adamw | sgd
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1
    momentum: float = 0.9  # sgd


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio * lr, in fp32."""
    step = step.to(torch.float32)
    warm = torch.clamp((step + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.decay_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos)


def _zeros(params):
    return map_tree(lambda _, t: torch.zeros_like(t, requires_grad=False), params)


def init_opt_state(cfg: OptimizerConfig, params, error_feedback: bool = False) -> dict:
    """Zero moments shaped like ``params`` on its devices, and an int32 step
    of 0 on the device of the first leaf."""
    dev = flatten_leaves(params)[0].device
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.name == "adamw":
        state["mu"] = _zeros(params)
        state["nu"] = _zeros(params)
    elif cfg.name == "sgd":
        state["mom"] = _zeros(params)
    else:
        raise ValueError(cfg.name)
    if error_feedback:  # gradient-compression residual buffer
        state["ef"] = _zeros(params)
    return state


def opt_state_axes(cfg: OptimizerConfig, param_axes, error_feedback: bool = False) -> dict:
    """The logical sharding axes of the state (data for ROADMAP A13c): each
    moment takes its param's axes, the step none."""
    axes = {"step": ()}
    if cfg.name == "adamw":
        axes["mu"] = param_axes
        axes["nu"] = param_axes
    else:
        axes["mom"] = param_axes
    if error_feedback:
        axes["ef"] = param_axes
    return axes


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    leaves = flatten_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before scaling); a new tree, as in the reference."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return map_tree(lambda _, g: g * scale, grads), norm


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, grads, state) -> tuple:
    """One optimizer step.  Returns (params, new_state, metrics): ``params``
    is the tree it was given, its leaves updated in place, as are the
    moments of ``state``; ``new_state`` is a new dict with step + 1.  The
    reference's arithmetic, one leaf at a time (the clip scale too), so the
    temporaries stay within a few copies of the largest leaf."""
    gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"]
    lr = lr_schedule(cfg, step)
    ps, gs = flatten_leaves(params), flatten_leaves(grads)
    if cfg.name == "adamw":
        b1, b2 = cfg.beta1, cfg.beta2
        c1 = 1.0 - b1 ** (step.to(torch.float32) + 1.0)
        c2 = 1.0 - b2 ** (step.to(torch.float32) + 1.0)
        for p, g, m, v in zip(ps, gs, flatten_leaves(state["mu"]), flatten_leaves(state["nu"])):
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = m / c1
            u.div_((v / c2).sqrt_().add_(cfg.eps))
            if p.dim() >= 2:  # decoupled weight decay on matrices only
                u.add_(cfg.weight_decay * p)
            p.sub_(u.mul_(lr))
    else:  # sgd + momentum
        for p, g, m in zip(ps, gs, flatten_leaves(state["mom"])):
            if scale is not None:
                g = g * scale
            m.mul_(cfg.momentum).add_(g)
            p.sub_(lr * m)
    return params, dict(state, step=step + 1), {"lr": lr, "grad_norm": gnorm}
