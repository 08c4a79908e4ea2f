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

On a mesh (a ``Placement``) the params and gradients are a rank's pieces
of the leaves, and the moments are ZeRO-1 pieces: each moment leaf is
resolved under ``launch.mesh.opt_rules``, which also splits its "d"
dimension over the data axes, so a rank holds 1/D of every moment whose
d_model dimension the data axis divides (a leaf it does not divide stays
whole, as ``_resolve`` drops the mapping).  ``apply_updates`` then updates
the rank's data slice of each param piece with the same arithmetic per
element and gathers the slices back over the data axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core.weight_plan import (
    ShardedLeaf,
    flatten_leaves,
    map_tree,
    matmul_split,
    unflatten_leaves,
)
from repro_torch.distributed import shardlib as sl


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


@dataclasses.dataclass(frozen=True)
class Placement:
    """A training state on a mesh, leaf by leaf in flatten order: the mesh
    and the rules the step runs under, each param's path (``map_tree``'s),
    whole shape, spec under the rules (the rank's piece is the trainable
    leaf) and ``ShardedLeaf`` split (``weight_plan.matmul_split``), and each
    moment's spec under ``moment_rules`` (``launch.mesh.opt_rules`` for
    ZeRO-1; the rules themselves keep the moments as the params' pieces).
    Every spec is resolved once, here."""

    mesh: Any
    rules: dict
    paths: tuple
    shapes: tuple
    param_specs: tuple
    splits: tuple
    moment_specs: tuple

    @classmethod
    def of(cls, whole, axes, mesh, rules: dict, moment_rules: dict,
           moment_axes=None) -> "Placement":
        """From a tree of the whole leaves (meta tensors will do) and the
        params' logical ``axes`` tree; ``moment_axes``, where given, is the
        moments' (each must split what its param's splits)."""
        flat = flatten_leaves(whole)

        def leaves(tree):
            return [tuple(a) if a else (None,) * t.dim()
                    for t, a in zip(flat, _axes_leaves(tree, whole))]

        ax = leaves(axes)
        mom = ax if moment_axes is None else leaves(moment_axes)
        specs = tuple(sl._resolve(mesh, rules, a, t.shape) for t, a in zip(flat, ax))
        return cls(mesh, rules, tuple(flatten_leaves(map_tree(lambda path, _: path, whole))),
                   tuple(tuple(t.shape) for t in flat), specs,
                   tuple(matmul_split(s, a, tuple(t.shape), mesh)
                         for s, a, t in zip(specs, ax, flat)),
                   tuple(sl._resolve(mesh, moment_rules, a, t.shape) for t, a in zip(flat, mom)))

    def piece(self, path: str, leaf: torch.Tensor) -> torch.Tensor:
        """The rank's piece of the whole ``leaf`` at ``path`` (a copy where
        the spec cuts it): ``transformer.make_params``' ``leaf_fn``, so a
        rank that draws the whole tree holds one whole leaf at a time."""
        spec = self.param_specs[self.paths.index(path)]
        if not sl.spec_axes(spec):
            return leaf
        return sl.local_piece(leaf, spec, self.mesh).contiguous().clone()

    def views(self, params):
        """``params`` (the rank's pieces) with each split matmul piece in a
        ``ShardedLeaf`` view, the tree ``weight_plan.local_params`` makes of
        a whole tree: the model's products route through
        ``sharded_linear`` as in serving.  Built each step over the
        trainable pieces."""
        return unflatten_leaves(params, [p if s is None else ShardedLeaf(p, *s)
                                         for p, s in zip(flatten_leaves(params), self.splits)])

    def moment_cut(self, i: int) -> tuple:
        """The spec that cuts leaf ``i``'s param piece to its moment piece:
        the dimensions the moment's spec splits and the param's does not."""
        return tuple(m if m != p else None
                     for p, m in zip(self.param_specs[i], self.moment_specs[i]))

    def split_axes(self, i: int) -> tuple:
        """The mesh axes that split param ``i`` (none for a whole leaf)."""
        return sl.spec_axes(self.param_specs[i])

    def state_specs(self, params, opt_state) -> tuple:
        """(params, opt_state)-shaped trees of ``shardlib.Spec``: what
        ``checkpoint.store`` gathers a whole state by and restores pieces
        by.  Moments take the moment specs, ``ef`` the params'."""
        p = unflatten_leaves(params, [sl.Spec(s, self.mesh) for s in self.param_specs])
        m = unflatten_leaves(params, [sl.Spec(s, self.mesh) for s in self.moment_specs])
        o = {k: sl.Spec((), self.mesh) if k == "step" else p if k == "ef" else m
             for k in opt_state}
        return p, o


def _axes_leaves(axes, tree) -> list:
    """The logical-axes tuple of every leaf of ``tree``, in flatten order."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in
                _axes_leaves(None if axes is None else axes.get(k), tree[k])]
    if isinstance(tree, list):
        return [a for i, v in enumerate(tree) for a in
                _axes_leaves(None if axes is None else axes[i], v)]
    return [axes]


def _zeros(params):
    return map_tree(lambda _, t: torch.zeros_like(t, requires_grad=False), params)


def init_opt_state(cfg: OptimizerConfig, params, error_feedback: bool = False,
                   placement: Optional[Placement] = None) -> dict:
    """Zero moments shaped like ``params`` on its devices, and an int32 step
    of 0 on the device of the first leaf.  With a ``placement`` the params
    are a rank's pieces and each moment is its ZeRO-1 piece; the
    error-feedback buffer keeps the params' pieces."""
    leaves = flatten_leaves(params)
    dev = leaves[0].device

    def moments():
        if placement is None:
            return _zeros(params)
        return unflatten_leaves(params, [
            torch.zeros(sl.local_shape(t.shape, placement.moment_cut(i), placement.mesh),
                        dtype=t.dtype, device=t.device) for i, t in enumerate(leaves)])

    state = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.name == "adamw":
        state["mu"] = moments()
        state["nu"] = moments()
    elif cfg.name == "sgd":
        state["mom"] = moments()
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


def global_norm(tree, placement: Optional[Placement] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32.  With a
    ``placement`` the leaves are a rank's pieces: the squares of the split
    leaves are summed over the axes that split them, so each element counts
    once and the norm is the whole tree's on every rank."""
    leaves = flatten_leaves(tree)
    squares = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves]
    if placement is None:
        return torch.sqrt(sum(squares))
    by_axes: dict = {}
    for i, sq in enumerate(squares):
        by_axes.setdefault(placement.split_axes(i), []).append(sq)
    return torch.sqrt(sum(sl.reduce_over(sum(parts), axes, placement.mesh)
                          for axes, parts in by_axes.items()))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before scaling); a new tree, as in the reference."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return map_tree(lambda _, g: g * scale, grads), norm


def _zero_slices(placement: Optional[Placement], ps: list, gs: list) -> tuple:
    """(param slices, gradient slices, the cuts): each param piece and its
    gradient cut to the rank's moment piece (views; the pieces themselves
    without a placement or where the moment is not cut)."""
    if placement is None:
        return ps, gs, [None] * len(ps)
    cuts = [placement.moment_cut(i) for i in range(len(ps))]
    cuts = [c if any(e is not None for e in c) else None for c in cuts]
    mesh = placement.mesh
    return ([p if c is None else sl.local_piece(p, c, mesh) for p, c in zip(ps, cuts)],
            [g if c is None else sl.local_piece(g, c, mesh) for g, c in zip(gs, cuts)], cuts)


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, grads, state,
                  placement: Optional[Placement] = None) -> tuple:
    """One optimizer step.  Returns (params, new_state, metrics): ``params``
    is the tree it was given, its leaves updated in place, as are the
    moments of ``state``; ``new_state`` is a new dict with step + 1.  The
    reference's arithmetic, one leaf at a time (the clip scale too), so the
    temporaries stay within a few copies of the largest leaf.

    With a ``placement`` (ZeRO-1) ``params`` and ``grads`` are a rank's
    pieces and each moment its piece of them: the rank updates the matching
    slice of each param piece and gathers the slices over the data axes;
    the norm is the whole tree's (``global_norm``), and weight decay keeps
    applying by the leaf's rank, as whole."""
    gnorm = global_norm(grads, placement)
    scale = None
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"]
    lr = lr_schedule(cfg, step)
    pieces = flatten_leaves(params)
    ps, gs, cuts = _zero_slices(placement, pieces, flatten_leaves(grads))
    if cfg.name == "adamw":
        b1, b2 = cfg.beta1, cfg.beta2
        c1 = 1.0 - b1 ** (step.to(torch.float32) + 1.0)
        c2 = 1.0 - b2 ** (step.to(torch.float32) + 1.0)
        for i, (p, g, m, v) in enumerate(zip(ps, gs, flatten_leaves(state["mu"]),
                                             flatten_leaves(state["nu"]))):
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = m / c1
            u.div_((v / c2).sqrt_().add_(cfg.eps))
            if p.dim() >= 2:  # decoupled weight decay on matrices only
                u.add_(cfg.weight_decay * p)
            p.sub_(u.mul_(lr))
            if cuts[i] is not None:  # every replica's updated slice, into the piece
                pieces[i].copy_(sl.gather_whole(p, cuts[i], placement.mesh))
    else:  # sgd + momentum
        for i, (p, g, m) in enumerate(zip(ps, gs, flatten_leaves(state["mom"]))):
            if scale is not None:
                g = g * scale
            m.mul_(cfg.momentum).add_(g)
            p.sub_(lr * m)
            if cuts[i] is not None:
                pieces[i].copy_(sl.gather_whole(p, cuts[i], placement.mesh))
    return params, dict(state, step=step + 1), {"lr": lr, "grad_norm": gnorm}
