"""Training step builder (port of ``repro/training/trainer.py``): grad +
clip + optimizer, with optional microbatch gradient accumulation and
gradient compression.

``make_train_step`` returns an eager function: autograd gives the
gradients of every leaf of the params tree (``torch.autograd.grad``, no
``.grad`` fields), and ``optimizer.apply_updates`` updates the leaves in
place.  The params tree must be the stacked tree of ``init_params`` (see
``models.transformer.forward``).

On a mesh (``placement=``, an ``optimizer.Placement`` that
``launch.mesh.train_placement`` builds) the step runs under
``shardlib.use_mesh``: the params are a rank's pieces (tensor parallelism
over "model" by the leaves' logical axes), each microbatch's rows are split
over the data replicas, the gradients are summed over the replicas once a
step, and the optimizer state is ZeRO-1.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.weight_plan import flatten_leaves, map_tree, unflatten_leaves
from repro_torch.distributed import compression as GC
from repro_torch.distributed import shardlib as sl
from repro_torch.training import optimizer as O


def _trainable(params):
    """The tree with every leaf a leaf tensor that requires grad: the same
    tensor where it already is one, else a detached alias of its storage
    (a masked tree from ``pruning.apply_masks`` is not made of leaves)."""
    def one(_, t):
        if t.is_leaf and t.requires_grad:
            return t
        return t.detach().requires_grad_(True)

    return map_tree(one, params)


def make_train_step(
    cfg,
    loss_fn: Callable,  # (cfg, params, batch) -> (loss, metrics)
    opt_cfg: O.OptimizerConfig,
    *,
    accum_steps: int = 1,
    compression: Optional[str] = None,  # None | "int8" | "topk"
    placement: Optional[O.Placement] = None,
):
    """Build train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).

    batch leaves have leading dim global_batch; with accum_steps > 1 they
    are split into accum_steps microbatches run one after another, the
    gradients summed in fp32 and divided by accum_steps (the loss too); the
    metrics are the last microbatch's.  Compression (with error feedback in
    opt_state["ef"]) runs before ``apply_updates``.

    With a ``placement`` params and opt_state are a rank's pieces
    (``optimizer.init_opt_state(..., placement=)``) and ``batch`` is the
    GLOBAL batch on every rank: each microbatch is a slice of it, as
    without a mesh, and the rank runs its replica's rows of the slice
    (``transformer.replica_rows``; a microbatch the replicas do not divide
    is refused), so each microbatch's loss is the mean over the same rows.
    The gradients are summed over the replicas once, after accumulation
    (each replica's term is already its rows' share of the mean), then
    compressed with whole-leaf semantics and applied as ZeRO-1.  ``loss``
    and ``grad_norm`` are the global values on every rank."""

    def grads_of(params, batch):
        views = params if placement is None else placement.views(params)
        loss, metrics = loss_fn(cfg, views, batch)
        grads = torch.autograd.grad(loss, flatten_leaves(params))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state, batch):
        if placement is None:
            return step(params, opt_state, batch)
        with sl.use_mesh(placement.mesh, placement.rules):
            return step(params, opt_state, batch)

    def step(params, opt_state, batch):
        params = _trainable(params)
        if accum_steps == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in flatten_leaves(params)]
            n = next(iter(batch.values())).shape[0] // accum_steps
            losses = []
            for i in range(accum_steps):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                loss_i, metrics, g = grads_of(params, mb)
                losses.append(loss_i)
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
            loss = sum(losses) / accum_steps
            grads = [g / accum_steps for g in grads]
        if placement is not None:  # the data replicas' terms, once a step
            grads = sl.all_reduce_flat(list(grads), sl.batch_axes(), placement.mesh)
        grads = unflatten_leaves(params, list(grads))
        if compression is not None:
            grads, opt_state = GC.compress_tree(grads, opt_state, kind=compression,
                                                placement=placement)
        params, opt_state, opt_metrics = O.apply_updates(opt_cfg, params, grads, opt_state,
                                                         placement)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg, loss_fn: Callable):
    """eval_step(params, batch) -> the loss function's metrics, without
    gradients."""

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(cfg, params, batch)
        return metrics

    return eval_step
