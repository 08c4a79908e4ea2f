"""Pruning (port of ``repro/core/pruning.py``; paper Section 4.3).

Two granularities:

1. **Element pruning** (paper-faithful): survivors are |w| above a
   magnitude threshold, as masks (``sparsity_target_mask`` and friends);
   ``models.fcnet.forward_pruned`` runs on the masked weights and the
   (w, z)^3 stream codec of ``core.sparse_format`` is their storage format.
   ``iterative_prune`` is the paper's prune-refine schedule under its 1.5%
   accuracy objective.
2. **Block pruning**: weights are scored and removed in (bk, bn) blocks, so
   a kernel can skip a whole block: both the bytes streamed and the MACs
   scale with (1 - q_prune), the paper's claim at a granularity the
   hardware can exploit.  Pack parity with the reference rests on three
   details kept here: fp32 scores, the threshold ``sort(scores)[k - 1]``
   and the strict ``s > delta``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

# ---------------------------------------------------------------------------
# Element-granular pruning (paper-faithful)
# ---------------------------------------------------------------------------


def magnitude_threshold_mask(w: torch.Tensor, delta: float) -> torch.Tensor:
    """Mask of survivors: |w| >= delta (paper Section 4.3)."""
    return (w.abs() >= delta).to(w.dtype)


def sparsity_target_mask(w: torch.Tensor, q_prune: float) -> torch.Tensor:
    """Mask pruning the q_prune fraction of smallest-|w| weights: the
    threshold delta is the k-th smallest magnitude, survivors are |w| > delta
    (ties at delta are pruned with it, as in the reference)."""
    if not 0.0 <= q_prune < 1.0:
        raise ValueError(f"q_prune must be in [0,1), got {q_prune}")
    flat = w.abs().reshape(-1)
    k = int(round(q_prune * flat.numel()))
    if k == 0:
        return torch.ones_like(w)
    delta = torch.sort(flat).values[k - 1]
    return (w.abs() > delta).to(w.dtype)


def apply_mask(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return w * mask


def measured_q_prune(mask: torch.Tensor) -> float:
    """Fraction of pruned (zero) entries in a mask -- the paper's q_prune."""
    return float(1.0 - mask.to(torch.float32).mean())


def row_q_prune(mask: torch.Tensor) -> torch.Tensor:
    """Per-output-neuron pruning factors q_prune_k (paper Section 5.6): the
    mask is (s_in, s_out), so the paper's rows of W^(j) are its columns."""
    return 1.0 - mask.to(torch.float32).mean(dim=0)


@dataclasses.dataclass(frozen=True)
class PruneSchedule:
    """Cubic sparsity ramp from start_step to end_step (Zhu & Gupta style),
    reaching final_q at end_step; before start_step no pruning.  start ==
    end is the paper's one-shot prune-then-refine."""

    final_q: float
    start_step: int
    end_step: int

    def q_at(self, step: int) -> float:
        if step < self.start_step:
            return 0.0
        if step >= self.end_step:
            return self.final_q
        frac = (step - self.start_step) / max(1, self.end_step - self.start_step)
        return self.final_q * (1.0 - (1.0 - frac) ** 3)


def _map_leaves(fn, tree, path: str = ""):
    """fn(path, leaf) over the tensors of a nested dict/list tree; paths are
    "0/w"-style strings."""
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, join(i)) for i, v in enumerate(tree))
    return fn(path, tree)


def update_masks(params, q_prune: float, filter_fn: Callable | None = None):
    """Masks at sparsity q_prune for every >= 2-D leaf that ``filter_fn(path,
    leaf)`` accepts (all of them without one); ones for the other leaves."""

    def _m(path, leaf):
        if leaf.dim() >= 2 and (filter_fn is None or filter_fn(path, leaf)):
            return sparsity_target_mask(leaf, q_prune)
        return torch.ones_like(leaf)

    return _map_leaves(_m, params)


@torch.no_grad()
def apply_masks(params, masks):
    """params * masks, leaf for leaf (the trees share their structure): new
    tensors, outside autograd."""
    if isinstance(params, dict):
        return {k: apply_masks(v, masks[k]) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(apply_masks(p, m) for p, m in zip(params, masks))
    return params * masks


def iterative_prune(
    params,
    train_some: Callable,  # (params, masks, steps) -> params
    evaluate: Callable,  # (params) -> accuracy in [0,1]
    target_q: float,
    *,
    stages: int = 4,
    refine_steps: int = 200,
    max_acc_drop: float = 0.015,
    filter_fn: Callable | None = None,
):
    """Prune in ``stages`` steps toward target_q, refining in between, as
    the reference does: stage i masks the smallest target_q * i / stages
    of every >= 2-D leaf, refines ``refine_steps`` steps on the masked
    weights and evaluates; the first stage whose accuracy falls more than
    ``max_acc_drop`` below the unpruned accuracy ends the schedule (the
    paper's "maximum accuracy deviation of 1.5%", Section 6.4).  Returns
    (params, masks, achieved_q, history) of the last stage that met it (q
    0 and all-ones masks if none did).  Each stage trains a fresh masked
    copy (``apply_masks``), so ``train_some`` may update its params in
    place without touching a kept stage."""
    base_acc = evaluate(params)
    best = (params, update_masks(params, 0.0, filter_fn), 0.0)
    history = [{"q": 0.0, "acc": base_acc}]
    for i in range(1, stages + 1):
        q = target_q * i / stages
        masks = update_masks(params, q, filter_fn)
        params = apply_masks(params, masks)
        params = train_some(params, masks, refine_steps)
        params = apply_masks(params, masks)
        acc = evaluate(params)
        history.append({"q": q, "acc": acc})
        if base_acc - acc <= max_acc_drop:
            best = (params, masks, q)
        else:
            break
    params, masks, q = best
    return params, masks, q, history


# ---------------------------------------------------------------------------
# Block-granular pruning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockPruneConfig:
    bk: int = 128  # block rows (contraction dim)
    bn: int = 128  # block cols (output dim)
    score: str = "l1"  # block score: l1 | l2 | max


def block_scores(w: torch.Tensor, cfg: BlockPruneConfig) -> torch.Tensor:
    """fp32 score of each (bk, bn) block of a 2-D weight matrix.

    The mean is taken in float64 and rounded once to fp32, so the scores
    order the blocks as the reference's fp32 reduction does (they differ
    only where two blocks tie to the last bit)."""
    K, N = w.shape
    if K % cfg.bk or N % cfg.bn:
        raise ValueError(f"{tuple(w.shape)} not divisible by ({cfg.bk},{cfg.bn})")
    a = w.to(torch.float32).abs().reshape(K // cfg.bk, cfg.bk, N // cfg.bn, cfg.bn)
    a = a.to(torch.float64)
    if cfg.score == "l1":
        s = a.mean(dim=(1, 3))
    elif cfg.score == "l2":
        s = (a * a).mean(dim=(1, 3)).sqrt()
    elif cfg.score == "max":
        s = a.amax(dim=(1, 3))
    else:
        raise ValueError(cfg.score)
    return s.to(torch.float32)


def block_mask(w: torch.Tensor, q_prune: float, cfg: BlockPruneConfig) -> torch.Tensor:
    """(K//bk, N//bn) bool block mask keeping the top (1-q_prune) blocks."""
    s = block_scores(w, cfg)
    flat = s.reshape(-1)
    k = int(round(q_prune * flat.numel()))
    if k == 0:
        return torch.ones_like(s, dtype=torch.bool)
    delta = torch.sort(flat).values[k - 1]
    return s > delta


def expand_block_mask(bmask: torch.Tensor, cfg: BlockPruneConfig) -> torch.Tensor:
    """Block mask -> element mask."""
    return bmask.repeat_interleave(cfg.bk, dim=0).repeat_interleave(cfg.bn, dim=1)


# ---------------------------------------------------------------------------
# Sparse-format accounting (feeds the perf model)
# ---------------------------------------------------------------------------


def element_stream_overhead(r: int = 3, w_bits: int = 16, word_bits: int = 64) -> float:
    """q_overhead of the paper's packed tuple stream: word / (r * w_bits)
    (paper: 64 / (3 * 16) = 1.333...)."""
    return word_bits / (r * w_bits)


def block_format_overhead(cfg: BlockPruneConfig, b_weight: float = 2.0,
                          idx_bytes: int = 4) -> float:
    """q_overhead of the block-sparse format: one int32 index per block."""
    return 1.0 + idx_bytes / (cfg.bk * cfg.bn * b_weight)
