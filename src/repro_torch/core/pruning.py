"""Block pruning (port of the block-granular part of ``repro/core/pruning.py``).

Weights are scored and removed in (bk, bn) blocks, so a kernel can skip a
whole block: both the bytes streamed and the MACs scale with (1 - q_prune),
the paper's Section 4.3 claim at a granularity the hardware can exploit.

Pack parity with the reference rests on three details kept here: fp32
scores, the threshold ``sort(scores)[k - 1]`` and the strict ``s > delta``.
"""

from __future__ import annotations

import dataclasses

import torch


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
