"""Data pipeline (port of ``repro/data/pipeline.py``; numpy only, so the
reference's code carries over line for line and its batches are equal
element for element): deterministic synthetic streams and file-backed
token shards.

Multi-host discipline: every source takes (host_index, host_count) and
yields only this host's slice of the global batch, with a seed schedule that
is a pure function of (seed, step) -- restart-safe resumption (restoring a
checkpoint at step k and re-seeking the pipeline reproduces the exact
batch sequence, no iterator state to checkpoint).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

# ---------------------------------------------------------------------------
# LM token streams
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.host_count == 0
        return self.global_batch // self.host_count


def synthetic_lm_batch(cfg: LMDataConfig, step: int) -> dict:
    """Markov-ish synthetic tokens: next token depends on the previous one,
    so the LM loss actually decreases during training (a pure-uniform stream
    would pin loss at log V and hide training bugs)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_index])
    )
    B, S, V = cfg.host_batch, cfg.seq_len, cfg.vocab
    base = rng.integers(0, V, size=(B, 1), dtype=np.int64)
    steps = rng.integers(1, 17, size=(B, S), dtype=np.int64)
    noise = rng.integers(0, V, size=(B, S), dtype=np.int64)
    use_noise = rng.random((B, S)) < 0.05
    toks = (base + np.cumsum(steps, axis=1)) % V
    toks = np.where(use_noise, noise, toks)
    tokens = toks.astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    return {"tokens": tokens, "labels": labels}


def synthetic_lm_stream(cfg: LMDataConfig, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield synthetic_lm_batch(cfg, step)
        step += 1


class TokenFileSource:
    """Memory-mapped binary token shard (int32 little-endian).

    Each host strides through the file with (host_index, host_count) offsets
    so the global batch is disjoint across hosts; the cursor is derivable
    from the step — no pipeline state in checkpoints.
    """

    def __init__(self, path: str, cfg: LMDataConfig):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        need = cfg.seq_len + 1
        self.n_windows = len(self.tokens) // need
        if self.n_windows < cfg.global_batch:
            raise ValueError("token file too small for one global batch")

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        need = cfg.seq_len + 1
        idx0 = (step * cfg.global_batch + cfg.host_index * cfg.host_batch) % self.n_windows
        rows = [(idx0 + i) % self.n_windows for i in range(cfg.host_batch)]
        windows = np.stack([self.tokens[r * need : r * need + need] for r in rows])
        return {
            "tokens": windows[:, :-1].astype(np.int32),
            "labels": windows[:, 1:].astype(np.int32),
        }


# ---------------------------------------------------------------------------
# paper benchmarks: synthetic MNIST/HAR-like classification tasks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClassifyDataConfig:
    n_features: int  # 784 (MNIST) / 561 (HAR)
    n_classes: int  # 10 / 6
    n_train: int = 8192
    n_test: int = 2048
    seed: int = 0


def synthetic_classification(cfg: ClassifyDataConfig) -> dict:
    """A learnable task with MNIST/HAR dimensionalities: a random 2-layer
    teacher net labels gaussian-mixture inputs.  Real datasets are not
    redistributable offline; what Table 4 needs is a task where pruning's
    accuracy effect is measurable, which this provides.
    """
    rng = np.random.default_rng(cfg.seed)
    F, C = cfg.n_features, cfg.n_classes
    centers = rng.normal(size=(C, F)).astype(np.float32) * 0.5
    w1 = rng.normal(size=(F, 64)).astype(np.float32) / np.sqrt(F)
    w2 = rng.normal(size=(64, C)).astype(np.float32) / 8.0

    def make(n):
        y0 = rng.integers(0, C, size=n)
        x = centers[y0] + 0.9 * rng.normal(size=(n, F)).astype(np.float32)
        h = np.maximum(x @ w1, 0.0)
        y = np.argmax(h @ w2 + 2.4 * np.eye(C)[y0], axis=1)  # teacher + prior
        return x.astype(np.float32), y.astype(np.int32)

    xtr, ytr = make(cfg.n_train)
    xte, yte = make(cfg.n_test)
    return {"x_train": xtr, "y_train": ytr, "x_test": xte, "y_test": yte}


def minibatches(x, y, batch: int, seed: int = 0) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    while True:
        idx = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            j = idx[i : i + batch]
            yield {"x": x[j], "y": y[j]}
