"""The one generator of every traffic mix (``portbench/traffic/<name>.json``).

A mix is data: a closed loop of ``clients`` that each send their next
request when the last one completes, the engine's ``max_batch`` slots, and
length distributions for prompts and outputs ("uniform" or "loguniform"
over whole numbers in [lo, hi]).

Every seed gets the same work in another order.  Requests come in blocks
of ``block``: each block holds the ``block`` quantiles (j + 0.5) / block of
the prompt distribution and the same of the output distribution, each in
an order drawn from the run's ``--seed``, which also draws the prompts'
tokens.  So any stretch of a run sees the mix's distributions, and two
seeds differ in which prompt meets which output, not in the sizes.

The first ``clients`` requests start part-way through their lives:
request i of them keeps (i + 0.5) / clients of its output length, as a
request in flight at a random moment would, so that completions begin at
once and the run reaches its steady mix early.

The mixture of lengths follows ``repro_torch.serving.loadgen``'s
``LengthMixture``, whose schedules are data in the same way; this module
does not import it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from portbench import weights as W

# the requests a run plans: more than a window at any rate the port reaches
CLOSED_POOL = 4096


@dataclasses.dataclass
class Planned:
    """One request of a run: its tokens and its output length."""

    uid: int
    prompt: np.ndarray
    max_new: int


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n quantiles (j + 0.5) / n of a length distribution."""
    lo, hi = int(dist["lo"]), int(dist["hi"])
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "uniform":
        x = lo + u * (hi + 1 - lo)
    elif dist["dist"] == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.floor(x).astype(np.int64), lo, hi)


def max_context(traffic: dict) -> int:
    """The longest prompt plus the longest output the mix can send."""
    return int(traffic["prompt"]["hi"]) + int(traffic["output"]["hi"])


def plan(traffic: dict, vocab: int, seed: int) -> list:
    """The run's CLOSED_POOL requests in the order they are sent."""
    B = int(traffic["block"])
    n = CLOSED_POOL
    n_blocks = -(-n // B)
    order_rng = np.random.default_rng(W.derive_seed(seed, W.TAG_PROMPTS, 0))
    tok_rng = np.random.default_rng(W.derive_seed(seed, W.TAG_PROMPTS, 1))
    pq, oq = quantiles(traffic["prompt"], B), quantiles(traffic["output"], B)
    prompts, outputs = [], []
    for _ in range(n_blocks):
        prompts.append(pq[order_rng.permutation(B)])
        outputs.append(oq[order_rng.permutation(B)])
    prompts = np.concatenate(prompts)[:n]
    outputs = np.concatenate(outputs)[:n]
    clients = int(traffic["clients"])
    for i in range(min(clients, n)):
        outputs[i] = max(1, int(math.ceil(outputs[i] * (i + 0.5) / clients)))
    return [Planned(uid=uid, prompt=tok_rng.integers(0, vocab, size=int(prompts[uid]),
                                                     dtype=np.int32),
                    max_new=int(outputs[uid])) for uid in range(n)]
