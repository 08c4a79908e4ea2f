"""The output check that decides a run's ``correct``.

Once the window has closed and the port's state is freed, a sample of the
requests the run finished -- the one with the most served tokens, then
others in an order drawn from the seed, until ``sample_tokens`` served
tokens -- is run through the plain reference (``reference/model.py``) over
each prompt with its served tokens.  For every served token the reference
reads how far its logit lies below the reference's best logit at that
position.  Two numbers are read: the widest such gap over the sample,
``max_logit_gap``, and their mean over the sample's served tokens,
``mean_logit_gap``; ``portbench/checks/<cell>.json`` gives a limit to each
number the cell compares.
A greedy token that the reference would also pick reads 0; a token that
the port's rounding turned at a near tie reads about that rounding; a
token altered anywhere on the path reads about the logits' spread.

``fp8_max_gap`` and ``fp8_mean_gap`` read the control of the same sample:
the reference in float8 (``precision="fp8"``) put in the port's place,
the gap of the token that it puts first at each position.  ``bf16_*``
read the reference in bfloat16 the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import weights as W
from portbench.reference.model import Reference


def sample(records: list, seed: int, target_tokens: int, since: float) -> list:
    """The records to check: finished at or after ``since``, the longest
    first, then in an order drawn from the seed until their served tokens
    reach ``target_tokens``."""
    done = [r for r in records if r.finished and r.finish_t is not None and r.finish_t >= since]
    if not done:
        return []
    done.sort(key=lambda r: r.uid)
    longest = max(done, key=lambda r: (len(r.output), -r.uid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(W.derive_seed(seed, W.TAG_SAMPLE))
    picked, total = [longest], len(longest.output)
    for i in rng.permutation(len(rest)):
        if total >= target_tokens:
            break
        picked.append(rest[i])
        total += len(rest[i].output)
    return picked


def gaps(logits: torch.Tensor, tokens) -> torch.Tensor:
    """Each row's best logit minus the logit of its token (inf for a token
    the model cannot have produced)."""
    tok = torch.as_tensor(list(map(int, tokens)), dtype=torch.long, device=logits.device)
    if tok.numel() != logits.shape[0] or bool(((tok < 0) | (tok >= logits.shape[1])).any()):
        return torch.full((logits.shape[0],), float("inf"))
    best = logits.max(dim=-1).values
    return (best - logits.gather(1, tok[:, None])[:, 0]).cpu()


def readings(config: dict, seed: int, picked: list, device, others=()) -> dict:
    """{"max_logit_gap", "mean_logit_gap": the port's readings, "tokens":
    served tokens read, and for each precision p of ``others`` ("fp8",
    "bf16") "p_max_gap", "p_mean_gap": the reference's in p}."""
    ref = Reference(config, seed, device)
    seqs = [(r.prompt, r.output) for r in picked]
    out = ref.logits(seqs, ("fp32",) + tuple(others))
    g = torch.cat([gaps(lg, r.output) for lg, r in zip(out["fp32"], picked)])
    res = {"max_logit_gap": float(g.max()), "mean_logit_gap": float(g.mean()),
           "tokens": int(g.numel())}
    for p in others:
        c = torch.cat([gaps(lg, lo.argmax(dim=-1).tolist())
                       for lg, lo in zip(out["fp32"], out[p])])
        res[f"{p}_max_gap"], res[f"{p}_mean_gap"] = float(c.max()), float(c.mean())
    return res
