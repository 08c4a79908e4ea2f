"""Gradient compression with error feedback (port of
``repro/distributed/compression.py``).

Two codecs, applied to the gradient before the optimizer (before the
data-parallel all-reduce, where there is one), so the payload shrinks:

  * int8: per-tensor symmetric int8 quantization of the gradient
    (``torch.round`` rounds half to even, as ``jnp.round`` does);
  * topk: keep the top-k fraction of entries by magnitude, every entry at
    or above the k-th largest magnitude (ties kept, as the reference's
    ``>=`` against ``top_k``'s last value keeps them).

Error feedback: the residual (g - decode(encode(g))) is carried in the
optimizer state's "ef" tree and added back next step, which keeps these
convergent (Karimireddy et al., 2019).  The codecs are value-level
(quantize-dequantize); ``payload_bytes`` counts the bytes a wire format
would carry.
"""

from __future__ import annotations

import torch

from repro_torch.core.weight_plan import flatten_leaves, unflatten_leaves


def _int8_codec(g: torch.Tensor) -> torch.Tensor:
    amax = g.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(g.dtype) * scale


def _topk_codec(g: torch.Tensor, frac: float = 0.1) -> torch.Tensor:
    if g.numel() <= 16:
        return g
    k = max(1, int(g.numel() * frac))
    flat = g.abs().reshape(-1)
    thresh = torch.kthvalue(flat, flat.numel() - k + 1).values  # the k-th largest
    return torch.where(g.abs() >= thresh, g, torch.zeros_like(g))


@torch.no_grad()
def compress_tree(grads, opt_state: dict, kind: str = "int8", topk_frac: float = 0.1):
    """Compress every >= 2-D gradient leaf with error feedback; a leaf of
    lower rank passes through and its residual is zero.  Returns (new
    grads, new opt_state); the "ef" tree of ``opt_state`` is updated in
    place.  Raises ValueError without one: create it with
    ``optimizer.init_opt_state(..., error_feedback=True)``."""
    if "ef" not in opt_state:
        raise ValueError(
            "gradient compression needs opt_state['ef']; init with error_feedback=True")
    out = []
    for g, e in zip(flatten_leaves(grads), flatten_leaves(opt_state["ef"])):
        if g.dim() < 2:
            e.zero_()
            out.append(g)
            continue
        gc = g + e
        if kind == "int8":
            dec = _int8_codec(gc)
        elif kind == "topk":
            dec = _topk_codec(gc, topk_frac)
        else:
            raise ValueError(kind)
        e.copy_(gc - dec)
        out.append(dec)
    return unflatten_leaves(grads, out), dict(opt_state)


def payload_bytes(grads, kind: str | None, topk_frac: float = 0.1) -> float:
    """Bytes on the wire per replica for the gradient all-reduce."""
    n = sum(g.numel() for g in flatten_leaves(grads))
    if kind is None:
        return 4.0 * n
    if kind == "int8":
        return 1.0 * n
    if kind == "topk":
        return (4.0 + 4.0) * n * topk_frac  # value + index
    raise ValueError(kind)
