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
import torch.distributed as dist

from repro_torch.core.weight_plan import flatten_leaves, unflatten_leaves
from repro_torch.distributed import shardlib as sl


def _int8_codec(g: torch.Tensor, whole=None) -> torch.Tensor:
    amax = g.abs().max()
    if whole is not None:  # the max over the whole leaf
        amax = sl.reduce_over(amax, sl.spec_axes(whole.spec), whole.mesh, op=dist.ReduceOp.MAX)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(g.dtype) * scale


def _topk_codec(g: torch.Tensor, frac: float = 0.1, whole=None) -> torch.Tensor:
    full = g if whole is None else sl.gather_whole(g, whole.spec, whole.mesh)
    if full.numel() <= 16:
        return g
    k = max(1, int(full.numel() * frac))
    flat = full.abs().reshape(-1)
    thresh = torch.kthvalue(flat, flat.numel() - k + 1).values  # the k-th largest
    return torch.where(g.abs() >= thresh, g, torch.zeros_like(g))


@torch.no_grad()
def compress_tree(grads, opt_state: dict, kind: str = "int8", topk_frac: float = 0.1,
                  placement=None):
    """Compress every >= 2-D gradient leaf with error feedback; a leaf of
    lower rank passes through and its residual is zero.  Returns (new
    grads, new opt_state); the "ef" tree of ``opt_state`` is updated in
    place.  Raises ValueError without one: create it with
    ``optimizer.init_opt_state(..., error_feedback=True)``.

    With a ``placement`` (``optimizer.Placement``) the gradients and ``ef``
    are a rank's pieces of the leaves, summed over the data replicas, and
    each codec keeps its whole-leaf meaning: the int8 scale is the max over
    the whole leaf (a MAX over the axes that split it), the top-k threshold
    the k-th largest magnitude of the whole leaf (gathered for
    ``kthvalue``)."""
    if "ef" not in opt_state:
        raise ValueError(
            "gradient compression needs opt_state['ef']; init with error_feedback=True")
    out = []
    for i, (g, e) in enumerate(zip(flatten_leaves(grads), flatten_leaves(opt_state["ef"]))):
        if g.dim() < 2:
            e.zero_()
            out.append(g)
            continue
        gc = g + e
        whole = None  # the leaf's spec where the rank holds a piece of it
        if placement is not None and placement.split_axes(i):
            whole = sl.Spec(placement.param_specs[i], placement.mesh)
        if kind == "int8":
            dec = _int8_codec(gc, whole)
        elif kind == "topk":
            dec = _topk_codec(gc, topk_frac, whole)
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
