"""RG-LRU recurrence block (port of ``repro/models/recurrent.py``;
RecurrentGemma / Griffin, arXiv:2402.19427): the temporal-mixing block of
the ``rec`` layer kind.  A GELU gate branch and a main branch (causal conv,
then the RG-LRU) are multiplied and projected back to d_model.

The recurrence h_t = a_t * h_{t-1} + b_t runs as one fused step at decode
(S == 1) and, over a prompt, as a log-depth parallel scan of the combine
(a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2): ceil(log2(S + 1)) elementwise
passes where the reference calls ``jax.lax.associative_scan`` (no Pallas
kernel either way; a loop over 2048 positions would be thousands of eager
launches a layer).  The state -- h (B, W) fp32 and the conv's last W-1
inputs -- is fixed-size and rewritten whole each step; training runs the
scan under autograd from a zero state (``state=None``).

On a mesh the block splits its channels over the model axis ("ff"): a
rank projects ``w_x`` and ``w_gate`` onto its columns, convolves and scans
its channels only (every op is per channel), and ``w_out`` contracts them
into a partial sum that ``sharded_linear`` all-reduces.  Its state holds
the rank's channels of its data replica's rows ("batch", "ff").  Where
the model axis does not divide the width, everything stays whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.weight_plan import GATE_ACTS, residual_linear, sharded_linear
from repro_torch.distributed import shardlib as sl
from repro_torch.models.ssm import causal_conv

_C = 8.0  # Griffin's recurrence sharpness constant


def rglru_shapes(cfg) -> dict:
    """One RG-LRU block's params as {name: (shape, init)} (``init_rglru``):
    ``lam`` so that a = exp(-c softplus(lam)) lies in (0.9, 0.999)."""
    d = cfg.d_model
    w = cfg.lru_dim or d
    return {
        "w_x": ((d, w), "dense"), "w_gate": ((d, w), "dense"),
        "conv": ((cfg.conv_width, w), "conv"),
        "lam": ((w,), "lru_lambda"),
        "w_rgate": ((w,), "gate"), "b_rgate": ((w,), "zeros"),
        "w_igate": ((w,), "gate"), "b_igate": ((w,), "zeros"),
        "w_out": ((w, d), "dense"),
    }


def rglru_axes() -> dict:
    return {
        "w_x": ("d", "ff"), "w_gate": ("d", "ff"), "conv": (None, "ff"),
        "lam": ("ff",), "w_rgate": ("ff",), "b_rgate": ("ff",),
        "w_igate": ("ff",), "b_igate": ("ff",), "w_out": ("ff", "d"),
    }


# the RG-LRU state is a fixed-size summary the step rewrites (not positional)
_RGLRU_STATE_AXES = sl.register_cache_kind(
    "rec.state", {"h": ("batch", "ff"), "conv": ("batch", None, "ff")},
    positional=False, family="recurrent")


def rglru_state_axes() -> dict:
    return dict(_RGLRU_STATE_AXES)


def lru_lambda(shape, generator: torch.Generator, device):
    """softplus^-1(-log(u) / c) for u uniform in (0.9, 0.999)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = 0.9 + 0.099 * u
    return torch.log(torch.expm1(-torch.log(u) / _C))


def init_rglru_state(cfg, batch: int, dtype=torch.float32, device="cpu") -> dict:
    """h (B, W) fp32 and the conv state (B, W-1, W) in ``dtype`` (the
    compute dtype)."""
    w = cfg.lru_dim or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype, device=device)}


def linear_scan(a, b, h0):
    """h_t = a_t h_{t-1} + b_t over axis 1 of a, b (B, S, ...) from h0 (B,
    ...): Hillis-Steele doubling over the sequence [(1, h0), (a_1, b_1),
    ...] with the reference's combine.  Returns h (B, S, ...)."""
    A = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
    Bv = torch.cat([h0[:, None].to(b.dtype), b], dim=1)
    d = 1
    while d < A.shape[1]:
        # element t combines with t - d: (A[t-d], B[t-d]) o (A[t], B[t])
        Bv = torch.cat([Bv[:, :d], A[:, d:] * Bv[:, :-d] + Bv[:, d:]], dim=1)
        A = torch.cat([A[:, :d], A[:, :-d] * A[:, d:]], dim=1)
        d *= 2
    return Bv[:, 1:]


def apply_rglru(cfg, p, x, state=None, seq: bool = False):
    """x (B, S, d) -> (y, new state); on a mesh over the rank's channels
    (see the module doc).  ``state`` None (training) starts from zeros of
    the rank's channels.  ``seq`` (sequence parallelism): y is the rank's
    piece of the sequence (``weight_plan.residual_linear``)."""
    B, S, _ = x.shape
    dt = x.dtype
    gate, split = sharded_linear(x, p["w_gate"])
    gate = GATE_ACTS["gelu"](gate)
    u, _ = sharded_linear(x, p["w_x"])
    if state is None:
        state = {"h": torch.zeros((B, u.shape[-1]), dtype=torch.float32, device=x.device),
                 "conv": None}
    u, conv_state = causal_conv(u, p["conv"], state["conv"])
    uf = u.float()
    # input-dependent diagonal gates
    r = torch.sigmoid(uf * p["w_rgate"] + p["b_rgate"])
    i = torch.sigmoid(uf * p["w_igate"] + p["b_igate"])
    log_a = -_C * F.softplus(p["lam"]) * r  # <= 0
    a = torch.exp(log_a)
    # sqrt(1 - a^2), stably: exp(log1p(-exp(2 log a)) / 2)
    beta = torch.exp(0.5 * torch.log1p(-torch.exp(torch.clamp_max(2.0 * log_a, -1e-6))))
    b = beta * (i * uf)
    if S == 1:
        h = a[:, 0] * state["h"] + b[:, 0]
        hs = h[:, None]
    else:
        hs = linear_scan(a, b, state["h"])
        h = hs[:, -1]
    y = residual_linear(hs.to(dt) * gate, p["w_out"], split, seq)
    return y, {"h": h, "conv": conv_state}
