"""xLSTM blocks (port of ``repro/models/ssm.py``; arXiv:2405.04517): the
mLSTM (a per-head matrix memory, exponential gating) and the sLSTM (scalar
memory, exponential gating, a per-head recurrence), and the depthwise
causal convolution they share with the RG-LRU block (``models/recurrent``).

Each block maps (B, S, d) to (B, S, d) and returns its new state, a dict of
fixed-size tensors: prefill (S > 1) and decode (S == 1) run the same code.
The states are not positionally addressed -- a step rewrites them whole --
so they are neither paged nor written speculatively
(``api.supports_spec_decode``).  The reference has no Pallas kernel here:
the recurrences are plain PyTorch, and every projection goes through
``apply_linear`` (kernels B1/B4 or B5 under a compressed plan).

The mLSTM's prefill is the chunkwise-parallel form (``_mlstm_chunkwise``,
chunks of ``min(MLSTM_CHUNK, S)``); ``mlstm_sequential`` is the per-token
recurrence it equals, which decode runs one step of.  The sLSTM's prefill
is a loop over the tokens.  Training runs the same forwards under autograd
from a zero state (``state=None``).

On a mesh (``distributed/shardlib``) the mLSTM runs on the rank's
channels of the 2d up projection ("ff": ``w_u``, ``w_z``, the conv and
the q/k/v scales), which are whole heads wherever the model axis divides
H; ``w_if`` stays whole, so every rank computes all 2H gates and takes
its heads' i and f.  Its state holds the rank's heads (C, n, m) and
channels (conv); ``w_down`` contracts the rank's channels into a partial
sum that ``sharded_linear`` all-reduces (a packed leaf stays whole and
gathers them first, ROADMAP C1).  Where the model axis splits the
channels but not the heads, the rank convolves its channels and gathers
them before the recurrence, which then runs whole.  The sLSTM's state is
whole on every rank of a data replica, as the reference's axes say: a
rank projects its columns of ``w_gates`` (a cut by gate, not by head) and
gathers them once a call, before the token loop; ``r_gates`` is placed
whole (``placement_axes``, a ROADMAP C1 departure from the reference's
head split), so the loop runs with no collective; ``w_up``'s product
columns are gathered once before ``GELU(a) * b``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.weight_plan import GATE_ACTS, apply_linear, residual_linear, sharded_linear
from repro_torch.distributed import shardlib as sl

# the sequence-start value of the mLSTM / sLSTM stabilizer m
M_INIT = -1e30
# the mLSTM prefill's chunk length (min(MLSTM_CHUNK, S) tokens a chunk)
MLSTM_CHUNK = 64


def _log_sigmoid(x):
    """log sigmoid(x) as the reference writes it: -softplus(-x)."""
    return -F.softplus(-x)


def causal_conv(u, w, state=None):
    """Depthwise causal convolution: u (B, S, F), w (W, F); ``state`` (B,
    W-1, F) carries the last W-1 inputs across calls (zeros when None).
    Returns (y (B, S, F), the new state), in u's dtype, summed tap by tap
    in the reference's order."""
    B, S, Fd = u.shape
    W = w.shape[0]
    if state is None:
        state = torch.zeros((B, W - 1, Fd), dtype=u.dtype, device=u.device)
    full = torch.cat([state.to(u.dtype), u], dim=1)  # (B, S + W - 1, F)
    y = full[:, 0:S] * w[0].to(u.dtype)
    for i in range(1, W):
        y = y + full[:, i:i + S] * w[i].to(u.dtype)
    return y, full[:, S:]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_shapes(cfg) -> dict:
    """One mLSTM cell's params as {name: (shape, init)} (``init_mlstm``)."""
    d, H = cfg.d_model, cfg.n_heads
    up = 2 * d
    return {
        "w_u": ((d, up), "dense"), "w_z": ((d, up), "dense"),
        "conv": ((cfg.conv_width, up), "conv"),
        "s_q": ((up,), "ones"), "s_k": ((up,), "ones"), "s_v": ((up,), "ones"),
        "w_if": ((d, 2 * H), "dense"),
        # forget-gate bias 3: remember by default
        "b_if": ((2 * H,), "forget_bias/2"),
        "w_down": ((up, d), "dense"),
    }


def mlstm_axes(cfg) -> dict:
    return {
        "w_u": ("d", "ff"), "w_z": ("d", "ff"), "conv": (None, "ff"),
        "s_q": ("ff",), "s_k": ("ff",), "s_v": ("ff",),
        "w_if": ("d", None), "b_if": (None,), "w_down": ("ff", "d"),
    }


_MLSTM_STATE_AXES = sl.register_cache_kind(
    "mlstm.state",
    {"C": ("batch", "heads", None, None), "n": ("batch", "heads", None),
     "m": ("batch", "heads"), "conv": ("batch", None, "ff")},
    positional=False, family="ssm")


def mlstm_state_axes() -> dict:
    return dict(_MLSTM_STATE_AXES)


def init_mlstm_state(cfg, batch: int, dtype=torch.float32, device="cpu") -> dict:
    """C (B, H, hd, hd), n (B, H, hd) and m (B, H) in fp32, m at M_INIT; the
    conv state (B, W-1, 2d) in ``dtype`` (the compute dtype)."""
    up, H = 2 * cfg.d_model, cfg.n_heads
    hd = up // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, H, hd, hd), **f32),
        "n": torch.zeros((batch, H, hd), **f32),
        "m": torch.full((batch, H), M_INIT, **f32),
        "conv": torch.zeros((batch, cfg.conv_width - 1, up), dtype=dtype, device=device),
    }


def _mlstm_zeros(batch: int, heads: int, hd: int, device) -> dict:
    """A zero mLSTM state of ``heads`` heads (m at M_INIT) with no conv
    state (``causal_conv`` starts from zeros)."""
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, heads, hd, hd), **f32),
            "n": torch.zeros((batch, heads, hd), **f32),
            "m": torch.full((batch, heads), M_INIT, **f32), "conv": None}


def mlstm_sequential(q, k, v, i_raw, f_raw, C, n, m):
    """The exact per-token recurrence: q/k/v (B, S, H, hd), i/f (B, S, H);
    state C (B, H, hd, hd), n (B, H, hd), m (B, H), all fp32.  Returns (h
    (B, S, H * hd) fp32, C, n, m)."""
    B, S, H, hd = q.shape
    q, k, v = q.float(), k.float(), v.float()
    hs = []
    for t in range(S):
        logf = _log_sigmoid(f_raw[:, t])
        m_new = torch.maximum(logf + m, i_raw[:, t])
        fg = torch.exp(logf + m - m_new)
        ig = torch.exp(i_raw[:, t] - m_new)
        C = fg[..., None, None] * C + ig[..., None, None] * (
            v[:, t, :, :, None] * k[:, t, :, None, :])
        n = fg[..., None] * n + ig[..., None] * k[:, t]
        h_num = torch.einsum("bhvk,bhk->bhv", C, q[:, t])
        h_den = torch.einsum("bhk,bhk->bh", n, q[:, t]).abs().clamp_min(1.0)
        hs.append(h_num / h_den[..., None])
        m = m_new
    return torch.stack(hs, dim=1).reshape(B, S, H * hd), C, n, m


def _mlstm_chunkwise(q, k, v, i_raw, f_raw, C0, n0, m0, chunk: int):
    """The chunkwise-parallel mLSTM, equal to ``mlstm_sequential`` (the
    reference's derivation, ``ssm.py:159-240``): inside a chunk of L
    tokens the outputs are (L x L) and (L x hd) products against the
    carried state, which updates once a chunk.  Padded tokens (S not a
    multiple of L) take i = -1e30 (weight 0) and f = +1e30 (no decay).
    Shapes as ``mlstm_sequential``'s."""
    B, S, H, hd = q.shape
    Lc = chunk
    pad = (-S) % Lc
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=-1e30)
        f_raw = F.pad(f_raw, (0, 0, 0, pad), value=1e30)
    nC = q.shape[1] // Lc

    def chunks(x):  # (B, S, H, ...) -> (nC, B, H, Lc, ...)
        x = x.reshape((B, nC, Lc) + tuple(x.shape[2:]))
        return x.permute((1, 0, 3, 2) + tuple(range(4, x.dim())))

    qc, kc, vc = (chunks(t).float() for t in (q, k, v))
    ic, fc = chunks(i_raw), chunks(f_raw)  # (nC, B, H, Lc)
    causal = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=q.device))
    C, n, m = C0, n0, m0
    hs = []
    for c in range(nC):
        qi, ki, vi, ii = qc[c], kc[c], vc[c], ic[c]
        Fc = torch.cumsum(_log_sigmoid(fc[c]), dim=-1)  # (B, H, Lc)
        u = ii - Fc
        M = torch.maximum(m[..., None], torch.cummax(u, dim=2).values)
        w_mem = torch.exp(m[..., None] - M)
        D = torch.exp(u[..., None, :] - M[..., :, None])  # (B, H, Lc_t, Lc_tau)
        D = torch.where(causal, D, torch.zeros_like(D))
        s = torch.einsum("bhtd,bhsd->bhts", qi, ki) * D
        intra = torch.einsum("bhts,bhsv->bhtv", s, vi)
        inter = torch.einsum("bhvk,bhtk->bhtv", C, qi) * w_mem[..., None]
        den = torch.einsum("bhk,bhtk->bht", n, qi) * w_mem + s.sum(-1)
        hs.append((inter + intra) / den.abs().clamp_min(1.0)[..., None])
        ML = torch.maximum(m, u.amax(-1))
        wL_mem = torch.exp(m - ML)
        wL = torch.exp(u - ML[..., None])
        C = wL_mem[..., None, None] * C + torch.einsum("bhs,bhsv,bhsk->bhvk", wL, vi, ki)
        n = wL_mem[..., None] * n + torch.einsum("bhs,bhsk->bhk", wL, ki)
        m = Fc[..., -1] + ML
    h = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(B, nC * Lc, H * hd)[:, :S]
    return h, C, n, m


def apply_mlstm(cfg, p, x, state=None, seq: bool = False):
    """x (B, S, d) -> (y, new state).  S == 1 (decode) is one step of the
    exact recurrence; S > 1 the chunkwise form with chunks of
    min(MLSTM_CHUNK, S).  On a mesh over the rank's channels and heads
    (see the module doc); ``seq`` (sequence parallelism): y is the rank's
    piece of the sequence."""
    B, S, d = x.shape
    up, H = 2 * d, cfg.n_heads
    hd = up // H
    dt = x.dtype
    if state is None:  # training: zeros of the rank's heads ("heads", as its cache's)
        split = sl.spec_for((H,), "heads") == ("model",)
        state = _mlstm_zeros(B, H // sl.axis_size("model") if split else H, hd, x.device)
    # the rank's channels are its conv's (its piece, or all of them)
    nc = p["conv"].shape[-1]
    c0 = sl.axis_index("model") * nc if nc < up else 0
    u, us = sharded_linear(x, p["w_u"])
    z, zs = sharded_linear(x, p["w_z"])
    u, z = sl.cols(u, us, c0, nc), sl.cols(z, zs, c0, nc)
    uc, conv_state = causal_conv(u, p["conv"], state["conv"])
    uc = F.silu(uc)
    q = uc * p["s_q"].to(dt)
    k = uc * p["s_k"].to(dt)
    v = u * p["s_v"].to(dt)
    # the rank's heads are its state's; a whole tensor enters its heads' work
    nh = state["C"].shape[1]
    h0 = sl.axis_index("model") * nh if nh < H else 0
    if nc != nh * hd:  # channels split, heads whole: the recurrence runs whole
        q, k, v, z = (sl.cols(t, True, 0, up) for t in (q, k, v, z))
    q = q.reshape(B, S, nh, hd)
    k = k.reshape(B, S, nh, hd) / math.sqrt(hd)
    v = v.reshape(B, S, nh, hd)
    gates = apply_linear(x, p["w_if"]) + p["b_if"].to(dt)  # whole ("d", None)
    i_raw, f_raw = (sl.cols(g, False, h0, nh) for g in gates.float().chunk(2, dim=-1))
    if S > 1:
        h, C, n, m = _mlstm_chunkwise(q, k, v, i_raw, f_raw, state["C"], state["n"],
                                      state["m"], chunk=min(MLSTM_CHUNK, S))
    else:
        h, C, n, m = mlstm_sequential(q, k, v, i_raw, f_raw, state["C"], state["n"],
                                      state["m"])
    y = residual_linear(h.to(dt) * F.silu(z), p["w_down"], nh < H, seq)
    return y, {"C": C, "n": n, "m": m, "conv": conv_state}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_up(cfg) -> int:
    """The width of the sLSTM's gated up projection: round(4 d / 3)."""
    return max(8, int(round(cfg.d_model * 4 / 3)))


def slstm_shapes(cfg) -> dict:
    """One sLSTM cell's params as {name: (shape, init)} (``init_slstm``)."""
    d, H = cfg.d_model, cfg.n_heads
    hd, f_up = d // H, slstm_up(cfg)
    return {
        "w_gates": ((d, 4 * d), "dense"),  # i, f, z, o
        "r_gates": ((4, H, hd, hd), "recurrent"),
        "b_gates": ((4 * d,), "forget_bias/4"),
        "w_up": ((d, 2 * f_up), "dense"),
        "w_down": ((f_up, d), "dense"),
    }


def slstm_axes(cfg) -> dict:
    return {
        "w_gates": ("d", "qkv"), "r_gates": (None, "heads", None, None),
        "b_gates": (None,), "w_up": ("d", "ff"), "w_down": ("ff", "d"),
    }


def placement_axes(axes_tree, moments: bool = False):
    """``axes_tree`` (a params tree's logical axes) with every sLSTM
    ``r_gates`` whole: the recurrence runs whole on every rank, so a mesh
    places it whole once instead of gathering its heads every call
    (ROADMAP C1).  ``moments``: the axes of its ZeRO-1 moments on a
    training mesh instead, its heads over "zero" (the data axes)."""
    def whole(axes):  # (..., 4, H, hd, hd): any stacked layer axes in front
        return tuple("zero" if moments and i == len(axes) - 3 else None
                     for i in range(len(axes)))

    if isinstance(axes_tree, dict):
        return {k: whole(v) if k == "r_gates" else placement_axes(v, moments)
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [placement_axes(v, moments) for v in axes_tree]
    return axes_tree


_SLSTM_STATE_AXES = sl.register_cache_kind(
    "slstm.state",
    {"c": ("batch", None), "n": ("batch", None), "h": ("batch", None), "m": ("batch", None)},
    positional=False, family="ssm")


def slstm_state_axes() -> dict:
    return dict(_SLSTM_STATE_AXES)


def init_slstm_state(cfg, batch: int, dtype=torch.float32, device="cpu") -> dict:
    """c, n, h (B, d) at 0 and m at M_INIT, all fp32 (the reference keeps
    every sLSTM state in fp32; ``dtype`` is taken for a uniform
    signature)."""
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32), "n": torch.zeros((batch, d), **f32),
            "h": torch.zeros((batch, d), **f32), "m": torch.full((batch, d), M_INIT, **f32)}


def slstm_step(r, gates, c, n, h, m) -> tuple:
    """One token of the sLSTM recurrence: the gate pre-activations ``gates``
    (B, 4 d) of the token plus the (4, H, hd, hd) product ``r`` with the
    previous h, then the stabilised exponential gating.  Returns the new
    (c, n, h, m), each (B, d) fp32."""
    B, d = h.shape
    H, hd = r.shape[1], r.shape[2]
    rec = torch.einsum("ghij,bhj->gbhi", r, h.reshape(B, H, hd)).reshape(4, B, d)
    gi, gf, gz, go = (g + rec[j] for j, g in enumerate(gates.chunk(4, dim=-1)))
    logf = _log_sigmoid(gf)
    m_new = torch.maximum(logf + m, gi)
    fg = torch.exp(logf + m - m_new)
    ig = torch.exp(gi - m_new)
    c = fg * c + ig * torch.tanh(gz)
    n = fg * n + ig
    return c, n, torch.sigmoid(go) * c / n.clamp_min(1.0), m_new


def apply_slstm(cfg, p, x, state=None, seq: bool = False):
    """x (B, S, d) -> (y, new state): the gate pre-activations of every
    token in one projection, then the recurrence token by token (each step
    a (4, H, hd, hd) product with the previous h), then the gated up/down
    projection (tanh GELU); ``seq`` as ``apply_mlstm``'s."""
    B, S, d = x.shape
    dt = x.dtype
    if state is None:
        state = init_slstm_state(cfg, B, dt, x.device)
    gx, gs = sharded_linear(x, p["w_gates"])
    gates_x = (sl.cols(gx, gs, 0, 4 * d) + p["b_gates"].to(dt)).float()
    r = p["r_gates"].float()
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    for t in range(S):
        c, n, h, m = slstm_step(r, gates_x[:, t], c, n, h, m)
        hs.append(h)
    y = torch.stack(hs, dim=1).to(dt)
    ab, abs_ = sharded_linear(y, p["w_up"])
    a, b = sl.cols(ab, abs_, 0, 2 * slstm_up(cfg)).chunk(2, dim=-1)
    y = residual_linear(GATE_ACTS["gelu"](a) * b, p["w_down"], seq=seq)
    return y, {"c": c, "n": n, "h": h, "m": m}
