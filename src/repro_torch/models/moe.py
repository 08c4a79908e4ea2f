"""Top-k routed Mixture-of-Experts FFN with optional shared experts (port
of ``repro/models/moe.py``).

The reference dispatches tokens with one-hot einsums over capacity buckets:
tokens are split into groups of ``_group_size(T)``, each (token, k)
assignment takes the next slot of its expert's group buffer, and an
assignment past the expert's capacity is dropped (its combine weight is
zero).  The port computes the same routing -- the same kept and dropped
assignments, the same slots, the same combine weights rounded to the
compute dtype -- with index arithmetic instead (``route``): a scatter of
the kept tokens into an ``(Ep, nG * C, d)`` expert buffer and a gather of
their outputs.  The expert FFNs run through the weight-plan dispatch over
the stacked ``(Ep, d, f)`` leaves: a packed stack is one launch of B2 for
every gate/up pair of the layer and one of B1 (B4 without walks) for every
down-projection (``weight_plan.apply_gate_up`` / ``apply_linear``).  The
padded experts ``E..Ep`` receive no token but are launched over, as the
reference's vmap runs them.

On a mesh (expert parallelism) a rank holds Ep / M experts of every stack
(``weight_plan.local_leaf``, ``ShardedLeaf.experts``).  The routing stays
global: the rank routes every token of its data replica as above, fills
only its experts' rows of the buffer, runs one stacked B2 and one stacked
B1 over its experts and combines their outputs into a partial sum.  The
shared experts run on the rank's "ff" columns, their ``w_down`` product a
partial sum too, and ONE all-reduce over the model axis a layer adds both.
Where the model axis does not divide Ep the stacks stay whole and no
routed all-reduce is issued (an "expert_ff" rule splits their FFN width
instead, whose ``w_down`` product is then the partial sum).

Training on a mesh runs the same code under autograd.  The rank runs its
data replica's rows, and the routing is the global batch's, as the
reference's jitted step routes it (``replicas``): the group size and the
capacity regime come from the global token count, a replica's rows hold
whole dispatch groups or one part of a group whose other parts are the
next replicas' (each expert's slots then start after the earlier
replicas' assignments, one all-reduce of their counts), and the Switch
loss takes the whole batch's means.  The dispatched tokens and the gate
values enter the rank's experts (or columns) through ``shardlib.fan_out``
and the partial sums meet in ``shardlib.reduce_sum``: Megatron's f and g.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.weight_plan import (
    ShardedLeaf,
    apply_gate_up,
    apply_linear,
    partial_linear,
    sharded_gate_up,
)
from repro_torch.distributed import shardlib as sl
from repro_torch.models import layers as L

# at most this many tokens a step, every expert takes all its assignments
# (a dropped token at decode would corrupt that sequence's output)
FULL_CAPACITY_TOKENS = 256


def moe_shapes(cfg) -> dict:
    """{name: (shape, init)} of one MoE FFN: the router over the real
    experts, the expert stacks over the padded ones.  The reference draws
    the stacks with fan-in on axis 1 (d for gate/up, f for down), which is
    axis -2, the default of ``layers.dense_init`` -- also once the layers
    are stacked in front."""
    m = cfg.moe
    d, f = cfg.d_model, m.expert_d_ff
    Ep = m.n_experts_padded
    p = {
        "router": ((d, m.n_experts), "dense"),
        "w_gate": ((Ep, d, f), "dense"),
        "w_up": ((Ep, d, f), "dense"),
        "w_down": ((Ep, f, d), "dense"),
    }
    if m.n_shared_experts:
        sf = (m.shared_d_ff or m.expert_d_ff) * m.n_shared_experts
        p["shared"] = {"w_gate": ((d, sf), "dense"), "w_up": ((d, sf), "dense"),
                       "w_down": ((sf, d), "dense")}
    return p


def moe_axes(cfg) -> dict:
    """Logical axes of ``moe_shapes``' leaves: the expert stacks over
    "experts", their FFN width over "expert_ff"."""
    a = {
        "router": ("d", None),
        "w_gate": ("experts", "d", "expert_ff"),
        "w_up": ("experts", "d", "expert_ff"),
        "w_down": ("experts", "expert_ff", "d"),
    }
    if cfg.moe.n_shared_experts:
        a["shared"] = {"w_gate": ("d", "ff"), "w_up": ("d", "ff"), "w_down": ("ff", "d")}
    return a


def init_moe(cfg, generator: torch.Generator, device) -> dict:
    """Random params of one MoE FFN with ``moe_shapes``' shapes and scales."""
    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return L.dense_init(node[0], generator, device)

    return make(moe_shapes(cfg))


def _group_size(T: int, target: int = 512) -> int:
    """Largest divisor of T that is <= target (dispatch group size)."""
    g = min(T, target)
    while T % g:
        g -= 1
    return g


def top_k(probs: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest along the last axis, largest
    first and ties to the lower index, as ``jax.lax.top_k`` orders them
    (``torch.topk`` does not promise an order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@dataclasses.dataclass(frozen=True)
class Routing:
    """One MoE call's routing over nG groups of G tokens (K assignments a
    token, in the reference's order: token-major, k-minor).

      probs:    (nG, G, E) fp32 router softmax over the real experts
      idx:      (nG, G, K) int64 expert of each assignment
      gates:    (nG, G, K) fp32 renormalised gate values
      slot:     (nG, G, K) int64 place in its expert's group buffer
      keep:     (nG, G, K) bool  slot < capacity (else dropped)
      capacity: slots per (expert, group)
    """

    probs: torch.Tensor
    idx: torch.Tensor
    gates: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    capacity: int


def route(cfg, xg: torch.Tensor, router: torch.Tensor, *, n_tokens: Optional[int] = None,
          share: int = 1) -> Routing:
    """The reference's routing of xg (nG, G, d): the router in the compute
    dtype, softmax in fp32, top-k renormalised; full capacity up to
    FULL_CAPACITY_TOKENS tokens, else ceil(G * K / E * capacity_factor)
    slots an expert a group, filled in (token, k) order.

    On a training mesh xg is a data replica's part of the global batch of
    ``n_tokens`` tokens (the regime's count), and with ``share`` > 1 it is
    one group's part of ``share`` consecutive replicas' (a group of G *
    share tokens): each expert's slots start after the assignments the
    group's earlier replicas made to it."""
    m = cfg.moe
    nG, G, _ = xg.shape
    K, Ep = m.top_k, m.n_experts_padded
    logits = (xg @ router.to(xg.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    if (n_tokens or nG * G) <= FULL_CAPACITY_TOKENS:
        capacity = G * share
    else:
        capacity = max(1, int(math.ceil(G * share * K / m.n_experts * m.capacity_factor)))
    # an assignment's slot: the earlier assignments of its group to its expert
    onehot = torch.nn.functional.one_hot(idx.reshape(nG, G * K), Ep)
    before = onehot.cumsum(dim=1) - onehot
    if share > 1:
        before = before + _earlier_replicas(onehot.sum(dim=1), share)[:, None]
    slot = before.gather(2, idx.reshape(nG, G * K, 1)).reshape(nG, G, K)
    return Routing(probs, idx, gates, slot, slot < capacity, capacity)


def _earlier_replicas(counts: torch.Tensor, share: int) -> torch.Tensor:
    """Each expert's assignments (1, Ep) in the parts of this replica's
    group that the group's earlier replicas hold: every replica's counts
    summed over the data axes into a table, its own row filled."""
    n, r = sl.data_replicas(), sl.replica_index()
    table = counts.new_zeros((n,) + tuple(counts.shape[1:]))
    table[r] = counts[0]
    table = sl.reduce_batch(table)
    return table[r - r % share:r].sum(dim=0, keepdim=True)


def dispatch_groups(T: int, replicas: int = 1) -> tuple:
    """(groups, share) of a data replica's T tokens of a global batch of
    ``replicas`` * T: its whole groups of ``_group_size`` of the global
    count and 1, or one part of a group (groups 1) and the replicas that
    share it.  Raises ValueError where the replicas' rows cut a group
    elsewhere than between whole parts."""
    G = _group_size(T * replicas)
    if T % G == 0:
        return T // G, 1
    if G % T == 0:
        return 1, G // T
    raise ValueError(f"dispatch groups of {G} tokens straddle the data replicas' rows: "
                     f"{T} tokens a replica of {T * replicas} hold neither whole groups nor "
                     f"whole parts of one (hint: a batch whose replicas' tokens divide or "
                     f"are divided by {G})")


def expert_range(p, Ep: int) -> tuple:
    """(first, count) of the experts this rank's stacks hold: all Ep
    without a mesh or where the stacks stayed whole."""
    got = {k: p[k].experts if isinstance(p[k], ShardedLeaf) else None
           for k in ("w_gate", "w_up", "w_down")}
    if len(set(got.values())) != 1:
        raise ValueError(f"the expert stacks are cut differently: {got}")
    return got["w_gate"] or (0, Ep)


def apply_moe(cfg, p, x: torch.Tensor, return_aux: bool = False, replicas: int = 1,
              seq: bool = False):
    """x (B, S, d) -> (B, S, d) [, the Switch load-balancing loss].
    ``replicas``: the data replicas whose rows make the global batch, x
    being this rank's (training on a mesh; see the module doc).  ``seq``
    (sequence parallelism): the output is the rank's piece of the
    sequence, the ranks' partial sums reduce-scattered.

    Kept tokens are scattered into an (Ep, nG * C, d) buffer (row
    (g * C + slot) of their expert; empty rows are zero, as the reference's
    dispatch einsum leaves them), the experts run over the whole stack, and
    each token sums its kept assignments' outputs weighted by its gate
    values rounded to the compute dtype (the reference's combine tensor).
    Every dropped assignment is copied to the same spare row, which is
    discarded: under autograd its gradient is zero, and a rematerialized
    layer that routes again keeps the same assignments.  On a mesh the
    buffer holds the rank's experts only, and an assignment to another
    rank's expert goes to the spare row too (see the module doc)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    dt = x.dtype
    nG, share = dispatch_groups(T, replicas)
    G = T // nG
    Ep, K = m.n_experts_padded, m.top_k
    xg = x.reshape(nG, G, d)
    r = route(cfg, xg, p["router"], n_tokens=T * replicas, share=share)
    C = r.capacity
    e0, ne = expert_range(p, Ep)
    keep = r.keep if ne == Ep else r.keep & (r.idx >= e0) & (r.idx < e0 + ne)

    # a dropped (or another rank's) assignment points at one spare row past the buffer
    spare = ne * nG * C
    group = torch.arange(nG, device=x.device)[:, None, None]
    dest = torch.where(keep, ((r.idx - e0) * nG + group) * C + r.slot, spare).reshape(-1)
    src = xg.reshape(T, 1, d).expand(T, K, d).reshape(T * K, d)
    g, u = p["w_gate"], p["w_up"]
    h_split = isinstance(g, ShardedLeaf) and g.n_split
    if isinstance(g, ShardedLeaf):  # the tokens enter the rank's own experts or columns
        g, u, src = g.local, u.local, sl.fan_out(src)
    buf = x.new_zeros((spare + 1, d))
    buf.index_copy_(0, dest, src)
    xe = buf[:-1].view(ne, nG * C, d)

    # the rank's sub-stacks (its experts, or under "expert_ff" its columns
    # of every expert): one stacked launch each
    h = apply_gate_up(xe, g, u, cfg.activation)
    if ne < Ep:
        ye, partial = apply_linear(h, p["w_down"].local), True
    else:
        ye, partial = partial_linear(h, p["w_down"], h_split)
    ye = ye.reshape(spare, d)

    # the rank's experts' (or columns') share of every token's sum: the
    # gate values enter it as the dispatched tokens do, and one all-reduce
    # adds the ranks' shares (with the shared experts' partial product)
    gates = sl.fan_out(r.gates) if partial else r.gates
    comb = torch.where(keep, gates, 0.0).to(dt).to(torch.float32)
    rows = ye[dest.clamp_max(spare - 1)].to(torch.float32).reshape(nG, G, K, d)
    routed = (comb[..., None] * rows).sum(dim=2)

    ys, s_partial = None, False
    if m.n_shared_experts:
        s = p["shared"]
        hs, hs_split = sharded_gate_up(xg, s["w_gate"], s["w_up"], cfg.activation)
        ys, s_partial = partial_linear(hs, s["w_down"], hs_split)
    def summed(t):  # the model ranks' partial terms of every token's output
        t = t.reshape(B, S, d)
        return sl.scatter_seq(t) if seq else sl.reduce_sum(t, "model")

    def whole(t):  # a term every rank holds whole
        t = t.reshape(B, S, d)
        return sl.split_seq(t) if seq else t

    if partial:
        if s_partial:
            y = summed(routed + ys.to(torch.float32)).to(dt)
        else:
            y = summed(routed).to(dt)
            y = y if ys is None else y + whole(ys)
    else:
        y = whole(routed.to(dt))
        if ys is not None:
            y = y + (summed(ys) if s_partial else whole(ys))
    if not return_aux:
        return y
    # Switch-style load balancing over the real experts, before capacity:
    # the whole batch's means (each replica's sums added over the replicas)
    E = m.n_experts

    def mean(t):
        t = t.sum((0, 1))
        return (sl.reduce_batch(t) if replicas > 1 else t) / (T * replicas)

    frac_tokens = mean(torch.nn.functional.one_hot(r.idx, E).sum(2).to(torch.float32))
    aux = E * (frac_tokens * mean(r.probs)).sum() * m.router_aux_weight
    return y, aux


def moe_n_params(cfg) -> int:
    m = cfg.moe
    d = cfg.d_model
    n = d * m.n_experts + m.n_experts * 3 * d * m.expert_d_ff
    if m.n_shared_experts:
        n += 3 * d * (m.shared_d_ff or m.expert_d_ff) * m.n_shared_experts
    return n
