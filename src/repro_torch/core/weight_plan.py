"""Compressed-weight execution plan (port of ``repro/core/weight_plan.py``).

The plan walks a model's params tree, assigns every large matmul weight one
of four representations and packs it; every layer routes its matmuls
through the one dispatch, ``apply_linear`` (and ``apply_gate_up`` for the
gated-FFN pair):

    ``dense``        -- fp weights as they are.
    ``quant``        -- int8 payload + per-output-channel fp32 scales, a
                        ``QuantLinear`` node (Section 4.1 at int8).
    ``block_sparse`` -- surviving (bk, bn) blocks per block-column with
                        int32 row indices (the z_w analogue, Section 5.6).
    ``quant_sparse`` -- both: int8 block payload + scales.

The compressed tree keeps the dense tree's structure (nested dicts and
lists; leaves become ``PackedLinear`` or ``QuantLinear`` nodes).
Stacked leaves keep their leading layer dimension, so leaf assignment and
packing match the reference leaf for leaf; the model unstacks the tree
into per-layer views once, when it is built (``transformer.unstack``).

On CUDA, packed weights run through the hand-written kernels B1/B2 and
int8 weights through B5 (``kernels/ops``); on the CPU, through their plain
versions.  A packed weight without its pack-time walk (a plan cache saved
without walks) runs through B4 instead of B1, as the reference's jitted
engine runs such a leaf.  Every plan node carries ``use_kernel``, set from
``PlanConfig.use_kernel`` when it is packed: False forces the plain
versions on CUDA too.  ``with_use_kernel`` switches every node of a tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.pruning import BlockPruneConfig, block_mask
from repro_torch.core.sparse_format import BlockSparse, build_walk, pad_walk
from repro_torch.distributed import shardlib as sl
from repro_torch.kernels import ops
from repro_torch.kernels.fused_gate_up import ACTS

REPRS = ("dense", "quant", "block_sparse", "quant_sparse")

# Leaves consumed by apply_linear / embed / unembed call sites, by name.
QUANT_KEYS = ("w", "tok", "head")

# THE activation table (the kernels' plain versions share it).
GATE_ACTS = ACTS


@dataclasses.dataclass(frozen=True)
class PackedLinear:
    """One block-sparse (optionally int8) matmul weight of dense shape (K, N).

      blocks:     (n_cols * mb, bk, bn)  payload -- fp32 or int8
      block_rows: (n_cols, mb) int32     row-block index per stored block
      counts:     (n_cols,) int32        true survivor count per column
      scales:     (N,) fp32 or None      per-output-channel dequant scales
      walk:       dict of (n_walk,) int32 host tensors -- the TPU kernel's
                  pack-time block list, kept on the host; no kernel reads
                  it, but a leaf with a walk runs B1 and one without B4

    Stacked variants carry leading layer dims on every child.
    ``use_kernel`` True runs the CUDA kernel when the input is on the card;
    False runs the plain version there too.
    """

    blocks: Any
    block_rows: Any
    counts: Any
    scales: Optional[Any]
    walk: Optional[dict] = None
    kind: str = "block_sparse"
    shape: tuple = ()
    bk: int = 128
    bn: int = 128
    use_kernel: bool = True

    def to_block_sparse(self) -> BlockSparse:
        if self.blocks.dim() != 3:
            raise ValueError("to_block_sparse needs an unstacked leaf")
        return BlockSparse(self.blocks, self.block_rows, self.counts, self.shape,
                           BlockPruneConfig(bk=self.bk, bn=self.bn))


@dataclasses.dataclass(frozen=True)
class QuantLinear:
    """One int8 matmul weight (or embedding table) of dense shape (K, N).

      q: (K, N) int8 payload
      s: (N,) fp32 per-output-channel dequant scales

    Stacked variants carry leading layer dims on both.  ``use_kernel`` as
    for PackedLinear (kernel B5)."""

    q: Any
    s: Any
    use_kernel: bool = True


@dataclasses.dataclass(frozen=True)
class ShardedLeaf:
    """A rank's local shard of one matmul weight of whole shape (K, N) on
    the model axis of a mesh (``local_params``): ``local`` is a tensor, a
    QuantLinear or a PackedLinear holding the rank's piece, ``k_split``
    says that its rows are this rank's K / M (the contraction is split: the
    product is partial and takes an all-reduce), ``n_split`` that its
    columns are this rank's N / M (whole block columns of a packed leaf).
    ``experts`` (first, count) says that a stack of experts was cut on its
    expert axis: ``local`` holds experts [first, first + count) whole.  A
    leaf with none of these is whole on every rank and stays unwrapped."""

    local: Any
    k_split: bool
    n_split: bool
    shape: tuple
    experts: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """How to compress a model for serving (see the reference's PlanConfig).

    use_kernel: True runs packed and int8 weights through the CUDA kernels
    whenever the activations are on the card; False forces the plain
    versions."""

    default: str = "quant_sparse"
    rules: tuple = ()
    q_prune: float = 0.0
    bk: int = 128
    bn: int = 128
    score: str = "l1"
    min_size: int = 16384
    min_contract: int = 64
    use_kernel: bool = True

    def __post_init__(self):
        if self.default not in REPRS:
            raise ValueError(f"default must be one of {REPRS}, got {self.default!r}")
        if not 0.0 <= self.q_prune < 1.0:
            raise ValueError(f"q_prune must be in [0, 1), got {self.q_prune}")
        for r in self.rules:
            if len(r) not in (2, 3):
                raise ValueError(f"rule must be (sub, repr[, q_prune]), got {r!r}")
            if r[1] not in REPRS:
                raise ValueError(f"unknown representation {r[1]!r} in rule {r!r}")
            if len(r) == 3 and r[2] is not None and not 0.0 <= r[2] < 1.0:
                raise ValueError(f"rule q_prune must be in [0, 1), got {r!r}")

    @property
    def block(self) -> BlockPruneConfig:
        return BlockPruneConfig(bk=self.bk, bn=self.bn, score=self.score)


def _quant_eligible(name: str, leaf, cfg: PlanConfig) -> bool:
    return (
        isinstance(leaf, torch.Tensor)
        and leaf.dim() >= 2
        and leaf.numel() >= cfg.min_size
        and leaf.shape[-2] >= cfg.min_contract
        and (name.startswith("w") or name in QUANT_KEYS)
    )


def _sparse_eligible(name: str, leaf, cfg: PlanConfig) -> bool:
    """Projection-style weights (w*) whose shape tiles exactly; embedding
    tables (tok, head) are consumed by gather / unembed and stay quant."""
    if not (_quant_eligible(name, leaf, cfg) and name.startswith("w")):
        return False
    K, N = leaf.shape[-2], leaf.shape[-1]
    return K % cfg.bk == 0 and N % cfg.bn == 0 and K // cfg.bk >= 1 and N // cfg.bn >= 1


def assign_leaf(path: str, leaf, cfg: PlanConfig) -> tuple:
    """(representation, q_prune) for the leaf at ``path`` ("unit/0/mlp/w_up"):
    rules override the default; ineligible leaves degrade quant_sparse ->
    quant -> dense; q_prune is 0 for the non-sparse representations."""
    name = path.rsplit("/", 1)[-1]
    kind, q = cfg.default, cfg.q_prune
    for rule in cfg.rules:
        if rule[0] in path:
            kind = rule[1]
            if len(rule) == 3 and rule[2] is not None:
                q = float(rule[2])
            break
    if kind in ("block_sparse", "quant_sparse") and not _sparse_eligible(name, leaf, cfg):
        kind = "quant" if kind == "quant_sparse" else "dense"
    if kind == "quant" and not _quant_eligible(name, leaf, cfg):
        kind = "dense"
    if kind not in ("block_sparse", "quant_sparse"):
        q = 0.0
    return kind, q


def quantize_leaf(leaf: torch.Tensor, use_kernel: bool = True) -> QuantLinear:
    """int8-quantize one matmul weight; scales reduce over the contraction
    axis (-2) only, so stacked layers keep their own."""
    lf = leaf.to(torch.float32)
    amax = lf.abs().amax(dim=-2, keepdim=True)
    scales = amax.clamp_min(1e-8) / 127.0
    qv = torch.round(lf / scales).clamp(-127, 127).to(torch.int8)
    return QuantLinear(q=qv, s=scales.squeeze(-2), use_kernel=use_kernel)


def quantize_for_serving(params, min_size: int = 16384):
    """int8-quantize every eligible matmul weight (the reference's pre-plan
    API, kept as the ``quant``-everywhere special case of ``compress``): the
    ``QuantLinear`` leaves ``compress(PlanConfig(default="quant",
    min_size=min_size))`` makes, without the plan; every other leaf as it
    is.  The dry run's ``int8`` variant."""
    cfg = PlanConfig(default="quant", min_size=min_size)

    def q(path, leaf):
        if _quant_eligible(path.rsplit("/", 1)[-1], leaf, cfg):
            return quantize_leaf(leaf)
        return leaf

    return map_tree(q, params)


def pack_block_sparse(leaf: torch.Tensor, cfg: PlanConfig, quant: bool) -> PackedLinear:
    """Prune ``leaf`` to block sparsity cfg.q_prune and pack it.

    Each (K, N) slice of a stacked leaf is pruned independently; ``mb``
    (stored blocks per column) is the max over all slices and columns so
    the layout is rectangular.  Padded entries are zero blocks with row 0.
    Runs on the leaf's device, vectorized over blocks."""
    w = leaf.to(torch.float32)
    lead = tuple(w.shape[:-2])
    K, N = w.shape[-2:]
    ws = w.reshape(-1, K, N)
    L = ws.shape[0]
    bk, bn = cfg.bk, cfg.bn
    nrb, ncb = K // bk, N // bn

    masks = torch.stack([block_mask(ws[i], cfg.q_prune, cfg.block) for i in range(L)])
    counts = masks.sum(dim=1).to(torch.int32)  # (L, ncb)
    mb = max(1, int(counts.max()))

    scales = None
    if quant:
        # per-(slice, output-channel) scales over the *masked* matrix, so a
        # column whose largest weights were pruned keeps full int8 range
        amax = torch.stack([
            (ws[i] * masks[i].repeat_interleave(bk, 0).repeat_interleave(bn, 1)).abs().amax(0)
            for i in range(L)])
        scales = amax.clamp_min(1e-8) / 127.0  # (L, N)

    # per (slice, column): surviving row blocks in ascending order, then pad
    order = torch.sort((~masks.transpose(1, 2)).to(torch.int8), dim=-1, stable=True).indices
    slot = torch.arange(mb, device=w.device)
    valid = slot[None, None, :] < counts[..., None]  # (L, ncb, mb)
    rows = torch.where(valid, order[..., :mb], torch.zeros_like(order[..., :mb]))

    # gathered slice by slice: the fp32 payload of a whole stack (glm4-9b's
    # 40 layers of 4096 x 13696) would need several GB of temporaries at once
    ji = torch.arange(ncb, device=w.device)[:, None]
    blocks = torch.empty((L, ncb * mb, bk, bn), dtype=torch.int8 if quant else torch.float32,
                         device=w.device)
    for i in range(L):
        wb = ws[i].reshape(nrb, bk, ncb, bn).permute(2, 0, 1, 3)  # (ncb, nrb, bk, bn)
        payload = wb[ji, rows[i]]  # (ncb, mb, bk, bn)
        if quant:
            payload = torch.round(payload / scales[i].reshape(ncb, 1, 1, bn)).clamp(-127, 127)
        payload = torch.where(valid[i][..., None, None], payload, torch.zeros_like(payload))
        blocks[i] = payload.to(blocks.dtype).reshape(ncb * mb, bk, bn)
    rows = rows.to(torch.int32)
    walk = _host_walk(rows, counts, mb, lead)

    return PackedLinear(
        blocks=blocks.reshape(lead + blocks.shape[1:]),
        block_rows=rows.reshape(lead + rows.shape[1:]),
        counts=counts.reshape(lead + counts.shape[1:]),
        scales=None if scales is None else scales.reshape(lead + scales.shape[1:]),
        walk=walk,
        kind="quant_sparse" if quant else "block_sparse",
        shape=(K, N), bk=bk, bn=bn, use_kernel=cfg.use_kernel,
    )


def _host_walk(rows: torch.Tensor, counts: torch.Tensor, mb: int, lead: tuple) -> dict:
    """The TPU kernel's walk of (L, ncb, mb) row blocks and (L, ncb) counts
    (pack-time static, built and kept on the host), each slice's padded to
    the longest, with ``lead`` dims in front."""
    rows_np = rows.reshape(-1, *rows.shape[-2:]).cpu().numpy()
    counts_np = counts.reshape(-1, counts.shape[-1]).cpu().numpy()
    walks = [build_walk(rows_np[i], counts_np[i], mb) for i in range(rows_np.shape[0])]
    n_walk = max(wk["idx"].shape[0] for wk in walks)
    walks = [pad_walk(wk, n_walk) for wk in walks]
    return {k: torch.from_numpy(np.stack([wk[k] for wk in walks]).reshape(lead + (n_walk,)))
            for k in ("idx", "rows", "cols", "flags")}


# ---------------------------------------------------------------------------
# axis-rules registry entries (distributed/shardlib): how the compressed
# representations shard, registered where their layouts are defined
# ---------------------------------------------------------------------------


def _packed_leaf_axes(node: PackedLinear, axes):
    """A dense weight's logical axes (..., in_ax, out_ax) expanded to the
    PackedLinear's children: every child with a block-column dimension
    takes the output-feature axis, the walk and the contraction axis stay
    whole (the reference's expansion)."""
    lead_n = node.blocks.dim() - 3
    ax = tuple(axes) if axes is not None else ()
    out_ax = ax[-1] if len(ax) >= 2 else None
    lead = ax[:-2] if len(ax) == lead_n + 2 else (None,) * lead_n
    return dataclasses.replace(
        node,
        blocks=lead + (out_ax, None, None),
        block_rows=lead + (out_ax, None),
        counts=lead + (out_ax,),
        scales=None if node.scales is None else lead + (out_ax,),
        walk=None if node.walk is None else {k: lead + (None,) for k in node.walk},
    )


def _quant_leaf_axes(node: QuantLinear, axes):
    """The int8 payload keeps the dense weight's axes; the per-output
    scales drop the contraction axis."""
    if axes is None:
        return dataclasses.replace(node, q=None, s=None)
    ax = tuple(axes)
    return dataclasses.replace(node, q=ax, s=ax[:-2] + ax[-1:])


sl.register_node_axes("packed", lambda n: isinstance(n, PackedLinear), _packed_leaf_axes)
sl.register_node_axes("quant", lambda n: isinstance(n, QuantLinear), _quant_leaf_axes)


# ---------------------------------------------------------------------------
# plan object + stats
# ---------------------------------------------------------------------------

_DENSE_STREAM_BYTES = 2.0  # dense weights are streamed bf16 at serving time


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    path: str
    kind: str
    shape: tuple
    n_weights: int
    surviving: int  # weights actually streamed (== n_weights unless pruned)
    payload_bytes: float
    metadata_bytes: float
    # the dense leaf's logical sharding axes (e.g. ("d", "ff")); the
    # registry expands them to the packed children.  () for a plan built
    # without axes.
    axes: tuple = ()

    @property
    def bytes(self) -> float:
        return self.payload_bytes + self.metadata_bytes

    @property
    def q_prune(self) -> float:
        return 1.0 - self.surviving / max(1, self.n_weights)


def _leaf_stats(path: str, kind: str, shape: tuple, packed, axes: tuple = ()) -> LeafPlan:
    n = int(np.prod(shape)) if shape else 1
    if kind == "dense":
        return LeafPlan(path, kind, shape, n, n, n * _DENSE_STREAM_BYTES, 0.0, axes)
    if kind == "quant":
        return LeafPlan(path, kind, shape, n, n, float(n), 4.0 * packed.s.numel(), axes)
    counts = packed.counts.cpu().numpy()
    surv_blocks = int(counts.sum())
    surviving = surv_blocks * packed.bk * packed.bn
    payload = surviving * (1.0 if kind == "quant_sparse" else _DENSE_STREAM_BYTES)
    meta = 4.0 * surv_blocks + 4.0 * counts.size  # row idx per block + counts
    if packed.scales is not None:
        meta += 4.0 * packed.scales.numel()
    return LeafPlan(path, kind, shape, n, surviving, payload, meta, axes)


@dataclasses.dataclass
class WeightPlan:
    """Per-leaf assignments + the compressed tree (``params``), which goes
    anywhere dense params go (prefill, decode_step, ServingEngine)."""

    cfg: PlanConfig
    leaves: dict  # path -> LeafPlan
    params: Any = None
    _by_path: dict = dataclasses.field(default_factory=dict)

    @property
    def n_weights(self) -> int:
        return sum(l.n_weights for l in self.leaves.values())

    @property
    def surviving_weights(self) -> int:
        return sum(l.surviving for l in self.leaves.values())

    @property
    def weight_bytes(self) -> float:
        """Device-memory bytes streamed per decode step (payload + metadata)."""
        return sum(l.bytes for l in self.leaves.values())

    @property
    def q_prune_effective(self) -> float:
        return 1.0 - self.surviving_weights / max(1, self.n_weights)

    @property
    def b_weight_effective(self) -> float:
        payload = sum(l.payload_bytes for l in self.leaves.values())
        return payload / max(1, self.surviving_weights)

    @property
    def q_overhead_effective(self) -> float:
        payload = sum(l.payload_bytes for l in self.leaves.values())
        return self.weight_bytes / max(1.0, payload)

    def axes_tree(self):
        """The dense logical axes of every leaf of ``params`` (from
        ``LeafPlan.axes``; None where the plan recorded none)."""
        def ax(path, _):
            lp = self.leaves.get(path)
            return tuple(lp.axes) if lp is not None and lp.axes else None

        return map_tree(ax, self.params)

    def param_specs(self, mesh=None, rules=None):
        """The spec of every tensor of the compressed ``params`` under
        (mesh, rules), through the registry (``shardlib.tree_specs``): the
        counterpart of the reference's ``param_shardings``."""
        return sl.tree_specs(self.params, self.axes_tree(), mesh=mesh, rules=rules)

    def sizer(self, *, sparse_compute: bool = True, **kw):
        """A BatchSizer charged with this plan's weight stream."""
        from repro_torch.core.batching import BatchSizer

        kw.setdefault("n_params", self.n_weights)
        return BatchSizer(
            b_weight=self.b_weight_effective,
            q_prune=self.q_prune_effective,
            q_overhead=self.q_overhead_effective,
            sparse_compute=sparse_compute,
            **kw,
        )

    @property
    def fused_pairs(self) -> int:
        """Gated-FFN (w_gate, w_up) pairs served by one fused launch."""
        n = 0
        for p, l in self.leaves.items():
            if not p.endswith("w_gate") or l.kind not in ("block_sparse", "quant_sparse"):
                continue
            lu = self.leaves.get(p[: -len("w_gate")] + "w_up")
            if lu is not None and lu.kind == l.kind and lu.shape == l.shape:
                n += 1
        return n

    def summary(self, *, kv_bytes_per_token: float = 0.0, context_len: int = 0,
                batch: Optional[int] = None, per_leaf: bool = False) -> str:
        """One traffic budget in the sizer's bytes/token units: the weight
        stream charged once per step and amortized over the batch, the KV
        stream per live token.  Each kind's aggregate carries its q_prune
        range; ``per_leaf=True`` appends one line per leaf with its kind,
        q_prune, bytes and shape (what an autotuned plan assigned)."""
        from repro_torch.core.batching import UNBOUNDED_NOPT

        by_kind: dict = {}
        for l in self.leaves.values():
            agg = by_kind.setdefault(l.kind, [0, 0.0, 1.0, 0.0])
            agg[0] += 1
            agg[1] += l.bytes
            agg[2] = min(agg[2], l.q_prune)
            agg[3] = max(agg[3], l.q_prune)

        def _q_label(lo: float, hi: float) -> str:
            if hi <= 0.0:
                return ""
            if hi - lo < 5e-3:
                return f" q={hi:.2f}"
            return f" q={lo:.2f}..{hi:.2f}"

        parts = [f"{k}:{n} ({b/1e6:.2f} MB{_q_label(lo, hi)})"
                 for k, (n, b, lo, hi) in sorted(by_kind.items())]
        n = batch or self.sizer(kv_bytes_per_token=kv_bytes_per_token,
                                context_len=context_len).n_opt
        n_label = "inf" if (batch is None and n >= UNBOUNDED_NOPT) else str(n)
        w_tok = self.weight_bytes / max(1, n)
        kv_tok = kv_bytes_per_token * context_len
        s = (
            f"plan[{', '.join(parts)}] "
            f"q_prune={self.q_prune_effective:.3f} "
            f"b_weight={self.b_weight_effective:.2f} "
            f"q_overhead={self.q_overhead_effective:.4f} "
            f"fused_pairs={self.fused_pairs} "
            f"bytes/step={self.weight_bytes/1e6:.2f} MB | "
            f"bytes/tok@n={n_label}: weights={w_tok:.0f} kv={kv_tok:.0f} "
            f"total={w_tok + kv_tok:.0f}"
        )
        if per_leaf:
            s += "\n" + "\n".join(
                f"  {p}: {l.kind} q={l.q_prune:.2f} {l.bytes/1e3:.1f} kB ({l.shape})"
                for p, l in sorted(self.leaves.items()))
        return s


PLAN_NODES = (PackedLinear, QuantLinear, ShardedLeaf)


def map_tree(fn, tree, path: str = ""):
    """Rebuild a nested dict/list tree, calling fn(path, node) on every
    tensor leaf and plan node (PackedLinear / QuantLinear)."""
    if isinstance(tree, PLAN_NODES) or not isinstance(tree, (dict, list, tuple)):
        return fn(path, tree)
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, join(k)) for k, v in tree.items()}
    return type(tree)(map_tree(fn, v, join(i)) for i, v in enumerate(tree))


def with_use_kernel(params, use_kernel: bool):
    """The same tree with every plan node's ``use_kernel`` replaced
    (tensors shared): ``False`` runs the plain versions on the card."""
    def one(_, n):
        if isinstance(n, ShardedLeaf):
            return dataclasses.replace(n, local=one(_, n.local))
        if isinstance(n, (PackedLinear, QuantLinear)):
            return dataclasses.replace(n, use_kernel=use_kernel)
        return n

    return map_tree(one, params)



# ---------------------------------------------------------------------------
# serve-time plan cache: persist/restore compressed trees (checkpoint/store)
# ---------------------------------------------------------------------------

WALK_KEYS = ("cols", "flags", "idx", "rows")  # sorted, as jax flattens the walk dict


@dataclasses.dataclass(frozen=True)
class _Slot:
    """A stored leaf's place in a skeleton tree, with its expected shape
    where the model fixes it (None: set by the packing)."""

    shape: Optional[tuple] = None


def flatten_leaves(tree) -> list:
    """The leaves of a params tree in the order ``jax.tree_util.tree_flatten``
    lists the reference's: dict keys sorted, lists in order, ``None`` no
    leaf; a PackedLinear as blocks, block_rows, counts, [scales], [walk
    cols, flags, idx, rows]; a QuantLinear (the reference's ``{"q", "s"}``)
    as q, s."""
    if tree is None:
        return []
    if isinstance(tree, ShardedLeaf):
        return flatten_leaves(tree.local)
    if isinstance(tree, PackedLinear):
        walk = [] if tree.walk is None else [tree.walk[k] for k in sorted(tree.walk)]
        return [tree.blocks, tree.block_rows, tree.counts,
                *flatten_leaves(tree.scales), *walk]
    if isinstance(tree, QuantLinear):
        return [tree.q, tree.s]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in flatten_leaves(v)]
    return [tree]


def unflatten_leaves(skeleton, leaves: list):
    """The inverse of ``flatten_leaves``: ``skeleton`` with its leaves
    replaced, in flatten order, by ``leaves`` (which must match in number)."""
    it = iter(leaves)

    def fill(node):
        if node is None:
            return None
        if isinstance(node, PackedLinear):
            blocks, rows, counts = next(it), next(it), next(it)
            scales = None if node.scales is None else next(it)
            walk = None if node.walk is None else {k: next(it) for k in sorted(node.walk)}
            return dataclasses.replace(node, blocks=blocks, block_rows=rows, counts=counts,
                                       scales=scales, walk=walk)
        if isinstance(node, QuantLinear):
            return dataclasses.replace(node, q=next(it), s=next(it))
        if isinstance(node, ShardedLeaf):
            return dataclasses.replace(node, local=fill(node.local))
        if isinstance(node, dict):
            # fill in sorted order, keep the skeleton's key order
            filled = {k: fill(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(fill(v) for v in node)
        return next(it)

    out = fill(skeleton)
    if next(it, None) is not None:
        raise ValueError("more leaves than the skeleton has places")
    return out


def _node_meta(node) -> dict:
    """Static reconstruction metadata for one planned node."""
    if isinstance(node, PackedLinear):
        return {
            "repr": "packed",
            "kind": node.kind,
            "shape": list(node.shape),
            "bk": node.bk,
            "bn": node.bn,
            "use_kernel": node.use_kernel,
            # the reference's load_plan reads this key for every packed
            # leaf; the port has no interpret mode and ignores it on load
            "interpret": False,
            "has_scales": node.scales is not None,
            "has_walk": node.walk is not None,
        }
    if isinstance(node, QuantLinear):
        return {"repr": "quant"}
    return {"repr": "dense"}


def _index_nodes(params) -> dict:
    """path -> planned node (PackedLinear / QuantLinear / plain tensor)."""
    out = {}

    def visit(path, node):
        out[path] = node
        return node

    map_tree(visit, params)
    return out


_PLAN_CFG_FIELDS = tuple(f.name for f in dataclasses.fields(PlanConfig) if f.name != "use_kernel")


def save_plan(base: str, plan: WeightPlan) -> str:
    """Persist a compressed plan (packed tree + reconstruction metadata)
    through ``checkpoint.store`` in the reference's layout, so that a
    serving engine boots from packed weights instead of re-packing.
    Saving over a directory that holds a plan replaces it (keep=1).
    Returns the step directory."""
    from repro_torch.checkpoint import store

    metadata = {
        "plan_cfg": {
            **{f.name: getattr(plan.cfg, f.name) for f in dataclasses.fields(plan.cfg)
               if f.name != "rules"},
            "rules": [list(r) for r in plan.cfg.rules],
        },
        "leaves": {p: {**dataclasses.asdict(l), "shape": list(l.shape),
                       "axes": list(l.axes)}
                   for p, l in plan.leaves.items()},
        "packed": {p: _node_meta(n) for p, n in _index_nodes(plan.params).items()},
    }
    return store.save(base, 0, flatten_leaves(plan.params), metadata=metadata, keep=1)


def load_plan(base: str, dense_params, *, use_kernel: bool = True) -> WeightPlan:
    """Rebuild a WeightPlan saved by ``save_plan`` here or by the reference's
    ``save_plan`` (tensors on the CPU).

    ``dense_params`` supplies the tree structure only (e.g. from
    ``init_params``): its leaves are replaced node for node by the stored
    packed representations -- no pruning or quantization runs.  The
    reference also checks its treedef string, which cannot be rebuilt
    without jax; this checks the leaf count, the shapes of every dense and
    int8 leaf and every packed leaf's dense shape instead, and raises
    ValueError on a mismatch (another arch or shape).  ``use_kernel`` is the run's choice,
    not the file's: it goes into every node and into ``plan.cfg``; the
    reference's ``interpret`` flags are ignored; each leaf's ``axes`` are
    read back, so a directory either package wrote places the same specs."""
    from repro_torch.checkpoint import store

    leaves_t, manifest = store.restore_flat(base)
    meta = manifest["metadata"]
    cfg_d = {k: meta["plan_cfg"][k] for k in _PLAN_CFG_FIELDS if k in meta["plan_cfg"]}
    cfg_d["rules"] = tuple(tuple(r) for r in cfg_d.get("rules", ()))
    cfg = PlanConfig(**cfg_d, use_kernel=use_kernel)

    def skeleton(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        pm = meta["packed"].get(path, {"repr": "dense"})
        if pm["repr"] == "quant":
            shape = tuple(leaf.shape)
            return QuantLinear(q=_Slot(shape), s=_Slot(shape[:-2] + shape[-1:]),
                               use_kernel=use_kernel)
        if pm["repr"] == "packed":
            if tuple(leaf.shape[-2:]) != tuple(pm["shape"]):
                raise ValueError(
                    f"plan cache leaf {path} packs dense shape {tuple(pm['shape'])}, "
                    f"model has {tuple(leaf.shape[-2:])}")
            return PackedLinear(
                blocks=_Slot(), block_rows=_Slot(), counts=_Slot(),
                scales=_Slot() if pm["has_scales"] else None,
                walk={k: _Slot() for k in WALK_KEYS} if pm["has_walk"] else None,
                kind=pm["kind"], shape=tuple(pm["shape"]), bk=pm["bk"], bn=pm["bn"],
                use_kernel=use_kernel)
        return leaf

    skel = map_tree(skeleton, dense_params)
    flat = flatten_leaves(skel)
    if len(flat) != manifest["n_leaves"]:
        raise ValueError(
            f"plan cache has {manifest['n_leaves']} leaves, model structure expects "
            f"{len(flat)} -- was it saved for a different config?")
    # dense placeholders are the model's own tensors, and an int8 leaf's
    # payload and scales follow its dense shape: their stored shapes must
    # match (catches e.g. a width or vocabulary change that keeps the count)
    for i, (ph, entry) in enumerate(zip(flat, manifest["leaves"])):
        if ph.shape is not None and tuple(ph.shape) != tuple(entry["shape"]):
            raise ValueError(f"plan cache leaf {i} has shape {tuple(entry['shape'])}, "
                             f"model structure expects {tuple(ph.shape)}")
    params = unflatten_leaves(skel, leaves_t)
    fields = {f.name for f in dataclasses.fields(LeafPlan)}
    leaves = {p: LeafPlan(**{**{k: v for k, v in d.items() if k in fields},
                             "shape": tuple(d["shape"]),
                             "axes": tuple(d.get("axes") or ())})
              for p, d in meta["leaves"].items()}
    return WeightPlan(cfg=cfg, leaves=leaves, params=params, _by_path=_index_nodes(params))


def _axes_by_path(axes, path: str = "") -> dict:
    """path -> logical-axes tuple of an axes tree (``map_tree``'s paths)."""
    if isinstance(axes, dict):
        join = (lambda k: f"{path}/{k}") if path else str
        return {p: a for k, v in axes.items() for p, a in _axes_by_path(v, join(k)).items()}
    if isinstance(axes, list):
        join = (lambda k: f"{path}/{k}") if path else str
        return {p: a for i, v in enumerate(axes) for p, a in _axes_by_path(v, join(i)).items()}
    return {path: axes}


def compress(params, cfg: PlanConfig = PlanConfig(), *, axes=None) -> WeightPlan:
    """Assign each leaf a representation, pack, and return the WeightPlan.
    ``axes`` (optional, ``api.param_axes(cfg)``) is the tree of dense
    logical axes: each leaf's are recorded in its LeafPlan, so the plan can
    place its packed tree on a mesh (``param_specs``)."""
    leaves: dict = {}
    by_path: dict = {}
    ax_of = _axes_by_path(axes) if axes is not None else {}

    def _one(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        packed, leaves[path] = compress_leaf(path, leaf, cfg, ax_of.get(path))
        by_path[path] = packed
        return packed

    compressed = map_tree(_one, params)
    return WeightPlan(cfg=cfg, leaves=leaves, params=compressed, _by_path=by_path)


def compress_leaf(path: str, leaf: torch.Tensor, cfg: PlanConfig, axes=None) -> tuple:
    """One leaf of ``compress``: (its packed form, its LeafPlan), by
    ``assign_leaf`` with its dense logical ``axes`` recorded."""
    kind, q = assign_leaf(path, leaf, cfg)
    if kind == "dense":
        packed = leaf
    elif kind == "quant":
        packed = quantize_leaf(leaf, cfg.use_kernel)
    else:
        pc = cfg if q == cfg.q_prune else dataclasses.replace(cfg, q_prune=q)
        packed = pack_block_sparse(leaf, pc, quant=(kind == "quant_sparse"))
    return packed, _leaf_stats(path, kind, tuple(leaf.shape), packed,
                               tuple(axes) if axes else ())


# ---------------------------------------------------------------------------
# the runtime dispatch -- every layer's matmuls route through here
# ---------------------------------------------------------------------------


def is_stacked(w) -> bool:
    """A layer's stack of experts: one lead dim over the (K, N) weight."""
    if isinstance(w, PackedLinear):
        return w.blocks.dim() == 4
    if isinstance(w, QuantLinear):
        return w.q.dim() == 3
    return w.dim() == 3


def _rows(x: torch.Tensor, stacked: bool, K: int) -> torch.Tensor:
    """x as the kernels take it: (M, K), or (E, M, K) for a stack of E
    experts (x's lead dim is the stack's; its other dims fold into M)."""
    return x.reshape(x.shape[0], -1, K) if stacked else x.reshape(-1, K)


def _fusable_pair(g, u) -> bool:
    return (
        isinstance(g, PackedLinear)
        and isinstance(u, PackedLinear)
        and g.kind == u.kind
        and g.shape == u.shape
        and (g.bk, g.bn) == (u.bk, u.bn)
        and (g.scales is None) == (u.scales is None)
        and g.blocks.dim() == u.blocks.dim()
    )


def apply_gate_up(x: torch.Tensor, w_gate, w_up, activation: str = "silu") -> torch.Tensor:
    """act(x @ Wg) * (x @ Wu).  A fusable packed pair runs as ONE kernel
    launch (B2), a stack of expert pairs too (x (E, ..., K), one launch
    over the experts, where the reference vmaps the kernel); any other
    representation mix is two ``apply_linear`` dispatches plus the
    elementwise gate."""
    if activation not in GATE_ACTS:
        raise ValueError(f"unknown gate activation {activation!r}")
    if _fusable_pair(w_gate, w_up):
        K, N = w_gate.shape
        y = ops.fused_gate_up(_rows(x, is_stacked(w_gate), K), w_gate, w_up, activation)
        return y.reshape(*x.shape[:-1], N)
    return GATE_ACTS[activation](apply_linear(x, w_gate)) * apply_linear(x, w_up)


def apply_linear(x: torch.Tensor, w) -> torch.Tensor:
    """y = x @ W for a dense tensor, a QuantLinear or a PackedLinear of one
    layer, or a stack of E experts of any of them with x (E, ..., K): a
    packed stack is ONE launch of B1 (B4 without walks), an int8 stack one
    B5 launch per expert, a dense stack one batched matmul."""
    if isinstance(w, PackedLinear):
        K, N = w.shape
        y = ops.block_sparse_matmul(_rows(x, is_stacked(w), K), w)
        return y.reshape(*x.shape[:-1], N)
    if isinstance(w, QuantLinear):
        return _apply_quant(x, w)
    if w.dim() == 3:
        E, K, N = w.shape
        return torch.bmm(_rows(x, True, K), w.to(x.dtype)).reshape(*x.shape[:-1], N)
    return x @ w.to(x.dtype)


def _apply_quant(x, w: QuantLinear):
    """int8 path through kernel B5 (its plain version on the CPU): (x @ q)
    * s with fp32 accumulation, in x's dtype; the scales factor out of the
    contraction.  A stack of experts runs B5 once per expert (ROADMAP:
    a stacked B5)."""
    K, N = w.q.shape[-2:]
    if w.q.dim() == 3:
        x3 = _rows(x, True, K)
        y = torch.stack([ops.quant_matmul(x3[e], dataclasses.replace(w, q=w.q[e], s=w.s[e]))
                         for e in range(w.q.shape[0])])
        return y.reshape(*x.shape[:-1], N)
    return ops.quant_matmul(x.reshape(-1, K), w).reshape(*x.shape[:-1], N)


def tree_to(tree, device):
    """Move every tensor of a (possibly compressed) params tree to
    ``device``; walks stay on the host (no kernel reads them)."""
    def mv(_, n):
        if isinstance(n, ShardedLeaf):
            return dataclasses.replace(n, local=mv(_, n.local))
        if isinstance(n, PackedLinear):
            return dataclasses.replace(
                n, blocks=n.blocks.to(device), block_rows=n.block_rows.to(device),
                counts=n.counts.to(device),
                scales=None if n.scales is None else n.scales.to(device))
        if isinstance(n, QuantLinear):
            return dataclasses.replace(n, q=n.q.to(device), s=n.s.to(device))
        return n.to(device) if isinstance(n, torch.Tensor) else n

    return map_tree(mv, tree)


# ---------------------------------------------------------------------------
# a rank's local shards on a mesh (distributed/shardlib)
# ---------------------------------------------------------------------------


def _model_split(entry, what: str) -> bool:
    """Whether a spec entry splits its dimension over the model axis
    (True) or leaves it whole (False).  Serving weights shard over "model"
    only: any other mesh axis is refused."""
    if entry is None or entry is sl.UNCONSTRAINED:
        return False
    if entry == "model":
        return True
    raise NotImplementedError(f"{what}: a weight sharded over {entry!r}; serving shards "
                              f"weights over the model axis only (ROADMAP A13c)")


def _local_packed(node: PackedLinear, parts: int, idx: int) -> PackedLinear:
    """Block columns [idx * n, (idx + 1) * n) of a packed leaf (n = ncb /
    parts), with their row blocks, counts, scales and a walk of their own."""
    ncb, mb = node.counts.shape[-1], node.block_rows.shape[-1]
    n, c0 = ncb // parts, idx * (ncb // parts)
    rows = node.block_rows.narrow(-2, c0, n).contiguous().clone()
    counts = node.counts.narrow(-1, c0, n).contiguous().clone()
    lead = tuple(node.counts.shape[:-1])
    return dataclasses.replace(
        node,
        blocks=node.blocks.narrow(-3, c0 * mb, n * mb).contiguous().clone(),
        block_rows=rows, counts=counts,
        scales=None if node.scales is None
        else node.scales.narrow(-1, c0 * node.bn, n * node.bn).contiguous().clone(),
        walk=None if node.walk is None else _host_walk(rows, counts, mb, lead),
        shape=(node.shape[0], n * node.bn))


def _packed_experts(node: PackedLinear, dim: int, start: int, n: int) -> PackedLinear:
    """Experts [start, start + n) of a packed stack whose lead dim ``dim``
    runs over the experts: every child narrowed there, and one host walk
    per kept expert (its own rows and counts at the stack's ``mb``, padded
    to the longest kept walk)."""
    def cut(t):
        return None if t is None else t.narrow(dim, start, n).contiguous().clone()

    rows, counts = cut(node.block_rows), cut(node.counts)
    return dataclasses.replace(
        node, blocks=cut(node.blocks), block_rows=rows, counts=counts, scales=cut(node.scales),
        walk=None if node.walk is None
        else _host_walk(rows, counts, rows.shape[-1], tuple(counts.shape[:-1])))


def _piece(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    return sl.local_piece(x, spec, mesh).contiguous().clone()


def _split_lead(spec: tuple, n_lead: int) -> Optional[int]:
    """The lead dim (of the ``n_lead`` in front of a leaf's (K, N), or of a
    packed leaf's block columns) that ``spec`` splits over the model axis
    -- a stack's expert axis under the "experts" rule -- or None."""
    dims = [d for d in range(n_lead) if _model_split(spec[d], "a stack's lead axis")]
    return dims[0] if dims else None


def _expert_range(shape: tuple, dim: int, mesh) -> tuple:
    """(first, count) of this rank's experts on lead dim ``dim``."""
    n = shape[dim] // sl.axis_sizes(mesh)["model"]
    return sl.mesh_coords(mesh)["model"] * n, n


def local_leaf(node, axes, mesh, rules):
    """This rank's piece of one leaf of a params tree, by its dense logical
    axes under (mesh, rules).  A matmul weight (a tensor of 2+ dims, a
    QuantLinear, a PackedLinear) split over the model axis becomes a
    ``ShardedLeaf``; anything the spec leaves whole is returned as it is.

    A stack of experts ((L, Ep, K, N) and its int8 and packed forms) whose
    expert axis the spec splits ("experts" -> "model") keeps the rank's
    Ep / M experts whole (``ShardedLeaf.experts``); where the model axis
    does not divide Ep, ``shardlib._resolve`` drops the mapping and the
    stack stays whole on every rank (its expert FFN width may split
    instead, under an "expert_ff" rule).

    A packed leaf splits only into whole block columns: by its ``counts``'
    spec (n_cols divisible by the model axis).  Where the reference's spec
    shards ``blocks`` but not ``counts`` (n_cols * mb divides, n_cols does
    not) the leaf stays whole on every rank (ROADMAP C1)."""
    if isinstance(node, PackedLinear):
        specs = sl.tree_specs(node, axes, mesh=mesh, rules=rules)
        c_spec = specs.counts.spec
        dim = _split_lead(c_spec, len(c_spec) - 1)
        if dim is not None:
            first, n = _expert_range(tuple(node.counts.shape), dim, mesh)
            return ShardedLeaf(_packed_experts(node, dim, first, n), False, False,
                               tuple(node.shape), experts=(first, n))
        if not _model_split(c_spec[-1], "counts"):
            return node
        coords, sizes = sl.mesh_coords(mesh), sl.axis_sizes(mesh)
        return ShardedLeaf(_local_packed(node, sizes["model"], coords["model"]),
                           k_split=False, n_split=True, shape=tuple(node.shape))
    if isinstance(node, QuantLinear):
        specs = sl.tree_specs(node, axes, mesh=mesh, rules=rules)
        q_spec = specs.q.spec
        k_split = _model_split(q_spec[-2], "q rows")
        n_split = _model_split(q_spec[-1], "q columns")
        dim = _split_lead(q_spec, len(q_spec) - 2)
        if not (k_split or n_split or dim is not None):
            return node
        local = dataclasses.replace(node, q=_piece(node.q, q_spec, mesh),
                                    s=_piece(node.s, specs.s.spec, mesh))
        return ShardedLeaf(local, k_split, n_split, tuple(node.q.shape[-2:]),
                           None if dim is None else _expert_range(tuple(node.q.shape), dim, mesh))
    if not isinstance(node, torch.Tensor):
        return node
    spec = sl.tree_specs(node, axes, mesh=mesh, rules=rules).spec
    split = matmul_split(spec, axes, tuple(node.shape), mesh)
    if split is not None:
        return ShardedLeaf(_piece(node, spec, mesh), *split)
    return _piece(node, spec, mesh) if any(e is not None for e in spec) else node


def matmul_split(spec: tuple, axes, shape: tuple, mesh) -> Optional[tuple]:
    """(k_split, n_split, (K, N), experts) -- ``ShardedLeaf``'s fields after
    ``local`` -- of a dense leaf of whole ``shape`` and logical ``axes``
    under ``spec``, or None where the rank's piece stays a plain tensor: a
    leaf with no named contraction axis (a vector, a stack of vectors or a
    conv's taps, which the model reads elementwise) or a matmul leaf the
    spec leaves whole."""
    if len(shape) < 2 or not (axes and axes[-2]):
        return None
    k_split = _model_split(spec[-2], "rows")
    n_split = _model_split(spec[-1], "columns")
    dim = _split_lead(spec, len(spec) - 2)
    if not (k_split or n_split or dim is not None):
        return None
    return (k_split, n_split, shape[-2:],
            None if dim is None else _expert_range(shape, dim, mesh))


def local_params(params, axes_tree, mesh, rules):
    """This rank's tree of a whole (stacked) params tree, dense or
    compressed: ``local_leaf`` of every leaf by its axes (``axes_tree``
    None: everything whole).  The pieces are copies, so the whole tree can
    be dropped after."""
    ax_of = _axes_by_path(axes_tree) if axes_tree is not None else {}

    def one(path, node):
        ax = ax_of.get(path)
        return local_leaf(node, tuple(ax) if ax else None, mesh, rules)

    return map_tree(one, params)


def contraction(w) -> int:
    """K of a whole matmul leaf."""
    if isinstance(w, PackedLinear):
        return w.shape[0]
    return (w.q if isinstance(w, QuantLinear) else w).shape[-2]


def partial_linear(x: torch.Tensor, w, x_split: bool = False) -> tuple:
    """y = x @ W on this rank's shard with a split contraction left
    unreduced: (y, partial).  ``y`` holds the whole output axis; ``partial``
    says that it is this rank's term of a sum over the model axis (the
    caller all-reduces it, maybe together with other partial terms)."""
    if isinstance(w, ShardedLeaf) and w.k_split:
        K = w.shape[0]
        m, M = sl.axis_index("model"), sl.axis_size("model")
        return apply_linear(sl.cols(x, x_split, m * K // M, K // M), w.local), True
    y, y_split = sharded_linear(x, w, x_split)
    return sl.cols(y, y_split, 0, output_width(w)), False


def output_width(w) -> int:
    """N of a whole matmul leaf."""
    if isinstance(w, (PackedLinear, ShardedLeaf)):
        return w.shape[1]
    return (w.q if isinstance(w, QuantLinear) else w).shape[-1]


def sharded_linear(x: torch.Tensor, w, x_split: bool = False) -> tuple:
    """y = x @ W on this rank's shard: (y, y_split).  ``x`` holds the whole
    contraction axis or (``x_split``) this rank's piece of it; the result
    holds the whole output axis or (``y_split``) this rank's columns.  A
    split contraction sums its partial products over the model axis (an
    int8 leaf's per-column scales commute with that sum: B5 runs with no
    activation).  A whole leaf gathers a split ``x`` first.  A stack cut on
    its expert axis runs the rank's experts on ``x`` (their rows).  Under
    autograd (meshed training) a whole ``x`` enters the rank's columns
    through ``shardlib.fan_out`` and a split contraction's partial products
    meet in ``shardlib.reduce_sum``: Megatron's f and g."""
    if not isinstance(w, ShardedLeaf):
        return apply_linear(sl.cols(x, x_split, 0, contraction(w)), w), False
    if w.k_split:
        y, _ = partial_linear(x, w, x_split)
        return sl.reduce_sum(y, "model"), False
    x = sl.fan_out(sl.cols(x, x_split, 0, w.shape[0]))
    return apply_linear(x, w.local), w.n_split


def residual_linear(x: torch.Tensor, w, x_split: bool = False, seq: bool = False):
    """y = x @ W for a product that joins the residual stream (a block's
    row-parallel output): the whole (B, S, N) on every rank, or with
    ``seq`` (sequence parallelism, ``shardlib.seq_split``) this rank's
    piece of the sequence -- a split contraction's partial products
    reduce-scattered over the model axis where they would be all-reduced,
    a product every rank holds whole cut to the piece."""
    if seq and isinstance(w, ShardedLeaf) and w.k_split:
        return sl.scatter_seq(partial_linear(x, w, x_split)[0])
    y, y_split = sharded_linear(x, w, x_split)
    y = sl.cols(y, y_split, 0, output_width(w))
    return sl.split_seq(y) if seq else y


def sharded_gate_up(x: torch.Tensor, w_gate, w_up, activation: str) -> tuple:
    """act(x @ Wg) * (x @ Wu) on this rank's shards: (y, y_split); ``x``
    whole.  A fusable packed pair of local columns is one B2 launch.  The
    activation does not commute with a sum, so a split contraction is
    refused."""
    if not isinstance(w_gate, ShardedLeaf):
        return apply_gate_up(x, w_gate, w_up, activation), False
    if w_gate.k_split or not isinstance(w_up, ShardedLeaf) or w_up.k_split \
            or w_up.n_split != w_gate.n_split:
        raise ValueError("gate/up shards must split the same output columns and no "
                         "contraction (the activation does not commute with a sum)")
    return apply_gate_up(sl.fan_out(x), w_gate.local, w_up.local, activation), w_gate.n_split
