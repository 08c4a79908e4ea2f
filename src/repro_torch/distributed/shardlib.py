"""Logical-axis sharding (port of ``repro/distributed/shardlib.py``).

Models name each tensor dimension by a *logical* axis ("d", "qkv", "ff",
"vocab", "batch", "kv_heads", ...); a rule table maps logical axes to the
physical axes of a mesh ("data", "model").  A mapping that the dimension
cannot honor (its size does not divide by the mesh axes' product) is
dropped and the dimension stays whole -- the reference's divisibility
rule, so every (arch x mesh) cell has a layout without per-arch cases.

The placement half is the reference's, function for function:
``DEFAULT_RULES``, ``_resolve`` (a spec is a tuple with one entry a
dimension: None, a mesh-axis name or a tuple of them, or ``UNCONSTRAINED``),
the axis registry (``register_axes``, ``axes_for``, ``register_node_axes``,
``expand_axes``, ``registry_table``), the cache-kind registry
(``CacheKind``, ``register_cache_kind``, ``cache_kind_table``),
``tree_specs`` (the counterpart of ``tree_shardings``: the spec of every
leaf of a params or cache tree), ``shard_degree``, ``parallelism_degrees``
and ``spec_for``.

The execution half replaces GSPMD.  The reference shards one jitted
program over a mesh and lets the compiler insert the collectives; the port
runs one process per rank, each holding its *local piece* of every leaf
(``local_piece``: the dims a spec shards are cut to this rank's slice, in
rank order; ``local_zeros`` allocates a cache's pieces), and the model
code moves activations between layouts with ``torch.distributed``
collectives over the mesh's process groups (``all_gather``,
``all_reduce``, ``cols``, ``gather_batch``).  ``shard`` / ``shard_pinned``
are the relayout their call sites need: a whole tensor to this rank's
piece.  Without an active mesh (``use_mesh``) every one of them
does nothing.  Training on a mesh runs the same model code under autograd:
there ``fan_out``, ``reduce_sum`` and ``gather_pieces`` (Megatron's f, g
and a gather with a slicing backward) take the collectives' places, and
``all_reduce_flat`` / ``reduce_over`` / ``gather_whole`` name their mesh
for the optimizer and the checkpoints.  The reference's production layouts
add sequence parallelism (``seq_split``, ``gather_seq`` / ``split_seq`` /
``scatter_seq``: all-gather and reduce-scatter, each the other's
conjugate under autograd) and the vocab-parallel cross entropy
(``vocab_nll``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` with dim names ("data",
"model") (``launch/mesh.py`` builds it), or a ``MeshShape``: axis sizes
and, optionally, this rank's coordinates, with no process group -- what the
placement functions and the tests need (``make_production_mesh``'s 256
ranks are shapes only).  A collective takes the tensors where they lie:
over NCCL on the card, over gloo on the CPU or, for CUDA tensors, through
gloo's own CUDA path (the backend is chosen up front, never after a
failure).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Sequence, Union

import torch
import torch.distributed as dist

_state = threading.local()


class _Unconstrained:
    """A dropped mapping in an activation spec: the reference's
    ``P.UNCONSTRAINED`` (GSPMD picks the layout)."""

    def __repr__(self):
        return "UNCONSTRAINED"


UNCONSTRAINED = _Unconstrained()

# logical axis name -> mesh axis name (or tuple of mesh axes)
DEFAULT_RULES = {
    "batch": ("pod", "data"),  # data parallel
    "seq": None,  # sequence: unsharded by default (overridden for long ctx)
    "seq_sp": None,  # residual-stream seq dim (Megatron-style SP, launcher opt-in)
    "cache_seq": None,  # decode KV cache length (sharded for long_500k)
    "d": None,  # d_model: replicated on activations
    "heads": "model",  # attention heads -- tensor parallel
    "kv_heads": "model",
    "qkv": "model",  # fused qkv feature dim
    "ff": "model",  # FFN hidden
    "vocab": "model",  # embedding/LM-head vocab shard
    "experts": "model",  # MoE expert parallelism
    "expert_ff": None,  # intra-expert TP (used when E % model != 0)
    "zero": ("pod", "data"),  # optimizer-state sharding axis (ZeRO)
}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh without processes: ``shape`` maps axis names to sizes (in
    mesh order); ``coords`` optionally places this rank on each axis (for
    ``local_piece`` without a process group)."""

    shape: dict
    coords: Optional[dict] = None


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or a MeshShape, in mesh order."""
    if mesh is None:
        return {}
    if isinstance(mesh, MeshShape):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_coords(mesh) -> dict:
    """{axis name: this rank's index on it}."""
    if isinstance(mesh, MeshShape):
        if mesh.coords is None:
            raise ValueError("a MeshShape without coords places no rank")
        return dict(mesh.coords)
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def _get():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Activate a mesh + logical rules for the model code's relayouts."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _get().append((mesh, merged))
    try:
        yield
    finally:
        _get().pop()


def current_mesh():
    s = _get()
    return s[-1][0] if s else None


def current_rules() -> dict:
    s = _get()
    return s[-1][1] if s else dict(DEFAULT_RULES)


def _axes_size(sizes: dict, axes: Union[str, Sequence[str], None]) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def _resolve(mesh, rules: dict, logical: Sequence[Optional[str]], shape,
             unconstrained_ok: bool = False) -> tuple:
    """Logical axes -> spec tuple, dropping non-divisible mappings (to
    ``UNCONSTRAINED`` for activation constraints, else None: replicated)."""
    sizes = axis_sizes(mesh)
    spec = []
    used: set = set()
    dropped = UNCONSTRAINED if unconstrained_ok else None
    for dim, name in zip(shape, logical):
        mapped = rules.get(name) if name else None
        if mapped is None:
            spec.append(None)
            continue
        axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        axes = tuple(a for a in axes if a in sizes and a not in used)
        size = _axes_size(sizes, axes)
        if size <= 1 or dim % size != 0:
            spec.append(dropped)
            continue
        used.update(axes)
        spec.append(axes[0] if len(axes) == 1 else axes)
    return tuple(spec)


# ---------------------------------------------------------------------------
# axis-rules registry: ONE table from leaf kind to logical axes
# ---------------------------------------------------------------------------
#
# Named leaf kinds (KV caches, scale leaves, page pools, the page table)
# register their logical axes where their layout is defined; structured
# kinds (PackedLinear, QuantLinear) register an expander from the dense
# weight's axes to their children's.  ``tree_specs`` resolves any params or
# cache tree, dense or compressed, through them.

AXIS_REGISTRY: dict = {}

_NODE_RULES: list = []  # (name, predicate, expander) -- first match wins


def register_axes(kind: str, axes: Sequence[Optional[str]]) -> tuple:
    """Register canonical logical axes for a named leaf kind; returns them."""
    AXIS_REGISTRY[kind] = tuple(axes)
    return AXIS_REGISTRY[kind]


def axes_for(kind: str) -> tuple:
    return AXIS_REGISTRY[kind]


def register_node_axes(name: str, predicate, expander):
    """Register a structured leaf kind: ``predicate(node)`` recognizes it,
    ``expander(node, dense_axes)`` returns the node with each tensor child
    replaced by its logical axes (``dense_axes`` None: replicated)."""
    _NODE_RULES.append((name, predicate, expander))


def is_registered_node(x) -> bool:
    return any(pred(x) for _, pred, _ in _NODE_RULES)


def expand_axes(node, axes):
    """Logical axes for one leaf: dense leaves keep ``axes``; registered
    node kinds expand to per-child axes."""
    for _, pred, exp in _NODE_RULES:
        if pred(node):
            return exp(node, axes)
    return axes


def registry_table() -> dict:
    """Named kinds -> axes, plus the structured kinds' names."""
    return {**{k: AXIS_REGISTRY[k] for k in sorted(AXIS_REGISTRY)},
            "node_kinds": tuple(name for name, _, _ in _NODE_RULES)}


CACHE_KIND_REGISTRY: dict = {}


@dataclasses.dataclass(frozen=True)
class CacheKind:
    """One serving-state leaf kind: its logical axes (a tuple, or a dict of
    sub-leaf -> tuple), whether it is positionally addressed (paging,
    speculation and chunked prefill need that), whether it is a pool-resident
    paged layout, and the family that owns it."""

    name: str
    axes: Any
    positional: bool
    paged: bool = False
    family: str = "attn"


def register_cache_kind(name: str, axes, *, positional: bool, paged: bool = False,
                        family: str = "attn"):
    """Register a serving-state leaf kind (its axes also enter the axis
    registry, as ``name`` or ``name.sub``); returns the stored axes."""
    if isinstance(axes, dict):
        stored = {k: register_axes(f"{name}.{k}", v) for k, v in axes.items()}
    else:
        stored = register_axes(name, axes)
    CACHE_KIND_REGISTRY[name] = CacheKind(name=name, axes=stored, positional=positional,
                                          paged=paged, family=family)
    return stored


def cache_kind(name: str) -> CacheKind:
    return CACHE_KIND_REGISTRY[name]


def cache_kind_table() -> dict:
    return {k: CACHE_KIND_REGISTRY[k] for k in sorted(CACHE_KIND_REGISTRY)}


@dataclasses.dataclass(frozen=True)
class Spec:
    """The resolved spec of one tensor leaf (a leaf of ``tree_specs``' tree,
    where a bare tuple would read as a container), with the mesh it was
    resolved on (``checkpoint.store.restore(shardings=)`` cuts by it)."""

    spec: tuple
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)


def _leaf_spec(mesh, rules, leaf, ax) -> tuple:
    shape = tuple(leaf.shape)
    if ax is None:
        ax = (None,) * len(shape)
    ax = tuple(ax)
    if len(ax) != len(shape):
        raise ValueError(f"{len(ax)} logical axes {ax} for shape {shape}")
    return _resolve(mesh, rules, ax, shape)


def map_leaves(fn, tree, axes_tree):
    """fn(leaf, axes) over a tree of tensors (nested dicts/lists, plan nodes
    expanded through the registry) and its axes tree; ``axes_tree`` None
    anywhere means replicated below it.  Returns the same structure."""
    if tree is None:
        return None
    if is_registered_node(tree):
        node = expand_axes(tree, axes_tree)
        return _map_node(fn, tree, node)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, None if axes_tree is None else axes_tree.get(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, None if axes_tree is None else axes_tree[i])
                          for i, v in enumerate(tree))
    if not isinstance(tree, torch.Tensor):
        return tree
    return fn(tree, axes_tree)


def _map_node(fn, node, axes_node):
    """A plan node with each tensor child (and each tensor of a dict child)
    replaced by fn(child, its axes)."""
    out = {}
    for f in dataclasses.fields(node):
        v, a = getattr(node, f.name), getattr(axes_node, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = fn(v, a)
        elif isinstance(v, dict):
            out[f.name] = {k: fn(t, None if a is None else a[k]) for k, t in v.items()}
    return dataclasses.replace(node, **out)


def tree_specs(tree, axes_tree, *, mesh=None, rules: Optional[dict] = None):
    """The resolved spec (a ``Spec``) of every tensor leaf of a params or
    cache tree (tensors, or meta tensors for shapes only), dense or
    compressed: the counterpart of the reference's ``tree_shardings``.
    ``axes_tree`` carries the dense logical axes; registered nodes expand."""
    mesh = mesh if mesh is not None else current_mesh()
    rules = rules if rules is not None else current_rules()
    if mesh is None:
        raise ValueError("tree_specs needs a mesh (argument or use_mesh)")
    return map_leaves(lambda leaf, ax: Spec(_leaf_spec(mesh, rules, leaf, ax), mesh),
                      tree, axes_tree)


def shard_degree(mesh, rules: dict, logical: Sequence[Optional[str]], shape, *,
                 dim: Optional[int] = None) -> int:
    """The shard degree ``_resolve`` achieves for a leaf (over all dims, or
    over ``dim``): 1 where divisibility dropped the mapping."""
    spec = _resolve(mesh, rules, logical, shape)
    sizes = axis_sizes(mesh)
    deg = 1
    for d in (range(len(spec)) if dim is None else (dim,)):
        entry = spec[d] if d < len(spec) else None
        if entry is None or entry is UNCONSTRAINED:
            continue
        deg *= _axes_size(sizes, entry)
    return deg


def parallelism_degrees(mesh, rules: dict, n_kv_heads: int = 0) -> tuple:
    """(data, model, kv) degrees for serving accounting: the batch axis's
    nominal degree, the model axis's size, and the degree the kv_heads
    dimension actually achieves (1 when it cannot split)."""
    if mesh is None:
        return 1, 1, 1
    sizes = axis_sizes(mesh)
    data = _axes_size(sizes, rules.get("batch"))
    model = int(sizes.get("model", 1))
    kv = shard_degree(mesh, rules, ("kv_heads",), (n_kv_heads,)) if n_kv_heads else 1
    return data, model, kv


def spec_for(shape: Sequence[int], *logical: Optional[str], mesh=None,
             rules: Optional[dict] = None) -> tuple:
    """The spec of a leaf of ``shape`` with logical axes (() without a mesh)."""
    mesh = mesh if mesh is not None else current_mesh()
    rules = rules or current_rules()
    if mesh is None:
        return ()
    return _resolve(mesh, rules, logical, shape)


# ---------------------------------------------------------------------------
# a rank's pieces: placement and relayout
# ---------------------------------------------------------------------------


def _piece(sizes: dict, coords: dict, entry) -> tuple:
    """(parts, index) of one spec entry: how many pieces its axes cut the
    dimension into, and this rank's (row-major over the axes)."""
    if entry is None or entry is UNCONSTRAINED:
        return 1, 0
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    parts, idx = 1, 0
    for a in axes:
        parts *= sizes[a]
        idx = idx * sizes[a] + coords[a]
    return parts, idx


def spec_axes(spec: tuple) -> tuple:
    """The mesh axes a spec splits its leaf over, in dimension order."""
    out: list = []
    for e in spec:
        if e is not None and e is not UNCONSTRAINED:
            out += [e] if isinstance(e, str) else list(e)
    return tuple(out)


def local_piece(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's piece of a whole tensor under ``spec`` (a view: each
    sharded dim narrowed to the rank's slice, pieces in rank order)."""
    sizes, coords = axis_sizes(mesh), mesh_coords(mesh)
    for d, entry in enumerate(spec):
        parts, idx = _piece(sizes, coords, entry)
        if parts > 1:
            n = x.shape[d] // parts
            x = x.narrow(d, idx * n, n)
    return x


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of this rank's piece of a leaf of ``shape`` under ``spec``."""
    sizes = axis_sizes(mesh)
    return tuple(n // _axes_size(sizes, None if e is UNCONSTRAINED else e)
                 for n, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


def local_zeros(tree, axes_tree, mesh, rules: dict, device, start=None):
    """Zeros of this rank's piece of every leaf of ``tree`` (meta tensors
    give the whole shapes and dtypes) by its logical axes: a sharded cache
    allocated as pieces.  ``start``, a tree like ``tree`` whose every leaf
    holds one value throughout (a cache of one slot), gives each leaf that
    value instead of zero (the xLSTM stabilizers start at -1e30).  A
    ``cache_seq`` mapping that does not divide its ring raises ValueError:
    a piece's global ring is its length times the mapping's ranks
    (``layers.cache_seq_piece``), so a ring kept whole there would be read
    as a piece."""
    values = []
    if start is not None:
        map_leaves(lambda t, ax: values.append(t.flatten()[0].item()), start, None)
    values = iter(values)
    sizes = axis_sizes(mesh)

    def one(t, ax):
        logical = tuple(ax) if ax else (None,) * t.dim()
        spec = _resolve(mesh, rules, logical, t.shape)
        if "cache_seq" in logical and rules.get("cache_seq") is not None:
            d = logical.index("cache_seq")
            mapped = rules["cache_seq"]
            used = {a for e in spec[:d] if e for a in ((e,) if isinstance(e, str) else e)}
            axes = [a for a in ((mapped,) if isinstance(mapped, str) else mapped)
                    if a in sizes and a not in used]
            if spec[d] is None and _axes_size(sizes, axes) > 1:
                raise ValueError(f"a ring of {t.shape[d]} slots under cache_seq over "
                                 f"{tuple(axes)}: the axes do not divide it")
        out = torch.zeros(local_shape(t.shape, spec, mesh), dtype=t.dtype, device=device)
        v = next(values, 0)
        return out.fill_(v) if v else out

    return map_leaves(one, tree, axes_tree)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """This rank's piece of the whole tensor ``x`` by logical axis names
    (the relayout of the reference's activation constraint); ``x`` itself
    without an active mesh."""
    s = _get()
    if not s:
        return x
    mesh, rules = s[-1]
    if len(logical) != x.dim():
        raise ValueError(f"{len(logical)} axes for rank-{x.dim()} tensor")
    return local_piece(x, _resolve(mesh, rules, logical, x.shape), mesh)


# a rank's piece keeps a dropped dimension whole, pinned or not
shard_pinned = shard


def axis_size(axis: str) -> int:
    """The active mesh's size on ``axis`` (1 without a mesh)."""
    mesh = current_mesh()
    return axis_sizes(mesh).get(axis, 1) if mesh is not None else 1


def axis_index(axis: str) -> int:
    """This rank's index on ``axis`` of the active mesh (0 without one)."""
    mesh = current_mesh()
    return mesh_coords(mesh).get(axis, 0) if mesh is not None else 0


def _group(axis: str):
    mesh = current_mesh()
    if isinstance(mesh, MeshShape):
        raise RuntimeError(f"a MeshShape has no process group for a collective over {axis!r}")
    return mesh.get_group(axis)


def all_gather(x: torch.Tensor, axis: str, dim: int = -1) -> torch.Tensor:
    """The ``axis`` group's pieces of ``x`` concatenated along ``dim`` in
    rank order (``x`` itself on a 1-wide axis)."""
    n = axis_size(axis)
    if n == 1:
        return x
    return _gather(x, _group(axis), n, dim)


def all_reduce(x: torch.Tensor, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced by ``op`` (the sum by default) over the ``axis`` group
    (a new tensor)."""
    if axis_size(axis) == 1:
        return x
    return _reduce(x, _group(axis), op)


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The ``n`` pieces of ``x`` of ``group``'s ranks concatenated along
    ``dim`` in rank order."""
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def _reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced by ``op`` over ``group`` (a new tensor, out of any
    autograd graph)."""
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


def _reduce_scatter(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ``n`` ranks, cut along ``dim`` into
    ``n`` equal pieces: this rank's piece (rank order), out of any autograd
    graph."""
    parts = [p.contiguous() for p in x.detach().chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def cols(y: torch.Tensor, split: bool, start: int, size: int) -> torch.Tensor:
    """Columns [start, start + size) of the whole last axis, from ``y`` that
    holds either the whole axis or (``split``) this rank's piece of M equal
    pieces over the model axis: a slice where the piece covers them, else
    an all-gather first.  A part of a whole axis is this rank's own (its
    heads, channels or contraction rows), so under autograd its gradient is
    summed over the model ranks (``fan_out``)."""
    if split:
        n = y.shape[-1]
        lo = axis_index("model") * n
        if lo <= start and start + size <= lo + n:
            return y.narrow(-1, start - lo, size)
        y = gather_pieces(y, "model", dim=-1)
    if size < y.shape[-1]:
        y = fan_out(y)
    return y.narrow(-1, start, size)


def data_rows(batch: int) -> Optional[slice]:
    """This data replica's rows of a batch of ``batch`` rows under the
    active rules (the ``batch`` mapping), or None when the batch stays whole
    (no mesh, a 1-wide data axis, or a batch that does not divide)."""
    mesh = current_mesh()
    if mesh is None:
        return None
    spec = _resolve(mesh, current_rules(), ("batch",), (batch,))
    parts, idx = _piece(axis_sizes(mesh), mesh_coords(mesh), spec[0])
    if parts == 1:
        return None
    n = batch // parts
    return slice(idx * n, (idx + 1) * n)


def gather_batch(x: torch.Tensor, rows: Optional[slice]) -> torch.Tensor:
    """The whole batch from this replica's ``rows`` of it (dim 0), in data
    order (``x`` itself when ``rows`` is None)."""
    if rows is None:
        return x
    axes = current_rules().get("batch")
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    for a in reversed([a for a in axes if axis_size(a) > 1]):
        x = all_gather(x, a, dim=0)
    return x


# ---------------------------------------------------------------------------
# collectives that autograd goes through: training on a mesh
# ---------------------------------------------------------------------------
#
# Every model rank of a data replica computes the same loss from replicated
# activations (Megatron's tensor parallelism), so two operators carry the
# gradient across the model axis: ``fan_out`` (identity forward, the ranks'
# gradients summed in the backward) where a replicated tensor enters work
# that differs by rank -- a column-split product, a rank's heads --, and
# ``reduce_sum`` (sum forward, identity backward) where the ranks' partial
# results become one replicated tensor -- a split contraction, the
# vocab-split embedding.  ``gather_pieces`` concatenates the ranks' pieces
# into a replicated tensor; its backward keeps the rank's slice of the
# replicated gradient.  (``torch.distributed.nn``'s all-reduce sums in its
# backward too: as ``reduce_sum`` it would make every gradient upstream of
# it M times too large.)  Each Function keeps its process group, since
# autograd runs a CUDA backward on a thread of its own, where ``use_mesh``'s
# stack is empty.  Without autograd -- serving -- the dispatchers call the
# plain collectives above.


def _grad_on(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _FanOut(torch.autograd.Function):
    """Forward: ``x`` as it is.  Backward: the gradient summed over the
    group's ranks, each of which used ``x`` for its own part of the work."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _ReduceSum(torch.autograd.Function):
    """Forward: the sum of ``x`` over the group's ranks.  Backward: the
    gradient as it is -- every rank holds the same gradient of the
    replicated sum, and its own term's share of it is all of it."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherPieces(torch.autograd.Function):
    """Forward: the group's pieces of ``x`` concatenated along ``dim`` in
    rank order.  Backward: this rank's slice (at ``index``) of the
    replicated gradient of the whole."""

    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        ctx.dim, ctx.start, ctx.len = dim, index * x.shape[dim], x.shape[dim]
        return _gather(x.detach(), group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.len).contiguous(), None, None, None, None


def fan_out(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """``x`` (replicated over ``axis``) entering rank-specific work: the
    identity, whose backward sums the ranks' gradients (``x`` itself
    without autograd or on a 1-wide axis)."""
    if axis_size(axis) == 1 or not _grad_on(x):
        return x
    return _FanOut.apply(x, _group(axis))


def reduce_sum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ``axis`` group: ``all_reduce``, or under
    autograd the sum whose backward is the identity."""
    if axis_size(axis) == 1:
        return x
    if not _grad_on(x):
        return all_reduce(x, axis)
    return _ReduceSum.apply(x, _group(axis))


def gather_pieces(x: torch.Tensor, axis: str, dim: int = -1) -> torch.Tensor:
    """The ``axis`` group's pieces of ``x`` concatenated along ``dim``:
    ``all_gather``, or under autograd the gather whose backward keeps this
    rank's slice of the gradient."""
    n = axis_size(axis)
    if n == 1:
        return x
    if not _grad_on(x):
        return all_gather(x, axis, dim)
    return _GatherPieces.apply(x, _group(axis), n, axis_index(axis), dim % x.dim())


class _SplitPieces(torch.autograd.Function):
    """Forward: this rank's piece (at ``index`` of ``n``) along ``dim`` of a
    tensor every rank of the group holds whole.  Backward: the group's
    pieces of the gradient concatenated -- the whole gradient, which the
    replicated work before the cut needs on every rank.  The conjugate of
    ``_GatherPieces``."""

    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        size = x.shape[dim] // n
        return x.narrow(dim, index * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.n, ctx.dim), None, None, None, None


class _ScatterSum(torch.autograd.Function):
    """Forward: the group's partial terms of ``x`` summed and cut along
    ``dim``, this rank's piece (a reduce-scatter).  Backward: the group's
    pieces of the gradient concatenated (an all-gather): each rank's term
    entered every piece of the sum."""

    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _reduce_scatter(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.n, ctx.dim), None, None, None


# ---------------------------------------------------------------------------
# Megatron sequence parallelism: the residual stream cut on its sequence
# ---------------------------------------------------------------------------
#
# Under a ``seq_sp`` rule (``launch.mesh.rules_for(sequence_parallel=True)``)
# the residual stream between blocks holds this rank's piece of the
# sequence (dim 1) over "model".  A block's input is gathered whole
# (``gather_seq``: all-gather, its backward the rank's slice of the
# gradient that the block's products summed over the ranks); its output
# comes back as the rank's piece (``scatter_seq``: the row-parallel
# product's partial terms reduce-scattered where tensor parallelism
# all-reduces them; ``split_seq``: a product every rank holds whole, cut).
# Norms run on the piece, their params entering it through ``fan_out``.


def seq_split(length: int) -> bool:
    """Whether the active rules cut a residual stream of ``length``
    positions over the model axis (``seq_sp``): False without a mesh or a
    mapping, or where the axis does not divide ``length`` (the reference's
    divisibility rule).  Raises NotImplementedError for a mapping onto
    another axis than "model", which the port does not run."""
    mesh = current_mesh()
    if mesh is None or current_rules().get("seq_sp") is None:
        return False
    entry = _resolve(mesh, current_rules(), ("seq_sp",), (length,))[0]
    if entry is None:
        return False
    if entry != "model":
        raise NotImplementedError(f"seq_sp over {entry!r}: the port cuts the residual "
                                  f"stream over 'model' only")
    return True


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """The whole sequence (dim 1) from the model ranks' pieces of it."""
    return gather_pieces(x, "model", dim=1)


def split_seq(x: torch.Tensor) -> torch.Tensor:
    """This rank's piece of the sequence (dim 1) of ``x``, which every
    model rank holds whole; under autograd its backward gathers the
    gradient whole."""
    n = axis_size("model")
    if n == 1:
        return x
    if not _grad_on(x):
        size = x.shape[1] // n
        return x.narrow(1, axis_index("model") * size, size).contiguous()
    return _SplitPieces.apply(x, _group("model"), n, axis_index("model"), 1)


def scatter_seq(x: torch.Tensor) -> torch.Tensor:
    """The sum of the model ranks' partial terms ``x`` (B, S, ...), this
    rank's piece of its sequence: a reduce-scatter, whose backward
    gathers the gradient whole."""
    n = axis_size("model")
    if n == 1:
        return x
    if not _grad_on(x):
        return _reduce_scatter(x, _group("model"), n, 1)
    return _ScatterSum.apply(x, _group("model"), n, 1)


def all_reduce_axes(x: torch.Tensor, axes: Sequence[str], op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced by ``op`` over each of ``axes`` of the active mesh in
    turn (over all of their ranks together)."""
    for a in axes:
        x = all_reduce(x, a, op)
    return x


# ---------------------------------------------------------------------------
# the vocab-parallel cross entropy
# ---------------------------------------------------------------------------


class _VocabNLL(torch.autograd.Function):
    """Each position's cross entropy over a vocabulary split over the
    group: ``logits`` (..., V_l) are this rank's columns [start, start +
    V_l).  Forward: the local max and an all-reduce MAX, the local sum of
    exp and an all-reduce SUM (the log-sum-exp), the label's logit taken
    on the rank that owns it and an all-reduce SUM; in fp32.  Backward
    (local, no collective): the rank's softmax columns minus the label's
    one-hot on its owner, times the positions' gradients; the gradient of
    the activations before the split product is summed over the ranks by
    its ``fan_out``.  No whole (rows, S, V) tensor exists."""

    @staticmethod
    def forward(ctx, logits, labels, start, group):
        lf = logits.to(torch.float32)
        V = lf.shape[-1]
        m = _reduce(lf.amax(dim=-1), group, dist.ReduceOp.MAX)
        lse = m + torch.log(_reduce(torch.exp(lf - m[..., None]).sum(dim=-1), group))
        local = labels.long() - start
        own = (local >= 0) & (local < V)
        local = local.clamp(0, V - 1)
        picked = lf.gather(-1, local[..., None])[..., 0]
        label_logit = _reduce(torch.where(own, picked, torch.zeros_like(picked)), group)
        ctx.save_for_backward(logits, lse, local, own)
        return lse - label_logit

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, own = ctx.saved_tensors
        p = torch.exp(logits.to(torch.float32) - lse[..., None])
        p.scatter_add_(-1, local[..., None], -own.to(p.dtype)[..., None])
        return (p * g[..., None]).to(logits.dtype), None, None, None


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor, start: int,
              axis: str = "model") -> torch.Tensor:
    """Each position's cross entropy (fp32, ``labels`` shaped like
    ``logits[..., 0]``, each >= 0) from this rank's vocabulary columns
    [start, start + V_l) of a vocabulary split over ``axis``
    (``_VocabNLL``)."""
    return _VocabNLL.apply(logits, labels, start, _group(axis))


def batch_axes() -> tuple:
    """The active mesh's axes that the ``batch`` rule maps to, of size > 1,
    in rule order (none without a mesh)."""
    axes = current_rules().get("batch")
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    return tuple(a for a in axes if axis_size(a) > 1)


def data_replicas() -> int:
    """The number of data replicas of the active mesh: the product of
    ``batch_axes``' sizes (1 without a mesh)."""
    n = 1
    for a in batch_axes():
        n *= axis_size(a)
    return n


def replica_index() -> int:
    """This rank's data replica, row-major over ``batch_axes`` -- the order
    of ``data_rows``' pieces (0 without a mesh)."""
    i = 0
    for a in batch_axes():
        i = i * axis_size(a) + axis_index(a)
    return i


def reduce_batch(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data replicas (``reduce_sum`` over each
    batch axis)."""
    for a in batch_axes():
        x = reduce_sum(x, a)
    return x


def carry_mesh(fn):
    """``fn`` run under the mesh and rules active now, wherever it is called
    from: ``torch.utils.checkpoint`` reruns a layer inside the backward,
    which autograd runs on a thread of its own for CUDA tensors."""
    s = _get()
    if not s:
        return fn
    mesh, rules = s[-1]

    def run(*args, **kwargs):
        with use_mesh(mesh, rules):
            return fn(*args, **kwargs)

    return run


def reduce_over(x: torch.Tensor, axes: Sequence[str], mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced by ``op`` over each of ``axes`` of ``mesh`` (a new
    tensor; ``x`` itself where every axis is 1-wide).  The mesh is named,
    not taken from ``use_mesh``, so no caller runs it unmeshed by
    accident."""
    sizes = axis_sizes(mesh)
    for a in axes:
        if sizes[a] > 1:
            x = _reduce(x, mesh.get_group(a), op)
    return x


# the flat buffers of ``all_reduce_flat``: a few collectives a step for the
# ~200 gradient leaves, without a second copy of a 1B model's gradients
FLAT_BUCKET_BYTES = 1 << 28


def all_reduce_flat(tensors: list, axes: Sequence[str], mesh) -> list:
    """The sums of ``tensors`` over each of ``axes`` of ``mesh``, a few flat
    buffers at a time (consecutive tensors of one dtype and device, up to
    ``FLAT_BUCKET_BYTES`` a buffer) instead of one collective a tensor.  Returns
    new tensors (views of the buffers), each the sum of its own tensor,
    element for element."""
    sizes = axis_sizes(mesh)
    groups = [mesh.get_group(a) for a in axes if sizes[a] > 1]
    if not groups:
        return list(tensors)
    buckets, size = [[]], 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        first = tensors[buckets[-1][0]] if buckets[-1] else t
        if buckets[-1] and (t.dtype != first.dtype or t.device != first.device
                            or size + nbytes > FLAT_BUCKET_BYTES):
            buckets.append([])
            size = 0
        buckets[-1].append(i)
        size += nbytes
    out = list(tensors)
    for idx in buckets:
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        for g in groups:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=g)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def gather_whole(piece: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from this rank's ``piece`` of it under ``spec`` (the
    inverse of ``local_piece``), on every rank of ``mesh``: each split
    dimension gathered over its axes, the minor axis first.  Collective
    over ``mesh``'s groups."""
    sizes = axis_sizes(mesh)
    x = piece
    for d, entry in enumerate(spec):
        if entry is None or entry is UNCONSTRAINED:
            continue
        for a in reversed((entry,) if isinstance(entry, str) else tuple(entry)):
            if sizes[a] > 1:
                x = _gather(x, mesh.get_group(a), sizes[a], d)
    return x
