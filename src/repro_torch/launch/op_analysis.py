"""Cost analysis of one eager step, op by op (the port's counterpart of
``repro/launch/hlo_analysis.py``).

The reference parses the optimized HLO of a jitted step and weights each
instruction by its loop's trip count.  Torch has no HLO: the port runs the
step eagerly, so ``OpAnalysis`` -- a ``TorchDispatchMode`` -- sees every
aten op the dispatcher runs, the backward's included, and charges each one
as the reference charges its instruction (``hlo_analysis.py:1-46``,
``_instr_costs`` at ``:397``).  Run under ``FakeTensorMode`` it needs no
memory and no card: the dry run (``launch/dryrun.py``) traces a step at
full width on the CPU this way.

Cost model per op (per rank: the step is one rank's program):
  * dot (mm, bmm, addmm, baddbmm, convolution, ...):
                 flops = 2 * |result| * K (K: the contraction's length)
  * reduction:   flops = |operands|
  * elementwise: flops = |result|

Bytes, in the reference's categories:
  * dot:          the operands at their source width (a dtype conversion
                  feeding a dot is fused into it: a bf16 weight cast up to
                  fp32 streams 2 bytes an element, an fp32 one cast down 2),
                  at most 4, plus at most 2 bytes a result element (the
                  result accumulates on chip);
  * reduce:       operands plus result;
  * copy:         2x the result of clone, cat, gather, index, scatter, pad,
                  roll and the like; views are free;
  * cache_update: 2x the update written in place into an existing tensor
                  (``copy_``, ``index_put_``, ``scatter_``: a KV cache slot,
                  a recurrent state);
  * collective:   the payload of each ``torch.distributed`` collective the
                  step sends (shardlib's ``all_gather`` / ``all_reduce`` /
                  ``reduce_over`` / ``all_reduce_flat`` and the autograd
                  Functions, which all reach c10d's ops), at the width the
                  port sends it -- a MoE's all-reduce is fp32;
  * entry_io:     the step's outputs, minus those that share storage with
                  an input the caller names as donated (updated in place);
  * while_carry:  always 0: an eager loop is unrolled, every trip of it is
                  seen and charged as it runs, so no carried state is left
                  to weight by a trip count.
Elementwise ops are assumed fused into a neighbour (0 bytes, their flops
counted), as in the reference.  Factories and metadata ops are free.

Memory (``Memory``): the arguments' bytes (their distinct storages), the
outputs', and the temp bytes: the peak of the storages the step creates
and still holds alive, above the arguments -- each new storage is weakly
referenced and counted until it is freed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
BYTE_CATS = ("entry_io", "dot", "reduce", "copy", "cache_update", "while_carry",
             "collective", "other")

# aten op name -> the position of its (lhs, rhs) operands
_DOTS = {"mm": (0, 1), "bmm": (0, 1), "matmul": (0, 1), "addmm": (1, 2),
         "baddbmm": (1, 2), "addbmm": (1, 2), "mv": (0, 1), "addmv": (1, 2),
         "dot": (0, 1), "vdot": (0, 1), "_int_mm": (0, 1)}
_CONVS = ("convolution", "_convolution", "conv1d", "conv2d")
_REDUCES = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
            "logsumexp", "_softmax", "_log_softmax", "_softmax_backward_data",
            "_log_softmax_backward_data", "var", "var_mean", "std", "std_mean", "norm",
            "linalg_vector_norm", "any", "all", "native_layer_norm",
            "native_layer_norm_backward", "cumsum", "cumprod", "nll_loss_forward",
            "nll_loss_backward", "aminmax"}
_COPIES = {"clone", "cat", "stack", "gather", "index", "_unsafe_index", "index_select",
           "embedding", "embedding_dense_backward", "take", "scatter", "scatter_add",
           "scatter_reduce", "index_put", "index_add", "index_copy", "constant_pad_nd",
           "pad", "roll", "flip", "repeat", "repeat_interleave", "sort", "topk",
           "contiguous", "masked_select", "tril_indices", "triu_indices"}
# in-place writes into an existing tensor -> the position of the update
_UPDATES = {"copy_": 1, "index_put_": 2, "_index_put_impl_": 2, "index_copy_": 3,
            "scatter_": 3, "scatter_add_": 3, "index_add_": 3, "slice_scatter": 1,
            "select_scatter": 1, "masked_scatter_": 2}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "zeros",
         "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros", "new_ones",
         "new_full", "arange", "scalar_tensor", "randn", "rand", "randint", "randperm",
         "randn_like", "rand_like", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
         "is_nonzero", "_has_compatible_shallow_copy_type", "set_", "resize_",
         "_to_copy_meta"}
# c10d's ops (what torch.distributed's collectives dispatch to) and the
# functional collectives, by the reference's collective names
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "allgather_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "broadcast_": "collective-permute", "send": "collective-permute",
         "recv_": "collective-permute",
         "all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}


@dataclasses.dataclass
class Costs:
    """One step's costs on one rank, in the reference's fields, plus
    ``dot_flops`` (the dots' and convolutions' share of ``flops``)."""

    flops: float = 0.0
    dot_flops: float = 0.0
    bytes_by_cat: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(BYTE_CATS, 0.0))
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))

    @property
    def bytes(self) -> float:
        return sum(self.bytes_by_cat.values())

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def add(self, other: "Costs", k: float = 1.0) -> None:
        """self += k * other, field by field."""
        self.flops += k * other.flops
        self.dot_flops += k * other.dot_flops
        for mine, theirs in ((self.bytes_by_cat, other.bytes_by_cat),
                             (self.collective_bytes, other.collective_bytes),
                             (self.collective_counts, other.collective_counts)):
            for key, v in theirs.items():
                mine[key] += k * v

    def copy(self) -> "Costs":
        out = Costs()
        out.add(self)
        return out


@dataclasses.dataclass
class Memory:
    """Bytes of one step: its arguments' distinct storages, its outputs',
    and the peak of the storages it made and held (above the arguments)."""

    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0


def tensors(tree) -> list:
    """Every tensor of a tree of dicts, lists, tuples and dataclasses (plan
    nodes), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree) for t in tensors(getattr(tree, f.name))]
    return []


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _signature(x):
    """A hashable key of a call's arguments: each tensor by its shape,
    strides, dtype and device type (not its values), everything else as
    it is."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    return x


def _layout(out):
    """The tensors' (shape, strides, dtype, device) of a call's output tree."""
    if isinstance(out, torch.Tensor):
        return ("T", tuple(out.shape), out.stride(), out.dtype, out.device)
    if isinstance(out, (list, tuple)):
        return type(out)(_layout(v) for v in out)
    return out


def _rebuild(layout):
    """Empty tensors laid out as ``_layout`` recorded them."""
    if isinstance(layout, tuple) and layout[:1] == ("T",):
        _, shape, stride, dtype, device = layout
        return torch.empty_strided(shape, stride, dtype=dtype, device=device)
    if isinstance(layout, (list, tuple)):
        return type(layout)(_rebuild(v) for v in layout)
    return layout


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages of a tree's tensors."""
    seen = WeakIdKeyDictionary()
    total = 0
    for t in tensors(tree):
        st = t.untyped_storage()
        if st not in seen:
            seen[st] = True
            total += st.nbytes()
    return total


class OpAnalysis(TorchDispatchMode):
    """Charges every op dispatched while it is active (``Costs``) and keeps
    the peak of the live storages made meanwhile.  ``before`` is a tree of
    the tensors that exist before the step (its arguments): their storages
    are not the step's temporaries."""

    def __init__(self, before=()):
        super().__init__()
        self.costs = Costs()
        self._known = WeakIdKeyDictionary()  # storage -> True: arguments and tracked ones
        self._width = WeakIdKeyDictionary()  # storage of a conversion -> its source's width
        for t in tensors(before):
            self._known[t.untyped_storage()] = True
        self.live = 0
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.overloadpacket.__name__ == "_to_copy" and isinstance(out, torch.Tensor):
            self._width[out.untyped_storage()] = self._source_width(args[0])
        self._charge(func, args, out)
        for t in tensors(out):
            self._track(t)
        return out

    def _source_width(self, t: torch.Tensor) -> int:
        """Bytes an element of the value ``t`` was converted from (its own
        width where it is no conversion's result)."""
        return min(t.element_size(), self._width.get(t.untyped_storage(), 8))

    def _dot_operand(self, t: torch.Tensor) -> int:
        return t.numel() * min(self._source_width(t), 4)

    @contextlib.contextmanager
    def repeated(self, module, name: str):
        """While active, a call of ``module.name`` whose arguments repeat an
        earlier call's signature (``_signature``: shapes, not values) is not
        run again: it adds the first call's costs, raises the peak by the
        first call's rise in live bytes, and returns empty tensors of its
        outputs' layout.  The op-level counterpart of the reference's
        trip-count weighting, for a loop body whose costs follow from its
        arguments' shapes (the flash attention's chunk rows, the sLSTM's
        token step): exact for the costs, and it spares the trace 64 x 64
        chunk pairs a layer at 32k tokens.  Calls recorded by autograd (an
        argument that requires grad, grad mode on) always run."""
        fn = getattr(module, name)
        memo: dict = {}

        def call(*args, **kwargs):
            if torch.is_grad_enabled() and any(t.requires_grad
                                               for t in tensors([args, kwargs])):
                return fn(*args, **kwargs)
            key = _signature([args, kwargs])
            if key in memo:
                delta, rise, layout = memo[key]
                self.costs.add(delta)
                self.peak = max(self.peak, self.live + rise)
                return _rebuild(layout)
            before, live, outer = self.costs.copy(), self.live, self.peak
            self.peak = live
            out = fn(*args, **kwargs)
            delta = self.costs.copy()
            delta.add(before, -1.0)
            memo[key] = (delta, self.peak - live, _layout(out))
            self.peak = max(outer, self.peak)
            return out

        setattr(module, name, call)
        try:
            yield
        finally:
            setattr(module, name, fn)

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._known:
            return
        self._known[st] = True
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _charge(self, func, args, out) -> None:
        c = self.costs
        name = func.overloadpacket.__name__
        if func.namespace in ("c10d", "_c10d_functional"):
            kind = _C10D.get(name)
            if kind is None:
                return
            # c10d's first argument is what lands: the reduced tensors, or
            # the gathered / scattered outputs (the reference charges a
            # collective's result); a functional collective returns it
            payload = sum(map(_nbytes, tensors(args[:1] if func.namespace == "c10d" else out)))
            c.collective_bytes[kind] += payload
            c.collective_counts[kind] += 1
            c.bytes_by_cat["collective"] += payload
            return
        if name in _FREE or func.is_view or func.namespace == "prim":
            return
        res = tensors(out)
        elems = res[0].numel() if res else 0
        if name in _DOTS:
            a, b = (args[i] for i in _DOTS[name])
            flops = 2.0 * elems * a.shape[-1]
            c.flops += flops
            c.dot_flops += flops
            c.bytes_by_cat["dot"] += (self._dot_operand(a) + self._dot_operand(b)
                                      + min(_nbytes(res[0]), 2 * elems))
        elif name in _CONVS:
            w = args[1]
            flops = 2.0 * elems * (w.numel() // w.shape[0])
            c.flops += flops
            c.dot_flops += flops
            c.bytes_by_cat["dot"] += _nbytes(args[0]) + _nbytes(w) + _nbytes(res[0])
        elif name in _REDUCES:
            ops = [t for t in tensors(args) if t.dim() > 0]
            c.flops += sum(t.numel() for t in ops)
            c.bytes_by_cat["reduce"] += sum(map(_nbytes, ops)) + sum(map(_nbytes, res))
        elif name in _UPDATES:
            upd = args[_UPDATES[name]] if len(args) > _UPDATES[name] else None
            if isinstance(upd, torch.Tensor):
                c.bytes_by_cat["cache_update"] += 2 * _nbytes(upd)
        elif name in _COPIES:
            c.bytes_by_cat["copy"] += 2 * sum(map(_nbytes, res))
        else:  # elementwise, assumed fused
            if not res and args and isinstance(args[0], torch.Tensor):
                elems = args[0].numel()  # an in-place op returns its own first argument
            c.flops += elems


def analyze(fn, *args, donate=(), repeated=()) -> tuple:
    """Run ``fn(*args)`` under ``OpAnalysis``: (its output, Costs, Memory).
    ``donate`` names the positions of the arguments the step updates in
    place (a cache, params and optimizer state): outputs that share their
    storage are not charged as entry I/O, as the reference subtracts its
    aliased outputs.  ``repeated`` lists (module, function name) pairs whose
    repeated calls replay their costs (``OpAnalysis.repeated``)."""
    mode = OpAnalysis(before=args)
    with contextlib.ExitStack() as stack:
        for module, name in repeated:
            stack.enter_context(mode.repeated(module, name))
        with mode:
            out = fn(*args)
    donated = WeakIdKeyDictionary()
    for i in donate:
        for t in tensors(args[i]):
            donated[t.untyped_storage()] = True
    seen = WeakIdKeyDictionary()
    entry = 0
    for t in tensors(out):
        st = t.untyped_storage()
        if st in donated or st in seen:
            continue
        seen[st] = True
        entry += _nbytes(t)
    mode.costs.bytes_by_cat["entry_io"] += entry
    mem = Memory(argument_bytes=storage_bytes(args), output_bytes=storage_bytes(out),
                 temp_bytes=mode.peak)
    return out, mode.costs, mem
