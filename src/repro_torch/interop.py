"""Reference params -> port params, without importing the reference.

``params_from_reference`` takes the reference's params tree -- nested dicts
and lists of arrays (numpy, or anything ``np.asarray`` accepts), including
a compressed tree whose leaves are the reference's ``PackedLinear`` nodes
(any object with ``blocks``/``block_rows``/``counts``/``scales``/``walk``/
``kind``/``shape``/``bk``/``bn`` attributes) and ``{"q", "s"}`` dicts --
and returns the same tree of torch tensors, with port ``PackedLinear`` and
``QuantLinear`` nodes.  ``plan_from_reference`` does the same for a reference
``WeightPlan``, so both packages can serve the identical packed payload.
``opt_state_from_reference`` carries the reference's optimizer state
(``step``, ``mu``/``nu`` or ``mom``, ``ef``) across the same way, and
``tree_to_numpy`` goes back: a dense tree of port tensors as numpy arrays
in the same nesting, which the reference takes as its params or state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.weight_plan import (
    LeafPlan,
    PackedLinear,
    PlanConfig,
    QuantLinear,
    WeightPlan,
    _index_nodes,
)


def _tensor(a, device):
    return torch.from_numpy(np.array(np.asarray(a))).to(device)


def _is_packed(n) -> bool:
    return all(hasattr(n, a) for a in ("blocks", "block_rows", "counts", "kind", "bk", "bn"))


def params_from_reference(tree, device="cpu", use_kernel: bool = True):
    """Convert a reference params tree (dense or compressed) leaf for leaf."""
    if _is_packed(tree):
        walk = None
        if tree.walk is not None:
            walk = {k: _tensor(v, "cpu") for k, v in tree.walk.items()}  # host only
        return PackedLinear(
            blocks=_tensor(tree.blocks, device),
            block_rows=_tensor(tree.block_rows, device),
            counts=_tensor(tree.counts, device),
            scales=None if tree.scales is None else _tensor(tree.scales, device),
            walk=walk, kind=tree.kind, shape=tuple(tree.shape), bk=int(tree.bk),
            bn=int(tree.bn), use_kernel=use_kernel)
    if isinstance(tree, dict) and "q" in tree:  # the reference's int8 leaf
        return QuantLinear(q=_tensor(tree["q"], device), s=_tensor(tree["s"], device),
                           use_kernel=use_kernel)
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device, use_kernel) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_reference(v, device, use_kernel) for v in tree)
    return _tensor(tree, device)


def plan_from_reference(ref_plan, device="cpu", use_kernel: bool = True) -> WeightPlan:
    """A port WeightPlan holding the reference plan's packed payload and
    per-leaf statistics (its PlanConfig fields that the port shares)."""
    params = params_from_reference(ref_plan.params, device, use_kernel)
    rc = ref_plan.cfg
    cfg = PlanConfig(default=rc.default, rules=tuple(rc.rules), q_prune=rc.q_prune,
                     bk=rc.bk, bn=rc.bn, score=rc.score, min_size=rc.min_size,
                     min_contract=rc.min_contract, use_kernel=use_kernel)
    leaves = {
        p: LeafPlan(path=l.path, kind=l.kind, shape=tuple(l.shape), n_weights=int(l.n_weights),
                    surviving=int(l.surviving), payload_bytes=float(l.payload_bytes),
                    metadata_bytes=float(l.metadata_bytes), axes=tuple(l.axes))
        for p, l in ref_plan.leaves.items()
    }
    return WeightPlan(cfg=cfg, leaves=leaves, params=params, _by_path=_index_nodes(params))


OPT_STATE_KEYS = ("step", "mu", "nu", "mom", "ef")


def opt_state_from_reference(state, device="cpu") -> dict:
    """The reference's optimizer state as port tensors: the int32 ``step``
    and every moment tree, leaf for leaf."""
    unknown = set(state) - set(OPT_STATE_KEYS)
    if unknown:
        raise ValueError(f"not an optimizer state: unknown keys {sorted(unknown)}")
    return {k: params_from_reference(v, device) for k, v in state.items()}


def tree_to_numpy(tree):
    """A dense tree of tensors (dicts, lists, tuples) as numpy arrays in the
    same nesting; the reference takes such a tree through ``jnp.asarray``."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()
