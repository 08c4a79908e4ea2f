"""Elastic scaling (port of ``repro/distributed/elastic.py``): re-plan the
mesh after losing ranks and re-shard state onto it.

Checkpoints store leaves whole (``checkpoint/store.py``), so elasticity is
a placement decision: the largest healthy (data, model) mesh that keeps the
model-parallel degree, then each rank takes its pieces of every leaf from
the same logical rules.  The batch axis stays the global batch.
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.distributed import shardlib as sl


def replan_mesh(n_healthy_devices: int, *, model_parallel: int,
                axis_names: Sequence[str] = ("data", "model")) -> sl.MeshShape:
    """The largest (data, model) mesh that fits the healthy device count
    while keeping the model-parallel degree (params must still fit a
    device), as a shape: the launcher starts its ranks."""
    if n_healthy_devices < model_parallel:
        raise ValueError(
            f"{n_healthy_devices} devices cannot sustain model_parallel={model_parallel}")
    data = n_healthy_devices // model_parallel
    return sl.MeshShape(dict(zip(tuple(axis_names), (data, model_parallel))))


def reshard_tree(tree, axes_tree, mesh, rules: Optional[dict] = None):
    """This rank's piece of every leaf of a whole tree on ``mesh`` (a
    DeviceMesh, or a MeshShape with coords), by logical axes; each piece is
    a contiguous copy, so the whole tree can be dropped."""
    rules = rules if rules is not None else sl.current_rules()

    def place(x, ax):
        spec = sl._resolve(mesh, rules, tuple(ax) if ax else (None,) * x.dim(), x.shape)
        return sl.local_piece(x, spec, mesh).contiguous().clone()

    return sl.map_leaves(place, tree, axes_tree)
