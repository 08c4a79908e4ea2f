"""Atomic checkpoint store (port of ``repro/checkpoint/store.py``, without
jax): the directory layout the reference writes, read and written with
numpy and torch only.

Layout (one directory per step):

    <base>/step_000000123/
        MANIFEST.json      # step, n_leaves, treedef, leaves [{dtype, shape}], metadata
        leaf_00000.npy ... # one file per leaf, in the caller's flatten order

Guarantees, as in the reference:
  * atomic: written to ``step_X.tmp`` then ``os.rename``'d -- a crash
    mid-save never corrupts the latest valid checkpoint;
  * restartable: ``latest_step``/``restore_flat`` pick the newest
    *complete* checkpoint (``MANIFEST.json`` is written last);
  * keep-k GC: old checkpoints are removed after a newer one is complete.

bfloat16 leaves: numpy has no bfloat16, and ``np.save`` of the
reference's bf16 arrays writes raw 2-byte records (descr ``<V2``) that
``np.load`` returns as void data.  The manifest's ``dtype`` says what they
are: ``restore_flat`` reinterprets such records as ``torch.bfloat16``, and
``save`` writes a bf16 tensor the same way.

Trees: ``save`` takes any params-like tree (nested dicts, lists and
tuples of tensors or arrays, plan nodes; a flat list is one) and stores
its leaves in the order the reference's ``jax.tree_util.tree_flatten``
gives the same tree (``weight_plan.flatten_leaves``: dict keys sorted).
``restore`` puts them back into the structure of a ``tree_like``, so a
``(params, opt_state)`` checkpoint goes both ways between the packages.
``AsyncCheckpointer`` copies every leaf to the host synchronously and
writes on a worker thread.

On a mesh checkpoints still hold whole leaves, as the reference's do:
``gather_state`` assembles the whole leaves of every rank's pieces on one
rank (the host copy it writes), leaf by leaf, and ``restore(shardings=)``
restores onto a mesh of any shape: each rank reads the stored leaves
through a memory map and copies out its own pieces on the host, so no rank
holds a whole state, on the host or the card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.weight_plan import flatten_leaves, map_tree, unflatten_leaves
from repro_torch.distributed import shardlib as sl

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:09d}")


def _to_numpy(leaf) -> tuple:
    """(array to ``np.save``, the manifest's dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(base: str, step: int, tree: Any, metadata: Optional[dict] = None,
         keep: int = 3) -> str:
    """Synchronous atomic write of the leaves of ``tree`` (tensors or
    arrays) in the reference's flatten order, and ``metadata``.  Returns
    the final directory."""
    leaves = flatten_leaves(tree)
    final = _step_dir(base, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    entries = []
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        entries.append({"dtype": dtype, "shape": list(arr.shape)})
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        # the reference stores jax's treedef string here, which the port
        # cannot build; its readers check shapes instead
        "treedef": "repro_torch: leaves in jax.tree_util's flatten order",
        "leaves": entries,
        "metadata": metadata or {},
    }
    # the manifest is written last inside tmp; the rename publishes atomically
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(base, keep)
    return final


def _gc(base: str, keep: int):
    steps = sorted(all_steps(base))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(base, s), ignore_errors=True)


def all_steps(base: str) -> list:
    """Steps with a complete directory (``MANIFEST.json`` present); ``.tmp``
    directories and directories without a manifest are ignored."""
    if not os.path.isdir(base):
        return []
    out = []
    for name in os.listdir(base):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(base, name, "MANIFEST.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(base: str) -> Optional[int]:
    steps = all_steps(base)
    return steps[-1] if steps else None


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_flat(base: str, step: Optional[int] = None, mmap: bool = False) -> tuple:
    """(list of CPU tensors in the stored leaf order, manifest dict) of the
    newest complete step, or of ``step``; with ``mmap`` the tensors map the
    files copy-on-write (read as they are touched).  Raises
    FileNotFoundError when no complete step exists."""
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {base}")
    d = _step_dir(base, step)
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    leaves = [
        _from_numpy(np.load(os.path.join(d, f"leaf_{i:05d}.npy"), mmap_mode="c" if mmap else None),
                    entry["dtype"])
        for i, entry in enumerate(manifest["leaves"])
    ]
    return leaves, manifest


def restore(base: str, tree_like: Any, step: Optional[int] = None, shardings: Any = None) -> tuple:
    """Restore the newest complete step (or ``step``) into the structure of
    ``tree_like``: each stored leaf keeps its stored dtype and goes to the
    device of the ``tree_like`` leaf in its place.  ``shardings`` (a tree of
    ``shardlib.Spec`` matching ``tree_like``, from ``shardlib.tree_specs``
    on this rank's mesh) keeps each leaf's local piece on this rank.
    Raises ValueError when the leaf count or a shape differs, TypeError
    when a sharding is not a Spec.  Returns (tree, metadata)."""
    arrs, manifest = restore_flat(base, step, mmap=shardings is not None)
    if shardings is not None:
        specs = flatten_leaves(shardings)
        if len(specs) != len(arrs) or not all(isinstance(s, sl.Spec) for s in specs):
            raise TypeError("shardings must be a tree of shardlib.Spec, one per stored leaf")
        arrs = [_own(sl.local_piece(a, s.spec, s.mesh)) for a, s in zip(arrs, specs)]
    leaves_like = flatten_leaves(tree_like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected {len(leaves_like)}")
    out = []
    for i, (arr, like) in enumerate(zip(arrs, leaves_like)):
        if shardings is None and tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"leaf {i}: shape {tuple(arr.shape)} != expected {tuple(like.shape)}")
        out.append(arr.to(like.device) if isinstance(like, torch.Tensor) else arr)
    return unflatten_leaves(tree_like, out), manifest["metadata"]


def _own(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in memory of its own (off a memory-mapped file)."""
    return torch.empty(t.shape, dtype=t.dtype).copy_(t)


def gather_state(tree: Any, specs: Any, rank: int) -> Optional[Any]:
    """The whole leaves of ``tree`` -- a rank's pieces, placed by ``specs``
    (a tree of ``shardlib.Spec`` like it) -- as host tensors on rank 0 (the
    writer), None on the others.  Collective: every rank of the specs' mesh
    calls it, and one leaf is gathered at a time, so a rank holds one whole
    leaf on its device at most."""
    out = []
    for t, s in zip(flatten_leaves(tree), flatten_leaves(specs)):
        whole = sl.gather_whole(t.detach(), s.spec, s.mesh)
        out.append(whole.to("cpu", copy=True) if rank == 0 else None)
    return unflatten_leaves(tree, out) if rank == 0 else None


def _host_copy(leaf):
    """A host copy of one leaf that later in-place updates cannot reach
    (``.cpu()`` of a CPU tensor is the same storage)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


class AsyncCheckpointer:
    """Copy to the host synchronously, write to disk on a worker thread; one
    save in flight at a time, and a worker's error is raised by the next
    ``save`` or ``wait``."""

    def __init__(self, base: str, keep: int = 3):
        self.base = base
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None):
        self.wait()  # one in-flight save at a time
        self.save_host(step, map_tree(lambda _, leaf: _host_copy(leaf), tree), metadata)

    def save_host(self, step: int, host_tree: Any, metadata: Optional[dict] = None):
        """``save`` of a tree of host tensors the caller hands over (no later
        update reaches them: ``gather_state``'s), written without a copy."""
        self.wait()

        def work():
            try:
                save(self.base, step, host_tree, metadata, keep=self.keep)
            except BaseException as e:  # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
