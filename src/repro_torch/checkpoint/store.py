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

The reference's ``restore`` (re-sharding onto a mesh) and
``AsyncCheckpointer`` are ROADMAP A13/A14.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import numpy as np
import torch

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


def save(base: str, step: int, leaves: list, metadata: Optional[dict] = None,
         keep: int = 3) -> str:
    """Synchronous atomic write of ``leaves`` (tensors or arrays, in the
    caller's flatten order) and ``metadata``.  Returns the final
    directory."""
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
        "treedef": "repro_torch: leaves in the caller's flatten order",
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


def restore_flat(base: str, step: Optional[int] = None) -> tuple:
    """(list of CPU tensors in the stored leaf order, manifest dict) of the
    newest complete step, or of ``step``.  Raises FileNotFoundError when no
    complete step exists."""
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {base}")
    d = _step_dir(base, step)
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    leaves = [
        _from_numpy(np.load(os.path.join(d, f"leaf_{i:05d}.npy")), entry["dtype"])
        for i, entry in enumerate(manifest["leaves"])
    ]
    return leaves, manifest
