"""Manifest-based checkpointing with atomic publication — the port of the
JAX package's ``repro/checkpoint/checkpoint.py``, in its on-disk format,
so each package reads the other's checkpoints.

Layout::

    <dir>/step_000042/          # complete, published checkpoint
        manifest.json           # treedef, shapes, dtypes, step, metadata
        leaf_00000.npy ...      # one file per pytree leaf (flatten order)
    <dir>/.tmp_step_000042/     # in-progress (renamed atomically on success)

Restart-safety: a checkpoint is visible iff its directory rename
completed, so a killed writer never leaves a half-readable step. The leaf
order is ``torch.utils._pytree``'s flatten order of the tree. A bfloat16
leaf, which numpy lacks, is stored as its ``uint16`` bit pattern with the
logical dtype ``"bfloat16"`` in the manifest, as the JAX package stores
it; it goes through ``tensor.view(torch.uint16)`` and back, bit for bit.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

__all__ = ["save", "restore", "all_steps", "latest_step"]

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """``(array to store, logical dtype name)`` of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _leaf_tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == "bfloat16":
        return torch.from_numpy(arr.astype(np.uint16, copy=False)).view(
            torch.bfloat16)
    return torch.from_numpy(arr.view(np.dtype(logical)))


def save(directory: str, step: int, tree, *, keep: int = 3,
         metadata: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, f".tmp_{name}")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves, spec = pytree.tree_flatten(tree)
    manifest = {
        "step": step,
        "treedef": str(spec),
        "n_leaves": len(leaves),
        "process_count": 1,
        "leaves": [],
        "metadata": metadata or {},
    }
    for i, leaf in enumerate(leaves):
        arr, logical = _host_array(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "file": fname, "shape": list(arr.shape), "dtype": logical})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publication
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)


def all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        m = _STEP_RE.match(d)
        if m and os.path.exists(os.path.join(directory, d, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: Optional[int] = None, *, target=None):
    """Load a checkpoint (the latest without ``step``) → ``(tree,
    manifest)``. Without ``target`` the tree is the list of leaves as CPU
    tensors, in manifest order. ``target`` (a tree of tensors shaped like
    the saved one, e.g. the train state, or zero-size stand-ins of it)
    supplies the structure, and each leaf lands on its target leaf's
    device."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tensors = [_leaf_tensor(np.load(os.path.join(path, entry["file"])),
                            entry["dtype"])
               for entry in manifest["leaves"]]
    if target is None:
        return tensors, manifest
    leaves, spec = pytree.tree_flatten(target)
    if len(leaves) != len(tensors):
        raise ValueError(f"checkpoint {path} has {len(tensors)} leaves; the "
                         f"target has {len(leaves)}")
    placed = [t.to(leaf.device) for t, leaf in zip(tensors, leaves)]
    return pytree.tree_unflatten(placed, spec), manifest
