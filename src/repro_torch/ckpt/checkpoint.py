"""Atomic checkpoints of a tree of arrays (counterpart of
``repro/ckpt/checkpoint.py``).

The reference's contract, and its file format:
  * **atomic**  — a step is written to ``step_XXXXXXXX.tmp`` and renamed
    only after its manifest (with a ``sha256[:16]`` checksum per leaf)
    lands, so a crashed writer never leaves a loadable but corrupt step;
  * **keep-k**  — older steps are removed after a successful save;
  * **placed restore** — ``restore`` loads into the structure of a
    target tree and places each leaf with the caller's callable (the
    reference takes a tree of ``NamedSharding``; a rank here takes its
    block, e.g. ``SpectralBasis.place_spectral``).

Format: ``<dir>/step_<n>/arr_<i>.npy`` and ``manifest.json`` (step,
treedef, and per leaf its file, shape, dtype and checksum). Leaves are
numbered in ``jax.tree_util`` order, dict keys sorted
(``repro_torch.tree_util``), so a directory that the reference's
``save`` wrote restores here, and the reverse. Leaves are saved as the
global arrays the caller hands in: torch tensors are copied to the host;
a solver gathers its blocks first (``SpectralSolverBase._ckpt_tree``).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree_util import (tree_leaves, tree_map, tree_unflatten,
                                   treedef_str)


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def save(ckpt_dir, step: int, tree, *, keep: int = 3) -> Path:
    """Write ``tree`` as step ``step`` under ``ckpt_dir`` (atomic), then
    keep the newest ``keep`` steps."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest: Dict[str, Any] = {"step": step, "leaves": [],
                                "treedef": treedef_str(tree)}
    for i, leaf in enumerate(tree_leaves(tree)):
        arr = _host(leaf)
        fname = f"arr_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append({
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "sha256": _checksum(arr),
        })
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish

    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(d for d in ckpt_dir.glob("step_*")
                   if d.is_dir() and not d.name.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(d, ignore_errors=True)
    for d in ckpt_dir.glob("*.tmp"):
        shutil.rmtree(d, ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(int(d.name.split("_")[1]) for d in ckpt_dir.glob("step_*")
                   if d.is_dir() and not d.name.endswith(".tmp"))
    return steps[-1] if steps else None


def restore(ckpt_dir, step: int, target_tree, *, place=None,
            verify: bool = True):
    """Load ``step`` into the structure of ``target_tree``.

    ``place`` is None or a tree of ``target_tree``'s structure holding,
    per leaf, a callable (numpy array → the placed leaf) or None. A leaf
    without a callable comes back as a numpy array. A checksum that does
    not match raises ``IOError``; a leaf whose shape differs from the
    target leaf's raises ``ValueError``."""
    src = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((src / "manifest.json").read_text())
    leaves = tree_leaves(target_tree)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(f"the target has {len(leaves)} leaves, step {step} "
                         f"holds {len(manifest['leaves'])}")
    out = []
    for i, (ref, meta) in enumerate(zip(leaves, manifest["leaves"])):
        arr = np.load(src / meta["file"])
        if verify and _checksum(arr) != meta["sha256"]:
            raise IOError(f"checksum mismatch in {meta['file']}")
        if hasattr(ref, "shape") and tuple(ref.shape) != arr.shape:
            raise ValueError(f"shape mismatch leaf {i}: "
                             f"{tuple(ref.shape)} vs {arr.shape}")
        out.append(arr)
    tree = tree_unflatten(target_tree, out)
    if place is None:
        return tree
    return tree_map(lambda arr, fn: arr if fn is None else fn(arr), tree,
                    place)
