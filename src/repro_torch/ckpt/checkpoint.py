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

Across ranks, ``save(gather=, mesh=)`` takes each rank's blocks: every
rank of the mesh gathers each leaf whole (``train.step.state_gathers``;
collective), the mesh's first rank writes the reference's full-array
files, and the mesh waits for the write before any rank goes on; so the
manifest's checksums are those of a one-rank save of the same state.
``restore(place=)`` with a policy's ``named`` callables cuts the blocks
for any mesh, the one at save time or another.
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


def save(ckpt_dir, step: int, tree, *, keep: int = 3, gather=None,
         mesh=None) -> Path:
    """Write ``tree`` as step ``step`` under ``ckpt_dir`` (atomic), then
    keep the newest ``keep`` steps. ``gather`` (a tree of ``tree``'s
    structure holding per-leaf callables, block → whole leaf) makes each
    leaf whole first; with ``mesh`` of more than one rank, every rank of
    it calls ``save``, the first writes and all wait for it."""
    ckpt_dir = Path(ckpt_dir)
    if gather is not None:
        tree = tree_map(lambda leaf, fn: fn(leaf), tree, gather)
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist
        if dist.get_rank() == mesh.first_rank:
            _write(ckpt_dir, step, tree, keep)
        # the wait: a one-element all-reduce on the mesh's device, the
        # path the gathers took
        dist.all_reduce(torch.zeros(1, device=mesh.device),
                        group=mesh.mesh_group)
        return ckpt_dir / f"step_{step:08d}"
    return _write(ckpt_dir, step, tree, keep)


def _write(ckpt_dir: Path, step: int, tree, keep: int) -> Path:
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
    target leaf's, before placing and after, raises ``ValueError`` (the
    target may hold the whole leaves or this rank's blocks of them)."""
    src = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((src / "manifest.json").read_text())
    leaves = tree_leaves(target_tree)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(f"the target has {len(leaves)} leaves, step {step} "
                         f"holds {len(manifest['leaves'])}")
    fns = [None] * len(leaves) if place is None else tree_leaves(
        tree_map(lambda _, fn: _Fn(fn), target_tree, place))
    out = []
    for i, (ref, meta, fn) in enumerate(zip(leaves, manifest["leaves"],
                                            fns)):
        arr = np.load(src / meta["file"])
        if verify and _checksum(arr) != meta["sha256"]:
            raise IOError(f"checksum mismatch in {meta['file']}")
        shapes = {tuple(arr.shape)}
        if fn is not None and fn.fn is not None:
            arr = fn.fn(arr)
            shapes.add(tuple(arr.shape))
        if hasattr(ref, "shape") and tuple(ref.shape) not in shapes:
            raise ValueError(f"shape mismatch leaf {i}: "
                             f"{tuple(ref.shape)} vs {tuple(arr.shape)}")
        out.append(arr)
    return tree_unflatten(target_tree, out)


class _Fn:
    """A placement callable held as one leaf (``None`` is a subtree)."""
    def __init__(self, fn):
        self.fn = fn
