"""Device mesh for the port (counterpart of ``repro/compat.py:43``).

The reference builds a ``jax.sharding.Mesh`` over its devices. This
slice of the port runs on one device, so a mesh here is a named shape
plus the ``torch.device`` every stage allocates on. Meshes of more than
one device need ``torch.distributed`` process groups, which come with
ROADMAP queue 1 item 8.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named mesh axes over one device: ``shape[name]`` is the axis
    extent, as on a ``jax.sharding.Mesh``."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    device: torch.device


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device="cuda") -> Mesh:
    """A mesh over ``device`` (the CUDA device unless the caller asks for
    the CPU). Only meshes of total size 1 exist in this slice."""
    axis_shapes = tuple(int(s) for s in axis_shapes)
    axis_names = tuple(axis_names)
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"{len(axis_shapes)} axis extents for "
                         f"{len(axis_names)} axis names")
    if math.prod(axis_shapes) != 1:
        raise NotImplementedError(
            f"mesh {dict(zip(axis_names, axis_shapes))} spans more than one "
            f"device; multi-device meshes over torch.distributed are "
            f"ROADMAP queue 1 item 8")
    return Mesh(axis_names, dict(zip(axis_names, axis_shapes)),
                torch.device(device))
