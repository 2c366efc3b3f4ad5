"""Mesh construction (counterpart of ``repro/launch/mesh.py``).

Only ``make_host_mesh`` is ported: the small mesh the reduced-config
drivers, the examples and the FFT serving engine's lazy default run on.
In the port one process drives one device, so a host mesh is a
one-process mesh over ``compat.make_mesh``: every axis extent 1, on the
CUDA device unless the caller asks for the CPU. A mesh over several
ranks is ``compat.make_mesh`` after ``torch.distributed`` is
initialised. The reference's production, multi-host (DCN × ICI),
transit and elastic set-ups stay with ROADMAP queue 1 items 14 and 17.
"""
from __future__ import annotations

from repro_torch.compat import Mesh, make_mesh


def make_host_mesh(shape=(2, 2), axes=("data", "model"), *,
                   device=None) -> Mesh:
    """Small mesh over the devices this process has (tests, examples,
    the serving engine's default).

    As in the reference, a requested shape that does not fit the
    devices present falls back to a layout over however many there are,
    so callers get *a* mesh, not an error: here that is one device, so
    every axis has extent 1. ``device`` defaults to ``cuda:{LOCAL_RANK}``
    and raises where that device does not exist; ``device="cpu"`` builds
    the mesh on the CPU."""
    if len(shape) != len(axes):
        raise ValueError(f"{len(shape)} axis extents for {len(axes)} axis "
                         f"names")
    return make_mesh((1,) * len(axes), axes, device=device)
