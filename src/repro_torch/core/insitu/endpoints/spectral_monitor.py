"""Spectral monitor — the paper's technique inside a training or serving
loop (counterpart of ``repro/core/insitu/endpoints/spectral_monitor.py``).

The "simulation" of the chain is a running job: this endpoint takes the
tensors the step exposes (gradients, parameters, logits), computes
per-tensor power spectra (FFT along the trailing dim, binned) on the
device with no host round trip, and publishes small ``insitu_*``
arrays. High-frequency gradient energy is a practical instability
diagnostic.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch.core.fft.spectrum import tensor_spectrum_summary
from repro_torch.core.insitu.bridge import BridgeData
from repro_torch.core.insitu.endpoint import Endpoint


def tree_leaves_with_path(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf of nested dicts, lists and tuples, in
    ``jax.tree_util`` order (dict keys sorted), with its ``keystr``
    paths (``['a'][0]``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in tree_leaves_with_path(tree[k],
                                                  f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree)
                for leaf in tree_leaves_with_path(v, f"{path}[{i}]")]
    return [(path, tree)]


class SpectralMonitorEndpoint(Endpoint):
    """Per-tensor power spectra of a tree of tensors, on the device."""

    name = "spectral_monitor"

    def __init__(self, *, source: str = "grads", nbins: int = 16,
                 max_tensors: int = 8, min_last_dim: int = 64,
                 sample_rows: int = 4):
        super().__init__(source=source, nbins=nbins)
        self.source = source
        self.nbins = nbins
        self.max_tensors = max_tensors
        self.min_last_dim = min_last_dim
        # spectra of a leading-rows sample of each tensor: the reference
        # measured a full-tensor FFT of a sharded tensor gathering it
        self.sample_rows = sample_rows

    def _sample(self, leaf):
        return leaf.reshape(-1, leaf.shape[-1])[: self.sample_rows]

    def execute(self, data: BridgeData) -> BridgeData:
        """Publish normalised per-tensor spectra
        (``insitu_grad_spectra``) and the mean high-frequency energy
        fraction (``insitu_highfreq_frac``)."""
        leaves = [(p, self._sample(l)) for p, l
                  in tree_leaves_with_path(data.arrays[self.source])
                  if torch.is_tensor(l) and l.dim() >= 2
                  and l.shape[-1] >= self.min_last_dim]
        leaves = leaves[: self.max_tensors]
        if leaves:
            spectra = torch.stack([tensor_spectrum_summary(l, self.nbins)
                                   for _, l in leaves])
        else:
            spectra = torch.zeros((1, self.nbins), dtype=torch.float32)
        total = spectra.sum(dim=-1, keepdim=True)
        norm = spectra / torch.clamp(total, min=1e-20)
        arrays = dict(data.arrays)
        arrays["insitu_grad_spectra"] = norm
        # high-frequency fraction: the top half of the bins
        arrays["insitu_highfreq_frac"] = torch.mean(
            norm[:, self.nbins // 2:].sum(dim=-1))
        return data.replace(arrays=arrays)
