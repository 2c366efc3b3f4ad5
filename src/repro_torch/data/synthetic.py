"""Deterministic synthetic token streams (counterpart of
``repro/data/synthetic.py``, numpy only: the batches are the
reference's bit for bit).

Restart-reproducible by construction: batch contents are a pure function
of (seed, step), so a job restarted from checkpoint step k regenerates
exactly the batches it would have seen — required for the fault-tolerance
resume-equivalence test.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def batch_at(step: int, *, global_batch: int, seq_len: int, vocab: int,
             seed: int = 0, family: str = "dense",
             num_patches: int = 0, patch_dim: int = 0,
             frame_dim: int = 0) -> Dict[str, np.ndarray]:
    """Tokens/labels (+ stub modality inputs) for one step."""
    rng = np.random.Generator(np.random.Philox(key=seed, counter=[0, 0, 0, step]))
    # Learnable stream: deterministic affine chain x_{t+1} = a·x_t + c
    # (mod V) with 10% noise resets — a pure bigram structure any LM can
    # fit, so example loss curves actually move.
    mult, inc = 31, 7
    x0 = rng.integers(0, vocab, size=(global_batch, 1), dtype=np.int64)
    tokens = np.empty((global_batch, seq_len + 1), dtype=np.int64)
    tokens[:, 0] = x0[:, 0]
    for t in range(1, seq_len + 1):
        tokens[:, t] = (tokens[:, t - 1] * mult + inc) % vocab
    noise = rng.random((global_batch, seq_len + 1)) < 0.1
    resets = rng.integers(0, vocab, size=(global_batch, seq_len + 1))
    tokens = np.where(noise, resets, tokens).astype(np.int32)
    out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:].copy()}
    if family == "vlm" and num_patches:
        out["patch_embeds"] = rng.standard_normal(
            (global_batch, num_patches, patch_dim), dtype=np.float32) * 0.02
        out["labels"][:, :num_patches] = -1
    if family == "encdec":
        out["frames"] = rng.standard_normal(
            (global_batch, seq_len, frame_dim), dtype=np.float32) * 0.02
    return out


def stream(start_step: int = 0, **kw) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at(step, **kw)
        step += 1
