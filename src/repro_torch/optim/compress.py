"""Int8 gradient compression with error feedback (counterpart of
``repro/optim/compress.py``).

For bandwidth-bound data-parallel training: gradients are quantized to
int8 *before* the data-parallel all-reduce and dequantized after,
cutting collective bytes 4x against float32. The quantization residual
is carried in an error-feedback buffer (Seide et al. 2014; Karimireddy
et al. 2019) so the bias does not accumulate.

Quantization delegates to the block-scaled wire codec
(``core/fft/wire.Int8Codec``): per-block absmax scales over the last
axis, ``block=64`` by default, so one outlier coarsens only its own
block (the reference's reason for dropping one absmax per leaf). Its
payloads and scales are the reference's bit for bit (round half to
even in both).

``compressed_psum_tree`` reduces over a ``torch.distributed`` process
group (the reference's ``psum`` over mesh axes inside ``shard_map``);
with one rank, or no process group, it is the identity on the
dequantized gradients plus the error feedback.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.fft import wire
from repro_torch.tree_util import tree_leaves, tree_map, tree_unflatten

DEFAULT_BLOCK = wire.DEFAULT_BLOCK


def _codec(block: Optional[int]) -> wire.Int8Codec:
    return wire.get_codec("int8" if block is None else f"int8_block{block}")


def quantize_int8(x, block: Optional[int] = DEFAULT_BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-scaled absmax int8: returns ``(q, scales)`` with ``q`` of
    ``x``'s shape and ``scales`` of shape ``x.shape[:-1] + (nblocks,)``
    (one float32 factor per ``block``-element chunk of the last axis;
    the trailing chunk may be partial). ``block=None`` scales each whole
    last-axis row with one factor."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return _codec(block).encode(torch.atleast_1d(x))


def dequantize_int8(q, scales, block: Optional[int] = DEFAULT_BLOCK
                    ) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` (pass the same ``block``). A
    scalar ``scales`` is accepted for the one-scale-per-leaf format of
    older buffers."""
    scales = torch.as_tensor(scales, dtype=torch.float32)
    if scales.dim() == 0:
        return torch.as_tensor(q).float() * scales
    return _codec(block).decode((torch.atleast_1d(torch.as_tensor(q)),
                                 scales))


def compressed_psum_tree(grads, error, group=None,
                         block: Optional[int] = DEFAULT_BLOCK):
    """Quantize (+ error feedback), sum over ``group``'s ranks,
    dequantize. Returns (mean grads in each leaf's dtype, new error
    buffers). ``group`` is a process group (None: the default group when
    one is initialized, else this process alone)."""
    n = dist.get_world_size(group) if dist.is_initialized() else 1

    def one(g, e):
        gf = g.float() + e
        q, scale = quantize_int8(gf, block)
        deq_local = dequantize_int8(q, scale, block).reshape(gf.shape)
        new_e = gf - deq_local                     # local residual
        tot = deq_local.clone()
        if n > 1:
            dist.all_reduce(tot, group=group)
        return (tot / n).to(g.dtype), new_e

    out = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(error))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
