"""Differentiable collectives over one mesh axis: what XLA's GSPMD
inserts for the reference, issued by the port itself.

Every tensor of a model under a multi-rank policy is this rank's local
piece of a logical tensor. The gradient a rank holds for it is the
gradient of the global loss with respect to that piece, so each
collective's backward is the transpose of its forward:

* ``reduce_sum``  — a partial sum (a contraction over a sharded dim)
  summed over the axis. Backward: identity (every rank's partial took
  part in the sum with weight one).
* ``enter``       — a tensor replicated along the axis entering a
  computation that differs from rank to rank along it (the column-
  parallel product, a leaf used on the local heads). Forward: identity.
  Backward: all-reduce, since each rank holds only its own ranks'
  contribution to the gradient. This is the TP backward.
* ``gather``      — a dim sharded along the axis made whole. Backward:
  the slice of the gradient (``grad="slice"``: the consumer is the same
  on every rank, so the gradients agree) or its reduce-scatter
  (``grad="sum"``: the consumer differs from rank to rank, as an FSDP
  leaf gathered for each data rank's batch).
* ``split``       — a replicated dim cut to this rank's block. Backward:
  the gathered gradient.
* ``all_to_all``  — block j of one dim to rank j, the blocks received
  concatenated along another (rows of every rank's batch for this
  rank's columns, turned into this rank's rows with every column).
  Backward: the all-to-all back.
* ``reduce_scatter`` — partial sums summed over the axis, this rank's
  block of one dim kept. Backward: the gathered gradient.

Gloo moves CUDA tensors through host memory. ``all_reduce``,
``all_gather`` (the list form) and ``all_to_all_single`` take CUDA
tensors on it; a reduce-scatter is staged as an ``all_to_all_single``
and a local sum (``_reduce_scatter``), which every backend takes.

``BYTES`` counts the bytes each kind of collective sent from this rank
(payload bytes, not wire bytes), for the per-step accounting.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

BYTES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                         "reduce_scatter": 0, "all_to_all": 0}


def reset_bytes() -> None:
    for k in BYTES:
        BYTES[k] = 0


def _count(kind: str, t: torch.Tensor) -> None:
    BYTES[kind] += t.numel() * t.element_size()


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM):
    out = x.contiguous().clone()
    _count("all_reduce", out)
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x: torch.Tensor, dim: int, n: int, group):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    _count("all_gather", x)
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int, n: int, group):
    """The sum over the axis of ``x``, cut to this rank's block of
    ``dim``: chunk j goes to rank j (``all_to_all_single``), then the
    received chunks are summed."""
    send = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    send = send.contiguous()
    recv = torch.empty_like(send)
    _count("reduce_scatter", send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.sum(dim=0)


def _all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int, n: int,
                group):
    send = x.unflatten(split_dim, (n, x.shape[split_dim] // n))
    send = send.movedim(split_dim, 0).contiguous()
    recv = torch.empty_like(send)
    _count("all_to_all", send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=cat_dim)   # block j from rank j


def _block(x: torch.Tensor, dim: int, n: int, index: int):
    step = x.shape[dim] // n
    return x.narrow(dim, index * step, step).contiguous()


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n, index, group, grad):
        ctx.args = (dim, n, index, group, grad)
        return _all_gather(x, dim, n, group)

    @staticmethod
    def backward(ctx, g):
        dim, n, index, group, grad = ctx.args
        if grad == "sum":
            g = _reduce_scatter(g, dim, n, group)
        else:
            g = _block(g, dim, n, index)
        return g, None, None, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n, index, group):
        ctx.args = (dim, n, group)
        return _block(x, dim, n, index)

    @staticmethod
    def backward(ctx, g):
        dim, n, group = ctx.args
        return _all_gather(g, dim, n, group), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, n, group):
        ctx.args = (split_dim, cat_dim, n, group)
        return _all_to_all(x, split_dim, cat_dim, n, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim, n, group = ctx.args
        return (_all_to_all(g.contiguous(), cat_dim, split_dim, n, group),
                None, None, None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n, group):
        ctx.args = (dim, n, group)
        return _reduce_scatter(x, dim, n, group)

    @staticmethod
    def backward(ctx, g):
        dim, n, group = ctx.args
        return _all_gather(g, dim, n, group), None, None, None


def reduce_sum(x, group):
    """All-reduce (sum) of a partial sum; backward identity."""
    return _ReduceSum.apply(x, group)


def reduce_max(x, group):
    """All-reduce (max), outside autograd (a softmax's shift)."""
    return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def enter(x, group):
    """Identity forward, all-reduce backward (see the module doc)."""
    return _Enter.apply(x, group)


def gather(x, dim: int, n: int, index: int, group, grad: str = "slice"):
    """The ``n`` blocks of ``dim`` concatenated in rank order."""
    if grad not in ("slice", "sum"):
        raise ValueError(f"gather grad {grad!r}: slice or sum")
    return _Gather.apply(x, dim % x.dim(), n, index, group, grad)


def split(x, dim: int, n: int, index: int, group):
    """Block ``index`` of ``n`` along ``dim``; backward all-gathers."""
    if x.shape[dim] % n:
        raise ValueError(f"split: extent {x.shape[dim]} of dim {dim} does "
                         f"not divide into {n} blocks")
    return _Split.apply(x, dim % x.dim(), n, index, group)


def all_to_all(x, split_dim: int, cat_dim: int, n: int, group):
    """Block j of ``split_dim`` to rank j; the blocks received, in rank
    order, concatenated along ``cat_dim``."""
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: extent {x.shape[split_dim]} of dim "
                         f"{split_dim} does not divide into {n} blocks")
    return _AllToAll.apply(x, split_dim % x.dim(), cat_dim % x.dim(), n,
                           group)


def reduce_scatter(x, dim: int, n: int, group):
    """The sum over the axis, this rank's block of ``dim`` kept."""
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: extent {x.shape[dim]} of dim "
                         f"{dim} does not divide into {n} blocks")
    return _ReduceScatter.apply(x, dim % x.dim(), n, group)
