"""Sharding policy: maps logical tensor roles onto mesh axes (counterpart
of ``repro/sharding/policy.py``).

The production mesh is ``("data", "model")`` single-pod or
``("pod", "data", "model")`` multi-pod. Parallelism composition, as in
the reference:

* **DP**    — batch over ``batch_axes`` (``("pod","data")`` when multi-pod).
* **FSDP**  — parameter + optimizer-state sharding over ``fsdp_axes``.
* **TP**    — attention heads / MLP hidden / vocab over ``tp_axis``.
* **EP**    — MoE experts over ``tp_axis`` when ``ep_mode`` (dbrx);
  otherwise experts are tensor-parallel (grok).
* **SP**    — optional sequence sharding of long KV caches
  (``kv_seq_axes``).

A spec is a plain tuple with one entry per tensor dim: ``None``
(replicated), an axis name, or a tuple of axis names — the entries of
the reference's ``PartitionSpec``, canonical as it makes them (``P``),
compared with it as tuples. The rules work on any mesh shape (``mesh``
is anything with a ``shape`` mapping of axis name to extent), so the
specs of the production meshes can be checked without the ranks to run
them.

Execution. On a mesh whose every extent is 1, ``constrain`` returns its
tensor (what XLA does with a sharding constraint there) and ``named``
places a leaf on the mesh's device. On a mesh of several ranks (a
``compat.Mesh`` over ranks of this world, ``launch/mesh.make_host_mesh``)
every tensor a model touches is this rank's local block of a logical
tensor, and the policy issues the collectives GSPMD inserts for the
reference (``sharding/collectives.py`` says how each differentiates):

* ``named(spec)`` cuts a full array to this rank's block, on the mesh's
  device; ``gather(x, spec)`` makes a block whole again (checkpoints, the
  monitor, the logits a server samples from).
* ``constrain(x, spec, src=..., partial=...)`` converts ``x`` from the
  layout ``src`` (default: already ``spec``) to ``spec`` by gathers and
  slices, after summing the partial sums over the ``partial`` axes (a
  contraction over a sharded dim: ``wo`` over heads, the MLP's down
  projection over its hidden dim, the vocab-sharded embedding lookup).
* ``enter_tp(x)`` marks a replicated activation entering a
  column-parallel product: identity forward, all-reduce over the model
  axis backward (the TP backward).
* ``use(w, spec)`` is a parameter where a layer uses it: the FSDP axes
  all-gathered (one period at a time, again under remat), the gradient
  reduce-scattered over them; over the data axes the leaf is replicated
  on, its gradient is all-reduced (DP). Each leaf's gradient thus comes
  out of the backward already reduced, as this rank's block.
* ``lookup`` (the embedding) and ``project`` (the last position's
  logits) move rows instead of the table where one batch axis shards
  D: a few rows of activations against a table of vocab rows.

A mesh of shapes only (no ranks: the spec tests' meshes) serves
``param_spec``/``tree_specs`` and raises ``ValueError`` on the calls
that execute.

The port keeps a model's periods as a list of per-period dicts where the
reference stacks them with a leading depth axis (``models/blocks.py``).
``tree_specs`` takes either layout: a leaf inside such a list gets the
stacked rule's spec without its leading (depth) entry.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.fft.distributed import _block, _names, _slices
from repro_torch.sharding import collectives as C

Spec = Tuple[Any, ...]

# parameter subtrees stacked over depth in the reference
STACKED = ("layers", "blocks", "enc_layers", "dec_layers", "fuse_projs")


def _flat(*groups) -> Optional[Tuple[str, ...]]:
    """Collapse axis groups, dropping Nones; returns None if empty."""
    axes: Tuple[str, ...] = ()
    for g in groups:
        if g is None:
            continue
        if isinstance(g, str):
            axes += (g,)
        else:
            axes += tuple(g)
    return axes if axes else None


def P(*entries) -> Spec:
    """A spec, canonical as the reference's ``PartitionSpec`` makes it: a
    group of one axis is that axis's name, an empty group ``None``."""
    def canon(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            return None if not e else (e[0] if len(e) == 1 else e)
        return e
    return tuple(canon(e) for e in entries)


def _to_tensor(arr, device) -> torch.Tensor:
    if torch.is_tensor(arr):
        return arr.to(device)
    arr = np.asarray(arr)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


@dataclasses.dataclass(frozen=True)
class Policy:
    mesh: Any
    batch_axes: Tuple[str, ...] = ("data",)
    fsdp_axes: Tuple[str, ...] = ("data",)
    tp_axis: Optional[str] = "model"
    ep_axis: Optional[str] = None          # set for EP-mode MoE archs
    kv_seq_axes: Tuple[str, ...] = ()      # SP for long-context KV caches
    scan_layers: bool = True

    # ------------------------------------------------------------------
    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.batch_axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def one_rank(self) -> bool:
        """Whether every mesh extent is 1."""
        return math.prod(self.mesh.shape.values()) == 1

    def batch(self) -> Optional[Tuple[str, ...]]:
        return _flat(self.batch_axes)

    def fsdp(self) -> Optional[Tuple[str, ...]]:
        return _flat(self.fsdp_axes)

    def tp(self) -> Optional[str]:
        return self.tp_axis

    # -- activation specs ----------------------------------------------
    def act_tokens(self) -> Spec:                  # (B, S)
        return P(self.batch(), None)

    def act_rows(self, ndim: int) -> Spec:         # (B, ...)
        """A batch array of ``ndim`` dims: rows over the batch axes."""
        return P(self.batch(), *(None,) * (ndim - 1))

    def act_hidden(self) -> Spec:                  # (B, S, D)
        return P(self.batch(), None, None)

    def act_heads(self) -> Spec:                   # (B, S, H, hd)
        return P(self.batch(), None, self.tp_axis, None)

    def act_mlp(self) -> Spec:                     # (B, S, F)
        return P(self.batch(), None, self.tp_axis)

    def tp_size(self) -> int:
        return self.mesh.shape[self.tp_axis] if self.tp_axis else 1

    def act_logits(self, vocab: Optional[int] = None) -> Spec:  # (B, S, V)
        if vocab is not None and vocab % self.tp_size() != 0:
            return P(self.batch(), None, None)
        return P(self.batch(), None, self.tp_axis)

    def act_kv_cache(self, kv_heads: Optional[int] = None) -> Spec:
        """(B, S, KV, hd). When KV heads don't divide the TP axis, the
        cache's *sequence* dim takes the model axis instead; long-context
        batch-1 cells add the idle data axes."""
        seq = _flat(self.kv_seq_axes)
        if kv_heads is not None and kv_heads % self.tp_size() != 0:
            seq = _flat(self.tp_axis, self.kv_seq_axes)
            return P(self.batch(), seq, None, None)
        return P(self.batch(), seq, self.tp_axis, None)

    def act_moe_dispatch(self) -> Spec:            # (E, C, D)
        if self.ep_axis:
            return P(self.ep_axis, None, None)
        return P(None, self.batch(), None)

    # -- execution on the mesh's ranks ----------------------------------
    def _live(self) -> None:
        """Raise ``ValueError`` unless this rank holds a position of a
        mesh over ranks of this world."""
        from repro_torch.compat import Mesh
        mesh = self.mesh
        if not isinstance(mesh, Mesh):
            raise ValueError(
                f"mesh {dict(mesh.shape)} names no ranks (a mesh of shapes "
                f"only serves the specs); build it over the world's ranks "
                f"(launch/mesh.make_host_mesh, compat.make_mesh)")
        world = (dist.get_world_size() if dist.is_available()
                 and dist.is_initialized() else 1)
        if not mesh.is_member or any(r >= world for r in mesh.members):
            raise ValueError(
                f"mesh {dict(mesh.shape)} over ranks {mesh.members}: this "
                f"rank is not one of them, or they are not ranks of this "
                f"world of {world}")

    def size(self, axis: str) -> int:
        return self.mesh.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.mesh.coordinate[axis]

    def _group(self, axis: str):
        return self.mesh.group(axis)

    def tp_index(self) -> int:
        return self.index(self.tp_axis) if self.tp_axis else 0

    def local_batch(self, global_batch: int) -> int:
        """This rank's rows of a batch split over the batch axes."""
        if global_batch % self.dp_size:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {self.dp_size} data-parallel ranks")
        return global_batch // self.dp_size

    def _gather_dim(self, x, dim: int, entry, grad: str):
        for a in reversed(_names(entry)):     # the minor axis first
            if self.size(a) > 1:
                x = C.gather(x, dim, self.size(a), self.index(a),
                             self._group(a), grad)
        return x

    def _split_dim(self, x, dim: int, entry):
        for a in _names(entry):               # the major axis first
            if self.size(a) > 1:
                x = C.split(x, dim, self.size(a), self.index(a),
                            self._group(a))
        return x

    def constrain(self, x, spec: Spec, *, src: Optional[Spec] = None,
                  partial=None):
        """``x`` laid out under ``spec``. On a one-rank mesh, ``x``
        itself. Across ranks: the partial sums over the axes ``partial``
        (a name or a tuple of names) summed first, then ``x`` converted
        from the layout ``src`` (None: ``x`` is laid out under ``spec``
        already) by gathering the dims ``src`` shards and ``spec`` does
        not, and cutting the dims ``spec`` shards."""
        if self.one_rank:
            return x
        self._live()
        for a in _names(partial):
            if self.size(a) > 1:
                x = C.reduce_sum(x, self._group(a))
        if src is None:
            return x
        src, spec = P(*src), P(*spec)
        if len(src) != x.dim() or len(spec) != x.dim():
            raise ValueError(f"constrain: specs {src} -> {spec} for a "
                             f"rank-{x.dim()} tensor")
        for d, (s, t) in enumerate(zip(src, spec)):
            if s != t:
                x = self._gather_dim(x, d, s, "slice")
        for d, (s, t) in enumerate(zip(src, spec)):
            if s != t:
                x = self._split_dim(x, d, t)
        return x

    def named(self, spec: Spec) -> Callable:
        """The placement of a leaf under ``spec``: a callable taking a
        full numpy array (or tensor) to this rank's block of it, a tensor
        on the mesh's device — the form ``ckpt.restore(place=)`` and
        ``run_with_restarts(state_place=)`` take."""
        if self.one_rank:
            device = self.mesh.device
            return lambda arr: _to_tensor(arr, device)
        self._live()
        mesh, device = self.mesh, self.mesh.device

        def place(arr):
            sl = _slices(mesh, spec, tuple(arr.shape), mesh.coordinate)
            if torch.is_tensor(arr):
                return arr[sl].to(device).contiguous()
            block = np.ascontiguousarray(np.asarray(arr)[sl])
            return torch.from_numpy(block).to(device)
        return place

    def gather(self, x, spec: Spec):
        """The whole tensor from this rank's block under ``spec``, on
        every rank of the mesh (collective; the identity on one rank)."""
        if self.one_rank:
            return x
        self._live()
        with torch.no_grad():
            for d, entry in enumerate(P(*spec)):
                x = self._gather_dim(x, d, entry, "slice")
        return x

    def enter_tp(self, x):
        """A replicated tensor entering a computation that differs along
        the model axis (a column-parallel product, a leaf used on the
        local heads): identity forward, all-reduce over the model axis
        backward — the TP backward; without it the gradient of ``x``
        would hold this rank's heads' share only."""
        if self.one_rank or not self.tp_axis or self.tp_size() == 1:
            return x
        return C.enter(x, self._group(self.tp_axis))

    def reduce_batch(self, x):
        """The sum over the batch axes of a per-rank partial (a loss sum,
        a token count); backward identity."""
        if self.one_rank:
            return x
        for a in self.batch_axes:
            if self.size(a) > 1:
                x = C.reduce_sum(x, self._group(a))
        return x

    def use(self, w, spec: Spec):
        """Parameter ``w`` (this rank's block under ``spec``) where a
        layer uses it: gathered over every axis but the model axis; the
        gradient reduce-scattered over the gathered axes the batch
        varies along (FSDP) and all-reduced over the batch axes the leaf
        is replicated on (DP)."""
        if self.one_rank:
            return w
        vary = {a for a in self.batch_axes if self.size(a) > 1}
        for d, entry in enumerate(P(*spec)):
            for a in reversed(_names(entry)):
                if a == self.tp_axis or self.size(a) == 1:
                    continue
                w = C.gather(w, d, self.size(a), self.index(a),
                             self._group(a),
                             "sum" if a in vary else "slice")
        held = {a for e in spec for a in _names(e)}
        for a in sorted(vary - held):
            w = C.enter(w, self._group(a))
        return w

    def _row_axis(self, entry):
        """The one batch axis (of more than one rank) that ``entry``
        shards a dim over, or None."""
        axes = [a for a in _names(entry) if self.size(a) > 1]
        vary = {a for a in self.batch_axes if self.size(a) > 1}
        return axes[0] if len(axes) == 1 and axes[0] in vary else None

    def _dp_enter(self, w, spec):
        """``w`` entering each batch axis it is replicated on (its
        gradient all-reduced there, DP)."""
        held = {a for e in spec for a in _names(e)}
        for a in sorted({a for a in self.batch_axes if self.size(a) > 1}
                        - held):
            w = C.enter(w, self._group(a))
        return w

    def lookup(self, table, tokens, spec: Spec):
        """``table[tokens]`` across ranks, ``table`` this rank's block
        under ``spec`` (rows, D), ``tokens`` this rank's rows of the
        batch. A token whose row another rank holds comes out zero: a
        partial sum over ``spec[0]``'s axes, which the caller sums. Where
        one batch axis shards D (FSDP), rows move instead of the table:
        every rank's tokens along it are looked up in this rank's
        columns, and an all-to-all hands each rank its rows with every
        column (backward: the all-to-all back, every rank's gradient
        rows landing in this block); otherwise the table is gathered
        (``use``)."""
        spec = P(*spec)
        axis = self._row_axis(spec[1])
        if axis is None:
            table = self.use(table, spec)
        else:
            table = self._dp_enter(table, spec)
            with torch.no_grad():
                tokens = C._all_gather(tokens, 0, self.size(axis),
                                       self._group(axis))
        block, count = _block(self.mesh, spec[0], self.mesh.coordinate)
        rows = table.shape[0]
        local = tokens.long() - block * rows
        out = table[local.clamp(0, rows - 1)]
        if count > 1:
            own = (local >= 0) & (local < rows)
            out = out * own[..., None].to(out.dtype)
        if axis is not None:
            out = C.all_to_all(out, 0, out.dim() - 1, self.size(axis),
                               self._group(axis))
        return out

    def project(self, h, w, spec: Spec):
        """``h @ w`` across ranks for a few rows (the last position's
        logits), ``w`` this rank's block under ``spec`` (D, N), ``h``
        this rank's rows with every D column. Where one batch axis shards
        D (FSDP), activations move instead of the weight: every rank's
        rows along it meet this rank's D block, and a reduce-scatter sums
        the partial products and hands each rank its rows; otherwise the
        weight is gathered (``use``)."""
        spec = P(*spec)
        axis = self._row_axis(spec[0])
        if axis is None:
            return h @ self.use(w, spec)
        w = self._dp_enter(w, spec)
        n, i, group = self.size(axis), self.index(axis), self._group(axis)
        rows = C.gather(h, 0, n, i, group, "sum")
        k = w.shape[0]
        return C.reduce_scatter(rows[..., i * k:(i + 1) * k] @ w, 0, n,
                                group)

    def use_tree(self, tree, specs):
        """``use`` over a tree of leaves and its spec tree."""
        return _map_leaves(self.use, tree, specs)

    def kv_heads_sharded(self, kv_heads: int) -> bool:
        """Whether K/V heads shard over the model axis (else the cache's
        sequence does and attention repeats K/V to the query heads)."""
        return kv_heads % self.tp_size() == 0

    # -- parameter specs -------------------------------------------------
    def param_spec(self, path: Sequence[str], shape: Tuple[int, ...]) -> Spec:
        """Sharding rule for one parameter leaf, keyed on its name/path
        (the reference's leaf-name conventions; ``shape`` includes the
        leading depth axis of a stacked leaf)."""
        return P(*self._param_rule(path, shape))

    def _param_rule(self, path, shape) -> Spec:
        name = path[-1]
        fsdp, tp, ep = self.fsdp(), self.tp_axis, self.ep_axis
        stacked = any(p in STACKED for p in path[:-1])

        def st(spec: Spec) -> Spec:
            return (None, *spec) if stacked else spec

        V_TP_MIN = 8  # don't TP tiny trailing dims
        tp_size = self.mesh.shape[tp] if tp else 1

        def tp_if(dim: int):
            return tp if (tp and dim % tp_size == 0) else None

        if name in ("embedding", "head_embedding"):
            return (tp_if(shape[0]), fsdp)
        if name in ("pos_embedding", "source_pos"):
            return (None, None)
        if name in ("wq", "wk", "wv"):              # (D, N, hd)
            return st((fsdp, tp_if(shape[-2]), None))
        if name == "wo":                            # (N, hd, D)
            return st((tp_if(shape[-3]), None, fsdp))
        if name in ("bq", "bk", "bv"):              # (N, hd)
            return st((tp_if(shape[-2]), None))
        if name in ("w_gate", "w_up"):              # (D, F)
            return st((fsdp, tp))
        if name == "w_down":                        # (F, D)
            return st((tp, fsdp))
        if name == "router":                        # (D, E)
            return st((fsdp, None))
        if name in ("moe_gate", "moe_up"):          # (E, D, F)
            if ep:
                return st((ep, fsdp, None))
            return st((None, fsdp, tp))
        if name == "moe_down":                      # (E, F, D)
            if ep:
                return st((ep, None, fsdp))
            return st((None, tp, fsdp))
        if name in ("wz", "wx_in"):                 # (D, Hs, P)
            return st((fsdp, tp, None))
        if name in ("wB", "wC"):                    # (D, G, N) — small, repl.
            return st((fsdp, None, None))
        if name == "wdt":                           # (D, Hs)
            return st((fsdp, tp))
        if name == "out_proj":                      # (Hs, P, D)
            return st((tp, None, fsdp))
        if name == "conv_x":                        # (K, Hs, P)
            return st((None, tp, None))
        if name in ("conv_B", "conv_C"):            # (K, G, N)
            return st((None, None, None))
        if name == "ssm_norm":                      # (Hs, P)
            return st((tp, None))
        if name in ("A_log", "ssm_D", "dt_bias"):   # (Hs,)
            return st((tp if shape[-1] % tp_size == 0
                       and shape[-1] >= V_TP_MIN else None,))
        if name == "fuse_proj":                     # (2D, D) zamba2 per-use
            return st((fsdp, None))
        if name == "head":                          # (D, V)
            return (fsdp, tp_if(shape[-1]))
        if name in ("scale", "bias", "q_norm", "k_norm", "post_scale",
                    "pre_scale", "norm_scale"):
            rank = len(shape) - (1 if stacked else 0)
            return st((None,) * rank)
        # conservative default: replicate
        return (None,) * len(shape)

    def tree_specs(self, params_shapes):
        """Spec tree mirroring a tree (nested dicts and lists) of leaves
        with a ``shape``: the reference's stacked layout, or the port's
        list of per-period dicts under a stacked key."""
        def walk(t, path, unstacked):
            if isinstance(t, dict):
                return {k: walk(v, path + (str(k),), unstacked)
                        for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                depth = bool(path) and path[-1] in STACKED
                return type(t)(walk(v, path + (str(i),), unstacked or depth)
                               for i, v in enumerate(t))
            shape = tuple(t.shape)
            if unstacked:   # one depth slice of the stacked leaf
                return self.param_spec(path, (1,) + shape)[1:]
            return self.param_spec(path, shape)
        return walk(params_shapes, (), False)

    def tree_shardings(self, params_shapes):
        """Per-leaf placement callables (``named``) mirroring
        ``tree_specs``."""
        return _map_specs(self.named, self.tree_specs(params_shapes))

    def tree_gathers(self, params_shapes):
        """Per-leaf callables taking this rank's block to the whole leaf
        (``gather``), mirroring ``tree_specs`` (collective)."""
        return _map_specs(lambda s: functools.partial(self.gather, spec=s),
                          self.tree_specs(params_shapes))

    def shard_tree(self, tree, path: Sequence[str] = ()):
        """A tree of whole leaves (numpy or tensors) cut to this rank's
        blocks, each leaf's spec from its name and shape under ``path``
        (as ``tree_specs`` reads it; ``("blocks", 0)`` for a period)."""
        specs = self.tree_specs(_nest(path, tree))
        for k in path:
            specs = specs[0 if isinstance(k, int) else k]
        return _map_leaves(lambda leaf, spec: self.named(spec)(leaf),
                           tree, specs)


def _nest(path, tree):
    """``tree`` under ``path``; an int entry is a position in a list (a
    period under ``"blocks"``)."""
    for k in reversed(tuple(path)):
        tree = [tree] if isinstance(k, int) else {k: tree}
    return tree


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    return fn(specs)


def _map_leaves(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def spec_leaves(specs) -> list:
    """The specs of a spec tree in leaf order (``tree_util``'s: dict keys
    sorted; a spec, itself a tuple, is a leaf)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]


def sharded(policy) -> bool:
    """Whether ``policy`` (a ``Policy`` or None) runs across ranks."""
    return policy is not None and not policy.one_rank


@functools.lru_cache(maxsize=64)
def period_specs(policy, cfg):
    """The specs of one period's parameter dict (the per-period slice of
    the stacked rule), from the config's shapes."""
    from repro_torch.models import blocks
    from repro_torch.models.common import ShapeOnly
    return policy.tree_specs(
        {"blocks": [blocks.init_period_params(cfg, ShapeOnly(),
                                              torch.float32)]})["blocks"][0]


def make_policy(mesh, *, global_batch: int, multi_pod: bool = False,
                ep_mode: bool = False, kv_seq_shard: bool = False,
                fsdp: bool = True, parallelism: str = "tp") -> Policy:
    """Build the per-cell policy.

    ``parallelism``:
      * "tp"   — DP/FSDP over (pod, data) × TP over model.
      * "fsdp" — pure data parallelism: batch AND parameters shard over
        every mesh axis, no tensor parallelism.

    Batch sharding degrades gracefully: if ``global_batch`` is not
    divisible by the full data-parallel extent, axes are dropped (pod
    first) until it divides; batch==1 cells shard the KV cache sequence
    dim over the idle data axes instead. ``multi_pod`` is accepted as
    the reference accepts it: the mesh's axes decide."""
    if parallelism == "fsdp":
        cand = tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
        tp_axis = None
        ep_axis = None
        fsdp_axes = cand
    else:
        cand = tuple(a for a in ("pod", "data") if a in mesh.shape)
        tp_axis = "model" if "model" in mesh.shape else None
        ep_axis = "model" if (ep_mode and "model" in mesh.shape) else None
        fsdp_axes = cand if fsdp else ()

    batch_axes: Tuple[str, ...] = cand
    while batch_axes:
        ext = 1
        for a in batch_axes:
            ext *= mesh.shape[a]
        if global_batch % ext == 0:
            break
        batch_axes = batch_axes[1:]
    kv_seq: Tuple[str, ...] = ()
    if kv_seq_shard:
        kv_seq = tuple(a for a in ("data",) if a in mesh.shape
                       and a not in batch_axes)
    return Policy(
        mesh=mesh,
        batch_axes=batch_axes,
        fsdp_axes=fsdp_axes,
        tp_axis=tp_axis,
        ep_axis=ep_axis,
        kv_seq_axes=kv_seq,
    )
