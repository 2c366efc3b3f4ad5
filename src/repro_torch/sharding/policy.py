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
compared with it as tuples. The rules
work on any mesh shape (``mesh`` is anything with a ``shape`` mapping of
axis name to extent), so the specs of the production meshes can be
checked without the ranks to run them.

Execution is one rank's: on a mesh whose every extent is 1,
``constrain`` returns its tensor (what XLA does with a sharding
constraint there) and ``named`` places a leaf on the mesh's device. On a
larger mesh both raise ``NotImplementedError``: running a model across
ranks (TP/FSDP/DP, multi-device serving) is ROADMAP queue 1 item 18
part 5.

The port keeps a model's periods as a list of per-period dicts where the
reference stacks them with a leading depth axis (``models/blocks.py``).
``tree_specs`` takes either layout: a leaf inside such a list gets the
stacked rule's spec without its leading (depth) entry.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

Spec = Tuple[Any, ...]

PART5 = ("running a model across ranks (TP/FSDP/DP, constrain or place "
         "off a one-rank mesh) is ROADMAP queue 1 item 18 part 5")

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
        """Whether every mesh extent is 1 (the port executes only there)."""
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

    def act_hidden(self) -> Spec:                  # (B, S, D)
        return P(self.batch(), None, None)

    def act_heads(self) -> Spec:                   # (B, S, H, hd)
        return P(self.batch(), None, self.tp_axis, None)

    def act_mlp(self) -> Spec:                     # (B, S, F)
        return P(self.batch(), None, self.tp_axis)

    def _tp_size(self) -> int:
        return self.mesh.shape[self.tp_axis] if self.tp_axis else 1

    def act_logits(self, vocab: Optional[int] = None) -> Spec:  # (B, S, V)
        if vocab is not None and vocab % self._tp_size() != 0:
            return P(self.batch(), None, None)
        return P(self.batch(), None, self.tp_axis)

    def act_kv_cache(self, kv_heads: Optional[int] = None) -> Spec:
        """(B, S, KV, hd). When KV heads don't divide the TP axis, the
        cache's *sequence* dim takes the model axis instead; long-context
        batch-1 cells add the idle data axes."""
        seq = _flat(self.kv_seq_axes)
        if kv_heads is not None and kv_heads % self._tp_size() != 0:
            seq = _flat(self.tp_axis, self.kv_seq_axes)
            return P(self.batch(), seq, None, None)
        return P(self.batch(), seq, self.tp_axis, None)

    def act_moe_dispatch(self) -> Spec:            # (E, C, D)
        if self.ep_axis:
            return P(self.ep_axis, None, None)
        return P(None, self.batch(), None)

    def constrain(self, x, spec: Spec):
        """``x`` laid out under ``spec``: on a one-rank mesh, ``x`` itself."""
        if not self.one_rank:
            raise NotImplementedError(
                f"Policy.constrain on mesh {dict(self.mesh.shape)}: {PART5}")
        return x

    def named(self, spec: Spec) -> Callable:
        """The placement of a leaf under ``spec``: a callable taking a
        numpy array (or tensor) to a tensor on the mesh's device — the
        form ``ckpt.restore(place=)`` and ``run_with_restarts
        (state_place=)`` take."""
        if not self.one_rank:
            raise NotImplementedError(
                f"Policy.named on mesh {dict(self.mesh.shape)}: {PART5}")
        device = self.mesh.device
        return lambda arr: _to_tensor(arr, device)

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
        def walk(t):
            if isinstance(t, dict):
                return {k: walk(v) for k, v in t.items()}
            if isinstance(t, list):
                return [walk(v) for v in t]
            return self.named(t)
        return walk(self.tree_specs(params_shapes))


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
