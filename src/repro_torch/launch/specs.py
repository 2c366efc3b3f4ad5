"""Per-cell step functions, shape-only inputs and their specs
(counterpart of ``repro/launch/specs.py``).

``build_cell(cfg, shape, mesh)`` returns, with the cell's policy, what a
dry run or a run on the card needs, for each of:

  * train   — the full train step (fwd+bwd+AdamW update), donated state
  * prefill — the prompt pass emitting last-token logits + caches
  * decode  — one-token serve step against a seq_len KV cache

as a dict:

* ``fn`` — the step callable. It runs on real tensors (this rank's
  blocks under the policy, on the mesh's device), so the same cell
  serves ``launch/dryrun.py`` (traced on fake tensors) and the card.
* ``args`` — the global arguments as ``meta`` tensors (shapes and dtypes,
  no memory: the reference's ``ShapeDtypeStruct`` trees, in the port's
  layout: per-period parameter dicts where the reference stacks them).
* ``local_args`` — this rank's blocks of ``args`` (``meta`` too): what
  ``fn`` takes on this rank of the mesh. On a one-rank mesh they are
  ``args``.
* ``in_specs`` / ``out_specs`` — the policy's spec trees for the
  arguments and the results (the reference's in/out shardings); a
  single spec where the reference's tree maps one spec over a subtree
  (the train step's metrics: every leaf replicated).
* ``donate_argnums``, ``meta`` — as in the reference.

Defaults are the reference's: float32 parameters for train, bfloat16
parameters and cache for prefill and decode, the dense cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.fft.distributed import _names
from repro_torch.models import encdec, lm
from repro_torch.models.common import ShapeOnly
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.serve.kvcache import KVCache, QuantKVCache
from repro_torch.sharding.policy import P, Policy, make_policy, sharded
from repro_torch.train import step as train_step_mod

WHISPER_CROSS_LEN = 1536   # padded encoder length for decode cells
WHISPER_DEC_PROMPT = 448


def cell_policy(cfg: ModelConfig, shape: ShapeConfig, mesh,
                multi_pod: bool, parallelism: str = "tp",
                fsdp_params: bool = True) -> Policy:
    ep = cfg.moe is not None and cfg.moe.mode == "ep"
    kv_seq = shape.is_decode and shape.global_batch < mesh.shape["data"]
    return make_policy(mesh, global_batch=shape.global_batch,
                       multi_pod=multi_pod, ep_mode=ep,
                       kv_seq_shard=kv_seq, parallelism=parallelism,
                       fsdp=fsdp_params)


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                         policy: Policy) -> int:
    per_chip = shape.global_batch // max(policy.dp_size, 1)
    return int(min(max(per_chip // 2, 1), 8))


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *, train: bool,
                policy: Policy):
    B, S = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {"tokens": _sds((B, S), torch.int32)}
    spec: Dict[str, Any] = {"tokens": P(policy.batch(), None)}
    if train:
        batch["labels"] = _sds((B, S), torch.int32)
        spec["labels"] = P(policy.batch(), None)
    if cfg.family == "vlm":
        batch["patch_embeds"] = _sds((B, cfg.num_patches, lm.VIT_STUB_DIM),
                                     torch.bfloat16)
        spec["patch_embeds"] = P(policy.batch(), None, None)
    if cfg.family == "encdec":
        batch["frames"] = _sds((B, S, cfg.d_model), torch.bfloat16)
        spec["frames"] = P(policy.batch(), None, None)
        # decoder runs on `tokens`; for train it mirrors seq_len,
        # for prefill it is the (short) transcription prompt
        if not train:
            batch["tokens"] = _sds((B, WHISPER_DEC_PROMPT), torch.int32)
            spec["tokens"] = P(policy.batch(), None)
    return batch, spec


def local_shapes(tree, specs, mesh):
    """This rank's blocks of a tree of ``meta`` tensors under its spec
    tree (walked by ``tree``'s structure: a spec is a tuple): each dim
    divided by the extents of the axes its entry names. Other leaves
    (host scalars, ints) as they are."""
    if torch.is_tensor(tree):
        if tree.device.type != "meta":
            return tree
        shape = list(tree.shape)
        lead = len(shape) - len(specs)
        for d, entry in enumerate(specs):
            for name in _names(entry):
                n = mesh.shape[name]
                if shape[lead + d] % n:
                    raise ValueError(
                        f"extent {shape[lead + d]} does not split into {n} "
                        f"blocks (spec {tuple(specs)}, mesh {mesh.shape})")
                shape[lead + d] //= n
        return _sds(shape, tree.dtype)
    if isinstance(tree, dict):
        return {k: local_shapes(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_shapes(v, s, mesh)
                          for v, s in zip(tree, specs))
    return tree


def _state_specs(policy: Policy, state_shapes):
    """The train state's specs: the parameter rules for the parameters
    and both moments, the scalars replicated."""
    pspecs = policy.tree_specs(state_shapes["params"])
    return {"params": pspecs,
            "opt": {"m": pspecs, "v": pspecs, "count": P()},
            "step": P()}


def build_train(cfg: ModelConfig, shape: ShapeConfig, policy: Policy,
                *, microbatches: int = 0, remat_policy=None,
                param_dtype=torch.float32, max_target: int = 0,
                insitu: bool = False):
    opt = AdamW(warmup_cosine(3e-4, 2000, 100_000))
    micro = microbatches or default_microbatches(cfg, shape, policy)
    insitu_hook = None
    if insitu:
        from repro_torch.core.insitu.chain import InSituChain
        from repro_torch.core.insitu.endpoints.spectral_monitor import (
            SpectralMonitorEndpoint)
        insitu_hook = InSituChain(
            [SpectralMonitorEndpoint(source="grads", nbins=16,
                                     max_tensors=8)]).as_step_hook()
    step_fn = train_step_mod.make_train_step(
        cfg, policy, opt, microbatches=micro, remat_policy=remat_policy,
        insitu_chain=insitu_hook, insitu_every=1)
    state_shapes = train_step_mod.train_state_shapes(
        cfg, opt, param_dtype=param_dtype,
        max_target=max_target or shape.seq_len)
    state_specs = _state_specs(policy, state_shapes)
    batch, batch_spec = batch_specs(cfg, shape, train=True, policy=policy)
    in_specs = (state_specs, batch_spec)
    args = (state_shapes, batch)
    return dict(fn=step_fn, args=args,
                local_args=local_shapes(args, in_specs, policy.mesh),
                in_specs=in_specs, out_specs=(state_specs, P()),
                donate_argnums=(0,), meta={"microbatches": micro})


def _param_shapes(cfg, dtype, max_target):
    if cfg.family == "encdec":
        return encdec.init_params(cfg, ShapeOnly(), dtype,
                                  max_target=max_target)
    return lm.init_params(cfg, ShapeOnly(), dtype)


def _decode_state(cfg, batch, cache_len, enc_len, dtype, policy=None,
                  cache_impl="dense"):
    """An empty decode state of ``meta`` tensors: the global one, or
    with a ``policy`` across ranks this rank's block in the port's
    cache layout."""
    if cfg.family == "encdec":
        return encdec.init_decode_state(cfg, batch, cache_len, enc_len,
                                        dtype, policy, device="meta")
    return lm.init_decode_state(cfg, batch, cache_len, dtype, policy,
                                cache_impl=cache_impl, device="meta")


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, policy: Policy,
                  *, param_dtype=torch.bfloat16):
    params = _param_shapes(cfg, param_dtype,
                           max_target=max(shape.seq_len, WHISPER_DEC_PROMPT)
                           if cfg.family == "encdec" else 0)
    mod = encdec if cfg.family == "encdec" else lm

    def fn(params, batch):
        return mod.prefill(cfg, params, batch, policy,
                           cache_len=shape.seq_len)

    batch, batch_spec = batch_specs(cfg, shape, train=False, policy=policy)
    in_specs = (policy.tree_specs(params), batch_spec)
    # the state prefill emits: caches of seq_len slots (encdec: the
    # cross K/V over the seq_len frames)
    state = _decode_state(cfg, shape.global_batch, shape.seq_len,
                          shape.seq_len, param_dtype)
    out_specs = (policy.act_logits(cfg.vocab_size),
                 decode_state_specs(cfg, state, policy))
    args = (params, batch)
    return dict(fn=fn, args=args,
                local_args=local_shapes(args, in_specs, policy.mesh),
                in_specs=in_specs, out_specs=out_specs, donate_argnums=(),
                meta={})


def build_decode(cfg: ModelConfig, shape: ShapeConfig, policy: Policy,
                 *, param_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                 cache_impl: str = "dense"):
    B, S = shape.global_batch, shape.seq_len
    params = _param_shapes(cfg, param_dtype,
                           max_target=S if cfg.family == "encdec" else 0)
    state = _decode_state(cfg, B, S, WHISPER_CROSS_LEN, cache_dtype,
                          cache_impl=cache_impl)
    mod = encdec if cfg.family == "encdec" else lm

    def fn(params, tokens, state):
        return mod.decode_step(cfg, params, tokens, state, policy)

    tokens = _sds((B, 1), torch.int32)
    state_specs = decode_state_specs(cfg, state, policy)
    pspecs = policy.tree_specs(params)
    tok_spec = P(policy.batch(), None)
    local = (local_shapes(params, pspecs, policy.mesh),
             local_shapes(tokens, tok_spec, policy.mesh),
             _decode_state(cfg, B, S, WHISPER_CROSS_LEN, cache_dtype,
                           policy, cache_impl) if sharded(policy)
             else state)
    return dict(fn=fn, args=(params, tokens, state), local_args=local,
                in_specs=(pspecs, tok_spec, state_specs),
                out_specs=(policy.act_logits(cfg.vocab_size), state_specs),
                donate_argnums=(2,), meta={})


def decode_state_specs(cfg, state, policy: Policy):
    """The decode state's specs, the reference's rules on the port's
    tree (caches are ``KVCache``/``QuantKVCache`` dataclasses holding
    specs in their tensor fields): KV caches (G?, B, S, KV, hd) → batch ×
    seq × tp; SSM states: heads over tp; scalars replicated. Where the
    KV heads do not divide the model axis the cache's sequence takes it
    (``act_kv_cache``); the enc-dec's cross K/V then hold the KV heads
    of this rank's query heads, a layout no spec of the global K/V
    describes (``local_args`` comes from ``init_decode_state``)."""
    kv_spec = policy.act_kv_cache(cfg.num_kv_heads)
    b = policy.batch()

    def cache_rule(nd):
        if nd == 5:      # k/v stacked over depth (G,B,S,KV,hd)
            return P(None, *kv_spec)
        if nd == 4:      # k/v (B,S,KV,hd)
            return P(*kv_spec)
        if nd == 3:      # positions (G,B,S)
            return P(None, b, kv_spec[1])
        if nd == 2:      # positions (B,S)
            return P(b, kv_spec[1])
        return P(*([None] * nd))

    def ssm_rule(field, nd):
        # SSMState fields (stacked over G groups):
        #   h (G,B,H,N,P) — heads on tp
        #   conv (G,B,K-1,H,P) — heads on tp
        #   conv_B / conv_C (G,B,K-1,Gr,N) — replicated
        if field == "h":
            return P(None, b, policy.tp_axis, None, None)
        if field == "conv":
            return P(None, b, None, policy.tp_axis, None)
        return P(None, b, *([None] * (nd - 2)))

    def walk(t, names):
        if isinstance(t, (KVCache, QuantKVCache)):
            return dataclasses.replace(t, **{
                f.name: cache_rule(getattr(t, f.name).dim())
                for f in dataclasses.fields(t)
                if torch.is_tensor(getattr(t, f.name))})
        if isinstance(t, dict):
            return {k: walk(v, names + (k,)) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):      # SSMState
            return type(t)(*(ssm_rule(f, v.dim())
                             for f, v in zip(t._fields, t)))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, names) for v in t)
        if not torch.is_tensor(t) or "pos" in names:
            return P()
        if any(n in ("caches", "self", "cross") for n in names):
            return cache_rule(t.dim())
        return P(*([None] * t.dim()))

    return walk(state, ())


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               multi_pod: bool = False, parallelism: str = "tp",
               fsdp_params: bool = True, **overrides):
    policy = cell_policy(cfg, shape, mesh, multi_pod, parallelism,
                         fsdp_params)
    if shape.kind == "train":
        return build_train(cfg, shape, policy, **overrides), policy
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, policy, **overrides), policy
    return build_decode(cfg, shape, policy, **overrides), policy
