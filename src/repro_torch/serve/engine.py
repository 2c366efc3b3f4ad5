"""Continuous-batching serve engine, slot based (counterpart of
``repro/serve/engine.py``).

A fixed pool of B slots decodes in lockstep (one decode step for the
whole pool); requests join by streaming their prompt into a free slot,
one token per tick, and leave on EOS or length, freeing the slot for the
next queued request. Per-slot cache positions are a (B,) tensor threaded
through the decode step (``kvcache.update_cache``'s per-row path), so
slots at different depths share one step.

Inactive slots replay their last token at their current position each
tick; the cache write is idempotent (same token and position give the
same K/V) and their logits are discarded. The reference's jitted step
is an eager call here, and a slot's reset is an in-place write of -1
(positions) and 0 (K/V, an int8 cache's scales, the SSM states) into
that slot's rows of every cache and state, as the reference's tree-wide
reset writes them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import lm


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (P,) int
    max_new: int = 32
    eos: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    def __init__(self, cfg, params, *, slots: int = 4,
                 cache_len: int = 256):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.cache_len = cache_len
        self.device = params["embedding"].device
        self.state = lm.init_decode_state(cfg, slots, cache_len,
                                          torch.float32, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.slot_pos = np.zeros(slots, np.int32)
        self.slot_remaining_prompt: List[List[int]] = [[] for _ in
                                                       range(slots)]
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self.cur_tok = np.zeros((slots, 1), np.int32)
        self.ticks = 0

    # -- queue management -----------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for s in range(self.slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[s] = req
                self.slot_pos[s] = 0
                self.slot_remaining_prompt[s] = [int(t) for t in
                                                 req.prompt]
                self._reset_slot_cache(s)
                self.cur_tok[s, 0] = self.slot_remaining_prompt[s].pop(0)

    def _reset_slot_cache(self, s: int):
        # stacked caches and states (G, B, ...): batch is axis 1
        for cache in self.state["caches"].values():
            for name, t in vars(cache).items():
                if torch.is_tensor(t):
                    t[:, s] = -1 if name == "positions" else 0
        for st in self.state["ssm"].values():
            for t in st:
                t[:, s] = 0

    # -- stepping ---------------------------------------------------------------
    def step(self) -> bool:
        """One scheduler tick: admit → lockstep decode → emit/retire."""
        self._admit()
        if not any(r is not None for r in self.slot_req):
            return False
        state = {**self.state,
                 "pos": torch.tensor(self.slot_pos, device=self.device)}
        logits, new_state = lm.decode_step(
            self.cfg, self.params,
            torch.tensor(self.cur_tok, device=self.device), state)
        self.state = {**new_state, "pos": 0}
        self.ticks += 1
        next_tok = logits[:, -1].argmax(dim=-1).cpu().numpy()

        for s in range(self.slots):
            req = self.slot_req[s]
            if req is None:
                continue                       # idempotent replay slot
            self.slot_pos[s] += 1
            if self.slot_remaining_prompt[s]:
                # still prefilling: feed the next prompt token
                self.cur_tok[s, 0] = self.slot_remaining_prompt[s].pop(0)
                continue
            tok = int(next_tok[s])
            req.out.append(tok)
            self.cur_tok[s, 0] = tok
            if ((req.eos is not None and tok == req.eos)
                    or len(req.out) >= req.max_new
                    or self.slot_pos[s] >= self.cache_len - 1):
                req.done = True
                self.finished[req.rid] = req
                self.slot_req[s] = None
        return True

    def run(self, max_ticks: int = 10_000) -> Dict[int, Request]:
        while (self.queue or any(self.slot_req)) and \
                self.ticks < max_ticks:
            if not self.step():
                break
        return self.finished
