"""Host→device input pipeline: placement + background prefetch
(counterpart of ``repro/data/pipeline.py``).

``ShardedLoader`` wraps the synthetic stream (or any step-indexed batch
function), places each global batch on the policy's mesh, and prepares
the next ``prefetch`` batches on a worker thread while the current step
runs — the standard overlap-input-with-compute pattern. Every rank
builds the same global batch from ``batch_fn(step)`` and keeps its data
rank's rows (``act_tokens``: the leading dim over the batch axes, the
rest whole), as the reference's ``device_put`` to the batch sharding
leaves each device its shard.

On a CUDA mesh the worker copies each batch from pinned host memory
with ``non_blocking=True`` on a stream of its own and records an event;
``__next__`` makes the consumer's current stream wait for that event
(and marks the tensors as used there), so the copy overlaps the step
that runs while it is in flight. On a CPU mesh the rows are taken as
they are.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core.fft.distributed import _slices


def place_rows(batch: Dict[str, np.ndarray], policy) -> Dict[str,
                                                             torch.Tensor]:
    """A global batch's arrays as this rank's rows (``act_tokens``'s
    leading entry; the whole arrays on one rank), on the mesh's device,
    without the prefetch thread."""
    return {k: policy.named(policy.act_rows(np.ndim(v)))(np.asarray(v))
            for k, v in batch.items()}


class ShardedLoader:
    def __init__(self, batch_fn: Callable[[int], Dict[str, np.ndarray]],
                 policy, *, start_step: int = 0, prefetch: int = 2):
        if not policy.one_rank:
            policy._live()
        self.batch_fn = batch_fn
        self.policy = policy
        self.device = torch.device(policy.mesh.device)
        self.step = start_step
        self.prefetch = prefetch
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def rows(self, arr) -> np.ndarray:
        """This rank's rows of one global array (the whole array on one
        rank)."""
        arr = np.asarray(arr)
        if self.policy.one_rank:
            return arr
        mesh = self.policy.mesh
        return arr[_slices(mesh, self.policy.act_rows(arr.ndim), arr.shape,
                           mesh.coordinate)]

    def _place(self, batch: Dict[str, np.ndarray]):
        """(placed batch, ready event or None)."""
        batch = {k: np.ascontiguousarray(self.rows(v))
                 for k, v in batch.items()}
        if self.device.type != "cuda":
            return {k: torch.from_numpy(v).to(self.device)
                    for k, v in batch.items()}, None
        stream = self._stream
        with torch.cuda.stream(stream):
            out = {k: torch.from_numpy(v).pin_memory()
                   .to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    def _worker(self):
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
        step = self.step
        while not self._stop.is_set():
            try:
                item = (step, *self._place(self.batch_fn(step)))
            except Exception as err:    # handed to the consumer to raise
                item = (step, err, None)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(item[1], Exception):
                return
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        step, batch, ready = self._q.get()
        if isinstance(batch, Exception):
            raise RuntimeError(f"ShardedLoader: batch {step} failed") \
                from batch
        if ready is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ready)
            for t in batch.values():
                t.record_stream(current)
        self.step = step
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
