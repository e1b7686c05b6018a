"""Host->device data loading with double-buffered prefetch (twin of
``repro/data/loader.py``).

``ShardedLoader`` copies each host batch to ``device`` on a background
thread while the current step runs, so the host->device copy overlaps
compute.  On the card a batch is staged in pinned host memory and copied
with ``non_blocking=True`` on a side stream; an event recorded after the
copy is handed over with the batch, and the consumer's stream waits on it
before the batch is yielded, so no kernel reads a batch before its copy
has ended.  On the CPU a batch is ``torch.as_tensor`` of the host arrays.

The JAX twin places batches with the step's input shardings.  Here
``shardings`` is a tree of ``dist.sharding.P`` matching the batch, with the
``mesh`` it refers to: each rank keeps its block of each leaf by the leaf's
spec (whole for ``P()``).  An exception in the producer (a
failing host generator) is raised in the consumer, where the JAX twin ends
the stream early (ROADMAP Queue 3).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import tree_leaves, tree_map


class ShardedLoader:
    def __init__(
        self,
        batches: Iterable[Any],
        shardings: Any | None = None,
        prefetch: int = 2,
        *,
        mesh: Any = None,
        device="cuda",
    ):
        if shardings is not None and mesh is None:
            raise ValueError("ShardedLoader(shardings=...) needs the mesh its specs refer to")
        self._shardings, self._mesh = shardings, mesh
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        else None)
        self._batches = iter(batches)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._done = object()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _place(self, batch):
        """-> (batch on the device, the copy's event or None)."""
        if self._shardings is not None:
            from repro_torch.dist.sharding import local_block

            batch = tree_map(lambda s, x: local_block(torch.as_tensor(np.asarray(x)), s,
                                                      self._mesh).contiguous(),
                             self._shardings, batch)
        if self._stream is None:
            return tree_map(torch.as_tensor, batch), None
        with torch.cuda.stream(self._stream):
            out = tree_map(lambda x: torch.as_tensor(x).pin_memory().to(
                self.device, non_blocking=True), batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _producer(self):
        try:
            for b in self._batches:
                self._q.put(self._place(b))
        except BaseException as e:  # noqa: BLE001 -- handed to the consumer, re-raised there
            self._q.put(e)
        finally:
            self._q.put(self._done)

    def __iter__(self) -> Iterator[Any]:
        while True:
            item = self._q.get()
            if item is self._done:
                return
            if isinstance(item, BaseException):
                raise item
            batch, event = item
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                for t in tree_leaves(batch):
                    t.record_stream(stream)     # allocated on the side stream, read here
            yield batch


def local_batch_slicer(global_batch: np.ndarray, process_index: int, n_processes: int):
    """Slice a global host batch to this process's shard (multi-host launch)."""
    n = global_batch.shape[0]
    per = n // n_processes
    return global_batch[process_index * per : (process_index + 1) * per]
