"""Fault-tolerant data sharding and the host-to-device input pipeline.

Twin of ``torchft_tpu/data.py``. ``DistributedSampler`` has the identical
index stream: an epoch-seeded numpy permutation sharded over
``num_replicas x num_replica_groups`` with
``global_rank = rank + num_replicas * replica_group``. It yields dataset
indices for any batching code; ``state_dict``/``load_state_dict``
checkpoint the position. Lossy by design when a group is down: it shards
by the maximum number of groups.

``PrefetchIterator`` keeps the next batches' host work and host-to-device
copies ahead of the step that consumes them.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Sized

import numpy as np
import torch

from torchft_tpu_torch.utils.device import resolve_device

__all__ = ["DistributedSampler", "PrefetchIterator"]


class DistributedSampler:
    """Shards a dataset across replica groups × local ranks."""

    def __init__(
        self,
        dataset: "Sized | int",
        replica_group: int,
        num_replica_groups: int,
        rank: int = 0,
        num_replicas: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ) -> None:
        """
        Args:
            dataset: the dataset (or its length) to shard
            replica_group: this group's id in [0, num_replica_groups)
            num_replica_groups: the MAX number of replica groups — torchft
                can't know how many are alive ahead of time, so shard by the
                maximum (ref data.py:33-35)
            rank: local rank within the replica group
            num_replicas: local world size of the replica group
        """
        self._size = dataset if isinstance(dataset, int) else len(dataset)
        self.global_rank = rank + num_replicas * replica_group
        self.global_world_size = num_replicas * num_replica_groups
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self._pos = 0  # position within the current epoch's shard

        if self.drop_last:
            self.num_samples = self._size // self.global_world_size
        else:
            self.num_samples = -(-self._size // self.global_world_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self._pos = 0

    def _epoch_indices(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(self._size)
        else:
            indices = np.arange(self._size)
        if self.drop_last:
            usable = self.num_samples * self.global_world_size
            indices = indices[:usable]
        else:
            # pad by wrapping so every shard has num_samples entries
            total = self.num_samples * self.global_world_size
            if total > len(indices):
                pad = indices[: total - len(indices)]
                indices = np.concatenate([indices, pad])
        return indices[self.global_rank:: self.global_world_size]

    def __iter__(self) -> Iterator[int]:
        shard = self._epoch_indices()
        if self._pos >= len(shard):
            # previous epoch fully consumed: restart (a freshly loaded
            # mid-epoch position still resumes where it left off)
            self._pos = 0
        for i in range(self._pos, len(shard)):
            self._pos = i + 1
            yield int(shard[i])

    def __len__(self) -> int:
        return self.num_samples

    # position checkpointing (StatefulDataLoader role, ref data.py:13-15)

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "pos": self._pos}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.epoch = state["epoch"]
        self._pos = state["pos"]


class PrefetchIterator:
    """Host-to-device input pipeline: a worker thread stays ``depth``
    batches ahead of the consumer, overlapping the next batch's host work
    and copy with the current step.

    ``source`` yields batches: tensors, numpy arrays, or dicts, lists and
    tuples of them (other values pass through). Each tensor goes to
    ``device`` (CUDA unless the caller asks for the CPU). On CUDA the worker
    stages it in pinned host memory and copies it with ``non_blocking=True``
    on a side stream, then records an event; ``__next__`` makes the
    consumer's current stream wait on that event (and records the batch's
    tensors on that stream for the allocator), so no batch is read before
    its copy lands. A source exception re-raises on the consumer; iteration
    ends when the source does. ``close()`` stops the worker."""

    _DONE = object()

    def __init__(self, source, depth: int = 2,
                 device: "Optional[str | torch.device]" = None) -> None:
        self._device = resolve_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._finished = False
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._thread = threading.Thread(target=self._worker,
                                        args=(iter(source),), daemon=True,
                                        name="prefetch")
        self._thread.start()

    def _place(self, x: Any, tensors: List[torch.Tensor]) -> Any:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor):
            if self._stream is not None:
                if not x.is_cuda:
                    x = x.pin_memory()
                x = x.to(self._device, non_blocking=True)
            else:
                x = x.to(self._device)
            tensors.append(x)
            return x
        if isinstance(x, dict):
            return type(x)((k, self._place(v, tensors)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(self._place(v, tensors) for v in x)
        return x

    def _worker(self, it) -> None:
        try:
            for item in it:
                if self._stop.is_set():
                    return
                tensors: List[torch.Tensor] = []
                event = None
                if self._stream is not None:
                    with torch.cuda.stream(self._stream):
                        placed = self._place(item, tensors)
                        event = torch.cuda.Event()
                        event.record(self._stream)
                else:
                    placed = self._place(item, tensors)
                while not self._stop.is_set():
                    try:
                        self._q.put((placed, event, tensors), timeout=0.1)
                        break
                    except queue.Full:
                        continue
            self._q.put(self._DONE)
        except BaseException as e:  # noqa: BLE001 — raised on the consumer
            self._q.put(e)

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        if self._finished:
            # the worker exited and will never fill the queue again
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            self._finished = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._finished = True
            raise item
        placed, event, tensors = item
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for t in tensors:
                t.record_stream(current)
        return placed

    def close(self) -> None:
        self._stop.set()
        # latch first: the drain below may discard the worker's sentinel
        self._finished = True
        try:
            while True:  # unblock a worker stuck on put()
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __del__(self) -> None:  # pragma: no cover — best effort
        try:
            self.close()
        except Exception:
            pass
