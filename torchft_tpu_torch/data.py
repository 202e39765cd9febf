"""Fault-tolerant data sharding.

Twin of ``DistributedSampler`` in ``torchft_tpu/data.py``, with the identical
index stream: an epoch-seeded numpy permutation sharded over
``num_replicas x num_replica_groups`` with
``global_rank = rank + num_replicas * replica_group``. It yields dataset
indices for any batching code; ``state_dict``/``load_state_dict``
checkpoint the position. Lossy by design when a group is down: it shards
by the maximum number of groups.
"""

from __future__ import annotations

from typing import Dict, Iterator, Sized

import numpy as np

__all__ = ["DistributedSampler"]


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
