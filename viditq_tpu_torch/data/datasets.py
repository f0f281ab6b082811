"""The resumable, dp-shardable index sampler and its batching (a copy of
`viditq_tpu/data/datasets.py:145-196`, numpy only: the port does not
import the JAX package). The same (n, seed, epoch, rank, world) gives the
JAX sampler's index order exactly. `DatasetFromCSV` and the video reading
are not ported."""

from __future__ import annotations

from typing import Iterator

import numpy as np


class StatefulSampler:
    """Resumable (optionally dp-sharded) index sampler: the reference's
    StatefulDistributedSampler (datasets/utils.py:38-63) without torch
    distributed; shard by (rank, world) explicitly."""

    def __init__(self, n: int, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world: int = 1):
        self.n = n
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world = world
        self.epoch = 0
        self.start_index = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def set_start_index(self, idx: int):
        self.start_index = idx

    def state_dict(self, consumed: int):
        return {"epoch": self.epoch, "start_index": consumed}

    def load_state_dict(self, state):
        self.epoch = state["epoch"]
        self.start_index = state["start_index"]

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.n)
        if self.shuffle:
            order = np.random.default_rng(
                self.seed + self.epoch).permutation(self.n)
        order = order[self.rank::self.world]
        yield from order[self.start_index:]
        self.start_index = 0


def _collate(batch):
    return {k: np.stack([b[k] for b in batch])
            if not isinstance(batch[0][k], str)
            else [b[k] for b in batch] for k in batch[0]}


def batch_iterator(dataset, sampler: StatefulSampler, batch_size: int):
    """The reference prepare_dataloader (datasets/utils.py:64) reduced to
    its order: full batches of `dataset[i]` items over sampler's
    indices, collated into arrays (strings into lists)."""
    batch = []
    for idx in sampler:
        batch.append(dataset[int(idx)])
        if len(batch) == batch_size:
            yield _collate(batch)
            batch = []
