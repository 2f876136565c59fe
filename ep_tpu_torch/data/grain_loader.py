"""grain-backed input pipeline (optional production loader).

Drop-in alternative to data/loader.py built on Google's grain: deterministic
global shuffling keyed by (seed, epoch), per-process sharding with the
DistributedSampler contract, worker-process parallelism for decode+augment,
and the same padded-final-batch protocol. Select with ``--use_grain``.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class _DecodeAugment:
    """grain MapTransform: dataset index → (image, label)."""

    def __init__(self, dataset, transform, seed: int, train: bool):
        self.dataset = dataset
        self.transform = transform
        self.seed = seed
        self.train = train

    def map(self, item):
        return self(item)

    def __call__(self, item):
        idx, epoch = item
        img, label = self.dataset[int(idx)]
        rng = np.random.default_rng((self.seed, int(epoch), int(idx)))
        return self.transform(img, rng), np.int32(label)


class GrainDataLoader:
    """DataLoader-protocol wrapper (set_epoch / len / iter with masks)."""

    def __init__(self, dataset, batch_size: int, transform, *,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0, num_workers: int = 2,
                 num_processes: int = 1, process_index: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.transform = transform
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(0, num_workers)
        self.num_processes = num_processes
        self.process_index = process_index
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            idx = np.random.default_rng((self.seed, self.epoch)).permutation(n)
        else:
            idx = np.arange(n)
        if self.num_processes > 1:
            per = -(-n // self.num_processes)
            idx = np.concatenate([idx, idx[: per * self.num_processes - n]])
            idx = idx[self.process_index::self.num_processes]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        import grain.python as gp

        idx = self._indices()
        n_batches = len(self)
        usable = n_batches * self.batch_size if self.drop_last else len(idx)
        items = [(int(i), self.epoch) for i in idx[:usable]]

        source = gp.MapDataset.source(items)
        ds = source.map(_DecodeAugment(self.dataset, self.transform,
                                       self.seed, self.shuffle))
        it = ds.to_iter_dataset()
        if self.num_workers > 0:
            it = it.mp_prefetch(
                gp.MultiprocessingOptions(num_workers=self.num_workers))

        images, labels = [], []
        produced = 0
        for img, label in it:
            images.append(img)
            labels.append(label)
            if len(images) == self.batch_size:
                yield (np.stack(images), np.asarray(labels, np.int32),
                       np.ones(self.batch_size, np.float32))
                produced += 1
                images, labels = [], []
        if images and not self.drop_last:
            pad = self.batch_size - len(images)
            valid = np.concatenate([np.ones(len(images), np.float32),
                                    np.zeros(pad, np.float32)])
            images += [np.zeros_like(images[0])] * pad
            labels = list(labels) + [np.int32(0)] * pad
            yield np.stack(images), np.asarray(labels, np.int32), valid
