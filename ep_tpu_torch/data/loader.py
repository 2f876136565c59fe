"""Sharded, prefetching data loader (replaces DataLoader + DistributedSampler).

Semantics mirrored from the reference:
  * train: global shuffle keyed by (seed, epoch) — the DistributedSampler
    set_epoch contract (main_linprobe.py:281-291,690) — then round-robin
    sharding across processes, drop_last (main_linprobe.py:315-325);
  * val: sequential, no drop; the final short batch is PADDED to the static
    batch shape with a validity mask so jitted eval never recompiles;
  * decode + augment run in a thread pool; finished batches are prefetched
    ahead of the device.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        transform,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        num_workers: int = 4,
        num_processes: int = 1,
        process_index: int = 0,
        prefetch: int = 2,
        pad_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.transform = transform
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.num_processes = num_processes
        self.process_index = process_index
        self.prefetch = prefetch
        self.pad_last = pad_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        # round-robin shard across processes (DistributedSampler layout);
        # pad with wraparound so every process sees the same batch count
        if self.num_processes > 1:
            per = -(-n // self.num_processes)
            idx = np.concatenate([idx, idx[: per * self.num_processes - n]])
            idx = idx[self.process_index::self.num_processes]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _make_batch(self, batch_idx: np.ndarray, epoch: int, start: int):
        bs = self.batch_size
        images, labels = [], []
        for off, i in enumerate(batch_idx):
            img, label = self.dataset[int(i)]
            rng = np.random.default_rng(
                (self.seed, epoch, start + off, self.process_index))
            images.append(self.transform(img, rng))
            labels.append(label)
        valid = np.ones(len(images), np.float32)
        if self.pad_last and len(images) < bs:
            pad = bs - len(images)
            images += [np.zeros_like(images[0])] * pad
            labels += [0] * pad
            valid = np.concatenate([valid, np.zeros(pad, np.float32)])
        return (np.stack(images), np.asarray(labels, np.int32), valid)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        idx = self._indices()
        bs = self.batch_size
        n_batches = len(self)
        epoch = self.epoch

        def gen_batches():
            for b in range(n_batches):
                yield idx[b * bs:(b + 1) * bs], b * bs

        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            pending = []
            it = gen_batches()
            # keep `prefetch` batches in flight
            for _ in range(self.prefetch + 1):
                try:
                    bidx, start = next(it)
                    pending.append(ex.submit(self._make_batch, bidx, epoch, start))
                except StopIteration:
                    break
            while pending:
                fut = pending.pop(0)
                try:
                    bidx, start = next(it)
                    pending.append(ex.submit(self._make_batch, bidx, epoch, start))
                except StopIteration:
                    pass
                yield fut.result()


def build_loaders(cfg, dataset_train, dataset_val, transform_train,
                  transform_val, num_processes: int = 1, process_index: int = 0):
    drop_last = not cfg.knn_eval  # main_linprobe.py:315-318
    loader_cls = DataLoader
    if getattr(cfg, "use_grain", False):
        from .grain_loader import GrainDataLoader
        loader_cls = GrainDataLoader
    train = loader_cls(
        dataset_train, cfg.batch_size, transform_train, shuffle=not cfg.knn_eval,
        drop_last=drop_last, seed=cfg.seed, num_workers=cfg.num_workers,
        num_processes=num_processes, process_index=process_index,
    )
    if cfg.dist_eval and num_processes > 1 and \
            len(dataset_val) % num_processes != 0:
        # main_linprobe.py:286-289 caveat: wraparound padding duplicates a few
        # eval samples to equalize the per-process count
        print("Warning: Enabling distributed evaluation with an eval dataset "
              "not divisible by process number. This will slightly alter "
              "validation results as extra duplicate entries are added to "
              "achieve equal num of samples per-process.")
    val = loader_cls(
        dataset_val, cfg.batch_size, transform_val, shuffle=False,
        drop_last=False, seed=cfg.seed, num_workers=cfg.num_workers,
        num_processes=num_processes if cfg.dist_eval else 1,
        process_index=process_index if cfg.dist_eval else 0,
    )
    return train, val
