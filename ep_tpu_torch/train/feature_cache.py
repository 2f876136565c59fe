"""Feature-cache probing: extract frozen-backbone features ONCE, then train
the head on cached descriptors/tokens (``--cache_features``).

Counterpart of ``ep_tpu/train/feature_cache.py``. The reference re-runs the
frozen encoder on every epoch of every probe run; with the backbone frozen
this mode runs the encoder once per split (or ``--cache_augs`` K times for
the train split) and then trains the head alone.

Semantics (as in the JAX package):
  * train images are transformed with the augmentation draw of epoch k for
    variant k, so epoch e reuses the crops of variant e % K;
  * features are stored float16 in a memmap ``feat_cache_{name}.npy`` under
    ``cache_dir`` when the split exceeds ``memmap_threshold`` (2 GiB) at the
    features' own width, float32 in RAM otherwise. The JAX package keeps the
    device's bf16 in RAM; numpy has no bf16, so the port widens it to f32,
    which holds every bf16 value exactly: the loader yields the same f32
    batches either way;
  * over several ranks (a registered mesh with a data axis above 1) each
    rank extracts its loader's rows and every batch is gathered over the
    data axis in rank order (features, labels and ``valid``), as the JAX
    package's ``process_allgather`` does: every rank ends with the whole
    cache, in the same order, and feeds the same cached batches to the head
    steps, as every JAX process feeds its own copy of them.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ep_tpu_torch.parallel.mesh import DATA_AXIS, current_mesh
from ep_tpu_torch.parallel.metrics import all_gather_rows
from .engine import gather_labels, to_device
from .steps import make_eval_step, make_train_step


class _HostCopy:
    """Copies a batch of device features to the host without blocking: on a
    card the copy runs on a side stream into pinned memory, so that it
    overlaps the next batch's forward; on the CPU it is the tensor itself."""

    def __init__(self, device: torch.device):
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def start(self, fd: torch.Tensor):
        if self.stream is None or not fd.is_cuda:
            return fd.detach(), None
        self.stream.wait_stream(torch.cuda.current_stream(fd.device))
        with torch.cuda.stream(self.stream):
            host = torch.empty(fd.shape, dtype=fd.dtype, pin_memory=True)
            host.copy_(fd, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        fd.record_stream(self.stream)  # keep fd's memory until the copy ends
        return host, done

    @staticmethod
    def finish(host: torch.Tensor, done) -> torch.Tensor:
        if done is not None:
            done.synchronize()
        return host


def extract_split(backbone_apply, loader, device, cache_dir: str, name: str,
                  memmap_threshold: int = 2 << 30, cfg=None):
    """Run the frozen backbone over a split -> (features array, labels).

    ``backbone_apply`` maps a device batch to its features; the loader's
    images reach ``device`` through ``engine.to_device`` (the bf16 host cast
    under ``cfg``'s bf16 amp). The RAM-vs-memmap decision is made ONCE, at
    the first batch, from dataset length x the bytes of one row of the
    backbone's output (valid-mask filtering can shrink early batches, so a
    per-batch estimate could flip mid-stream and strand rows already kept).
    Each batch's features are read one batch late: batch k's copy to the host
    overlaps batch k+1's forward. Over several ranks each batch is gathered
    over the data axis first (under gloo through the host), and the store
    holds every rank's rows: the data axis' size times this rank's."""
    device = torch.device(device)
    copier = _HostCopy(device)
    mesh = current_mesh()
    n_data = mesh.shape[DATA_AXIS] if mesh is not None else 1
    rows = len(loader.dataset) if n_data == 1 else \
        n_data * len(loader._indices())
    pin = bool(cfg is not None and cfg.pin_mem)
    labels_list = []
    store = None  # the float16 memmap or the f32 array, for every row
    n_written = 0

    def consume(host, done, labels, valid):
        """Write one batch's kept rows into the store (made at the first
        batch), converting them on the way."""
        nonlocal store, n_written
        f = copier.finish(host, done)
        keep = valid > 0
        if not keep.all():
            f = f[torch.from_numpy(keep)]
        labels_list.append(labels[keep])
        if store is None:
            per_row = int(np.prod(f.shape[1:])) * f.element_size()
            shape = (rows,) + tuple(f.shape[1:])
            if bool(cache_dir) and per_row * rows > memmap_threshold:
                os.makedirs(cache_dir, exist_ok=True)
                store = np.lib.format.open_memmap(
                    os.path.join(cache_dir, f"feat_cache_{name}.npy"),
                    mode="w+", dtype=np.float16, shape=shape)
            else:
                store = np.empty(shape, np.float32)
        torch.from_numpy(store[n_written:n_written + len(f)]).copy_(f)
        n_written += len(f)

    pending = None
    with torch.no_grad():
        for images, labels, valid in iter(loader):
            fd = backbone_apply(to_device(images, device, pin, cfg))
            if n_data > 1:
                fd = all_gather_rows(fd, DATA_AXIS, mesh)
                labels, valid = gather_labels(labels, valid)
            nxt = (*copier.start(fd), labels, valid)
            if pending is not None:
                consume(*pending)
            pending = nxt
    if pending is not None:
        consume(*pending)
    labels = np.concatenate(labels_list)
    if isinstance(store, np.memmap):
        store.flush()
    return store[:n_written], labels


def make_head_steps(head, optimizer, lr_fn):
    """Train and eval steps that consume cached features directly: the steps
    of ``train/steps.py`` over the head module alone (``model.head`` of the
    driver's ``ProbeModel``), with ``optimizer`` built over the same
    parameters, so the metrics, the LR schedule, head-only checkpoints and
    ``--auto_resume`` are those of the uncached path."""
    return make_train_step(head, optimizer, lr_fn), make_eval_step(head)


class CachedFeatureLoader:
    """Batches over cached features with per-epoch shuffling; mirrors the
    DataLoader protocol (set_epoch / __len__ / iteration with masks).

    ``feats`` may be a LIST of per-augmentation variants (--cache_augs K:
    K epoch-seeded crops of every image, extracted in dataset order so the
    labels align across variants); epoch e trains on variant e % K, so
    successive epochs see different crops like no-cache training does."""

    def __init__(self, feats, labels, batch_size: int, shuffle: bool,
                 drop_last: bool, seed: int = 0):
        self.variants = list(feats) if isinstance(feats, (list, tuple)) \
            else [feats]
        self.labels = labels.astype(np.int32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.labels)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        n = len(self.labels)
        idx = (np.random.default_rng((self.seed, self.epoch)).permutation(n)
               if self.shuffle else np.arange(n))
        feats = self.variants[self.epoch % len(self.variants)]
        bs = self.batch_size
        for b in range(len(self)):
            sel = idx[b * bs:(b + 1) * bs]
            f = np.asarray(feats[sel], np.float32)
            l = self.labels[sel]
            valid = np.ones(len(sel), np.float32)
            if len(sel) < bs:
                pad = bs - len(sel)
                f = np.concatenate([f, np.zeros((pad,) + f.shape[1:], f.dtype)])
                l = np.concatenate([l, np.zeros(pad, l.dtype)])
                valid = np.concatenate([valid, np.zeros(pad, np.float32)])
            yield f, l, valid
