"""The port's host data pipeline against the JAX package's, bit for bit.

``ep_tpu_torch.data`` is a copy of ``ep_tpu.data`` (``tests/test_torch_imports.py``
holds the texts equal). Here both pipelines run: the same configuration
gives the same datasets, transforms and loaders, so two epochs of train and
val batches (the per-(seed, epoch) permutation, the per-sample RNG of the
crops, flips, colour jitter and AutoAugment, the zero-padded last val batch
and its ``valid`` mask) must be equal array for array, on the synthetic
``fake`` and ``fake_needle`` datasets and on an ImageFolder tree that the test
writes with PIL, under ``--train_aug default`` and ``aimv2``.
"""
import dataclasses

import numpy as np
import pytest

from ep_tpu.configs import TrainConfig
from ep_tpu.data.datasets import build_datasets as jax_datasets
from ep_tpu.data.loader import build_loaders as jax_loaders
from ep_tpu.data.transforms import build_transforms as jax_transforms
from ep_tpu_torch.configs import TrainConfig as PortTrainConfig
from ep_tpu_torch.data.datasets import build_datasets
from ep_tpu_torch.data.loader import build_loaders
from ep_tpu_torch.data.transforms import build_transforms


def _image_folder(root, n_classes=3, per_class=7):
    from PIL import Image
    rng = np.random.default_rng(5)
    for split, n in (("train", per_class), ("val", 3)):
        for c in range(n_classes):
            d = root / split / f"class_{c}"
            d.mkdir(parents=True)
            for i in range(n):
                h, w = rng.integers(18, 40, 2)
                img = rng.integers(0, 256, (h, w, 3), np.uint8)
                ext = ".png" if i % 2 else ".jpg"
                Image.fromarray(img).save(d / f"img_{i}{ext}")
    return root


def _batches(cfg, datasets, transforms, loaders, epochs=2):
    dtr, dva = datasets(cfg)
    ttr, tva = transforms(cfg)
    ltr, lva = loaders(cfg, dtr, dva, ttr, tva)
    out = []
    for epoch in range(epochs):
        ltr.set_epoch(epoch)
        out += [("train", epoch, b) for b in ltr]
        out += [("val", epoch, b) for b in lva]
    return out


@pytest.mark.parametrize("dataset, aug", [
    ("fake", "default"), ("fake", "aimv2"), ("fake_needle", "default"),
    ("imagenet1k", "default"), ("imagenet1k", "aimv2")])
def test_batches_equal_the_jax_packages(tmp_path, dataset, aug):
    kw = dict(dataset_name=dataset, nb_classes=4, image_size=16,
              batch_size=48, train_aug=aug, seed=3, num_workers=2)
    if dataset == "imagenet1k":
        kw.update(data_path=_image_folder(tmp_path), nb_classes=3,
                  batch_size=8)
    cfg = TrainConfig(**kw)
    ours = _batches(PortTrainConfig(**dataclasses.asdict(cfg)),
                    build_datasets, build_transforms, build_loaders)
    theirs = _batches(cfg, jax_datasets, jax_transforms, jax_loaders)
    assert len(ours) == len(theirs) > 4
    for (split, epoch, a), (_, _, b) in zip(ours, theirs):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y), (split, epoch)
    # the val split ends in a padded batch whose padding is masked
    last_val = [b for s, e, b in ours if s == "val"][-1]
    images, _, valid = last_val
    assert valid.shape == (images.shape[0],)
    if dataset == "imagenet1k":  # 9 val images in batches of 8
        assert valid.sum() == 1 and not images[1:].any()
    # the train permutation changes with the epoch
    first = [b[1] for s, e, b in ours if s == "train" and e == 0]
    second = [b[1] for s, e, b in ours if s == "train" and e == 1]
    assert any(not np.array_equal(a, b) for a, b in zip(first, second))


def test_grain_loader_matches_the_loaders_sharding():
    """``--use_grain`` (``data/grain_loader.py``) keeps the DataLoader's
    per-process contract: at 2 processes, on a dataset that 2 does not
    divide, each process gets the port's DataLoader's indices for the epoch
    (``tests/test_data.py::test_grain_loader_matches_thread_loader_sharding``);
    and its batches, read without worker processes, are the JAX package's
    grain loader's array for array."""
    from ep_tpu.data.grain_loader import GrainDataLoader as JaxGrainLoader
    from ep_tpu_torch.data.datasets import FakeDataset
    from ep_tpu_torch.data.grain_loader import GrainDataLoader
    from ep_tpu_torch.data.loader import DataLoader
    from ep_tpu_torch.data.transforms import TrainTransform
    ds = FakeDataset(n=101, num_classes=5, image_size=8)
    t = TrainTransform(8)
    kw = dict(shuffle=True, seed=7, num_processes=2)
    for p in range(2):
        a = DataLoader(ds, 16, t, process_index=p, **kw)
        b = GrainDataLoader(ds, 16, t, process_index=p, num_workers=0, **kw)
        c = JaxGrainLoader(ds, 16, t, process_index=p, num_workers=0, **kw)
        for loader in (a, b, c):
            loader.set_epoch(4)
        np.testing.assert_array_equal(a._indices(), b._indices())
        assert len(a) == len(b) == 4
        batches = list(b)
        assert len(batches) == 4 and batches[-1][2].sum() == 51 - 48
        for ours, theirs in zip(batches, c):
            for x, y in zip(ours, theirs):
                np.testing.assert_array_equal(x, y)
