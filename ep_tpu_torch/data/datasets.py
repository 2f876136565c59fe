"""Dataset zoo: the reference's 11 datasets + a synthetic one, torch-free.

Dispatch mirrors main_linprobe.py:239-273. Each dataset is an indexable
``(raw_image, label)`` source; decode/augment happens in the loader workers.
Custom split logic (CUB200 train_test_split.txt, SUN397 Training_01/Testing_01)
follows util/cub200.py:5-50 and util/sun397.py:7-72; the torchvision-backed
ones (CIFAR100/STL10/DTD/Pets/Food101/Aircraft/Cars/Places365) are
re-implemented directly against the standard on-disk layouts.
"""
from __future__ import annotations

import json
import os
import pickle
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np


class ImageDataset:
    """Base: image paths (or raw arrays) + integer labels."""

    def __init__(self, items: List[Tuple], classes: Optional[List[str]] = None):
        self.items = items
        self.classes = classes or []

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        src, label = self.items[idx]
        if isinstance(src, np.ndarray):
            return src, label
        from PIL import Image
        with Image.open(src) as im:
            return im.convert("RGB"), label

    def __repr__(self):
        return (f"{type(self).__name__}(n={len(self)}, "
                f"classes={len(self.classes)})")


class FakeDataset(ImageDataset):
    """Deterministic synthetic dataset: class-dependent colored blobs on
    noise, linearly separable from pooled features — lets the e2e tests and
    benches run the full pipeline without any files."""

    def __init__(self, n: int = 256, num_classes: int = 10, image_size: int = 32,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        sig_rng = np.random.default_rng(12345)  # class tints shared by splits
        tints = sig_rng.integers(40, 200, (num_classes, 3))
        items = []
        for i in range(n):
            label = int(i % num_classes)
            img = rng.integers(0, 48, (image_size, image_size, 3), np.uint8)
            # class signature: a global color tint — survives crops and flips
            img = (img + tints[label][None, None]).clip(0, 255).astype(np.uint8)
            items.append((img, label))
        super().__init__(items, [str(c) for c in range(num_classes)])


class FakeNeedleDataset(ImageDataset):
    """Synthetic 'needle' dataset: the class signature lives in ONE randomly
    placed patch-sized square; the rest is noise. Global average pooling
    dilutes the signal ~N×, while attentive poolings (EP) can attend to the
    needle — a demo-scale reproduction of the paper's core phenomenon."""

    def __init__(self, n: int = 512, num_classes: int = 8,
                 image_size: int = 32, patch: int = 8, seed: int = 0):
        rng = np.random.default_rng(seed)
        sig_rng = np.random.default_rng(999)
        tints = sig_rng.integers(30, 226, (num_classes, 3))
        g = image_size // patch
        items = []
        for i in range(n):
            label = int(i % num_classes)
            img = rng.integers(96, 160, (image_size, image_size, 3), np.uint8)
            r, c = rng.integers(0, g, 2)
            img[r * patch:(r + 1) * patch, c * patch:(c + 1) * patch] = \
                tints[label][None, None]
            items.append((img, label))
        super().__init__(items, [str(c) for c in range(num_classes)])


def image_folder(root: Path) -> ImageDataset:
    """torchvision.datasets.ImageFolder-compatible layout."""
    root = Path(root)
    classes = sorted(d.name for d in root.iterdir() if d.is_dir())
    class_to_idx = {c: i for i, c in enumerate(classes)}
    exts = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm", ".tif", ".tiff"}
    items = []
    for c in classes:
        for p in sorted((root / c).rglob("*")):
            if p.suffix.lower() in exts:
                items.append((str(p), class_to_idx[c]))
    return ImageDataset(items, classes)


def cifar100(root: Path, train: bool) -> ImageDataset:
    """CIFAR-100 python-pickle layout (cifar-100-python/{train,test})."""
    base = Path(root) / "cifar-100-python"
    with open(base / ("train" if train else "test"), "rb") as f:
        d = pickle.load(f, encoding="latin1")
    data = d["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    labels = d["fine_labels"]
    items = [(data[i], int(labels[i])) for i in range(len(labels))]
    with open(base / "meta", "rb") as f:
        meta = pickle.load(f, encoding="latin1")
    return ImageDataset(items, meta["fine_label_names"])


def stl10(root: Path, split: str) -> ImageDataset:
    """STL10 binary layout (stl10_binary/{train,test}_{X,y}.bin)."""
    base = Path(root) / "stl10_binary"
    with open(base / f"{split}_X.bin", "rb") as f:
        x = np.frombuffer(f.read(), np.uint8).reshape(-1, 3, 96, 96)
        x = x.transpose(0, 3, 2, 1)  # CHW col-major -> HWC
    with open(base / f"{split}_y.bin", "rb") as f:
        y = np.frombuffer(f.read(), np.uint8).astype(np.int64) - 1
    items = [(x[i], int(y[i])) for i in range(len(y))]
    return ImageDataset(items, [str(i) for i in range(10)])


def cub200(root: Path, split: str) -> ImageDataset:
    """CUB-200 via train_test_split.txt + images.txt (util/cub200.py:5-50)."""
    root = Path(root)
    paths = {}
    with open(root / "images.txt") as f:
        for line in f:
            i, p = line.strip().split()
            paths[int(i)] = root / "images" / p
    keep = []
    with open(root / "train_test_split.txt") as f:
        for line in f:
            i, is_train = line.strip().split()
            if (split == "train") == bool(int(is_train)):
                keep.append(int(i))
    sel = [paths[i] for i in keep]
    classes = sorted({p.parent.name for p in sel})
    cti = {c: i for i, c in enumerate(classes)}
    items = [(str(p), cti[p.parent.name]) for p in sel]
    return ImageDataset(items, classes)


def sun397(root: Path, split: str) -> ImageDataset:
    """SUN397 with Training_01.txt / Testing_01.txt splits (util/sun397.py)."""
    data_dir = Path(root) / "SUN397"
    split_file = data_dir / ("Training_01.txt" if split == "train"
                             else "Testing_01.txt")
    class_file = data_dir / "ClassName.txt"
    with open(class_file) as f:
        classes = [line.strip() for line in f if line.strip()]
    cti = {c: i for i, c in enumerate(classes)}
    items = []
    with open(split_file) as f:
        for line in f:
            rel = line.strip()
            if not rel:
                continue
            full = data_dir / rel[1:]
            cls = "/" + "/".join(rel.split("/")[1:-1])
            if full.exists() and cls in cti:
                items.append((str(full), cti[cls]))
    return ImageDataset(items, classes)


def dtd(root: Path, split: str) -> ImageDataset:
    """DTD with labels/{split}1.txt lists."""
    base = Path(root) / "dtd"
    with open(base / "labels" / f"{split}1.txt") as f:
        rels = [line.strip() for line in f if line.strip()]
    classes = sorted({r.split("/")[0] for r in rels})
    cti = {c: i for i, c in enumerate(classes)}
    items = [(str(base / "images" / r), cti[r.split("/")[0]]) for r in rels]
    return ImageDataset(items, classes)


def oxford_pets(root: Path, split: str) -> ImageDataset:
    """OxfordIIITPet via annotations/{trainval,test}.txt."""
    base = Path(root) / "oxford-iiit-pet"
    name = "trainval" if split in ("train", "trainval") else "test"
    items, classes = [], {}
    with open(base / "annotations" / f"{name}.txt") as f:
        for line in f:
            img, cls_id, *_ = line.strip().split()
            label = int(cls_id) - 1
            classes[label] = "_".join(img.split("_")[:-1])
            items.append((str(base / "images" / f"{img}.jpg"), label))
    cls = [classes[i] for i in sorted(classes)]
    return ImageDataset(items, cls)


def food101(root: Path, split: str) -> ImageDataset:
    base = Path(root) / "food-101"
    with open(base / "meta" / f"{split}.json") as f:
        meta = json.load(f)
    classes = sorted(meta.keys())
    cti = {c: i for i, c in enumerate(classes)}
    items = []
    for c, rels in meta.items():
        for r in rels:
            items.append((str(base / "images" / f"{r}.jpg"), cti[c]))
    return ImageDataset(items, classes)


def fgvc_aircraft(root: Path, split: str) -> ImageDataset:
    base = Path(root) / "fgvc-aircraft-2013b" / "data"
    with open(base / "variants.txt") as f:
        classes = [line.strip() for line in f if line.strip()]
    cti = {c: i for i, c in enumerate(classes)}
    items = []
    with open(base / f"images_variant_{split}.txt") as f:
        for line in f:
            parts = line.strip().split(" ", 1)
            if len(parts) == 2:
                items.append((str(base / "images" / f"{parts[0]}.jpg"),
                              cti[parts[1]]))
    return ImageDataset(items, classes)


def stanford_cars(root: Path, split: str) -> ImageDataset:
    """StanfordCars via devkit .mat annotations (needs scipy)."""
    import scipy.io as sio
    root = Path(root)
    devkit = root / "devkit"
    meta = sio.loadmat(str(devkit / "cars_meta.mat"), squeeze_me=True)
    classes = [str(c) for c in meta["class_names"]]
    if split == "train":
        ann = sio.loadmat(str(devkit / "cars_train_annos.mat"), squeeze_me=True)
        img_dir = root / "cars_train"
    else:
        ann = sio.loadmat(str(root / "cars_test_annos_withlabels.mat"),
                          squeeze_me=True)
        img_dir = root / "cars_test"
    annos = np.atleast_1d(ann["annotations"])
    items = [(str(img_dir / str(a["fname"])), int(a["class"]) - 1)
             for a in annos]
    return ImageDataset(items, classes)


def places365(root: Path, split: str) -> ImageDataset:
    """Places365-standard (small) file-list layout."""
    root = Path(root)
    with open(root / "categories_places365.txt") as f:
        classes = [line.split()[0] for line in f]
    if split == "train":
        list_file = root / "places365_train_standard.txt"
        base = root / "data_256"
    else:
        list_file = root / "places365_val.txt"
        base = root / "val_256"
    items = []
    with open(list_file) as f:
        for line in f:
            rel, label = line.strip().rsplit(" ", 1)
            items.append((str(base / rel.lstrip("/")), int(label)))
    return ImageDataset(items, classes)


def build_datasets(cfg) -> Tuple[ImageDataset, ImageDataset]:
    """Name dispatch (main_linprobe.py:239-273)."""
    name, root = cfg.dataset_name, cfg.data_path
    if name == "imagenet1k":
        return (image_folder(Path(root) / "train"),
                image_folder(Path(root) / "val"))
    if name == "places365":
        return places365(root, "train"), places365(root, "val")
    if name == "CIFAR100":
        return cifar100(root, True), cifar100(root, False)
    if name == "StanfordCars":
        return stanford_cars(root, "train"), stanford_cars(root, "test")
    if name == "Food101":
        return food101(root, "train"), food101(root, "test")
    if name == "FGVCAircraft":
        return fgvc_aircraft(root, "train"), fgvc_aircraft(root, "val")
    if name == "SUN397":
        return sun397(root, "train"), sun397(root, "test")
    if name == "DTD":
        return dtd(root, "train"), dtd(root, "val")
    if name == "OxfordIIITPet":
        return oxford_pets(root, "trainval"), oxford_pets(root, "test")
    if name == "CUB200":
        return cub200(root, "train"), cub200(root, "test")
    if name == "stl10":
        return stl10(root, "train"), stl10(root, "test")
    if name == "fake":
        return (FakeDataset(512, cfg.nb_classes, cfg.image_size, seed=0),
                FakeDataset(128, cfg.nb_classes, cfg.image_size, seed=1))
    if name == "fake_needle":
        return (FakeNeedleDataset(1024, cfg.nb_classes, cfg.image_size,
                                  seed=0),
                FakeNeedleDataset(256, cfg.nb_classes, cfg.image_size,
                                  seed=1))
    raise ValueError(f'Unsupported dataset "{name}"')
