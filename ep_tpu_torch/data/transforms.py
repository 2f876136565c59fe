"""Image transforms, numpy/PIL-based (no torchvision at runtime).

Train: TF/TPU-style RandomResizedCrop — the BYOL algorithm without the
torchvision retry loop, which the reference already adopted *specifically for
TPU parity* (util/crop.py:9-35) — + horizontal flip + ImageNet
normalization (main_linprobe.py:214-228). Optional aimv2 recipe adds
ColorJitter(0.3) and an IMAGENET AutoAugment-equivalent policy.

Val: Resize(image_size·256/224, bicubic) + CenterCrop (main_linprobe.py:230-234).
"""
from __future__ import annotations

import numpy as np

try:
    from PIL import Image
    HAVE_PIL = True
except ImportError:  # pragma: no cover
    HAVE_PIL = False

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# OpenCLIP towers ship their own normalization (main_linprobe.py:210-211
# pulls the transforms from open_clip; these are its constants)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
BICUBIC = 3  # PIL.Image.BICUBIC


def tf_random_resized_crop_params(
    rng: np.random.Generator, width: int, height: int,
    scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
):
    """BYOL/TF crop sampling: one draw, clamped — no retry loop
    (util/crop.py:16-35)."""
    area = height * width
    target_area = area * rng.uniform(scale[0], scale[1])
    log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
    aspect_ratio = np.exp(rng.uniform(log_ratio[0], log_ratio[1]))
    w = int(round(np.sqrt(target_area * aspect_ratio)))
    h = int(round(np.sqrt(target_area / aspect_ratio)))
    w = min(w, width)
    h = min(h, height)
    i = int(rng.integers(0, height - h + 1))
    j = int(rng.integers(0, width - w + 1))
    return i, j, h, w


def normalize(img: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD
              ) -> np.ndarray:
    """uint8 (H,W,3) -> float32 normalized (fused native pass when built)."""
    from ep_tpu_torch.data import _native
    return _native.normalize_u8(img, mean, std)


class TrainTransform:
    """RandomResizedCrop(TF-style) + hflip + normalize → float32 (S,S,3)."""

    def __init__(self, image_size: int = 224, scale=(0.08, 1.0),
                 ratio=(3.0 / 4.0, 4.0 / 3.0), color_jitter: float = 0.0,
                 hflip: bool = True, autoaugment: bool = False,
                 mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean, self.std = mean, std
        self.image_size = image_size
        self.scale = scale
        self.ratio = ratio
        self.color_jitter = color_jitter
        self.hflip = hflip
        self.autoaugment = autoaugment

    def __call__(self, img, rng: np.random.Generator) -> np.ndarray:
        from ep_tpu_torch.data import _native
        s = self.image_size
        if isinstance(img, np.ndarray) and _native.available():
            # native fast path: crop+bicubic resize fused, no PIL round trip
            h, w = img.shape[:2]
            i, j, hh, ww = tf_random_resized_crop_params(
                rng, w, h, self.scale, self.ratio)
            arr = _native.resize_bicubic_crop_u8(img, (i, j, hh, ww), s)
        else:
            if isinstance(img, np.ndarray):
                img = Image.fromarray(img)
            img = img.convert("RGB")
            w, h = img.size
            i, j, hh, ww = tf_random_resized_crop_params(
                rng, w, h, self.scale, self.ratio)
            img = img.resize((s, s), BICUBIC, box=(j, i, j + ww, i + hh))
            arr = np.asarray(img)
        if self.hflip and rng.random() < 0.5:
            arr = arr[:, ::-1]
        if self.color_jitter > 0:
            arr = _color_jitter(np.ascontiguousarray(arr), rng,
                                self.color_jitter)
        if self.autoaugment:
            from .autoaugment import autoaugment_imagenet
            arr = autoaugment_imagenet(np.ascontiguousarray(arr), rng)
        return normalize(arr, self.mean, self.std)


class ValTransform:
    """Resize(short side = image_size*256/224) + CenterCrop + normalize.

    ``resize_to`` overrides the pre-crop size (build_dataset_v2 uses the
    truncated ``int(input_size*16/14)``, util/datasets.py:38)."""

    def __init__(self, image_size: int = 224, mean=IMAGENET_MEAN,
                 std=IMAGENET_STD, resize_to: int = None):
        self.mean, self.std = mean, std
        self.image_size = image_size
        self.resize_to = (resize_to if resize_to is not None
                          else int(round(image_size * 256 / 224)))

    def __call__(self, img, rng=None) -> np.ndarray:
        if isinstance(img, np.ndarray):
            img = Image.fromarray(img)
        img = img.convert("RGB")
        w, h = img.size
        short = min(w, h)
        nw = int(round(w * self.resize_to / short))
        nh = int(round(h * self.resize_to / short))
        img = img.resize((nw, nh), BICUBIC)
        s = self.image_size
        left = (nw - s) // 2
        top = (nh - s) // 2
        img = img.crop((left, top, left + s, top + s))
        return normalize(np.asarray(img), self.mean, self.std)


def _color_jitter(arr: np.ndarray, rng: np.random.Generator,
                  strength: float) -> np.ndarray:
    """Brightness/contrast/saturation jitter by ±strength (aimv2 recipe,
    main_linprobe.py:224: ColorJitter(0.3))."""
    x = arr.astype(np.float32)
    b = rng.uniform(1 - strength, 1 + strength)
    x = x * b
    c = rng.uniform(1 - strength, 1 + strength)
    mean = x.mean()
    x = (x - mean) * c + mean
    s = rng.uniform(1 - strength, 1 + strength)
    gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
    x = (x - gray[..., None]) * s + gray[..., None]
    return np.clip(x, 0, 255).astype(np.uint8)


class DinoAugTransform:
    """DINO-style train augmentation (util/datasets.py:22-34):
    RandomResizedCrop(scale 0.4-1.0, bicubic) + hflip(0.5) +
    ColorJitter(0.4, 0.4, 0.2, 0.1) @ p=0.8 + grayscale @ p=0.2 +
    GaussianBlur(sigma 0.1-2.0) @ p=0.1 + solarize(128) @ p=0.2."""

    def __init__(self, image_size: int = 224, mean=IMAGENET_MEAN,
                 std=IMAGENET_STD):
        self.image_size = image_size
        self.mean, self.std = mean, std

    def __call__(self, img, rng: np.random.Generator) -> np.ndarray:
        if isinstance(img, np.ndarray):
            img = Image.fromarray(img)
        img = img.convert("RGB")
        s = self.image_size
        w, h = img.size
        i, j, hh, ww = tf_random_resized_crop_params(
            rng, w, h, scale=(0.4, 1.0))
        img = img.resize((s, s), BICUBIC, box=(j, i, j + ww, i + hh))
        if rng.random() < 0.1:
            from PIL import ImageFilter
            img = img.filter(ImageFilter.GaussianBlur(
                radius=rng.uniform(0.1, 2.0)))
        arr = np.asarray(img)
        if rng.random() < 0.5:
            arr = arr[:, ::-1]
        if rng.random() < 0.8:
            arr = _dino_color_jitter(np.ascontiguousarray(arr), rng)
        if rng.random() < 0.2:  # grayscale
            gray = (arr.astype(np.float32)
                    @ np.array([0.299, 0.587, 0.114], np.float32))
            arr = np.clip(gray, 0, 255).astype(np.uint8)[..., None].repeat(3, -1)
        if rng.random() < 0.2:  # solarize(threshold=128)
            arr = np.where(arr >= 128, 255 - arr, arr).astype(np.uint8)
        return normalize(np.ascontiguousarray(arr), self.mean, self.std)


def _dino_color_jitter(arr: np.ndarray, rng: np.random.Generator
                       ) -> np.ndarray:
    """ColorJitter(brightness=0.4, contrast=0.4, saturation=0.2, hue=0.1):
    torchvision applies the four ops in a random order with uniform factors."""
    ops = list(rng.permutation(4))
    x = arr.astype(np.float32)
    for op in ops:
        if op == 0:  # brightness
            x = np.clip(x * rng.uniform(0.6, 1.4), 0, 255)
        elif op == 1:  # contrast
            m = (x @ np.array([0.299, 0.587, 0.114], np.float32)).mean()
            x = np.clip((x - m) * rng.uniform(0.6, 1.4) + m, 0, 255)
        elif op == 2:  # saturation
            g = x @ np.array([0.299, 0.587, 0.114], np.float32)
            x = np.clip((x - g[..., None]) * rng.uniform(0.8, 1.2)
                        + g[..., None], 0, 255)
        else:  # hue shift in HSV space
            shift = rng.uniform(-0.1, 0.1)
            hsv = np.asarray(Image.fromarray(
                x.astype(np.uint8)).convert("HSV")).copy()
            hsv[..., 0] = (hsv[..., 0].astype(np.int16)
                           + int(shift * 255)) % 256
            x = np.asarray(Image.fromarray(hsv, "HSV").convert("RGB")
                           ).astype(np.float32)
    return x.astype(np.uint8)


class PlainCifarTransform:
    """build_dataset_v2's cifar branch (util/datasets.py:48): no resize/crop,
    ToTensor + Normalize(0.5, 0.5)."""

    def __init__(self):
        self.mean = np.array([0.5, 0.5, 0.5], np.float32)
        self.std = np.array([0.5, 0.5, 0.5], np.float32)

    def __call__(self, img, rng=None) -> np.ndarray:
        if not isinstance(img, np.ndarray):
            img = np.asarray(img.convert("RGB"))
        return normalize(np.ascontiguousarray(img), self.mean, self.std)


def build_transforms_v2(image_size: int, dataset_name: str = "",
                        dino_aug: bool = False):
    """The DINO-style builder used by the attention-stats driver
    (util/datasets.py:13-63 ``build_dataset_v2``): train = RRC(0.2-1.0) or
    the DINO aug stack; val = Resize(int(size*16/14)) + CenterCrop; cifar
    datasets bypass both for plain Normalize(0.5, 0.5)."""
    if "cifar" in dataset_name:
        assert image_size == 32, image_size
        t = PlainCifarTransform()
        return t, t
    train = (DinoAugTransform(image_size) if dino_aug
             else TrainTransform(image_size, scale=(0.2, 1.0)))
    val = ValTransform(image_size, resize_to=int(image_size * 16 / 14))
    return train, val


def build_transforms(cfg):
    """Train/val transform pair from a TrainConfig (main_linprobe.py:210-237).
    OpenCLIP towers use CLIP's own normalization constants (:210-211)."""
    mean, std = ((CLIP_MEAN, CLIP_STD) if getattr(cfg, "openclip", False)
                 else (IMAGENET_MEAN, IMAGENET_STD))
    if cfg.train_aug == "aimv2":
        train = TrainTransform(cfg.image_size, scale=(0.08, 1.0),
                               ratio=(0.75, 1.33), color_jitter=0.3,
                               autoaugment=True, mean=mean, std=std)
    else:
        train = TrainTransform(cfg.image_size, mean=mean, std=std)
    val = ValTransform(cfg.image_size, mean=mean, std=std)
    if cfg.knn_eval:  # kNN mode evaluates train images deterministically
        train = val
    return train, val
