"""AutoAugment, IMAGENET policy — PIL-backed, torchvision-free.

The reference's aimv2 training recipe appends
``AutoAugment(policy=IMAGENET)`` after ColorJitter (main_linprobe.py:220-228,
noted as equivalent to timm 'rand-m9-mstd0.5-inc1'). This is the standard
25-sub-policy ImageNet AutoAugment search result (Cubuk et al., 2019), each
sub-policy = two (op, probability, magnitude) steps.
"""
from __future__ import annotations

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

# (op, prob, magnitude-bin 0..9) pairs; magnitudes resolved per-op below
IMAGENET_POLICY = [
    (("Posterize", 0.4, 8), ("Rotate", 0.6, 9)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, None)),
    (("Equalize", 0.8, None), ("Equalize", 0.6, None)),
    (("Posterize", 0.6, 7), ("Posterize", 0.6, 6)),
    (("Equalize", 0.4, None), ("Solarize", 0.2, 4)),
    (("Equalize", 0.4, None), ("Rotate", 0.8, 8)),
    (("Solarize", 0.6, 3), ("Equalize", 0.6, None)),
    (("Posterize", 0.8, 5), ("Equalize", 1.0, None)),
    (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
    (("Equalize", 0.6, None), ("Posterize", 0.4, 6)),
    (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
    (("Rotate", 0.4, 9), ("Equalize", 0.6, None)),
    (("Equalize", 0.0, None), ("Equalize", 0.8, None)),
    (("Invert", 0.6, None), ("Equalize", 1.0, None)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Rotate", 0.8, 8), ("Color", 1.0, 2)),
    (("Color", 0.8, 8), ("Solarize", 0.8, 7)),
    (("Sharpness", 0.4, 7), ("Invert", 0.6, None)),
    (("ShearX", 0.6, 5), ("Equalize", 1.0, None)),
    (("Color", 0.4, 0), ("Equalize", 0.6, None)),
    (("Equalize", 0.4, None), ("Solarize", 0.2, 4)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, None)),
    (("Invert", 0.6, None), ("Equalize", 1.0, None)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Equalize", 0.8, None), ("Equalize", 0.6, None)),
]


def _mag(op: str, bin_: int, sign: float):
    if op in ("ShearX", "ShearY"):
        return sign * np.linspace(0, 0.3, 10)[bin_]
    if op in ("TranslateX", "TranslateY"):
        return sign * np.linspace(0, 150 / 331, 10)[bin_]
    if op == "Rotate":
        return sign * np.linspace(0, 30, 10)[bin_]
    if op in ("Color", "Contrast", "Brightness", "Sharpness"):
        return 1.0 + sign * np.linspace(0, 0.9, 10)[bin_]
    if op == "Posterize":
        return 8 - int(np.round(np.linspace(0, 4, 10)[bin_]))
    if op == "Solarize":
        return int(np.round(np.linspace(255, 0, 10))[bin_])
    return None


def _apply_op(img: Image.Image, op: str, mag) -> Image.Image:
    if op == "ShearX":
        return img.transform(img.size, Image.AFFINE, (1, mag, 0, 0, 1, 0),
                             Image.BILINEAR)
    if op == "ShearY":
        return img.transform(img.size, Image.AFFINE, (1, 0, 0, mag, 1, 0),
                             Image.BILINEAR)
    if op == "TranslateX":
        return img.transform(img.size, Image.AFFINE,
                             (1, 0, mag * img.size[0], 0, 1, 0),
                             Image.BILINEAR)
    if op == "TranslateY":
        return img.transform(img.size, Image.AFFINE,
                             (1, 0, 0, 0, 1, mag * img.size[1]),
                             Image.BILINEAR)
    if op == "Rotate":
        return img.rotate(mag)
    if op == "Color":
        return ImageEnhance.Color(img).enhance(mag)
    if op == "Contrast":
        return ImageEnhance.Contrast(img).enhance(mag)
    if op == "Brightness":
        return ImageEnhance.Brightness(img).enhance(mag)
    if op == "Sharpness":
        return ImageEnhance.Sharpness(img).enhance(mag)
    if op == "Posterize":
        return ImageOps.posterize(img, int(mag))
    if op == "Solarize":
        return ImageOps.solarize(img, int(mag))
    if op == "AutoContrast":
        return ImageOps.autocontrast(img)
    if op == "Equalize":
        return ImageOps.equalize(img)
    if op == "Invert":
        return ImageOps.invert(img)
    raise ValueError(op)


def autoaugment_imagenet(arr: np.ndarray, rng: np.random.Generator
                         ) -> np.ndarray:
    """Apply one random IMAGENET sub-policy to a (H, W, 3) uint8 array."""
    img = Image.fromarray(arr)
    sub = IMAGENET_POLICY[int(rng.integers(len(IMAGENET_POLICY)))]
    for op, prob, bin_ in sub:
        if rng.random() < prob:
            sign = -1.0 if rng.random() < 0.5 else 1.0
            mag = _mag(op, bin_, sign) if bin_ is not None else None
            img = _apply_op(img, op, mag)
    return np.asarray(img)
