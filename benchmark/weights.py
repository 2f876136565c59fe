"""Weights and batches drawn from ``--seed`` on the device.

Both come from generators on the device, one call a tensor, in the type
they are served in: a frozen encoder's weights in bfloat16 (the driver
stores a probed encoder so), trained weights in float32, images in
bfloat16 NHWC as the driver's loader hands them to the step. The same seed
gives the same tensors, so the reference is handed what the program was.
"""
from __future__ import annotations

import torch

from .manifest import reference

POOL_BATCHES = 4  # more than the checked steps, so that those all differ


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def draw_weights(cfg: dict, image_size: int, seed: int, device,
                 frozen_encoder: bool) -> dict:
    """name -> tensor in the layout of the configuration's reference, drawn
    from ``seed`` by the configuration's ``init``: [mean, std] of a normal
    draw, std null for 1/sqrt(fan_in)."""
    ref = reference(cfg)
    d = ref.dims(cfg, image_size)
    g = _generator(device, 2 * seed)
    out = {}
    for name, shape in ref.layout(d).items():
        mean, std = cfg["init"][name]
        if std is None:
            std = ref.fan_in(name, shape, d) ** -0.5
        dt = (torch.bfloat16 if frozen_encoder and name in ref.ENCODER_KEYS
              else torch.float32)
        t = torch.randn(shape, generator=g, device=device, dtype=dt)
        t.mul_(std).add_(mean)
        out[name] = t
    return out


def draw_batches(cfg: dict, traffic: dict, seed: int, device):
    """(images (P, B, S, S, 3) bf16, labels (P, B) int64): the pool of
    ``POOL_BATCHES`` batches that the window cycles through."""
    g = _generator(device, 2 * seed + 1)
    P, B, S = POOL_BATCHES, traffic["batch"], traffic["image_size"]
    images = torch.randn((P, B, S, S, 3), generator=g, device=device,
                         dtype=torch.bfloat16)
    labels = torch.randint(0, cfg["num_classes"], (P, B), generator=g,
                           device=device)
    return images, labels

