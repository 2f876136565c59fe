"""Device-side augmentation (``--device_aug``): ship u8 staged batches and
run RandomResizedCrop + hflip + normalize on the card, inside the train step.

Counterpart of ``ep_tpu/data/device_aug.py``. The host does only decode plus
ONE deterministic staging resize (epoch-invariant, cacheable by
:class:`StagedImageCache`) and ships uint8; the random crop, resize, flip and
normalize run on the device as part of the step. The host half (the staging
transforms, the staged-image cache, ``build_staging_transforms``) is the JAX
package's text with its imports renamed; the device half is plain torch on
tensors, as the JAX package leaves it to XLA (no Pallas kernel there, so no
hand-written kernel here).

Device half:
  * the crop-resample is two batched interpolation-matrix products
    (separable bicubic, PIL-style support scaling when minifying):
    (B,out,S)@(B,S,S*3), then the transposed x-pass, about 84 GFLOP at batch
    512, S=256, out=224. The operands are bf16 values (u8 pixels are exact in
    bf16, the weights are rounded to it) and the sums f32, as the JAX
    package's ``preferred_element_type=float32``: the products run on the
    bf16 values widened to f32, where each product of two bf16 values is
    exact, so the result is that of a bf16 product with f32 accumulation. The
    y-pass is rounded to bf16 (as there); the x-pass stays f32 (a bf16 output
    would round values near 255 by steps of 1.0).
  * Randomness: JAX keys it by fold_in(key(seed), step); torch cannot
    reproduce those bits. Here a CPU ``torch.Generator`` is seeded with
    :func:`step_seed` (seed, step), a function of the run's seed and the global
    step and nothing else, and draws, in this order, four (B,) f32 uniform
    rows (area, log aspect ratio, top, left) and one (B,) uniform row for the
    flips (flip where < 0.5). The crop boxes and flips are computed on the CPU
    and moved to the images' device, so the same step draws the same boxes on
    the CPU and on the card, and a resumed run (which carries the global step)
    draws those of the run it resumes. The sampler mirrors
    ``transforms.tf_random_resized_crop_params`` (the distribution is held to
    the host sampler's in ``tests/test_torch_device_aug.py``).
  * Several ranks (``DeviceAug.shards`` > 1, the registered mesh's data
    axis): each rank draws the boxes and flips of the whole global batch
    (``shards`` times its own rows) and keeps the columns of its rows, rank
    order, so the ranks crop their rows as one process would crop the
    global batch, never with one another's draws, and a resume draws them
    again.

Known protocol difference (of both packages): the random crop samples over
the SQUARE staged image (stage x stage) rather than the original rectangle.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Sequence, Tuple

import numpy as np
import torch

from ep_tpu_torch.ops.attention import mm_f32
from ep_tpu_torch.parallel.mesh import DATA_AXIS, current_mesh
from .transforms import (CLIP_MEAN, CLIP_STD, IMAGENET_MEAN, IMAGENET_STD,
                         ValTransform)

# ---------------------------------------------------------------------------
# host-side staging transforms (deterministic, u8 out)
# ---------------------------------------------------------------------------

class StageTrainTransform:
    """Decode → bicubic resize to (stage, stage) → uint8.

    The only per-image host work left in --device_aug train mode. Epoch-
    invariant, so a staged-image cache (loader-level) makes epochs ≥2
    decode-free."""

    def __init__(self, stage_size: int):
        self.stage_size = stage_size

    def __call__(self, img, rng=None) -> np.ndarray:
        s = self.stage_size
        from ep_tpu_torch.data import _native
        if isinstance(img, np.ndarray) and _native.available():
            h, w = img.shape[:2]
            return _native.resize_bicubic_crop_u8(img, (0, 0, h, w), s)
        from PIL import Image
        if isinstance(img, np.ndarray):
            img = Image.fromarray(img)
        img = img.convert("RGB")
        return np.asarray(img.resize((s, s), 3))  # 3 = PIL BICUBIC


class StageValTransform(ValTransform):
    """The reference val transform minus normalization: short-side resize +
    center crop, uint8 out. The device normalizes (normalize_u8_batch)."""

    def __call__(self, img, rng=None) -> np.ndarray:
        from PIL import Image
        if isinstance(img, np.ndarray):
            img = Image.fromarray(img)
        img = img.convert("RGB")
        w, h = img.size
        short = min(w, h)
        nw = int(round(w * self.resize_to / short))
        nh = int(round(h * self.resize_to / short))
        img = img.resize((nw, nh), 3)
        s = self.image_size
        left = (nw - s) // 2
        top = (nh - s) // 2
        return np.asarray(img.crop((left, top, left + s, top + s)))


class IdentityTransform:
    """Loader-facing no-op for datasets that already serve staged u8."""

    def __call__(self, img, rng=None) -> np.ndarray:
        return img


class StagedImageCache:
    """Dataset wrapper that stages each image ONCE and serves u8 from a
    memmap afterwards.

    Staging (decode + one deterministic resize) costs MORE per image than
    the host RRC (which crops a small window before resizing) — measured
    268 vs 375 img/s/core on 500×400 frames — so --device_aug only wins
    end-to-end because staging is epoch-invariant: epoch 1 fills this
    cache, every later epoch reads ~150 kB/image off the page cache
    instead of re-running decode+resize+augment. Labels are cached
    alongside so repeat epochs never touch the underlying dataset.

    Thread-safe by idempotence: concurrent loader workers may stage the
    same index twice, writing identical bytes; the done flag flips last.
    """

    def __init__(self, dataset, transform, cache_dir: str, split: str):
        import os
        self.dataset = dataset
        self.transform = transform
        n = len(dataset)
        probe = np.asarray(transform(dataset[0][0]))
        assert probe.dtype == np.uint8, probe.dtype
        self.shape = probe.shape
        os.makedirs(cache_dir, exist_ok=True)
        tag = f"{split}_{n}x{'x'.join(map(str, probe.shape))}"
        def mm(name, dtype, shape):
            path = f"{cache_dir}/{name}_{tag}.npy"
            mode = "r+" if os.path.exists(path) else "w+"
            return np.lib.format.open_memmap(path, mode=mode, dtype=dtype,
                                             shape=shape)
        self._imgs = mm("staged", np.uint8, (n,) + probe.shape)
        self._labels = mm("labels", np.int64, (n,))
        self._done = mm("done", np.uint8, (n,))

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, i: int):
        if not self._done[i]:
            img, label = self.dataset[i]
            self._imgs[i] = self.transform(img)
            self._labels[i] = label
            self._done[i] = 1
        return np.array(self._imgs[i]), int(self._labels[i])

    def __repr__(self):
        return (f"StagedImageCache({self.dataset!r}, staged "
                f"{int(self._done.sum())}/{len(self)})")


# ---------------------------------------------------------------------------
# device-side pieces (plain torch on the images' device)
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def step_seed(seed: int, step: int) -> int:
    """The seed of a step's generator: splitmix64 of ``seed * 2**32 + step``
    (both taken modulo 2**64), its top bit cleared.

        z = seed * 2**32 + step + 0x9E3779B97F4A7C15
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9
        z = (z ^ (z >> 27)) * 0x94D049BB133111EB
        seed' = (z ^ (z >> 31)) & (2**63 - 1)

    all modulo 2**64. Neighbouring steps and seeds get unrelated streams."""
    z = ((seed << 32) + step + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of a step's draws."""
    return torch.Generator().manual_seed(step_seed(seed, step))


def _cubic(x: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    """PIL's bicubic filter (a = -0.5, support 2)."""
    ax = x.abs()
    inner = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
    outer = (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a
    return torch.where(ax < 1.0, inner,
                       torch.where(ax < 2.0, outer, torch.zeros_like(ax)))


def _resample_taps(start: torch.Tensor, length: torch.Tensor, src: int,
                   out: int):
    """The nonzero band of :func:`resample_weights`: for each image and
    output pixel, the source pixels its filter can reach, as (index, weight)
    pairs (B, out, taps) f32. The bicubic support is 2 * max(scale, 1) on
    either side of the output's center, so ``taps`` = floor(4 * max(src /
    out, 1)) + 2 source pixels cover it for any span within the source;
    taps outside the source or the support weigh 0. Each weight is the
    dense matrix's (the same f32 arithmetic on the same source center), and
    rows renormalize over the taps, the dense rows' only nonzeros."""
    dev = start.device
    scale = length[:, None] / out  # (B, 1)
    fscale = torch.clamp(scale, min=1.0)
    centers = start[:, None] + (torch.arange(out, dtype=torch.float32,
                                             device=dev)[None, :]
                                + 0.5) * scale  # (B, out)
    taps = int(math.floor(4.0 * max(src / out, 1.0))) + 2
    first = torch.floor(centers - 2.0 * fscale - 0.5)  # (B, out)
    idx = first[:, :, None] + torch.arange(taps, dtype=torch.float32,
                                           device=dev)  # (B, out, taps)
    t = (idx + 0.5 - centers[:, :, None]) / fscale[:, :, None]
    w = torch.where((idx >= 0) & (idx < src), _cubic(t), torch.zeros_like(t))
    return idx, w / w.sum(dim=-1, keepdim=True)


def _dense(idx: torch.Tensor, w: torch.Tensor, src: int) -> torch.Tensor:
    """(B, out, src) matrix of the taps, zero elsewhere; the taps outside the
    source (weight 0) land on its edge and add nothing."""
    B, out, _ = w.shape
    dense = torch.zeros(B, out, src, dtype=w.dtype, device=w.device)
    return dense.scatter_add_(2, idx.clamp(0, src - 1).long(), w)


def resample_weights(start: torch.Tensor, length: torch.Tensor, src: int,
                     out: int) -> torch.Tensor:
    """Per-image (out, src) bicubic interpolation matrix for resampling the
    half-open source span [start, start+length) onto `out` pixels.

    PIL semantics: filter support scales with the minification factor;
    rows renormalize over in-bounds source pixels. Built from the band of
    :func:`_resample_taps`, the only nonzeros of each row.

    start/length: (B,) float32. Returns (B, out, src) float32 on their
    device."""
    return _dense(*_resample_taps(start, length, src, out), src)


def sample_crop_params(generator: torch.Generator, batch: int, stage: int,
                       scale: Tuple[float, float],
                       ratio: Tuple[float, float]):
    """Mirror of transforms.tf_random_resized_crop_params (BYOL/TF sampling:
    one draw, clamped, no retry loop), vectorized over the batch and drawn
    from ``generator`` (four (B,) uniform rows). Returns i, j, h, w as (B,)
    float32 CPU tensors (whole numbers)."""
    u = torch.rand((4, batch), generator=generator, dtype=torch.float32)
    area = stage * stage * (u[0] * (scale[1] - scale[0]) + scale[0])
    log_r = (math.log(ratio[0]), math.log(ratio[1]))
    ar = torch.exp(u[1] * (log_r[1] - log_r[0]) + log_r[0])
    w = torch.clamp(torch.round(torch.sqrt(area * ar)), 1.0, float(stage))
    h = torch.clamp(torch.round(torch.sqrt(area / ar)), 1.0, float(stage))
    # integers uniform over [0, stage - h] inclusive, like rng.integers
    i = torch.floor(u[2] * (stage - h + 1.0))
    j = torch.floor(u[3] * (stage - w + 1.0))
    return i, j, h, w


def sample_flips(generator: torch.Generator, batch: int) -> torch.Tensor:
    """(B,) bool CPU tensor: flip each image with probability 0.5."""
    return torch.rand(batch, generator=generator, dtype=torch.float32) < 0.5


def resample_crop(images_u8: torch.Tensor, i, j, h, w, out: int,
                  flip=None) -> torch.Tensor:
    """Batched separable bicubic crop-resize: (B,H,W,3) u8 + per-image
    boxes -> (B,out,out,3) float32 in [0,255]. bf16 operands, f32 sums; the
    y-pass is rounded to bf16, the x-pass stays f32. The source may be
    rectangular. ``flip`` ((B,) bool, or None) mirrors the flagged outputs
    horizontally, by reversing the rows of their x-pass weights: each output
    column is the same sum as in the unflipped crop, written mirrored.

    The result is a (B,out,out,3) view of the x-pass's (B,out_x,out_y,3)
    product, which the caller's first elementwise pass lays out."""
    B, H_src, W_src, C = images_u8.shape
    iy, wy = _resample_taps(i, h, H_src, out)
    ix, wx = _resample_taps(j, w, W_src, out)
    if flip is not None:
        f = flip[:, None, None]
        ix, wx = torch.where(f, ix.flip(1), ix), torch.where(f, wx.flip(1), wx)
    wy = _dense(iy, wy.to(torch.bfloat16), H_src)
    wx = _dense(ix, wx.to(torch.bfloat16), W_src)
    x = images_u8.to(torch.bfloat16).reshape(B, H_src, W_src * C)
    # y-pass: contract source rows -> (B, out, W, C), rounded to bf16
    y = mm_f32(wy, x).to(torch.bfloat16).reshape(B, out, W_src, C)
    # x-pass: contract source cols -> (B, out, out, C)
    y = y.permute(0, 2, 1, 3).reshape(B, W_src, out * C)  # (B, W, out*C)
    x = mm_f32(wx, y).reshape(B, out, out, C)  # (B, out_x, out_y, C)
    return x.permute(0, 2, 1, 3)


def _norm_affine(mean: Sequence[float], std: Sequence[float], device):
    """(scale, bias) f32 (3,) tensors on ``device``, made once per
    (mean, std, device): a copy to the card each call would wait for it."""
    return _norm_affine_on(tuple(np.asarray(mean, np.float32).tolist()),
                           tuple(np.asarray(std, np.float32).tolist()),
                           torch.device(device))


@functools.lru_cache(maxsize=None)
def _norm_affine_on(mean: Tuple[float, ...], std: Tuple[float, ...],
                    device: torch.device):
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    scale = (1.0 / (255.0 * std)).astype(np.float32)
    bias = (-mean / std).astype(np.float32)
    return (torch.from_numpy(scale).to(device),
            torch.from_numpy(bias).to(device))


def normalize_u8_batch(images_u8: torch.Tensor, mean, std,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """u8 (B,H,W,3) -> normalized compute-dtype batch: x/255 sub-mean
    div-std as one scale and one bias (the device half of the val
    transform; the eval/extract steps call this on u8 inputs). Rounds after
    the product and after the sum, where XLA on the CPU contracts the two
    into one fused multiply-add."""
    scale, bias = _norm_affine(mean, std, images_u8.device)
    return (images_u8.float() * scale + bias).to(dtype)


def crop_flip_normalize(images_u8: torch.Tensor, i, j, h, w, flip, out: int,
                        mean, std, dtype=torch.bfloat16) -> torch.Tensor:
    """The device-side train transform on given boxes and flips (``flip``
    None: no flips): resample, flip, clip to [0, 255], normalize."""
    x = resample_crop(images_u8, i, j, h, w, out, flip)  # f32 0..255
    nscale, nbias = _norm_affine(mean, std, images_u8.device)
    # resampling can slightly over/undershoot [0,255] (bicubic lobes);
    # PIL clamps to u8 - match it before normalizing. The clamp writes the
    # (B,out,out,3) layout; the product and the sum round as x*scale + bias
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    torch.clamp(x, 0.0, 255.0, out=y)
    return y.mul_(nscale).add_(nbias).to(dtype)


def augment_train_batch(generator: torch.Generator, images_u8: torch.Tensor,
                        out: int, scale: Tuple[float, float],
                        ratio: Tuple[float, float], mean, std,
                        dtype=torch.bfloat16, hflip: bool = True,
                        shards: int = 1, shard: int = 0) -> torch.Tensor:
    """The full device-side train transform: RandomResizedCrop(TF-style)
    + hflip(0.5) + normalize. images_u8: (B, stage, stage, 3). The boxes,
    then the flips, are drawn from ``generator`` on the CPU and moved to the
    images' device in one copy (pinned and not blocking on a card). With
    ``shards`` > 1 the images are rows ``shard * B`` to ``(shard + 1) * B``
    of a global batch of ``shards * B``: the draws are the global batch's,
    and these rows' are kept."""
    B, S = images_u8.shape[0], images_u8.shape[1]
    G = B * shards
    draws = torch.stack(sample_crop_params(generator, G, S, scale, ratio)
                        + ((sample_flips(generator, G).float(),)
                           if hflip else ()))
    if shards > 1:
        draws = draws[:, shard * B:(shard + 1) * B].contiguous()
    if images_u8.is_cuda:
        draws = draws.pin_memory().to(images_u8.device, non_blocking=True)
    i, j, h, w = draws[:4]
    flip = draws[4] > 0 if hflip else None
    return crop_flip_normalize(images_u8, i, j, h, w, flip, out, mean, std,
                               dtype)


# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceAug:
    """Everything the steps need to augment on device. Built once from the
    TrainConfig and the registered mesh (from_cfg); passed to
    make_train_step / make_eval_step / make_extract_step."""

    out_size: int
    stage_size: int
    scale: Tuple[float, float] = (0.08, 1.0)
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    mean: Tuple[float, ...] = tuple(IMAGENET_MEAN.tolist())
    std: Tuple[float, ...] = tuple(IMAGENET_STD.tolist())
    seed: int = 0
    hflip: bool = True
    dtype: Any = torch.bfloat16
    shards: int = 1  # ranks on the data axis: the global batch is shards x B
    shard: int = 0  # this rank's place on it

    @staticmethod
    def stage_for(image_size: int, override: int = 0) -> int:
        return override if override else int(round(image_size * 256 / 224))

    @classmethod
    def from_cfg(cls, cfg) -> "DeviceAug":
        mean, std = ((CLIP_MEAN, CLIP_STD) if getattr(cfg, "openclip", False)
                     else (IMAGENET_MEAN, IMAGENET_STD))
        dtype = torch.bfloat16 if cfg.amp in ("bfloat16", "float16") \
            else torch.float32
        mesh = current_mesh()
        return cls(out_size=cfg.image_size,
                   stage_size=cls.stage_for(
                       cfg.image_size, getattr(cfg, "device_aug_stage", 0)),
                   mean=tuple(np.asarray(mean).tolist()),
                   std=tuple(np.asarray(std).tolist()),
                   seed=cfg.seed, dtype=dtype,
                   shards=mesh.shape[DATA_AXIS] if mesh else 1,
                   shard=mesh.data_index if mesh else 0)

    def train_fn(self, step: int, images: torch.Tensor) -> torch.Tensor:
        """Augment a u8 staged batch; the global ``step`` seeds the draws
        (:func:`step_seed`), so the schedule is resume-deterministic; this
        rank keeps its rows' draws of the global batch."""
        return augment_train_batch(step_generator(self.seed, int(step)),
                                   images, self.out_size, self.scale,
                                   self.ratio, self.mean, self.std,
                                   self.dtype, self.hflip, self.shards,
                                   self.shard)

    def eval_fn(self, images: torch.Tensor) -> torch.Tensor:
        return normalize_u8_batch(images, self.mean, self.std, self.dtype)


def build_staging_transforms(cfg):
    """--device_aug replacement for transforms.build_transforms: both
    splits yield uint8; randomness moves into the jitted step."""
    stage = DeviceAug.stage_for(cfg.image_size,
                                getattr(cfg, "device_aug_stage", 0))
    train = StageTrainTransform(stage)
    val = StageValTransform(cfg.image_size)
    if cfg.knn_eval:  # kNN evaluates train images deterministically
        train = val
    return train, val
