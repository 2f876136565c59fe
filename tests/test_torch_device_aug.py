"""The port's device-side augmentation (``ep_tpu_torch/data/device_aug.py``,
``--device_aug``) against the JAX package's, on the CPU.

* The crop sampler's moments against the host TF/BYOL sampler
  (``transforms.tf_random_resized_crop_params``) at the bounds of
  ``tests/test_device_aug.py::test_crop_param_distribution_matches_host``.
* ``resample_weights``, ``resample_crop`` and the whole train transform
  against JAX's on the same boxes and flips. Both sum f32 products of bf16
  values, in another order: the weights within 2.5e-7 of each (one f32
  rounding of the row sum and one of the division), the crop
  (values 0-255) within 1e-4 (measured 1.5e-5; the y-pass rounds to bf16 in
  both, and no element crossed a rounding boundary), the normalized batch
  within 1e-5 in f32 (measured 4.8e-7) and equal in bf16.
* ``normalize_u8_batch`` within 2 ulp of JAX's (XLA on the CPU may contract
  ``x*scale + bias`` into one fused multiply-add; the port rounds twice), and
  staged val + normalize equals the host ``ValTransform``.
* ``DeviceAug.train_fn`` is a function of (seed, step): the same step draws
  the same batch, another step another.
* The host half is the JAX text with its imports renamed, and
  ``StagedImageCache`` serves repeat reads from its memmap.
* The driver: ``--device_aug --eval`` and ``--device_aug --knn_eval`` from one
  checkpoint print what the JAX driver prints; ``--device_aug`` with
  ``--device_aug_cache`` learns ``fake`` past 40%, as
  ``test_device_aug_e2e_learns`` requires of the JAX driver.
"""
import ast
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import ep_tpu.cli.linprobe as jax_linprobe
from ep_tpu.data import device_aug as ja
from ep_tpu.data.transforms import tf_random_resized_crop_params
from ep_tpu_torch.data import device_aug as da
from ep_tpu_torch.data.transforms import (IMAGENET_MEAN, IMAGENET_STD,
                                          ValTransform)
import ep_tpu_torch.cli.linprobe as linprobe

from test_torch_checkpoint import write_timm_checkpoint
from test_torch_driver import (_cfg, _jax_checkpoint_to_port, _p,
                               tiny)  # noqa: F401  (tiny is a fixture)

ROOT = Path(__file__).resolve().parent.parent
SCALE, RATIO = (0.08, 1.0), (3.0 / 4.0, 4.0 / 3.0)
# the boxes (i, j, h, w) of test_resample_matches_pil_bicubic
BOXES = [(0, 0, 64, 64), (8, 12, 40, 32), (0, 0, 12, 12), (30, 0, 34, 64)]


def _images(n=4, size=64, seed=42):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, size, size, 3), np.uint8)


def _box_arrays():
    return [np.array([b[k] for b in BOXES], np.float32) for k in range(4)]


# ---- the sampler ------------------------------------------------------------

def test_crop_param_distribution_matches_host():
    stage, n = 64, 8192
    dev = np.stack([t.numpy() for t in da.sample_crop_params(
        da.step_generator(0, 0), n, stage, SCALE, RATIO)]).astype(np.float64)
    rng = np.random.default_rng(0)
    host = np.array([tf_random_resized_crop_params(rng, stage, stage, SCALE,
                                                   RATIO)
                     for _ in range(n)], np.float64).T  # rows: i, j, h, w
    assert np.all(dev == np.round(dev))
    assert dev[2].min() >= 1 and dev[2].max() <= stage
    assert np.all(dev[0] + dev[2] <= stage) and np.all(dev[1] + dev[3] <= stage)
    assert dev[0].min() >= 0 and dev[1].min() >= 0
    for d_row, h_row in zip(dev, host):
        assert abs(d_row.mean() - h_row.mean()) < 0.03 * stage, \
            (d_row.mean(), h_row.mean())
        assert abs(d_row.std() - h_row.std()) < 0.05 * stage, \
            (d_row.std(), h_row.std())
    a_dev = (dev[2] * dev[3]).mean() / stage ** 2
    a_host = (host[2] * host[3]).mean() / stage ** 2
    assert abs(a_dev - a_host) < 0.03, (a_dev, a_host)
    flips = da.sample_flips(da.step_generator(0, 1), n).numpy()
    assert abs(flips.mean() - 0.5) < 0.03


# ---- the resample against JAX -----------------------------------------------

@pytest.mark.parametrize("axis", ["rows", "cols"])
@pytest.mark.parametrize("src, out", [(64, 24), (256, 224), (37, 32),
                                      (16, 48)])
def test_resample_weights_match_jax(axis, src, out):
    """The four boxes at 64 -> 24 px, and 64 boxes of the sampler at the
    train path's 256 -> 224, at 37 -> 32 and magnified 16 -> 48: the band of
    taps the port builds the matrix from covers every nonzero of JAX's."""
    if (src, out) == (64, 24):
        i, j, h, w = _box_arrays()
    else:
        i, j, h, w = (t.numpy() for t in da.sample_crop_params(
            da.step_generator(src, out), 64, src, SCALE, RATIO))
    start, length = (i, h) if axis == "rows" else (j, w)
    ref = np.asarray(ja.resample_weights(jnp.asarray(start),
                                         jnp.asarray(length), src, out))
    got = da.resample_weights(torch.from_numpy(start),
                              torch.from_numpy(length), src, out)
    assert got.dtype == torch.float32 and got.shape == (len(start), out, src)
    # the same f32 weight over a row sum taken in another order: one
    # rounding of the sum and one of the division apart
    np.testing.assert_allclose(got.numpy(), ref, rtol=2.5e-7, atol=0)
    assert np.array_equal(got.numpy() != 0, ref != 0)


def test_resample_crop_matches_jax_and_stays_f32():
    imgs = np.concatenate([_images(1)] * 4)
    boxes = _box_arrays()
    ref = np.asarray(ja.resample_crop(jnp.asarray(imgs),
                                      *map(jnp.asarray, boxes), 24))
    got = da.resample_crop(torch.from_numpy(imgs),
                           *map(torch.from_numpy, boxes), 24)
    assert got.dtype == torch.float32 and got.shape == (4, 24, 24, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    # the x-pass is not rounded to bf16: near 255 bf16's step is 1.0, and
    # the crop keeps values between those steps
    near = got[(got > 128) & (got < 255)]
    assert near.numel() > 100
    assert not torch.equal(near, near.to(torch.bfloat16).float())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_transform_matches_jax_on_the_same_draws(dtype):
    """JAX's augment_train_batch from a key against the port's transform on
    the boxes and flips that key draws."""
    imgs = _images(4, 64, seed=5)
    key = jax.random.key(7)
    ref = ja.augment_train_batch(key, jnp.asarray(imgs), 24, SCALE, RATIO,
                                 IMAGENET_MEAN, IMAGENET_STD,
                                 getattr(jnp, dtype))
    k_crop, k_flip = jax.random.split(key)
    boxes = [np.asarray(b) for b in ja.sample_crop_params(
        k_crop, 4, 64, SCALE, RATIO)]
    flip = np.asarray(jax.random.bernoulli(k_flip, 0.5, (4,)))
    got = da.crop_flip_normalize(
        torch.from_numpy(imgs), *(torch.from_numpy(b.copy()) for b in boxes),
        torch.from_numpy(flip.copy()), 24, IMAGENET_MEAN, IMAGENET_STD,
        getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (4, 24, 24, 3)
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.float().numpy(), ref)


def test_normalize_matches_jax_within_two_ulp():
    imgs = _images(2, 16, seed=3)
    ref = np.asarray(ja.normalize_u8_batch(jnp.asarray(imgs), IMAGENET_MEAN,
                                           IMAGENET_STD, jnp.float32))
    got = da.normalize_u8_batch(torch.from_numpy(imgs), IMAGENET_MEAN,
                                IMAGENET_STD, torch.float32).numpy()
    assert np.all(np.abs(got - ref) <= 2 * np.spacing(np.abs(ref)))
    bf = da.normalize_u8_batch(torch.from_numpy(imgs), IMAGENET_MEAN,
                               IMAGENET_STD)
    assert bf.dtype == torch.bfloat16


def test_val_staging_plus_device_normalize_is_exact():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (50, 70, 3), np.uint8)
    host = ValTransform(image_size=32)(img)
    staged = da.StageValTransform(image_size=32)(img)
    assert staged.dtype == np.uint8 and staged.shape == (32, 32, 3)
    dev = da.normalize_u8_batch(torch.from_numpy(staged[None]), IMAGENET_MEAN,
                                IMAGENET_STD, dtype=torch.float32)[0]
    np.testing.assert_allclose(dev.numpy(), host, atol=2e-6)


# ---- the draws are a function of (seed, step) --------------------------------

def test_train_fn_is_deterministic_in_the_step():
    imgs = torch.from_numpy(_images(4, 37, seed=0))
    aug = da.DeviceAug(out_size=32, stage_size=37, seed=3,
                       dtype=torch.float32)
    a = aug.train_fn(5, imgs)
    b = da.DeviceAug(out_size=32, stage_size=37, seed=3,
                     dtype=torch.float32).train_fn(5, imgs)
    c = aug.train_fn(6, imgs)
    d = da.DeviceAug(out_size=32, stage_size=37, seed=4,
                     dtype=torch.float32).train_fn(5, imgs)
    assert a.shape == (4, 32, 32, 3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 1e-3  # a new step draws new crops
    assert (a - d).abs().max() > 1e-3  # so does another seed
    lo = ((0 - IMAGENET_MEAN) / IMAGENET_STD).min()
    hi = ((1 - IMAGENET_MEAN) / IMAGENET_STD).max()
    assert a.min() >= lo - 1e-3 and a.max() <= hi + 1e-3
    # the stated mixing function, and distinct seeds for neighbouring steps
    assert da.step_seed(0, 0) == 7070836379803831727
    seeds = {da.step_seed(s, t) for s in range(4) for t in range(256)}
    assert len(seeds) == 4 * 256 and max(seeds) < 2 ** 63


# ---- the host half ------------------------------------------------------------

HOST_HALF = ("StageTrainTransform", "StageValTransform", "IdentityTransform",
             "StagedImageCache", "build_staging_transforms")


def _segment(path: Path, name: str) -> str:
    text = path.read_text()
    node = next(n for n in ast.parse(text).body
                if isinstance(n, (ast.ClassDef, ast.FunctionDef))
                and n.name == name)
    return ast.get_source_segment(text, node)


@pytest.mark.parametrize("name", HOST_HALF)
def test_host_half_is_the_jax_text(name):
    jax_text = _segment(ROOT / "ep_tpu/data/device_aug.py", name)
    port_text = _segment(ROOT / "ep_tpu_torch/data/device_aug.py", name)
    assert port_text == jax_text.replace("ep_tpu.data", "ep_tpu_torch.data")


def test_staged_image_cache(tmp_path):
    calls = []

    class Counting:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            calls.append(i)
            rng = np.random.default_rng(i)
            return rng.integers(0, 256, (40, 50, 3), np.uint8), i % 3

    ds = da.StagedImageCache(Counting(), da.StageTrainTransform(16),
                             str(tmp_path), "train")
    first = [ds[i] for i in range(6)]
    n_calls = len(calls)
    again = [ds[i] for i in range(6)]
    assert len(calls) == n_calls  # cache hits: base dataset untouched
    for (a, la), (b, lb) in zip(first, again):
        np.testing.assert_array_equal(a, b)
        assert la == lb
    assert first[0][0].shape == (16, 16, 3)
    ref = np.asarray(Image.fromarray(Counting()[0][0]).resize((16, 16), 3))
    assert np.abs(first[0][0].astype(int) - ref.astype(int)).mean() < 2.0
    calls.clear()
    ds2 = da.StagedImageCache(Counting(), da.StageTrainTransform(16),
                              str(tmp_path), "train")
    img, label = ds2[4]
    np.testing.assert_array_equal(img, first[4][0])
    assert label == 1 and 4 not in calls  # served from the memmap


# ---- the driver ----------------------------------------------------------------

_STAMP = re.compile(r"^(\[\d\d:\d\d:\d\d\.\d+\] )+")


def _said(out: str, *starts) -> list[str]:
    lines = [_STAMP.sub("", l) for l in out.splitlines()]
    return [l for l in lines if l.startswith(starts)]


def test_device_aug_eval_and_knn_print_what_the_jax_driver_prints(
        tmp_path, tiny, capsys):  # noqa: F811
    ckpt = write_timm_checkpoint(tmp_path / "mae.pth")
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    flags = dict(finetune=ckpt, device_aug=True)
    jax_linprobe.main(_cfg(jax_dir, epochs=1, **flags))
    port_dir.mkdir()
    _jax_checkpoint_to_port(jax_dir / "checkpoint-.msgpack",
                            port_dir / "checkpoint-.pth")
    runs = {}
    for name, kw in (
            ("eval", dict(eval=True, **flags)),
            ("knn", dict(knn_eval=True, cls_features="pos", **flags))):
        capsys.readouterr()
        jax_linprobe.main(_cfg(jax_dir / name, resume=str(
            jax_dir / "checkpoint-.msgpack"), **kw))
        said_jax = capsys.readouterr().out
        linprobe.main(_p(_cfg(port_dir / name, resume=str(
            port_dir / "checkpoint-.pth"), **kw)))
        said_port = capsys.readouterr().out
        runs[name] = said_jax, said_port
    starts = ("* Acc@1", "Accuracy of the network", "Train features shape",
              "Test features shape", "| device-side augmentation")
    got = [_said(s, *starts) for s in runs["eval"]]
    assert len(got[0]) == 3 and got[1] == [
        l.replace("on the TPU", "on the cpu device") for l in got[0]]
    got = [_said(s, *starts, "5-NN", "10-NN", "20-NN", "50-NN", "100-NN",
                 "200-NN") for s in runs["knn"]]
    assert len(got[0]) == 9 and got[1] == [
        l.replace("on the TPU", "on the cpu device") for l in got[0]]


def test_device_aug_driver_learns(tmp_path, tiny):  # noqa: F811
    """The plain LP head on ``gap`` features over 5 epochs, as the JAX test
    runs it, with the encoder of ``write_timm_checkpoint`` (the one the
    hand-off tests give both packages). From the port's own seed-0 encoder
    and head the LP head stays under 25% in 5 epochs, with or without
    ``--device_aug`` (``test_torch_driver``'s docstring: that draw, where
    the training itself is held to the JAX driver's by the hand-off
    tests)."""
    ckpt = write_timm_checkpoint(tmp_path / "mae.pth")
    res = linprobe.main(_p(_cfg(tmp_path, cls_features="gap", epochs=5,
                                finetune=ckpt, device_aug=True,
                                device_aug_cache=str(tmp_path / "staged"))))
    assert res["max_accuracy"] > 40.0  # chance = 25%
    assert list((tmp_path / "staged").glob("staged_train_*.npy"))
    assert list((tmp_path / "staged").glob("staged_val_*.npy"))
