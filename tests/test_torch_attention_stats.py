"""The attention statistics of the port (ROADMAP module item 8) against the
JAX package's, on the CPU.

* ``ops/attention.py::attn_stats_from_probs`` against
  ``ep_tpu/ops/attention.py``'s on the same probabilities, at 1e-6.
* ``VisionTransformer(..., capture_stats=True)``: features, the (5, B,
  blocks, H, T) statistics and the (2, B, blocks, T) magnitudes against the
  flax module with the same weights, f32 at 1e-5, for a plain ViT, a
  DINOv2-style one (registers, LayerScale: the branch's magnitude is taken
  before LayerScale), a SimMIM-style one (relative-position bias, ``qv_only``
  bias) and an early ``return_block``; every block on the plain route (no
  supercell, no fused attention), the MLP half without int8.
* The CLI (``ep_tpu_torch/cli/attention_stats.py``): its
  ``attention_stats.json`` against ``ep_tpu.cli.attention_stats.main``'s on
  the same test-written timm checkpoint and ``fake`` data, at 1e-5.

Sizes: ``test_torch_backbone_util.py`` (D=64, 2 heads, depth 2, 32 px in
patches of 8) for the backbone, ``test_torch_checkpoint.py``'s tiny ViT
(width 32, 2 blocks of 2 heads, 16 px in patches of 4) for the CLI.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ep_tpu.cli.attention_stats as jax_as
import ep_tpu_torch.cli.attention_stats as port_as
import ep_tpu_torch.models.vit as pvit
from ep_tpu.models.vit import VisionTransformer as FlaxViT
from ep_tpu.models.vit import ViTConfig as FlaxViTConfig
from ep_tpu.ops.attention import attn_stats_from_probs as jax_stats
from ep_tpu_torch.ops.attention import AttnStats, attn_stats_from_probs
from ep_tpu_torch.models.vit import ViTConfig, VisionTransformer

from test_torch_backbone_util import (close, flax_cfg, images, load_port,
                                      port_cfg, redraw)
from test_torch_checkpoint import write_timm_checkpoint


@pytest.mark.parametrize("B, H, T", [(2, 3, 5), (3, 2, 17)])
def test_attn_stats_from_probs_matches_jax(B, H, T):
    rng = np.random.default_rng(T)
    logits = rng.standard_normal((B, H, T, T)).astype(np.float32) * 3
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    got = attn_stats_from_probs(torch.from_numpy(probs))
    want = np.asarray(jax_stats(jnp.asarray(probs)))
    assert got.shape == (5, B, 1, H, T) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the stack is the AttnStats layout of the JAX package
    assert AttnStats._fields == ("stats", "magnitudes")


CAPTURE = {
    "plain": dict(),
    "layerscale": dict(init_values=0.5, reg_tokens=4, final_norm="ln"),
    "relpos": dict(qkv_bias_mode="qv_only", use_abs_pos_emb=False,
                   rel_pos_bias="shared", init_values=0.1),
}


def _pair(kw, seed):
    fcfg = flax_cfg(**kw)
    fm = FlaxViT(fcfg)
    v = {"params": redraw(fm.init(jax.random.key(0), jnp.zeros(
        (2, 32, 32, 3)))["params"], seed)}
    return fm, v, load_port(VisionTransformer(port_cfg(fcfg)), v)


@pytest.mark.parametrize("name", list(CAPTURE))
def test_capture_stats_matches_flax(name, monkeypatch):
    """Features, statistics and magnitudes of every block; the kernel routes
    are never taken (they would raise here)."""
    fm, v, pm = _pair(CAPTURE[name], seed=3)
    assert pm.blocks[0].supercell == (name == "plain")

    def refuse(*a, **k):
        raise AssertionError("the capture took a kernel route")
    monkeypatch.setattr(pvit, "attn_supercell", refuse)
    monkeypatch.setattr(pvit, "attention_qkv_fused", refuse)
    x = images(11)
    feats_t, stats_t, magn_t = pm(torch.from_numpy(x), "cls",
                                  capture_stats=True)
    feats_j, stats_j, magn_j = fm.apply(v, jnp.asarray(x), "cls",
                                        capture_stats=True)
    T = 17 + CAPTURE[name].get("reg_tokens", 0)
    assert stats_t.shape == (5, 4, 2, 2, T) and magn_t.shape == (2, 4, 2, T)
    close(feats_t, feats_j, "float32", "features")
    close(stats_t, stats_j, "float32", "stats")
    close(magn_t, magn_j, "float32", "magnitudes")
    if name == "layerscale":
        # the branch's norm is taken before LayerScale: doubling block 0's
        # gamma moves the features and block 1's input norm, not block 0's
        # branch norm
        with torch.no_grad():
            pm.blocks[0].ls1.gamma.mul_(2)
            feats_2, _, magn_2 = pm(torch.from_numpy(x), "cls",
                                    capture_stats=True)
        torch.testing.assert_close(magn_2[1, :, 0], magn_t[1, :, 0],
                                   rtol=0, atol=0)
        assert not torch.allclose(magn_2[0, :, 1], magn_t[0, :, 1])
        assert not torch.allclose(feats_2, feats_t)


def test_capture_stats_at_an_early_return_block():
    fm, v, pm = _pair({}, seed=4)
    x = images(12)
    got = pm(torch.from_numpy(x), "gap", 0, capture_stats=True)
    want = fm.apply(v, jnp.asarray(x), "gap", 0, capture_stats=True)
    assert got[1].shape == (5, 4, 1, 2, 17)
    for a, b, what in zip(got, want, ("features", "stats", "magnitudes")):
        close(a, b, "float32", what)


def test_capture_stats_of_subsets_are_dropped_as_in_jax():
    fm, v, pm = _pair({}, seed=5)
    noise = torch.rand(4, 16, generator=torch.Generator().manual_seed(0))
    out = pm(torch.from_numpy(images(13)), "cls", shuffle_subsets=2,
             shuffle_noise=noise, capture_stats=True)
    assert out[0].shape == (4, 2, 64) and out[1] is None and out[2] is None


TINY = FlaxViTConfig(img_size=16, patch_size=4, embed_dim=32, depth=2,
                     num_heads=2, dtype=jnp.float32)


def _args(tmp_path, name, ckpt, **kw):
    return argparse.Namespace(**{**dict(
        model="vit_tiny_patch16", simmim=False, finetune=ckpt,
        checkpoint_key="model", input_size=16, dataset_name="fake",
        data_path=".", amp="float32", batch_size=16, num_workers=2, seed=0,
        output_dir=str(tmp_path / name), max_batches=3,
        draw_2d_embeddings=False, dino_aug=False), **kw})


def test_cli_matches_the_jax_cli(tmp_path, monkeypatch):
    """``attention_stats.json`` of both CLIs on the same checkpoint and
    images (3 batches of 16 of ``fake``'s val split): every stat of every
    block within 1e-5."""
    ckpt = write_timm_checkpoint(tmp_path / "vit.pth", seed=2)
    monkeypatch.setattr(jax_as, "build_backbone_config", lambda cfg: TINY)
    monkeypatch.setattr(
        port_as, "build_backbone_config",
        lambda cfg: ViTConfig(img_size=16, patch_size=4, embed_dim=32,
                              depth=2, num_heads=2, dtype=torch.float32))
    jax_as.main(_args(tmp_path, "jax", ckpt))
    summary = port_as.main(_args(tmp_path, "port", ckpt, device="cpu"))
    ours = json.loads((tmp_path / "port" / "attention_stats.json").read_text())
    theirs = json.loads((tmp_path / "jax" / "attention_stats.json").read_text())
    assert ours == summary and list(ours) == port_as.STAT_NAMES
    assert list(theirs) == jax_as.STAT_NAMES == port_as.STAT_NAMES
    for name in port_as.STAT_NAMES:
        assert len(ours[name]) == 2
        np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    for name in ("cls_cls_attention", "pos_self_attention",
                 "cls_pos_attention", "pos_cls_attention"):
        assert all(0.0 <= v <= 1.0 for v in ours[name])


def test_cli_refuses_an_autoencoder(tmp_path):
    with pytest.raises(ValueError, match="autoencoder"):
        port_as.main(_args(tmp_path, "mae", "", model="mae_vit_base_patch16",
                           device="cpu"))


def test_cli_runs_on_the_card_by_default(tmp_path):
    """Without ``--device`` the CLI asks for the card, and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = port_as.get_args_parser().parse_args([])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_as.main(_args(tmp_path, "card", "", device=args.device))


@pytest.mark.parametrize("model", ["vit_tiny_patch16", "dinov2_vits14_reg"])
def test_cli_model_is_the_seeded_backbone(model):
    """The CLI's backbone, built without the constructors' own
    initialisation, holds what ``init_backbone`` draws from the seed."""
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.models.assembly import build_backbone_config, init_backbone
    cfg = TrainConfig(model=model, image_size=28, seed=5, amp="float32")
    got = port_as.build_model(cfg, torch.device("cpu")).state_dict()
    ref = VisionTransformer(build_backbone_config(cfg))
    init_backbone(ref, torch.Generator().manual_seed(5))
    for k, v in ref.state_dict().items():
        assert torch.equal(got[k], v), k
