"""Every feature mode of the port's VisionTransformer against the flax
module, and the forward's options: ``return_block``, ``shuffle_subsets``,
the attention temperature, the ``dino`` mode with its oracle, and the
refusals the JAX package makes (``tcut-*``, the scan rules), and
``capture_stats`` (module item 8) beside a feature mode.

Sizes, weights and tolerances: ``test_torch_backbone_util.py`` (f32 at 1e-5,
bf16 within 2**-5 of the largest magnitude). The ``ca*`` and ``attn-*``
modes average the last block's f32 probabilities; ``attn-lcte`` takes the
argmin of the heads' entropies, which random inputs leave without ties
(the test asserts a gap between the two heads' entropies).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_backbone_util import (B, IMG, close, flax_cfg, images,
                                      load_port, port_cfg, redraw,
                                      redraw_backbone)
from ep_tpu.configs import TrainConfig
from ep_tpu.models.assembly import ProbeModel as FlaxProbeModel
from ep_tpu.models.vit import VisionTransformer as FlaxViT
from ep_tpu_torch.configs import TrainConfig as PortTrainConfig
from ep_tpu_torch.models.assembly import ProbeModel, oracle_config
from ep_tpu_torch.models.vit import VisionTransformer

MODES = ["cls", "pos", "gap", "raw", "both", "cp1", "cp2", "cp3", "cp4",
         "ca1", "ca2", "ca3", "ca4", "attn-mn", "attn-lcte"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("EP_TPU_PALLAS_INTERPRET", "1")


def _pair(dtype="float32", seed=0, **kw):
    fcfg = flax_cfg(dtype, **kw)
    fm = FlaxViT(fcfg)
    v = fm.init(jax.random.key(0), jnp.zeros((2, IMG, IMG, 3)))
    v = {"params": redraw(v["params"], seed)}
    return fm, v, load_port(VisionTransformer(port_cfg(fcfg)), v)


_CACHE = {}


def _cached_pair(dtype):
    if dtype not in _CACHE:
        _CACHE[dtype] = _pair(dtype)
    return _CACHE[dtype]


def _run(fm, v, pm, mode, x, **kw):
    out_j = fm.apply(v, jnp.asarray(x), mode, **kw)[0]
    out_t = pm(torch.from_numpy(x), mode, **kw)
    return out_t, out_j


@pytest.mark.parametrize("mode", MODES)
def test_feature_mode_matches_flax(mode):
    fm, v, pm = _cached_pair("float32")
    close(*_run(fm, v, pm, mode, images()), "float32", mode)


@pytest.mark.parametrize("mode", ["raw", "cp4", "ca2", "attn-mn", "attn-lcte"])
def test_feature_mode_matches_flax_in_bf16(mode):
    fm, v, pm = _cached_pair("bfloat16")
    close(*_run(fm, v, pm, mode, images()), "bfloat16", mode)


def test_lcte_inputs_have_no_entropy_ties():
    """The heads' class-token entropies of the images above differ, so the
    argmin is the same on both sides."""
    fm, v, pm = _cached_pair("float32")
    _, (probs, _) = pm(torch.from_numpy(images()), "cls",
                       return_final_attn=True)
    cls_pos = probs[:, :, 0, 1:]
    wo = cls_pos / (cls_pos.sum(2, keepdim=True) + 1e-6)
    ent = -(wo * torch.log(wo + 1e-6)).sum(2)
    top2 = ent.sort(dim=1).values[:, :2]
    assert float((top2[:, 1] - top2[:, 0]).min()) > 1e-3


@pytest.mark.parametrize("return_block, mode", [(0, "pos"), (0, "ca2"),
                                                (1, "cls"), (0, "raw")])
def test_return_block_matches_flax(return_block, mode):
    fm, v, pm = _cached_pair("float32")
    out_t, out_j = _run(fm, v, pm, mode, images(1), return_block=return_block)
    close(out_t, out_j, "float32", f"{mode} at block {return_block}")
    full_t = pm(torch.from_numpy(images(1)), mode)
    if return_block == 0:
        assert not torch.allclose(out_t, full_t)


@pytest.mark.parametrize("mode", ["cls", "pos", "gap"])
def test_shuffle_subsets_match_flax(mode):
    """Two subsets of 8 patch tokens each, from the same uniform noise
    (JAX draws it from the key; the port takes it as a tensor)."""
    fm, v, pm = _cached_pair("float32")
    x = images(2)
    key = jax.random.key(7)
    out_j = fm.apply(v, jnp.asarray(x), mode, shuffle_subsets=2,
                     shuffle_rng=key)[0]
    noise = np.asarray(jax.random.uniform(key, (B, 16)))
    out_t = pm(torch.from_numpy(x), mode, shuffle_subsets=2,
               shuffle_noise=torch.from_numpy(noise))
    close(out_t, out_j, "float32", mode)


@pytest.mark.parametrize("kw, mode", [
    (dict(), "pos"),                  # the supercell
    (dict(init_values=0.1), "pos"),   # the plain route through the fused core
    (dict(), "ca2"),                  # the last block through mha
    (dict(rel_pos_bias="shared", qkv_bias_mode="qv_only"), "cls"),
])
def test_temperature_matches_flax(kw, mode):
    fm, v, pm = _pair(seed=3, **kw)
    out_t, out_j = _run(fm, v, pm, mode, images(3), attn_temperature=1.5)
    close(out_t, out_j, "float32", f"{kw} {mode}")
    assert not torch.allclose(out_t, pm(torch.from_numpy(images(3)), mode))


def _dino_models(dtype, return_block=None):
    amp = "bfloat16" if dtype == "bfloat16" else "float32"
    cfg = TrainConfig(model="vit_tiny_patch16", cls_features="dino",
                      nb_classes=5, image_size=IMG, amp=amp, batch_size=B,
                      return_block=return_block)
    fcfg = flax_cfg(dtype)
    fm = FlaxProbeModel(fcfg, cfg)
    v = fm.init(jax.random.key(0), jnp.zeros((2, IMG, IMG, 3)), train=True)
    v = redraw_backbone(v, seed=4)
    pcfg = PortTrainConfig(**dataclasses.asdict(cfg))
    pm = load_port(ProbeModel(port_cfg(fcfg), pcfg), v)
    return fm, v, pm


@pytest.mark.parametrize("dtype, return_block", [
    ("float32", None), ("bfloat16", None), ("float32", 0)])
def test_dino_mode_with_oracle_matches_flax(dtype, return_block):
    """The backbone's patch tokens weighted by the oracle's last cls-to-patch
    attention (the oracle a plain twin at this width), logits and features."""
    fm, v, pm = _dino_models(dtype, return_block)
    assert pm.oracle is not None and not pm.oracle.cfg.reg_tokens
    pm.eval()
    x = images(5)
    logits_j, feats_j = fm.apply(v, jnp.asarray(x), train=False,
                                 return_backbone_features=True)
    logits_t, feats_t = pm(torch.from_numpy(x), return_backbone_features=True)
    close(feats_t, feats_j, dtype, "features")
    close(logits_t, logits_j, dtype, "logits")


def test_oracle_config_matches_jax():
    from ep_tpu.models.assembly import oracle_config as jax_oracle_config
    from ep_tpu.models.wrappers import dinov2_config
    for fcfg in (flax_cfg(init_values=0.1, reg_tokens=4),
                 dinov2_config("dinov2_vitl14_reg")):
        ours = oracle_config(port_cfg(fcfg))
        theirs = port_cfg(jax_oracle_config(fcfg))
        assert ours == theirs


def test_dino_oracle_takes_no_gradient():
    """Fine-tuning trains the backbone through the dino features; the oracle's
    attention is a constant, as under the JAX package's stop_gradient."""
    _, _, pm = _dino_models("float32")
    pm.finetuning = True
    pm.train()
    pm(torch.from_numpy(images(6))).sum().backward()
    assert pm.backbone.blocks[0].attn.qkv.weight.grad is not None
    assert all(p.grad is None for p in pm.oracle.parameters())


def test_tcut_raises_as_in_jax():
    fm, v, pm = _cached_pair("float32")
    x = images()[:2]
    with pytest.raises(NotImplementedError):
        fm.apply(v, jnp.asarray(x), "tcut-4")
    with pytest.raises(NotImplementedError):
        pm(torch.from_numpy(x), "tcut-4")


def test_capture_stats_names_item_8():
    """Named for the refusal it held before module item 8 was ported: the
    capture now returns flax's features, statistics and magnitudes (f32,
    1e-5), here beside a mode that reads the last block's probabilities."""
    fm, v, pm = _cached_pair("float32")
    x = images()[:2]
    got = pm(torch.from_numpy(x), "ca2", capture_stats=True)
    want = fm.apply(v, jnp.asarray(x), "ca2", capture_stats=True)
    assert got[1].shape == (5, 2, 2, 2, 17) and got[2].shape == (2, 2, 2, 17)
    for a, b, what in zip(got, want, ("features", "stats", "magnitudes")):
        close(a, b, "float32", what)


@pytest.mark.parametrize("kw, call", [
    (dict(), dict(return_features="ca2")),
    (dict(), dict(return_block=0)),
    (dict(rel_pos_bias="per_block"), dict()),
])
def test_scan_blocks_refusals_match_jax(kw, call):
    """``scan_blocks`` is flag surface in the port, but what the JAX
    package's scan refuses raises ``ValueError`` in both."""
    fcfg = flax_cfg(scan_blocks=True, **kw)
    fm = FlaxViT(fcfg)
    x = images()[:2]
    call = {"return_features": "cls", **call}
    with pytest.raises(ValueError, match="scan_blocks"):
        fm.init(jax.random.key(0), jnp.asarray(x), **call)
    with pytest.raises(ValueError, match="scan_blocks"):
        VisionTransformer(port_cfg(fcfg))(torch.from_numpy(x), **call)
