"""The whole probing slice: ep_tpu ProbeModel (flax) against ep_tpu_torch's
ProbeModel with the same weights, through convert/from_flax.py.

Small sizes: D=64, 2 heads, depth 2, 32 px images with patch 16 (T=5), 4 EP
queries, 5 classes. The flax model takes its kernel path (attention supercell
and EP kernel in interpret mode), whose cast points the port keeps.

Tolerances: float32 at 1e-5 (the suite's parity bar). In bfloat16 the two
sides round at the same points, but sums run in another order and a few
products (patch embed, fc1/fc2, the EP value projection) round once where flax
rounds the product and then the bias add; one bf16 step (2**-8 relative)
taken early propagates through two blocks, BatchNorm and the classifier, so
logits agree within 3e-2 of their largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ep_tpu.configs import TrainConfig
import test_torch_backbone_util as bu
from ep_tpu.models.assembly import (ProbeModel as FlaxProbeModel,
                                    build_backbone_config as
                                    build_flax_backbone_config)
from ep_tpu.models.vit import (ViTConfig as FlaxViTConfig,
                               VisionTransformer as FlaxVisionTransformer,
                               stack_block_params)
from ep_tpu_torch.configs import TrainConfig as PortTrainConfig
from ep_tpu_torch.convert.from_flax import flax_to_torch
from ep_tpu_torch.models.assembly import (ProbeModel, build_backbone_config,
                                          init_probe_model)
from ep_tpu_torch.models.vit import PatchEmbed, VisionTransformer

IMG, B = 32, 8
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfg(feats="ep", amp="float32"):
    return TrainConfig(model="vit_tiny_patch16", cls_features=feats,
                       ep_queries=4, d_out=1, nb_classes=5, image_size=IMG,
                       amp=amp, batch_size=B, eff_batch_size=B)


def _p(cfg):
    """The same configuration as the port's own ``TrainConfig``."""
    return PortTrainConfig(**dataclasses.asdict(cfg))


def flax_model(cfg, dtype, attn_impl="pallas"):
    bcfg = FlaxViTConfig(img_size=IMG, patch_size=16, embed_dim=64, depth=2,
                         num_heads=2, dtype=DT[dtype][0], attn_impl=attn_impl)
    return FlaxProbeModel(bcfg, cfg)


def torch_model(cfg, dtype, variables):
    cfg = _p(cfg)
    bcfg = build_backbone_config(cfg).replace(embed_dim=64, depth=2,
                                              num_heads=2)
    assert bcfg.dtype == DT[dtype][1]
    model = ProbeModel(bcfg, cfg)
    params, buffers = flax_to_torch(
        jax.tree_util.tree_map(np.asarray, variables), device="cpu")
    model.load_state_dict({**params, **buffers}, strict=True)
    return model


def images(seed=0):
    return np.random.default_rng(seed).standard_normal((B, IMG, IMG, 3),
                                                       np.float32)


def _assert_logits(out_t, out_j, dtype):
    a, b = out_t.detach().numpy(), np.asarray(out_j)
    assert a.dtype == np.float32 and a.shape == b.shape
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=3e-2 * np.abs(b).max())


@pytest.mark.parametrize("feats, dtype, train", [
    ("ep", "float32", False),
    ("ep", "float32", True),
    ("ep", "bfloat16", False),
    ("ep", "bfloat16", True),
    ("cls", "float32", True),
    ("pos", "float32", True),  # plain LP on mean-pooled patch tokens
])
def test_probe_model_matches_flax(monkeypatch, feats, dtype, train):
    monkeypatch.setenv("EP_TPU_PALLAS_INTERPRET", "1")
    amp = "bfloat16" if dtype == "bfloat16" else "float32"
    cfg = _cfg(feats, amp)
    fm = flax_model(cfg, dtype)
    x = images()
    variables = fm.init(jax.random.key(0), jnp.zeros((2, IMG, IMG, 3)),
                        train=True)
    tm = torch_model(cfg, dtype, variables)
    tm.train(train)
    out_t = tm(torch.from_numpy(x))
    if train:
        out_j, upd = fm.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        bn = upd["batch_stats"]["head"]["bn"]
        np.testing.assert_allclose(tm.head.bn.running_mean.numpy(),
                                   np.asarray(bn["mean"]), rtol=1e-5,
                                   atol=1e-5 if dtype == "float32" else 3e-3)
        np.testing.assert_allclose(tm.head.bn.running_var.numpy(),
                                   np.asarray(bn["var"]), rtol=1e-5 if
                                   dtype == "float32" else 3e-2, atol=1e-5)
    else:
        out_j = fm.apply(variables, jnp.asarray(x), train=False)
    _assert_logits(out_t, out_j, dtype)


def test_scan_layout_converts_like_loop_layout():
    cfg = _cfg()
    variables = flax_model(cfg, "float32", attn_impl="xla").init(
        jax.random.key(1), jnp.zeros((2, IMG, IMG, 3)), train=True)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    loop, _ = flax_to_torch(variables, device="cpu")
    scan_params = dict(variables["params"])
    scan_params["backbone"] = stack_block_params(dict(scan_params["backbone"]),
                                                 2)
    scan, _ = flax_to_torch({"params": scan_params}, device="cpu")
    assert loop.keys() == scan.keys()
    for k in loop:
        torch.testing.assert_close(loop[k], scan[k], rtol=0, atol=0)
    assert loop["backbone.blocks.1.attn.qkv.weight"].shape == (192, 64)
    assert loop["backbone.patch_embed.proj.weight"].shape == (64, 3, 16, 16)


def test_patch_embed_matmul_equals_conv():
    pe = PatchEmbed(16, 3, 64)
    x = torch.from_numpy(images()[:2])
    out = pe(x, torch.float32)
    ref = F.conv2d(x.permute(0, 3, 1, 2), pe.proj.weight, pe.proj.bias,
                   stride=16).flatten(2).transpose(1, 2)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(rel_pos_bias="shared"), dict(init_values=0.1), dict(reg_tokens=4),
    dict(mlp_type="swiglu"), dict(pre_norm=True), dict(proj_dim=512),
])
def test_unported_backbone_variants_raise(monkeypatch, kw):
    """Named for the refusal it held before the backbone family was ported:
    each variant of the JAX ViT now builds and matches the flax module (cls
    features at f32, 1e-5; ``test_torch_backbone_util.py``)."""
    monkeypatch.setenv("EP_TPU_PALLAS_INTERPRET", "1")
    fcfg = bu.flax_cfg(**kw)
    fm = FlaxVisionTransformer(fcfg)
    v = {"params": bu.redraw(fm.init(jax.random.key(0), jnp.zeros(
        (2, bu.IMG, bu.IMG, 3)))["params"])}
    pm = bu.load_port(VisionTransformer(bu.port_cfg(fcfg)), v)
    x = bu.images(9)
    bu.close(pm(torch.from_numpy(x)), fm.apply(v, jnp.asarray(x))[0],
             "float32", str(kw))


@pytest.mark.parametrize("kw", [
    pytest.param(dict(return_block=5), id="kw0-item 7"),
    pytest.param(dict(cls_features="raw"), id="kw1-item 7"),
    pytest.param(dict(model="dinov2_vitb14"), id="kw2-item 7"),
])
def test_unported_configs_raise(monkeypatch, kw):
    """Named, with its case ids, for the refusal it held before the backbone
    family was ported (ROADMAP module item 7): each configuration now builds
    a ProbeModel whose logits match the flax model's (f32, 1e-5)."""
    monkeypatch.setenv("EP_TPU_PALLAS_INTERPRET", "1")
    cfg = _cfg(**{"feats": kw.get("cls_features", "ep")})
    cfg = dataclasses.replace(cfg, **{k: v for k, v in kw.items()
                                      if k != "cls_features"})
    depth = 6 if "return_block" in kw else 2
    fcfg = build_flax_backbone_config(cfg).replace(
        img_size=IMG, patch_size=16, embed_dim=64, depth=depth, num_heads=2,
        attn_impl="pallas")
    fm = FlaxProbeModel(fcfg, cfg)
    v = bu.redraw_backbone(fm.init(jax.random.key(0),
                                   jnp.zeros((2, IMG, IMG, 3)), train=True))
    pm = bu.load_port(ProbeModel(bu.port_cfg(fcfg), _p(cfg)), v)
    pm.eval()
    x = images(1)
    _assert_logits(pm(torch.from_numpy(x)),
                   fm.apply(v, jnp.asarray(x), train=False), "float32")


@pytest.mark.parametrize("mode", ["raw", "dino", "cp4"])
def test_unported_feature_modes_raise_in_the_backbone(monkeypatch, mode):
    """Named for the refusal it held before the feature modes were ported:
    ``raw`` and ``cp4`` now match the flax backbone; ``dino`` is a mode of
    ProbeModel (the oracle), which the backbone refuses in both packages."""
    monkeypatch.setenv("EP_TPU_PALLAS_INTERPRET", "1")
    fcfg = bu.flax_cfg(depth=1)
    fm = FlaxVisionTransformer(fcfg)
    v = {"params": bu.redraw(fm.init(jax.random.key(0), jnp.zeros(
        (2, bu.IMG, bu.IMG, 3)))["params"])}
    vit = bu.load_port(VisionTransformer(bu.port_cfg(fcfg)), v)
    x = bu.images(10)
    if mode == "dino":
        with pytest.raises(NotImplementedError):
            fm.apply(v, jnp.asarray(x), mode)
        with pytest.raises(NotImplementedError):
            vit(torch.from_numpy(x), mode)
        return
    bu.close(vit(torch.from_numpy(x), mode), fm.apply(v, jnp.asarray(x), mode)[0],
             "float32", mode)


def test_init_is_seeded():
    cfg = _p(_cfg())
    bcfg = build_backbone_config(cfg).replace(embed_dim=64, depth=1,
                                              num_heads=2)
    a = init_probe_model(cfg, 3, bcfg, device="cpu").state_dict()
    b = init_probe_model(cfg, 3, bcfg, device="cpu").state_dict()
    c = init_probe_model(cfg, 4, bcfg, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.fc.weight"], c["head.fc.weight"])
