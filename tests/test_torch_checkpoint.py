"""The port's checkpoints and ``--finetune`` loading.

* A round trip of a seeded model after a LARS step (head, BN statistics,
  momentum, step, epoch): strict, then lenient when the classifier's shape
  changed; probing saves ``head.*`` only, fine-tuning everything.
* ``_merge_lenient`` and ``find_auto_resume`` on the cases of
  ``tests/test_checkpoint_edge.py`` (the JAX package's).
* ``--finetune`` of a timm/MAE-layout ``.pth`` that the test writes (prefixed
  keys, a decoder key, the mask token, a classifier, a position embedding of
  another grid) against ``ep_tpu``'s ``load_pretrained_backbone``: the same
  backbone and the same logits, float32 at 1e-5.

A tiny ViT: width 32, 2 blocks of 2 heads, 16 px images in patches of 4.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ep_tpu.configs import TrainConfig
from ep_tpu.convert.torch_vit import load_pretrained_backbone as jax_load
from ep_tpu.models.assembly import ProbeModel as FlaxProbeModel
from ep_tpu.models.vit import ViTConfig as FlaxViTConfig
from ep_tpu_torch.configs import TrainConfig as PortTrainConfig
from ep_tpu_torch.convert.from_flax import flax_to_torch
from ep_tpu_torch.convert.torch_vit import (load_pretrained_backbone,
                                            torch_vit_to_backbone)
from ep_tpu_torch.models.assembly import build_backbone_config, init_probe_model
from ep_tpu_torch.runtime.checkpoint import (_merge_lenient, find_auto_resume,
                                             load_model, save_model)
from ep_tpu_torch.train.lars import LARS
from ep_tpu_torch.train.state import freeze
from ep_tpu_torch.train.steps import make_train_step

IMG, D, DEPTH, HEADS, PATCH = 16, 32, 2, 2, 4


def _cfg(tmp_path, **kw):
    base = dict(model="vit_tiny_patch16", cls_features="ep", ep_queries=4,
                nb_classes=4, image_size=IMG, amp="float32",
                output_dir=str(tmp_path), epochs=4)
    base.update(kw)
    return PortTrainConfig(**base)


def _model(cfg, seed=0):
    bcfg = build_backbone_config(cfg).replace(
        patch_size=PATCH, embed_dim=D, depth=DEPTH, num_heads=HEADS)
    return init_probe_model(cfg, seed, bcfg, device="cpu"), bcfg


def _trained(cfg, seed=0):
    """A model and its LARS optimizer after two steps on seeded images."""
    model, _ = _model(cfg, seed)
    opt = LARS(freeze(model, cfg.finetuning), weight_decay=0.05)
    step = make_train_step(model, opt, lambda s: 0.5)
    rng = np.random.default_rng(seed)
    for i in range(2):
        x = torch.from_numpy(rng.standard_normal((8, IMG, IMG, 3),
                                                 np.float32))
        step(i, x, torch.from_numpy(rng.integers(0, 4, 8)))
    return model, opt


def test_round_trip_strict(tmp_path):
    cfg = _cfg(tmp_path)
    model, opt = _trained(cfg)
    path = save_model(cfg, 1, model, opt, step=2, test_stats={"acc1": 5.0})
    assert path.endswith("checkpoint-.pth")
    payload = torch.load(path, weights_only=True)
    assert payload["model"] and all(k.startswith("head.")
                                    for k in payload["model"])
    assert "head.bn.running_var" in payload["model"]
    fresh, _ = _model(cfg, seed=1)
    fresh_opt = LARS(freeze(fresh, False), weight_decay=0.05)
    start, step, stats = load_model(cfg.replace(resume=path), fresh, fresh_opt)
    assert (start, step, stats) == (2, 2, {"acc1": 5.0})
    a, b = model.state_dict(), fresh.state_dict()
    for k in a:
        if k.startswith("head."):
            assert torch.equal(a[k], b[k]), k
    # the frozen backbone is not in a probing checkpoint
    k = "backbone.blocks.0.attn.qkv.weight"
    assert not torch.equal(a[k], b[k])
    params = dict(fresh.named_parameters())
    for name, p in model.named_parameters():
        if name.startswith("head."):
            assert torch.equal(opt.state[p]["mu"],
                               fresh_opt.state[params[name]]["mu"]), name


def test_fine_tuning_saves_everything(tmp_path):
    cfg = _cfg(tmp_path, finetuning=True)
    model, opt = _trained(cfg)
    payload = torch.load(save_model(cfg, 0, model, opt, step=2),
                         weights_only=True)
    assert set(payload["model"]) == set(model.state_dict())
    assert len(payload["optimizer"]["state"]) == len(list(model.parameters()))


def test_round_trip_lenient_when_the_classifier_changed(tmp_path):
    """A checkpoint of 4 classes into a model of 6: the classifier keeps its
    initialisation, the rest of the head is restored, the optimizer's state
    (of the other shapes) is skipped and training starts at start_epoch."""
    cfg = _cfg(tmp_path)
    model, opt = _trained(cfg)
    path = save_model(cfg, 1, model, opt, step=2)
    cfg6 = _cfg(tmp_path, nb_classes=6, resume=path)
    fresh, _ = _model(cfg6, seed=1)
    init_fc = fresh.head.fc.weight.detach().clone()
    fresh_opt = LARS(freeze(fresh, False))
    start, step, _ = load_model(cfg6, fresh, fresh_opt)
    assert (start, step) == (0, 0)
    assert torch.equal(fresh.head.fc.weight, init_fc)
    assert torch.equal(fresh.head.pool.v.weight, model.head.pool.v.weight)
    assert torch.equal(fresh.head.bn.running_mean, model.head.bn.running_mean)
    assert not fresh_opt.state


def test_eval_restores_the_model_without_the_optimizer(tmp_path):
    cfg = _cfg(tmp_path)
    model, opt = _trained(cfg)
    path = save_model(cfg, 0, model, opt, step=2)
    fresh, _ = _model(cfg, seed=1)
    fresh_opt = LARS(freeze(fresh, False))
    start, step, _ = load_model(cfg.replace(resume=path, eval=True), fresh,
                                fresh_opt)
    assert (start, step) == (0, 0) and not fresh_opt.state
    assert torch.equal(fresh.head.fc.weight, model.head.fc.weight)


def test_merge_lenient_keeps_template_on_shape_mismatch():
    template = {"head.fc.weight": torch.zeros(10, 8),
                "head.fc.bias": torch.zeros(10), "pool.w": torch.zeros(4, 4)}
    loaded = {"head.fc.weight": torch.ones(5, 8),  # nb_classes changed
              "head.fc.bias": torch.ones(10), "pool.w": torch.ones(4, 4)}
    out = _merge_lenient(template, loaded)
    assert torch.equal(out["head.fc.weight"], torch.zeros(10, 8))
    assert torch.equal(out["head.fc.bias"], torch.ones(10))
    assert torch.equal(out["pool.w"], torch.ones(4, 4))


def test_merge_lenient_ignores_extra_and_missing_keys():
    template = {"a": torch.zeros(3), "b": torch.zeros(2)}
    loaded = {"a": torch.ones(3), "zzz": torch.ones(9)}
    out = _merge_lenient(template, loaded)
    assert set(out) == {"a", "b"}
    assert torch.equal(out["a"], torch.ones(3))
    assert torch.equal(out["b"], torch.zeros(2))


def test_find_auto_resume_newest_by_name(tmp_path):
    assert find_auto_resume(str(tmp_path)) is None
    (tmp_path / "checkpoint-_3.pth").write_bytes(b"x")
    (tmp_path / "checkpoint-_12.pth").write_bytes(b"x")
    (tmp_path / "other.txt").write_bytes(b"x")
    assert find_auto_resume(str(tmp_path)).endswith("checkpoint-_12.pth")
    assert find_auto_resume("") is None
    assert find_auto_resume(str(tmp_path / "missing")) is None


def test_find_auto_resume_name_order_beats_mtime(tmp_path):
    a = tmp_path / "checkpoint-best.pth"
    b = tmp_path / "checkpoint-last.pth"
    a.write_bytes(b"x")
    b.write_bytes(b"x")
    os.utime(a, (2_000_000_000, 2_000_000_000))
    assert find_auto_resume(str(tmp_path)).endswith("checkpoint-last.pth")


# ---- --finetune of a timm-layout checkpoint -------------------------------

def timm_state_dict(seed: int = 0, grid: int = 3) -> dict:
    """A timm/MAE-layout ViT state dict of the tiny shape, its position
    embedding on a ``grid`` x ``grid`` patch grid, with the keys a real
    checkpoint carries that the loader must drop."""
    rng = np.random.default_rng(seed)

    def r(*shape, s=0.1):
        return torch.from_numpy((rng.standard_normal(shape) * s)
                                .astype(np.float32))

    sd = {"patch_embed.proj.weight": r(D, 3, PATCH, PATCH),
          "patch_embed.proj.bias": r(D), "cls_token": r(1, 1, D),
          "pos_embed": r(1, 1 + grid * grid, D)}
    for i in range(DEPTH):
        p = f"blocks.{i}."
        sd.update({p + "norm1.weight": 1 + r(D), p + "norm1.bias": r(D),
                   p + "attn.qkv.weight": r(3 * D, D),
                   p + "attn.qkv.bias": r(3 * D),
                   p + "attn.proj.weight": r(D, D), p + "attn.proj.bias": r(D),
                   p + "norm2.weight": 1 + r(D), p + "norm2.bias": r(D),
                   p + "mlp.fc1.weight": r(4 * D, D),
                   p + "mlp.fc1.bias": r(4 * D),
                   p + "mlp.fc2.weight": r(D, 4 * D), p + "mlp.fc2.bias": r(D)})
    return sd


def write_timm_checkpoint(path, seed: int = 0) -> str:
    sd = {f"module.{k}": v for k, v in timm_state_dict(seed).items()}
    sd["module.decoder_embed.weight"] = torch.zeros(8, D)
    sd["module.mask_token"] = torch.zeros(1, 1, D)
    sd["module.head.weight"] = torch.zeros(1000, D)
    torch.save({"model": sd}, path)
    return str(path)


def test_finetune_loads_like_the_jax_package(tmp_path):
    ckpt = write_timm_checkpoint(tmp_path / "mae.pth")
    jcfg = TrainConfig(model="vit_tiny_patch16", cls_features="ep",
                       ep_queries=4, nb_classes=4, image_size=IMG,
                       amp="float32", pallas_pool=False, finetune=ckpt)
    fbcfg = FlaxViTConfig(img_size=IMG, patch_size=PATCH, embed_dim=D,
                          depth=DEPTH, num_heads=HEADS, dtype=jnp.float32,
                          attn_impl="xla")
    fmodel = FlaxProbeModel(fbcfg, jcfg)
    variables = fmodel.init(jax.random.key(0), jnp.zeros((2, IMG, IMG, 3)),
                            train=True)
    variables = jax_load(jcfg, fbcfg, variables)
    ref_state, _ = flax_to_torch(jax.tree_util.tree_map(np.asarray, variables),
                                 device="cpu")

    cfg = _cfg(tmp_path, finetune=ckpt)
    model, bcfg = _model(cfg, seed=5)
    load_pretrained_backbone(cfg, bcfg, model)
    own = model.state_dict()
    for k, v in ref_state.items():
        if k.startswith("backbone."):
            torch.testing.assert_close(own[k], v, rtol=1e-5, atol=1e-5)
    # the same head on both sides, then the same logits
    model.load_state_dict({k: v for k, v in ref_state.items()
                           if k.startswith("head.")}, strict=False)
    model.eval()
    x = np.random.default_rng(9).standard_normal((4, IMG, IMG, 3), np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(fmodel.apply(variables, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


def test_finetune_refuses_what_it_cannot_load(tmp_path):
    cfg = _cfg(tmp_path)
    model, bcfg = _model(cfg)
    sd = timm_state_dict()
    del sd["blocks.1.mlp.fc2.bias"]
    with pytest.raises(KeyError, match="blocks.1.mlp.fc2.bias"):
        torch_vit_to_backbone(sd, model.backbone, bcfg)
    sd = timm_state_dict()
    sd["blocks.0.mlp.fc1.weight"] = torch.zeros(8, D)
    with pytest.raises(ValueError, match="fc1.weight"):
        torch_vit_to_backbone(sd, model.backbone, bcfg)
    # an OpenCLIP layout is read (tests/test_torch_convert_variants.py), and
    # refused where it lacks what the backbone holds
    with pytest.raises(KeyError, match="blocks.0.norm1.weight"):
        torch_vit_to_backbone({"class_embedding": torch.zeros(D)},
                              model.backbone, bcfg)
    with pytest.raises(FileNotFoundError):
        load_pretrained_backbone(cfg.replace(finetune=str(tmp_path / "no.pth")),
                                 bcfg, model)
