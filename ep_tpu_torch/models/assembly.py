"""Backbone + probe-head assembly.

Counterpart of ``ep_tpu/models/assembly.py``: the model-name dispatch over
the whole backbone family (``build_backbone_config``), the frozen DINO
oracle of the ``dino`` feature mode (``oracle_config``), and ``ProbeModel``.
In probing mode the backbone runs under ``torch.no_grad()``, the counterpart
of the JAX package's ``stop_gradient`` on the features: the encoder is an
inference subgraph that autograd never records. With ``--finetuning`` it runs
under autograd and trains with the head; the oracle's attention never takes a
gradient.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch
import torch.nn as nn
from torch.overrides import TorchFunctionMode

from ep_tpu_torch.configs import TrainConfig
from ep_tpu_torch.ops import default_device
from ep_tpu_torch.poolings.common import mean_f32, normal_
from ep_tpu_torch.poolings.registry import ProbeHead
from ep_tpu_torch.runtime.profiler import span
from .mae import (MAEConfig, MaskedAutoencoderViT, mae_vit_base_patch16,
                  mae_vit_huge_patch14, mae_vit_large_patch16)
from .vit import (VIT_CONFIGS, ViTConfig, VisionTransformer, remap_features,
                  select_features, simmim_vit_base_patch16)
from .wrappers import (capi_config, dinov2_config, dinov3_config,
                       openclip_vit_config, siglip2_config)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "none": torch.float32, "float16": torch.bfloat16}
_MAE = {"mae_vit_base_patch16": mae_vit_base_patch16,
        "mae_vit_large_patch16": mae_vit_large_patch16,
        "mae_vit_huge_patch14": mae_vit_huge_patch14}


def build_backbone_config(cfg: TrainConfig) -> Union[ViTConfig, MAEConfig]:
    """Model-name dispatch (``ep_tpu/models/assembly.py::
    build_backbone_config``, the reference's main_linprobe.py:338-371)."""
    dtype = _DTYPES[cfg.amp]
    flags = dict(attn_impl=cfg.attn_impl, scan_blocks=cfg.scan_blocks,
                 remat_blocks=cfg.remat_blocks, remat_policy=cfg.remat_policy)
    kw = dict(img_size=cfg.image_size, dtype=dtype, int8_mlp=cfg.int8_mlp,
              **flags)
    if cfg.simmim:
        return simmim_vit_base_patch16(**kw)
    if cfg.openclip:
        return openclip_vit_config(cfg.model, cfg.image_size, dtype,
                                   pretrain=cfg.openclip_pretrain).replace(
                                       attn_impl=cfg.attn_impl)
    name = cfg.model
    if name.startswith("mae_vit"):
        # the encoder's latent, a full-token pass (mask_ratio=0); its blocks
        # take the kernels whatever --attn_impl says (MAEConfig.encoder_vit)
        if name not in _MAE:
            raise ValueError(f"unknown MAE model {name}")
        return _MAE[name](img_size=cfg.image_size, dtype=dtype)
    if name.startswith("capi"):
        return capi_config(cfg.image_size, dtype).replace(**flags)
    if name.startswith("dinov2"):
        return dinov2_config(name, cfg.image_size, dtype).replace(**flags)
    if name.startswith("dinov3"):
        return dinov3_config(name, cfg.image_size, dtype).replace(**flags)
    if name.startswith("siglip2"):
        _check_siglip2_features(cfg.cls_features)
        return siglip2_config(name, cfg.image_size, dtype).replace(**flags)
    if name not in VIT_CONFIGS:
        raise ValueError(f"unknown model {name}")
    extra = {}
    if "huge" in name:
        extra["class_token"] = not cfg.no_cls_token
    return VIT_CONFIGS[name](**extra).replace(**kw)


def _check_siglip2_features(cls_features: str) -> None:
    """SigLIP2's tower has neither [CLS] nor registers, so the feature modes
    that read a class token (``cls``, the ``_all`` poolings, ``ca*``,
    ``attn-*``) would read ``_finish``'s zero vector, or the first patch's
    attention as the class token's: refused, for this family only, so that
    the MAE-H tower without [CLS] keeps the JAX package's behaviour."""
    mode = remap_features(cls_features)
    if mode in ("cls", "both") or mode.startswith(("ca", "attn")):
        raise ValueError(
            f"--cls_features {cls_features}: SigLIP2 has no [CLS] token, and "
            "its MAP head (the model's own attentive pool) is not ported; "
            "probe its patch tokens with ep (or another attentive pooling), "
            "or with pos, their mean (the gap mode)")


def oracle_config(backbone_cfg: ViTConfig) -> ViTConfig:
    """The frozen DINO teacher of the ``dino`` feature mode: a plain ViT-B/16
    (timm's vit_base_patch16_224.dino) for a backbone 384 or more wide, else a
    plain twin of the backbone (``ep_tpu/models/assembly.py::oracle_config``)."""
    cfg = backbone_cfg.replace(
        init_values=None, rel_pos_bias="none", use_abs_pos_emb=True,
        qkv_bias_mode="full", class_token=True, reg_tokens=0,
        cls_from_registers=False, pre_norm=False, proj_dim=None,
        rope_base=None,
        scan_blocks=False)  # the oracle needs its final attention
    if backbone_cfg.embed_dim >= 384:
        cfg = cfg.replace(embed_dim=768, depth=12, num_heads=12,
                          patch_size=16)
    return cfg


def head_width(backbone_cfg, mode: str) -> int:
    """The width of the features the head gets: OpenCLIP's cls descriptors
    are ``proj_dim`` wide, every other mode the backbone's."""
    proj_dim = getattr(backbone_cfg, "proj_dim", None)
    return proj_dim if proj_dim and mode == "cls" else backbone_cfg.embed_dim


class ProbeModel(nn.Module):
    """backbone(features mode) -> head(pool, BN, linear). Batch statistics in
    the head's BN follow the module's ``train()``/``eval()`` mode."""

    def __init__(self, backbone_cfg: Union[ViTConfig, MAEConfig],
                 cfg: TrainConfig):
        super().__init__()
        self.finetuning = cfg.finetuning
        self.return_block = cfg.return_block
        self.mode = remap_features(cfg.cls_features)
        self.mae = isinstance(backbone_cfg, MAEConfig)
        if self.mae:
            self.backbone = MaskedAutoencoderViT(backbone_cfg, decoder=False)
        else:
            # hold what the JAX package creates for this feature mode: the
            # blocks up to return_block, OpenCLIP's proj on the cls path only
            self.backbone = VisionTransformer(backbone_cfg)
            if cfg.return_block is not None:
                self.backbone.keep_blocks(cfg.return_block + 1)
            if self.mode != "cls":
                self.backbone.proj = None
        self.oracle = (VisionTransformer(oracle_config(backbone_cfg))
                       if self.mode == "dino" and not self.mae else None)
        self.num_prefix_tokens = (1 if self.mae
                                  else backbone_cfg.num_prefix_tokens)
        self.head = ProbeHead(cfg, head_width(backbone_cfg, self.mode),
                              backbone_cfg.num_patches, backbone_cfg.dtype)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """The backbone's features for the head (``ProbeModel.__call__``
        before the head in the JAX package)."""
        if self.mae:
            latent, _, _ = self.backbone(images, mask_ratio=0.0,
                                         return_latent=True)
            return select_features(self.mode, latent, latent[:, 0],
                                   latent[:, 1:], None)
        if self.mode == "dino":
            # patch tokens of the probed backbone weighted by the oracle's
            # last cls-to-patch attention, which takes no gradient
            raw = self.backbone(images, "raw", self.return_block)
            fm = raw[:, self.num_prefix_tokens:]
            with torch.no_grad():
                _, (d_attn, _) = self.oracle(images, "cls",
                                             return_final_attn=True)
            d_attn = d_attn[:, :, 0, 1:]  # (B, H, N) f32
            return mean_f32(fm[:, None] * d_attn[..., None].to(fm.dtype),
                            (1, 2))
        return self.backbone(images, self.mode, self.return_block)

    def forward(self, images: torch.Tensor,
                return_backbone_features: bool = False,
                return_attn: bool = False):
        """images (B, H, W, 3) NHWC -> f32 logits (B, nb_classes). With
        ``return_backbone_features`` also the backbone's features (the
        descriptors kNN evaluation reads), with ``return_attn`` also the
        pool's attention map, in the JAX package's order: (logits, feats,
        attn), (logits, feats) or (logits, attn)
        (``ep_tpu/models/assembly.py``)."""
        grad = contextlib.nullcontext() if self.finetuning else torch.no_grad()
        with grad:
            feats = self.features(images)
        with span("ep::head"):
            out = self.head(feats, return_attn=return_attn)
        if not return_backbone_features:
            return out
        if return_attn:
            logits, attn = out
            return logits, feats, attn
        return out, feats

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator`` (:func:`init_backbone`
        for the backbone, then the oracle); the head by its modules' own
        initializers (``ProbeHead.init_weights``), after the backbone."""
        for m in (self.backbone, self.oracle):
            if m is not None:
                init_backbone(m, generator)
        self.head.init_weights(generator)


@torch.no_grad()
def init_backbone(module: nn.Module, generator: torch.Generator) -> None:
    """Draw a backbone's parameters (a ``VisionTransformer`` or a
    ``MaskedAutoencoderViT``) from ``generator`` in the order of
    ``named_parameters``, with the JAX package's initial distributions:
    lecun-normal dense kernels and zero biases, pos-embed N(0, 0.02),
    LayerScale at its constant, zero registers and bias tables, OpenCLIP's
    ``proj`` N(0, 1/D), MAE's ``cls_token`` and ``mask_token`` N(0, 0.02)."""
    mae = isinstance(module, MaskedAutoencoderViT)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("pos_embed") or (
                mae and leaf in ("cls_token", "mask_token")):
            normal_(p, 0.02, generator)
        elif leaf == "gamma":  # LayerScale
            p.fill_(module.cfg.init_values)
        elif leaf == "proj":  # OpenCLIP's (D, proj_dim) projection
            normal_(p, p.shape[0] ** -0.5, generator)
        elif "norm" in name:
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "weight":
            normal_(p, p[0].numel() ** -0.5, generator)
        else:  # biases, the [CLS] token, registers, rel-pos tables
            p.zero_()


def init_probe_model(cfg: TrainConfig, seed: int = 0,
                     backbone_cfg: Optional[ViTConfig] = None,
                     device=None) -> ProbeModel:
    """A ProbeModel on ``device`` (None: the card; raises where there is no
    CUDA device) with weights drawn from ``seed``. The weights are drawn from
    a CPU generator and then moved, so every device holds the same weights."""
    device = default_device(device)
    with SkipDefaultInit():
        model = ProbeModel(backbone_cfg or build_backbone_config(cfg), cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


class SkipDefaultInit(TorchFunctionMode):
    """Skips the functions of ``torch.nn.init``, which every module's
    constructor runs on its parameters. ``reset_parameters`` draws each of
    them anew, so those draws were thrown away (ViT-H/14's took 4 of 7 s on
    a CPU core); the weights are the same."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__module__", None) == "torch.nn.init":
            return args[0] if args else kwargs["tensor"]
        return func(*args, **(kwargs or {}))
