"""Backbone + probe-head assembly.

Counterpart of ``ep_tpu/models/assembly.py``. In probing mode the backbone
runs under ``torch.no_grad()``, the counterpart of the JAX package's
``stop_gradient`` on the features: the encoder is an inference subgraph that
autograd never records. With ``--finetuning`` it runs under autograd and
trains with the head.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ep_tpu_torch.configs import TrainConfig
from ep_tpu_torch.ops import default_device
from ep_tpu_torch.poolings.common import normal_
from ep_tpu_torch.poolings.registry import ProbeHead
from .vit import (_TODO_BACKBONE, FEATURE_MODES, VIT_CONFIGS, ViTConfig,
                  VisionTransformer, remap_features)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "none": torch.float32, "float16": torch.bfloat16}


def build_backbone_config(cfg: TrainConfig) -> ViTConfig:
    """Model-name dispatch for the plain ``vit_*`` backbones."""
    name = cfg.model
    if cfg.simmim or cfg.openclip or name.startswith(("mae_vit", "capi",
                                                        "dinov2")):
        raise NotImplementedError(
            f"backbone {name!r} is not ported yet (ROADMAP module item 7)")
    if name not in VIT_CONFIGS:
        raise ValueError(f"unknown model {name}")
    extra = {}
    if "huge" in name:
        extra["class_token"] = not cfg.no_cls_token
    return VIT_CONFIGS[name](**extra).replace(
        img_size=cfg.image_size, dtype=_DTYPES[cfg.amp],
        scan_blocks=cfg.scan_blocks, remat_blocks=cfg.remat_blocks,
        remat_policy=cfg.remat_policy, int8_mlp=cfg.int8_mlp)


class ProbeModel(nn.Module):
    """backbone(features mode) -> head(pool, BN, linear). Batch statistics in
    the head's BN follow the module's ``train()``/``eval()`` mode."""

    def __init__(self, backbone_cfg: ViTConfig, cfg: TrainConfig):
        super().__init__()
        if cfg.return_block is not None:
            raise NotImplementedError(
                "return_block is not ported yet (ROADMAP module item 7)")
        self.finetuning = cfg.finetuning
        self.mode = remap_features(cfg.cls_features)
        if self.mode not in FEATURE_MODES:
            raise NotImplementedError(
                f"--cls_features {cfg.cls_features} (feature mode "
                f"{self.mode!r}) {_TODO_BACKBONE}")
        self.backbone = VisionTransformer(backbone_cfg)
        self.head = ProbeHead(cfg, backbone_cfg.embed_dim,
                              backbone_cfg.num_patches, backbone_cfg.dtype)

    def forward(self, images: torch.Tensor,
                return_backbone_features: bool = False,
                return_attn: bool = False):
        """images (B, H, W, 3) NHWC -> f32 logits (B, nb_classes). With
        ``return_backbone_features`` also the backbone's features (the
        descriptors kNN evaluation reads), with ``return_attn`` also the
        pool's attention map, in the JAX package's order: (logits, feats,
        attn), (logits, feats) or (logits, attn)
        (``ep_tpu/models/assembly.py``)."""
        if self.finetuning:
            feats = self.backbone(images, self.mode)
        else:
            with torch.no_grad():
                feats = self.backbone(images, self.mode)
        out = self.head(feats, return_attn=return_attn)
        if not return_backbone_features:
            return out
        if return_attn:
            logits, attn = out
            return logits, feats, attn
        return out, feats

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator``, with the JAX package's
        initial distributions: lecun-normal dense kernels and zero biases in
        the backbone, pos-embed N(0, 0.02); the head by its modules' own
        initializers (``ProbeHead.init_weights``), after the backbone."""
        for name, p in self.backbone.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith("pos_embed"):
                normal_(p, 0.02, generator)
            elif "norm" in name:
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "weight":
                normal_(p, p[0].numel() ** -0.5, generator)
            else:  # biases and the [CLS] token
                p.zero_()
        self.head.init_weights(generator)


def init_probe_model(cfg: TrainConfig, seed: int = 0,
                     backbone_cfg: Optional[ViTConfig] = None,
                     device=None) -> ProbeModel:
    """A ProbeModel on ``device`` (None: the card; raises where there is no
    CUDA device) with weights drawn from ``seed``. The weights are drawn from
    a CPU generator and then moved, so every device holds the same weights."""
    device = default_device(device)
    model = ProbeModel(backbone_cfg or build_backbone_config(cfg), cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)
