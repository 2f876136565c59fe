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
from ep_tpu_torch.poolings.common import normal_, torch_bias_init_, torch_linear_init_
from ep_tpu_torch.poolings.registry import ProbeHead
from .vit import VIT_CONFIGS, ViTConfig, VisionTransformer, remap_features

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
        self.backbone = VisionTransformer(backbone_cfg)
        self.head = ProbeHead(cfg, backbone_cfg.embed_dim, backbone_cfg.dtype)

    def forward(self, images: torch.Tensor,
                return_backbone_features: bool = False):
        """images (B, H, W, 3) NHWC -> f32 logits (B, nb_classes); with
        ``return_backbone_features`` (logits, the backbone's features), the
        descriptors kNN evaluation reads (``ep_tpu/models/assembly.py``)."""
        if self.finetuning:
            feats = self.backbone(images, self.mode)
        else:
            with torch.no_grad():
                feats = self.backbone(images, self.mode)
        logits = self.head(feats)
        return (logits, feats) if return_backbone_features else logits

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator``, with the JAX package's
        initial distributions: lecun-normal dense kernels and zero biases in
        the backbone, pos-embed N(0, 0.02), EP queries N(0, 0.02), torch-Linear
        uniform for the head's projections."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.startswith("head."):
                if name == "head.pool.cls_token":
                    normal_(p, 0.02, generator)
                elif leaf == "weight":
                    torch_linear_init_(p, generator)
                else:  # the classifier's bias
                    torch_bias_init_(p, self.head.fc.in_features, generator)
            elif name.endswith("pos_embed"):
                normal_(p, 0.02, generator)
            elif "norm" in name:
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "weight":
                normal_(p, p[0].numel() ** -0.5, generator)
            else:  # biases and the [CLS] token
                p.zero_()


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
