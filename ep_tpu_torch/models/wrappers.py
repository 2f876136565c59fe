"""Backbone configs of the hub-style families (DINOv2, CAPI, OpenCLIP).

Counterpart of ``ep_tpu/models/wrappers.py``, with the same numbers: each
family is a ``ViTConfig`` of the one Vision Transformer, whose feature modes
route cls against patch tokens (``vit.py::select_features``), and a key map
in ``convert/torch_vit.py``.

  * DINOv2: register tokens are left out of the patch stream (they are prefix
    tokens); the giant tower uses SwiGLU.
  * CAPI: no [CLS]; ``cls`` is the register mean (``cls_from_registers``).
  * OpenCLIP: ln_pre, ln_post over all tokens, and the visual projection on
    the cls path only (``proj_dim``).
"""
from __future__ import annotations

import torch

from .vit import ViTConfig


def dinov2_config(name: str, image_size: int = 224,
                  dtype: torch.dtype = torch.bfloat16) -> ViTConfig:
    """DINOv2 towers: patch 14, LayerScale 1e-5, final LN; '_reg' variants
    carry 4 register tokens; the giant tower uses SwiGLU."""
    dims = {"vits14": (384, 12, 6), "vitb14": (768, 12, 12),
            "vitl14": (1024, 24, 16), "vitg14": (1536, 40, 24)}
    core = name.replace("dinov2_", "").replace("_reg", "")
    d, depth, heads = dims.get(core, (1024, 24, 16))
    reg = 4 if name.endswith("_reg") else 0
    return ViTConfig(
        img_size=image_size, patch_size=14, embed_dim=d, depth=depth,
        num_heads=heads, init_values=1e-5, final_norm="ln",
        reg_tokens=reg, mlp_type="swiglu" if core == "vitg14" else "gelu",
        dtype=dtype,
    )


def capi_config(image_size: int = 224,
                dtype: torch.dtype = torch.bfloat16) -> ViTConfig:
    """CAPI ViT-L/14: no [CLS], 16 register tokens, global_repr = register
    mean, final LN."""
    return ViTConfig(img_size=image_size, patch_size=14, embed_dim=1024,
                     depth=24, num_heads=16, final_norm="ln",
                     class_token=False, reg_tokens=16,
                     cls_from_registers=True, dtype=dtype)


def openclip_vit_config(name: str, image_size: int = 224,
                        dtype: torch.dtype = torch.bfloat16,
                        pretrain: str = "openai") -> ViTConfig:
    """OpenCLIP visual towers: ln_pre (pre_norm), final LN (ln_post over all
    tokens), the cls-only visual projection (proj_dim). OpenAI-pretrained
    towers use QuickGELU; laion-trained ones plain GELU."""
    dims = {"ViT-B-16": (768, 12, 12, 16, 512),
            "ViT-L-14": (1024, 24, 16, 14, 768),
            "ViT-L-16": (1024, 24, 16, 16, 768)}
    d, depth, heads, patch, proj = dims.get(name, (1024, 24, 16, 14, 768))
    return ViTConfig(img_size=image_size, patch_size=patch, embed_dim=d,
                     depth=depth, num_heads=heads, final_norm="ln",
                     norm_eps=1e-5, pre_norm=True, proj_dim=proj,
                     mlp_type="quick_gelu" if pretrain == "openai" else "gelu",
                     dtype=dtype)
