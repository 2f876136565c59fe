"""Backbone family and assembly (counterpart of ``ep_tpu.models``)."""
from .assembly import (ProbeModel, build_backbone_config, init_probe_model,
                       oracle_config)
from .mae import (MAEConfig, MaskedAutoencoderViT, mae_vit_base_patch16,
                  mae_vit_huge_patch14, mae_vit_large_patch16)
from .vit import (VIT_CONFIGS, Attention, Block, ViTConfig, VisionTransformer,
                  remap_features, simmim_vit_base_patch16, vit_base_patch16,
                  vit_huge_patch14, vit_large_patch16, vit_small_patch16,
                  vit_tiny_patch16)
from .wrappers import capi_config, dinov2_config, openclip_vit_config

__all__ = [
    "ProbeModel", "build_backbone_config", "init_probe_model", "oracle_config",
    "MAEConfig", "MaskedAutoencoderViT", "mae_vit_base_patch16",
    "mae_vit_huge_patch14", "mae_vit_large_patch16",
    "VIT_CONFIGS", "Attention", "Block", "ViTConfig", "VisionTransformer",
    "remap_features", "simmim_vit_base_patch16", "vit_base_patch16",
    "vit_huge_patch14", "vit_large_patch16", "vit_small_patch16",
    "vit_tiny_patch16",
    "capi_config", "dinov2_config", "openclip_vit_config",
]
