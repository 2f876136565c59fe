"""Backbone configs of the hub-style families (DINOv2, DINOv3, CAPI,
OpenCLIP, SigLIP2).

Counterpart of ``ep_tpu/models/wrappers.py``, with the same numbers: each
family is a ``ViTConfig`` of the one Vision Transformer, whose feature modes
route cls against patch tokens (``vit.py::select_features``), and a key map
in ``convert/torch_vit.py``.

  * DINOv2: register tokens are left out of the patch stream (they are prefix
    tokens); the giant tower uses SwiGLU. Two departures from the JAX
    package, to the hub's layout (``dinov2/hub/backbones.py``): the giant's
    SwiGLU hidden width is DINOv2's (:func:`swiglu_hidden`: 4096 at D=1536,
    where the JAX package keeps 4 * D), and a ``_reg`` tower's position
    embedding has no rows for its registers (``reg_pos_embed=False``).
  * DINOv3 (the port's alone; the JAX package has no DINOv3): no absolute
    position embedding, 2D axial RoPE on q and k of the patch tokens
    (``rope_base``), 4 storage tokens as registers after [CLS], no qkv bias,
    LayerScale, a SwiGLU FFN at the hub's ``swiglu64`` width, LayerNorm eps
    1e-5 and a final LayerNorm (:func:`dinov3_config`).
  * CAPI: no [CLS]; ``cls`` is the register mean (``cls_from_registers``).
  * OpenCLIP: ln_pre, ln_post over all tokens, and the visual projection on
    the cls path only (``proj_dim``).
  * SigLIP2 (the port's alone): no [CLS] and no registers, a learned
    position embedding of one row a patch, the tanh GELU at every precision,
    LayerNorm eps 1e-6 and ``post_layernorm`` over every token
    (:func:`siglip2_config`). Its MAP head (the model's own attentive pool)
    is not ported: the probe head pools the patch tokens.
"""
from __future__ import annotations

import torch

from .vit import ViTConfig


def swiglu_hidden(dim: int) -> int:
    """DINOv2's SwiGLU hidden width (``dinov2/layers/swiglu_ffn.py::
    SwiGLUFFNFused`` at ``mlp_ratio`` 4): two thirds of ``4 * dim``, rounded
    up to a multiple of 8."""
    return (int(dim * 4 * 2 / 3) + 7) // 8 * 8


def dinov2_config(name: str, image_size: int = 224,
                  dtype: torch.dtype = torch.bfloat16) -> ViTConfig:
    """DINOv2 towers: patch 14, LayerScale 1e-5, final LN; '_reg' variants
    carry 4 register tokens outside the position embedding; the giant tower
    uses SwiGLU at the hub's hidden width, carried as ``mlp_ratio`` so that
    ``int(embed_dim * mlp_ratio)`` reads it."""
    dims = {"vits14": (384, 12, 6), "vitb14": (768, 12, 12),
            "vitl14": (1024, 24, 16), "vitg14": (1536, 40, 24)}
    core = name.replace("dinov2_", "").replace("_reg", "")
    d, depth, heads = dims.get(core, (1024, 24, 16))
    reg = 4 if name.endswith("_reg") else 0
    swiglu = core == "vitg14"
    ratio = swiglu_hidden(d) / d if swiglu else 4.0
    return ViTConfig(
        img_size=image_size, patch_size=14, embed_dim=d, depth=depth,
        num_heads=heads, mlp_ratio=ratio, init_values=1e-5, final_norm="ln",
        reg_tokens=reg, reg_pos_embed=False,
        mlp_type="swiglu" if swiglu else "gelu", dtype=dtype,
    )


def dinov3_config(name: str, image_size: int = 224,
                  dtype: torch.dtype = torch.bfloat16) -> ViTConfig:
    """DINOv3 ViT-7B/16, the hub's ``dinov3_vit7b16``
    (``dinov3/hub/backbones.py``): D=4096, depth 40, 32 heads of 128, patch
    16, RoPE base 100 (``pos_embed_rope_base``), no qkv bias, LayerScale
    1e-5, 4 storage tokens, no absolute position embedding, LayerNorm eps
    1e-5 (``layernormbf16``) and a final LayerNorm. Its ``swiglu64`` FFN at
    ``ffn_ratio`` 3 is ``int(3 * 4096 * 2 / 3)`` = 8192 wide, rounded up to
    a multiple of 64, carried as ``mlp_ratio`` 2 so that ``int(embed_dim *
    mlp_ratio)`` reads it."""
    if name != "dinov3_vit7b16":
        raise ValueError(f"unknown DINOv3 model {name} (dinov3_vit7b16)")
    d = 4096
    hidden = (int(d * 3 * 2 / 3) + 63) // 64 * 64
    return ViTConfig(
        img_size=image_size, patch_size=16, embed_dim=d, depth=40,
        num_heads=32, mlp_ratio=hidden / d, qkv_bias=False, init_values=1e-5,
        final_norm="ln", norm_eps=1e-5, reg_tokens=4, use_abs_pos_emb=False,
        mlp_type="swiglu", rope_base=100.0, dtype=dtype)


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


def siglip2_config(name: str, image_size: int = 384,
                   dtype: torch.dtype = torch.bfloat16) -> ViTConfig:
    """SigLIP2 SO400M/14's vision tower (google/siglip2-so400m-patch14-384,
    transformers' ``SiglipVisionTransformer``): D=1152, depth 27, 16 heads
    of 72, an MLP of hidden 4304 with ``gelu_pytorch_tanh``, biases on every
    product, LayerNorm eps 1e-6, no [CLS], a learned position embedding with
    a row for each of the image's patches, and a final LayerNorm
    (``post_layernorm``). The patch embedding is a valid convolution: at 384
    px, 27 patches a side, T=729. The hidden width is carried as
    ``mlp_ratio`` 4304 / 1152, which ``int(embed_dim * mlp_ratio)`` reads
    back as 4304."""
    if name != "siglip2_so400m_patch14":
        raise ValueError(f"unknown SigLIP2 model {name} "
                         "(siglip2_so400m_patch14)")
    d = 1152
    return ViTConfig(
        img_size=image_size, patch_size=14, embed_dim=d, depth=27,
        num_heads=16, mlp_ratio=4304 / d, class_token=False, final_norm="ln",
        norm_eps=1e-6, mlp_type="gelu_tanh", dtype=dtype)
