"""The pooling zoo's registry and the probe head: pool -> BatchNorm1d(affine
off, eps 1e-6) -> Linear.

Counterpart of ``ep_tpu/poolings/registry.py``: :func:`build_pooling` takes
every ``--cls_features`` name with the JAX dispatch (the ``_all`` names use the
same pool on [CLS] + patch tokens; clip, cbam and dolg reshape the tokens to
a square grid and refuse their ``_all`` names with the JAX package's
``ValueError``). The BatchNorm pools (aim, cbam, dolg) follow the module's
``train()``/``eval()``, as the descriptor BN does.

``ProbeHead.forward(x, return_attn=True)`` gives ``(logits, attn)``, the map
being the pool's (None for plain linear probing and for cait, whose class
attention keeps none).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ep_tpu_torch.configs import TrainConfig
from .abmilp import ABMILPHead
from .aim import AIMAttentionPooling
from .batchnorm import TorchBatchNorm
from .cae import CAEAttentiveBlock
from .cait import CaiTPooling
from .cbam import CbamPooling
from .clip_pool import CLIPAttentionPool2d, SigLIPAttentionPool
from .coca import CoCaCrossAttnPooling
from .common import Dense
from .dinovit import DinoViTBlockPooling
from .dolg import DOLGSpatialAttention
from .ep import EfficientProbing
from .jepa import JEPAAttentivePooler
from .simpool import SimPool, SimPoolNoLinears


def base_name(cls_features: str) -> str:
    return cls_features[:-4] if cls_features.endswith("_all") else cls_features


def build_pooling(cfg: TrainConfig, dim: int, num_patches: Optional[int] = None,
                  dtype: torch.dtype = torch.bfloat16) -> Optional[nn.Module]:
    """The pooling module for ``cfg.cls_features``, or None for plain LP."""
    name = base_name(cfg.cls_features)
    if cfg.cls_features.endswith("_all") and name in ("clip", "cbam", "dolg"):
        raise ValueError(
            f"--cls_features {cfg.cls_features}: the grid-reshaping "
            f"poolings (clip/cbam/dolg) cannot consume the [CLS]-prepended "
            f"N+1 token sequence the _all variants produce (N+1 is never a "
            f"square grid); the reference CLI exposes this name but its own "
            f"module crashes identically. Use '{name}' (patch tokens only).")
    if name == "abmilp":
        return ABMILPHead(
            dim=dim, self_attention_apply_to=cfg.abmilp_sa,
            activation=cfg.abmilp_act, depth=cfg.abmilp_depth,
            cond=cfg.abmilp_cond, content=cfg.abmilp_content,
            num_patches=num_patches, dtype=dtype)
    if name == "simpool":
        return SimPool(dim=dim, num_heads=1, dtype=dtype)
    if name == "esimpool":
        return SimPoolNoLinears(dim=dim, num_heads=12, dtype=dtype)
    if name == "clip":
        # 16 for CAPI, else 14 (the reference's sizes); another grid than
        # that takes its own size
        feat_size = 16 if cfg.model == "capi_vitl14_in1k" else 14
        if feat_size * feat_size != num_patches:
            feat_size = int(round(num_patches ** 0.5))
            if feat_size * feat_size != num_patches:
                raise ValueError(
                    f"clip pooling requires a square token grid; got "
                    f"{num_patches} patch tokens (no integer feat_size)")
        return CLIPAttentionPool2d(in_features=dim, feat_size=feat_size,
                                   dtype=dtype)
    if name == "siglip":
        return SigLIPAttentionPool(in_features=dim, dtype=dtype)
    if name == "aim":
        return AIMAttentionPooling(dim=dim, num_heads=cfg.num_heads, dtype=dtype)
    if name == "ep":
        return EfficientProbing(dim=dim, num_queries=cfg.ep_queries,
                                d_out=cfg.d_out, dtype=dtype)
    if name == "cbam":
        return CbamPooling(channels=dim, spatial_kernel_size=7, dtype=dtype)
    if name == "coca":
        return CoCaCrossAttnPooling(dim=dim, dtype=dtype)
    if name == "cait":
        return CaiTPooling(embed_dim=dim, dtype=dtype)
    if name == "dinovit":
        return DinoViTBlockPooling(d_model=dim, dtype=dtype)
    if name == "jepa":
        return JEPAAttentivePooler(embed_dim=dim, num_heads=cfg.num_heads,
                                   dtype=dtype)
    if name == "dolg":
        return DOLGSpatialAttention(in_c=dim, s3_dim=dim, dtype=dtype)
    if name == "cae":
        return CAEAttentiveBlock(dim=dim, dtype=dtype)
    return None  # plain LP: BN + Linear only


def head_in_features(cfg: TrainConfig, dim: int) -> int:
    """Descriptor size entering the BN+Linear classifier."""
    if base_name(cfg.cls_features) == "ep":
        return dim // cfg.d_out
    return dim


class ProbeHead(nn.Module):
    def __init__(self, cfg: TrainConfig, dim: int,
                 num_patches: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cls_features = cfg.cls_features
        self.pool = build_pooling(cfg, dim, num_patches, dtype)
        d_in = head_in_features(cfg, dim)
        self.bn = TorchBatchNorm(d_in, momentum=0.9, epsilon=1e-6, dtype=dtype)
        self.fc = Dense(d_in, cfg.nb_classes, dtype=dtype, fan_in=d_in)
        self._warned = False

    def init_weights(self, generator: torch.Generator) -> None:
        """The pool's own init (the JAX package's initializers), then the
        classifier's torch-Linear draws; the BN's running statistics reset."""
        if self.pool is not None:
            self.pool.init_weights(generator)
        self.bn.reset_running_stats()
        self.fc.init_weights(generator)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        attn = None
        if self.pool is None and x.ndim == 3 and not self._warned:
            # the reference's Sequential(BN1d, Linear) fails on tokens; BN
            # runs over the last axis here, as in the JAX package
            self._warned = True
            print(f"[warn] --cls_features {self.cls_features} feeds "
                  f"token-shaped {tuple(x.shape)} features into a plain "
                  f"LP head (the reference errors here); did you mean a "
                  f"pooling head or cls/gap?")
        if self.pool is not None:
            out = self.pool(x, return_attn=return_attn)
            x, attn = out if return_attn else (out, None)
        logits = self.fc(self.bn(x)).float()
        return (logits, attn) if return_attn else logits
