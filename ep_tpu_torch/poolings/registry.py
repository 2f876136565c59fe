"""Probe head: pool -> BatchNorm1d(affine=False, eps 1e-6) -> Linear.

Counterpart of ``ep_tpu/poolings/registry.py::ProbeHead``. This slice covers
the EP pool and plain linear probing (``cls``/``gap`` features: BN + Linear).
Every other pooling of the zoo is ROADMAP module item 6 and raises.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ep_tpu_torch.configs import TrainConfig
from ep_tpu_torch.models.vit import ATTENTIVE_POOLINGS
from .batchnorm import TorchBatchNorm
from .common import Dense
from .ep import EfficientProbing


def base_name(cls_features: str) -> str:
    return cls_features[:-4] if cls_features.endswith("_all") else cls_features


def build_pooling(cfg: TrainConfig, dim: int,
                  dtype: torch.dtype = torch.bfloat16) -> Optional[nn.Module]:
    """The pooling module for ``cfg.cls_features``, or None for plain LP."""
    name = base_name(cfg.cls_features)
    if name == "ep":
        return EfficientProbing(dim=dim, num_queries=cfg.ep_queries,
                                d_out=cfg.d_out, dtype=dtype)
    if name in ATTENTIVE_POOLINGS:
        raise NotImplementedError(
            f"pooling {name!r} is not ported yet (ROADMAP module item 6, "
            "the rest of the pooling zoo)")
    return None


def head_in_features(cfg: TrainConfig, dim: int) -> int:
    """Descriptor size entering the BN+Linear classifier."""
    if base_name(cfg.cls_features) == "ep":
        return dim // cfg.d_out
    return dim


class ProbeHead(nn.Module):
    def __init__(self, cfg: TrainConfig, dim: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.pool = build_pooling(cfg, dim, dtype)
        d_in = head_in_features(cfg, dim)
        self.bn = TorchBatchNorm(d_in, momentum=0.9, epsilon=1e-6, dtype=dtype)
        self.fc = Dense(d_in, cfg.nb_classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool is not None:
            x = self.pool(x)
        return self.fc(self.bn(x)).float()
