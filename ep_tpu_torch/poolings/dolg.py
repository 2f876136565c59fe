"""DOLG local-branch spatial attention pooling ("dolg").

Counterpart of ``ep_tpu/poolings/dolg.py``: the tokens as a square NHWC grid;
a 1x1 convolution C → s3 (ResNet init, N(0, 2/fan_out), zero bias), an affine
BatchNorm (eps 1e-5); the BN output L2-normalised over the channels (the norm
in f32, clipped at 1e-12) before the ReLU; ReLU, a 1x1 convolution s3 → 1,
softplus in f32 as the attention score; the descriptor is the spatial mean of
score × normalised features. ``return_attn`` gives the score (B, H, W, 1).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .batchnorm import TorchBatchNorm
from .cbam import conv1x1, init_conv_
from .common import mean_f32, normal_, tokens_to_grid


def _resnet_conv_init_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """N(0, 2/fan_out), fan_out = kh * kw * out."""
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    return normal_(w, math.sqrt(2.0 / fan_out), generator)


class DOLGSpatialAttention(nn.Module):
    def __init__(self, in_c: int, s3_dim: int = 1024, act_fn: str = "relu",
                 bn_eps: float = 1e-5, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.act_fn = act_fn
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_c, s3_dim, 1)
        self.bn = TorchBatchNorm(s3_dim, momentum=0.9, epsilon=bn_eps,
                                 affine=True, dtype=dtype)
        self.conv2 = nn.Conv2d(s3_dim, 1, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        init_conv_(self.conv1, _resnet_conv_init_, generator)
        self.bn.reset_parameters()
        init_conv_(self.conv2, _resnet_conv_init_, generator)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        g = self.bn(conv1x1(tokens_to_grid(x), self.conv1, self.dtype))
        norm = torch.linalg.vector_norm(g.float(), dim=-1, keepdim=True)
        fmap_norm = g / norm.clamp(min=1e-12).to(g.dtype)
        h = torch.relu(g) if self.act_fn == "relu" else F.leaky_relu(g)
        att = F.softplus(conv1x1(h, self.conv2, self.dtype).float()).to(g.dtype)
        out = mean_f32(att * fmap_norm, (1, 2))
        return (out, att) if return_attn else out
