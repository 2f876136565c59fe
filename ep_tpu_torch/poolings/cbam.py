"""CBAM pooling ("cbam").

Counterpart of ``ep_tpu/poolings/cbam.py``: the tokens as a square NHWC grid;
channel attention (a shared 1x1-convolution MLP C → C/16 → C without bias
and ReLU, on the spatial mean and on the spatial max, a sigmoid gate);
spatial attention (the channel mean and max, a 7x7 convolution 2 → 1
without bias, "SAME" padding, an affine BatchNorm at eps 1e-5, a sigmoid
gate); the residual, ReLU and the spatial mean → (B, C).

The convolutions keep ``nn.Conv2d``'s parameter layout; a 1x1 convolution
on the NHWC grid is ``F.linear`` with its weight's (out, in) view, and the
7x7 one runs on NCHW around ``F.conv2d`` (padding 3), on its operands
widened to f32. Every kernel is flax's ``lecun_normal``. The maxima are
``amax``, which shares the gradient between ties as JAX does.
``return_attn`` gives the spatial gate (B, H, W, 1).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .batchnorm import TorchBatchNorm
from .common import lecun_normal_, mean_f32, tokens_to_grid


def _make_divisible(v: float, divisor: int = 1) -> int:
    return max(1, int(v + divisor / 2) // divisor * divisor)


def conv1x1(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """A 1x1 ``conv`` on an NHWC tensor, in ``dtype``."""
    w = conv.weight.to(dtype).reshape(conv.out_channels, conv.in_channels)
    b = None if conv.bias is None else conv.bias.to(dtype)
    return F.linear(x.to(dtype), w, b)


def init_conv_(conv: nn.Conv2d, kernel_init_, generator: torch.Generator) -> None:
    """``kernel_init_(weight, generator)``; a zero bias, flax's default."""
    kernel_init_(conv.weight, generator)
    if conv.bias is not None:
        with torch.no_grad():
            conv.bias.zero_()


def _lecun(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return lecun_normal_(w, w[0].numel(), generator)  # fan_in = in * kh * kw


class CbamPooling(nn.Module):
    def __init__(self, channels: int, rd_ratio: float = 1.0 / 16,
                 spatial_kernel_size: int = 7,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        C, k = channels, spatial_kernel_size
        rd = _make_divisible(C * rd_ratio)
        self.dtype = dtype
        self.fc1 = nn.Conv2d(C, rd, 1, bias=False)
        self.fc2 = nn.Conv2d(rd, C, 1, bias=False)
        self.spatial_conv = nn.Conv2d(2, 1, k, padding=k // 2, bias=False)
        self.spatial_bn = TorchBatchNorm(1, momentum=0.9, epsilon=1e-5,
                                         affine=True, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        for conv in (self.fc1, self.fc2, self.spatial_conv):
            init_conv_(conv, _lecun, generator)
        self.spatial_bn.reset_parameters()

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        return conv1x1(torch.relu(conv1x1(x, self.fc1, self.dtype)), self.fc2,
                       self.dtype)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        dt = self.dtype
        g = tokens_to_grid(x)  # (B, H, W, C)
        residual = g
        x_avg = self._mlp(mean_f32(g, (1, 2), keepdim=True))
        x_max = self._mlp(g.amax(dim=(1, 2), keepdim=True))
        g = g * torch.sigmoid(x_avg + x_max)

        sp = torch.cat([mean_f32(g, -1, keepdim=True),
                        g.amax(dim=-1, keepdim=True)], dim=-1)
        conv = self.spatial_conv
        sp = F.conv2d(sp.permute(0, 3, 1, 2).float(), conv.weight.to(dt).float(),
                      padding=conv.padding).to(dt).permute(0, 2, 3, 1)
        gate = torch.sigmoid(self.spatial_bn(sp))
        g = torch.relu(g * gate + residual)
        pooled = mean_f32(g, (1, 2))
        return (pooled, gate) if return_attn else pooled
