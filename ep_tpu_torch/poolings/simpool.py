"""SimPool and eSimPool attentive pooling.

Counterpart of ``ep_tpu/poolings/simpool.py``:

* SimPool: the GAP query and LayerNorm'd keys and values, learned q and k
  projections (no bias), one-head cross-attention, the logits scaled after
  the product;
* SimPool_nolinears ("esimpool"): no projections, LayerNorm'd query and
  keys, raw values, 12 heads (fixed at the registry).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .common import Dense, LayerNorm, mean_f32, pooled_mha


class SimPool(nn.Module):
    def __init__(self, dim: int, num_heads: int = 1, qkv_bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.norm_patches = LayerNorm(dim, 1e-6, dtype)
        self.wq = Dense(dim, dim, bias=qkv_bias, dtype=dtype)
        self.wk = Dense(dim, dim, bias=qkv_bias, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        self.norm_patches.init_weights()
        self.wq.init_weights(generator)
        self.wk.init_weights(generator)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        d = x.shape[-1]
        scale = (d // self.num_heads) ** -0.5
        gap = mean_f32(x, -2, keepdim=True)  # (B, 1, d)
        xn = self.norm_patches(x)
        out, attn = pooled_mha(self.wq(gap), self.wk(xn), xn, self.num_heads,
                               scale, scale_after=True)
        out = out[:, 0]
        return (out, attn) if return_attn else out


class SimPoolNoLinears(nn.Module):
    def __init__(self, dim: int, num_heads: int = 12,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.norm_patches = LayerNorm(dim, 1e-6, dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        self.norm_patches.init_weights()

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        d = x.shape[-1]
        scale = (d // self.num_heads) ** -0.5
        ln = self.norm_patches
        out, attn = pooled_mha(ln(mean_f32(x, -2, keepdim=True)), ln(x), x,
                               self.num_heads, scale, scale_after=True)
        out = out[:, 0]
        return (out, attn) if return_attn else out
