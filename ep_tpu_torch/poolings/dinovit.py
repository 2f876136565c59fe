"""DINOv2-block pooling ("dinovit").

Counterpart of ``ep_tpu/poolings/dinovit.py``: one whole pre-norm
transformer block over the tokens (8 heads, qkv without bias, proj with
bias, no LayerScale, LayerNorms at eps 1e-5, exact-GELU MLP of ratio 4), then
the mean over the tokens. The attention is ``ops/attention.py::mha``.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ep_tpu_torch.ops.attention import mha
from .common import Dense, LayerNorm, mean_f32


class DinoViTBlockPooling(nn.Module):
    def __init__(self, d_model: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        C, hidden = d_model, int(d_model * mlp_ratio)
        self.num_heads = num_heads
        self.norm1 = LayerNorm(C, 1e-5, dtype)
        self.qkv = Dense(C, 3 * C, bias=False, dtype=dtype)
        self.proj = Dense(C, C, dtype=dtype, fan_in=C)
        self.norm2 = LayerNorm(C, 1e-5, dtype)
        self.mlp_fc1 = Dense(C, hidden, dtype=dtype, fan_in=C)
        self.mlp_fc2 = Dense(hidden, C, dtype=dtype, fan_in=hidden)

    def init_weights(self, generator: torch.Generator) -> None:
        for m in (self.norm1, self.qkv, self.proj, self.norm2, self.mlp_fc1,
                  self.mlp_fc2):
            m.init_weights(generator)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        B, N, C = x.shape
        H = self.num_heads
        qkv = self.qkv(self.norm1(x)).reshape(B, N, 3, H, C // H)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        y = mha(q, k, v, (C // H) ** -0.5, return_probs=return_attn)
        attn = None
        if return_attn:
            y, attn = y
        x = x + self.proj(y.transpose(1, 2).reshape(B, N, C))
        m = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none"))
        pooled = mean_f32(x + m, 1)
        return (pooled, attn) if return_attn else pooled
