"""AIM attentive-probe pooling.

Counterpart of ``ep_tpu/poolings/aim.py``: a BatchNorm over the channels
(affine off, eps 1e-6, statistics over batch and tokens, running statistics
in eval), one learned query (N(0, 0.02)), k and v projections without bias,
``num_heads``-head attention (``--num_heads``), the mean over the queries.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .batchnorm import TorchBatchNorm
from .common import Dense, mean_f32, normal_, pooled_mha


class AIMAttentionPooling(nn.Module):
    def __init__(self, dim: int, num_heads: int = 12, qkv_bias: bool = False,
                 num_queries: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.bn = TorchBatchNorm(dim, momentum=0.9, epsilon=1e-6, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, num_queries, dim))
        self.k = Dense(dim, dim, bias=qkv_bias, dtype=dtype)
        self.v = Dense(dim, dim, bias=qkv_bias, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.cls_token, 0.02, generator)
        self.k.init_weights(generator)
        self.v.init_weights(generator)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        B, N, C = x.shape
        x = self.bn(x)
        q = self.cls_token.to(self.dtype).expand(B, -1, -1)
        out, attn = pooled_mha(q, self.k(x), self.v(x), self.num_heads,
                               (C // self.num_heads) ** -0.5)
        out = mean_f32(out, 1)
        return (out, attn) if return_attn else out
