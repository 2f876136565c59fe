"""CAE attentive probe ("cae").

Counterpart of ``ep_tpu/poolings/cae.py``: one learned query token
initialised to zeros, separately LayerNorm'd query, keys and values (eps
1e-5), q, k and v projections without bias, 8 heads, an output projection
with a bias; no residual.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .common import Dense, LayerNorm, pooled_mha


class CAEAttentiveBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.query_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.norm1_q = LayerNorm(dim, 1e-5, dtype)
        self.norm1_k = LayerNorm(dim, 1e-5, dtype)
        self.norm1_v = LayerNorm(dim, 1e-5, dtype)
        self.q = Dense(dim, dim, bias=False, dtype=dtype)
        self.k = Dense(dim, dim, bias=False, dtype=dtype)
        self.v = Dense(dim, dim, bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype, fan_in=dim)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.query_token.zero_()
        for m in (self.norm1_q, self.norm1_k, self.norm1_v, self.q, self.k,
                  self.v, self.proj):
            m.init_weights(generator)

    def forward(self, x_kv: torch.Tensor, return_attn: bool = False):
        B, N, C = x_kv.shape
        q_tok = self.query_token.to(self.dtype).expand(B, -1, -1)
        q = self.q(self.norm1_q(q_tok))
        k = self.k(self.norm1_k(x_kv))
        v = self.v(self.norm1_v(x_kv))
        out, attn = pooled_mha(q, k, v, self.num_heads,
                               (C // self.num_heads) ** -0.5)
        pooled = self.proj(out)[:, 0]
        return (pooled, attn) if return_attn else pooled
