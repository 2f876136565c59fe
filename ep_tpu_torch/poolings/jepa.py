"""I-JEPA attentive pooler ("jepa").

Counterpart of ``ep_tpu/poolings/jepa.py``: learned query tokens (flax
``truncated_normal(0.02)``); one cross-attention block, q += xattn(q,
LN₁(x)), q += MLP(LN₂(q)), with a q projection, a fused kv projection (both
with bias), ``num_heads`` heads (``--num_heads``), the logits scaled after the
product, and an output projection; every weight ``truncated_normal(0.02)``,
xattn's proj and the MLP's fc2 divided by √2, every bias zero; LayerNorms at
eps 1e-5; exact GELU.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Dense, LayerNorm, pooled_mha, trunc_normal_


class JEPAAttentivePooler(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int = 12,
                 mlp_ratio: float = 4.0, num_queries: int = 1,
                 qkv_bias: bool = True, init_std: float = 0.02,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        C, hidden = embed_dim, int(embed_dim * mlp_ratio)
        self.num_heads = num_heads
        self.num_queries = num_queries
        self.init_std = init_std
        self.dtype = dtype

        def tn(t, g):
            return trunc_normal_(t, init_std, g)

        def tn_rescaled(t, g):
            with torch.no_grad():
                return tn(t, g).div_(math.sqrt(2.0))

        self.query_tokens = nn.Parameter(torch.zeros(1, num_queries, C))
        self.norm1 = LayerNorm(C, 1e-5, dtype)
        self.xattn_q = Dense(C, C, bias=qkv_bias, dtype=dtype, weight_init=tn)
        self.xattn_kv = Dense(C, 2 * C, bias=qkv_bias, dtype=dtype,
                              weight_init=tn)
        self.xattn_proj = Dense(C, C, dtype=dtype, weight_init=tn_rescaled)
        self.norm2 = LayerNorm(C, 1e-5, dtype)
        self.mlp_fc1 = Dense(C, hidden, dtype=dtype, weight_init=tn)
        self.mlp_fc2 = Dense(hidden, C, dtype=dtype, weight_init=tn_rescaled)

    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_(self.query_tokens, self.init_std, generator)
        for m in (self.norm1, self.xattn_q, self.xattn_kv, self.xattn_proj,
                  self.norm2, self.mlp_fc1, self.mlp_fc2):
            m.init_weights(generator)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        B, N, C = x.shape
        q_in = self.query_tokens.to(self.dtype).expand(B, -1, -1)
        kv = self.xattn_kv(self.norm1(x))
        y, attn = pooled_mha(self.xattn_q(q_in), kv[:, :, :C], kv[:, :, C:],
                             self.num_heads, (C // self.num_heads) ** -0.5,
                             scale_after=True)
        q_out = q_in + self.xattn_proj(y)
        h = self.mlp_fc1(self.norm2(q_out))
        q_out = q_out + self.mlp_fc2(F.gelu(h, approximate="none"))
        pooled = q_out[:, 0] if self.num_queries == 1 else q_out.squeeze(1)
        return (pooled, attn) if return_attn else pooled
