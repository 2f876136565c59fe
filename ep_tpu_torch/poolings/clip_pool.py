"""CLIP-style AttentionPool2d and SigLIP-style latent attention pooling.

Counterpart of ``ep_tpu/poolings/clip_pool.py``.

``CLIPAttentionPool2d``: LayerNorm (eps 1e-6) on the tokens, their mean
prepended, a learned position embedding (feat_size² + 1, D) (flax
``truncated_normal(D^-0.5)``), a fused qkv weight (the same init, zero bias),
4 heads with the logits scaled after the product, an output projection; the
descriptor is token 0. Only token 0's output is read, so, as in the JAX
package, q is projected for token 0 alone from the first D rows of the fused
weight and k, v for every token from the rest: the values and the
parameters' gradients are those of the full self-attention.

``SigLIPAttentionPool``: a learned latent query (1, 1, D)
(``truncated_normal(D^-0.5)``), a q and a fused kv projection (with bias), 8
heads, an output projection, then a residual MLP (ratio 4, exact GELU) with
no pre-norm; token 0.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Dense, LayerNorm, mean_f32, pooled_mha, trunc_normal_


class CLIPAttentionPool2d(nn.Module):
    def __init__(self, in_features: int, feat_size: int = 14,
                 num_heads: int = 4, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        D = in_features
        self.num_heads = num_heads
        self.norm = LayerNorm(D, 1e-6, dtype)
        self.pos_embed = nn.Parameter(torch.zeros(feat_size ** 2 + 1, D))
        # a parameter holder: q and kv are products with row blocks of it
        self.qkv = Dense(D, 3 * D, bias=qkv_bias, dtype=dtype,
                         weight_init=lambda t, g: trunc_normal_(t, D ** -0.5, g))
        self.proj = Dense(D, D, dtype=dtype, fan_in=D)

    def init_weights(self, generator: torch.Generator) -> None:
        self.norm.init_weights()
        trunc_normal_(self.pos_embed, self.pos_embed.shape[1] ** -0.5,
                      generator)
        self.qkv.init_weights(generator)
        self.proj.init_weights(generator)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        D = self.pos_embed.shape[1]
        x = self.norm(x)
        x = torch.cat([mean_f32(x, 1, keepdim=True), x], dim=1)
        x = x + self.pos_embed[None].to(x.dtype)
        w = self.qkv.weight.to(x.dtype)
        kv = F.linear(x, w[D:])
        q0 = F.linear(x[:, :1], w[:D])
        if self.qkv.bias is not None:  # added after the product, as flax
            b = self.qkv.bias.to(x.dtype)
            kv = kv + b[D:]
            q0 = q0 + b[:D]
        out, attn = pooled_mha(q0, kv[:, :, :D], kv[:, :, D:], self.num_heads,
                               (D // self.num_heads) ** -0.5, scale_after=True)
        out = self.proj(out)[:, 0]
        return (out, attn[:, :, 0, 1:]) if return_attn else out


class SigLIPAttentionPool(nn.Module):
    def __init__(self, in_features: int, num_heads: int = 8,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 latent_len: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        C, hidden = in_features, int(in_features * mlp_ratio)
        self.num_heads = num_heads
        self.dtype = dtype
        self.latent = nn.Parameter(torch.zeros(1, latent_len, C))
        self.q = Dense(C, C, bias=qkv_bias, dtype=dtype, fan_in=C)
        self.kv = Dense(C, 2 * C, bias=qkv_bias, dtype=dtype, fan_in=C)
        self.proj = Dense(C, C, dtype=dtype, fan_in=C)
        self.mlp_fc1 = Dense(C, hidden, dtype=dtype, fan_in=C)
        self.mlp_fc2 = Dense(hidden, C, dtype=dtype, fan_in=hidden)

    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_(self.latent, self.latent.shape[-1] ** -0.5, generator)
        for m in (self.q, self.kv, self.proj, self.mlp_fc1, self.mlp_fc2):
            m.init_weights(generator)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        B, N, C = x.shape
        q = self.q(self.latent.to(self.dtype).expand(B, -1, -1))
        kv = self.kv(x)
        out, attn = pooled_mha(q, kv[:, :, :C], kv[:, :, C:], self.num_heads,
                               (C // self.num_heads) ** -0.5)
        out = self.proj(out)
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(out), approximate="none"))
        out = (out + h)[:, 0]
        return (out, attn) if return_attn else out
