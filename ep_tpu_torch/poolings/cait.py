"""CaiT class-attention pooling ("cait").

Counterpart of ``ep_tpu/poolings/cait.py``: a learned cls token (flax
``truncated_normal(0.02)``); ``iterations`` LayerScale class-attention blocks,
u = [cls; x], cls += γ₁·ClassAttention(LN₁(u)), cls += γ₂·Mlp(LN₂(cls)), with
γ initialised to 1e-5, the block norms at eps 1e-6, 4 heads and q, k, v
biases; then a LayerNorm at eps 1e-5 of the cls row. Parameter names are the
JAX package's flat ``blocks_token_only_{i}_*``.

``return_attn`` gives ``(pooled, None)``: the class attention's map is not
kept. The JAX module ignores the flag and returns the array alone, which its
``ProbeHead`` then unpacks as a pair (ROADMAP §3, "Differences kept on
purpose").
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Dense, LayerNorm, pooled_mha, trunc_normal_


class _ClassAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 4, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.q = Dense(dim, dim, bias=qkv_bias, dtype=dtype, fan_in=dim)
        self.k = Dense(dim, dim, bias=qkv_bias, dtype=dtype, fan_in=dim)
        self.v = Dense(dim, dim, bias=qkv_bias, dtype=dtype, fan_in=dim)
        self.proj = Dense(dim, dim, dtype=dtype, fan_in=dim)

    def init_weights(self, generator: torch.Generator) -> None:
        for m in (self.q, self.k, self.v, self.proj):
            m.init_weights(generator)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        C = u.shape[-1]
        out, _ = pooled_mha(self.q(u[:, :1]), self.k(u), self.v(u),
                            self.num_heads, (C // self.num_heads) ** -0.5)
        return self.proj(out)


class CaiTPooling(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int = 4, iterations: int = 1,
                 mlp_ratio: float = 4.0, init_scale: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        D, hidden = embed_dim, int(embed_dim * mlp_ratio)
        self.iterations = iterations
        self.init_scale = init_scale
        self.dtype = dtype
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        for i in range(iterations):
            blk = f"blocks_token_only_{i}"
            setattr(self, f"{blk}_gamma_1", nn.Parameter(torch.zeros(D)))
            setattr(self, f"{blk}_gamma_2", nn.Parameter(torch.zeros(D)))
            setattr(self, f"{blk}_norm1", LayerNorm(D, 1e-6, dtype))
            setattr(self, f"{blk}_attn",
                    _ClassAttention(D, num_heads, dtype=dtype))
            setattr(self, f"{blk}_norm2", LayerNorm(D, 1e-6, dtype))
            setattr(self, f"{blk}_mlp_fc1", Dense(D, hidden, dtype=dtype,
                                                  fan_in=D))
            setattr(self, f"{blk}_mlp_fc2", Dense(hidden, D, dtype=dtype,
                                                  fan_in=hidden))
        self.norm = LayerNorm(D, 1e-5, dtype)

    def _block(self, i: int, name: str):
        return getattr(self, f"blocks_token_only_{i}_{name}")

    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_(self.cls_token, 0.02, generator)
        for i in range(self.iterations):
            with torch.no_grad():
                self._block(i, "gamma_1").fill_(self.init_scale)
                self._block(i, "gamma_2").fill_(self.init_scale)
            for name in ("norm1", "attn", "norm2", "mlp_fc1", "mlp_fc2"):
                self._block(i, name).init_weights(generator)
        self.norm.init_weights()

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        B, N, D = x.shape
        dt = self.dtype
        cls = self.cls_token.to(dt).expand(B, -1, -1)
        for i in range(self.iterations):
            blk = lambda name: self._block(i, name)  # noqa: E731
            u = torch.cat([cls, x], dim=1)
            a = blk("attn")(blk("norm1")(u))
            cls = cls + blk("gamma_1").to(dt) * a
            m = blk("mlp_fc1")(blk("norm2")(cls))
            m = blk("mlp_fc2")(F.gelu(m, approximate="none"))
            cls = cls + blk("gamma_2").to(dt) * m
        # the JAX package norms the cls row alone: LayerNorm is per token
        out = self.norm(cls)[:, 0]
        return (out, None) if return_attn else out
