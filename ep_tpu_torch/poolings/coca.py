"""CoCa-style multi-query cross-attention pooling.

Counterpart of ``ep_tpu/poolings/coca.py``: 196 learned image queries
(N(0, 1)), a LayerNorm on the queries only (flax's default eps, 1e-6), a q
projection to 8 heads of 64 (no bias) and a fused kv projection to one
shared head of 64 (multi-query attention), the softmax of the logits less
their row maximum, an output projection (no bias); the descriptor is query
0.

Without ``return_attn`` only query 0 is computed: the queries do not
interact, so its output and every gradient are those of the full form (the
other queries' rows of ``img_queries`` get a zero gradient either way, and
LARS's trust ratio still reads the norm of all 196 rows). With
``return_attn`` all 196 queries run and the map is (B, 8, 196, N).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ep_tpu_torch.ops.attention import scaled
from .common import Dense, LayerNorm, normal_


class CoCaCrossAttnPooling(nn.Module):
    def __init__(self, dim: int, dim_head: int = 64, num_img_queries: int = 196,
                 heads: int = 8, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.dtype = dtype
        inner = heads * dim_head
        self.img_queries = nn.Parameter(torch.zeros(num_img_queries, dim))
        self.norm = LayerNorm(dim, 1e-6, dtype)
        self.to_q = Dense(dim, inner, bias=False, dtype=dtype)
        self.to_kv = Dense(dim, 2 * dim_head, bias=False, dtype=dtype)
        self.to_out = Dense(inner, dim, bias=False, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.img_queries, 1.0, generator)
        for m in (self.norm, self.to_q, self.to_kv, self.to_out):
            m.init_weights(generator)

    def forward(self, context: torch.Tensor, return_attn: bool = False):
        B, N, D = context.shape
        H, Dh = self.heads, self.dim_head
        kv = self.to_kv(context)
        k, v = kv[..., :Dh], kv[..., Dh:]  # (B, N, Dh) each: one shared head
        rows = 1 if not return_attn else self.img_queries.shape[0]
        x = self.img_queries[:rows].to(self.dtype)[None].expand(B, -1, -1)
        q = self.to_q(self.norm(x)).reshape(B, rows, H, Dh).transpose(1, 2)
        sim = torch.einsum("bhid,bjd->bhij", scaled(q, Dh ** -0.5).float(),
                           k.float())
        sim = sim - sim.amax(dim=-1, keepdim=True)
        attn = torch.softmax(sim, dim=-1)
        out = torch.einsum("bhij,bjd->bhid", attn.to(v.dtype).float(),
                           v.float()).to(v.dtype)
        out = self.to_out(out.transpose(1, 2).reshape(B, rows, H * Dh))
        return (out[:, 0], attn) if return_attn else out[:, 0]
