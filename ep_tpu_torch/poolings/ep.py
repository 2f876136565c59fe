"""EP — Efficient Probing (the paper's method).

Counterpart of ``ep_tpu/poolings/ep.py::EfficientProbing`` (reference
semantics included): a learned query bank (1, Q, D) initialised randn*0.02;
the keys are the raw tokens; one value projection D -> D/d_out without bias;
single-head attention with scale D^-0.5; query i attends over the i-th
D/(d_out*Q) slice of the projected values, and the output is the
concatenation of those slices; no output projection.

The attention is ``ops/pool_attn.py::ep_pool_attend``: kernel D on the card,
the plain version on the CPU. With ``EP_TPU_EP_FUSED`` set (read on every
call, opt-in as in the JAX package) it is ``ep_pool_proj_attend``, with the
value projection inside the kernel (G on the card): ``self.v`` is not called,
only its weight is read, so both routes share their parameters and a
checkpoint moves between them. The fused route has no bias: with
``qkv_bias=True`` the JAX package prints a line and runs the unfused route;
the port raises. The JAX package's ``use_pallas`` switch has no counterpart,
since the port picks the kernel by device.

``return_attn`` gives ``(out, attn (B, Q, N) f32)`` through the plain
version of the pool, the JAX package's composition (its
``poolings/ep.py:126-146``): neither kernel computes the probabilities, so
that call alone leaves them, as the JAX kernel gate does; with ``EP_TPU_EP_FUSED`` set it raises, where the JAX package
prints a line and runs the composition. ``init_weights`` draws the queries
N(0, 0.02), then the value projection.
"""
from __future__ import annotations

import os

import torch
import torch.nn as nn

from ep_tpu_torch.ops.pool_attn import (ep_pool_attend, ep_pool_attend_ref,
                                        ep_pool_proj_attend)
from .common import Dense, normal_


class EfficientProbing(nn.Module):
    def __init__(self, dim: int, num_heads: int = 1, qkv_bias: bool = False,
                 num_queries: int = 32, d_out: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        Q = num_queries
        self.num_queries = Q
        self.c_prime = dim // d_out
        self.cq = dim // (d_out * Q)
        if self.cq * d_out * Q != dim:
            raise ValueError(
                f"dim={dim} must be divisible by d_out*num_queries={d_out * Q}")
        self.scale = (dim // num_heads) ** -0.5
        self.dtype = dtype
        self.cls_token = nn.Parameter(torch.randn(1, Q, dim) * 0.02)
        self.v = Dense(dim, self.c_prime, bias=qkv_bias, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.cls_token, 0.02, generator)
        self.v.init_weights(generator)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        B, N, _ = x.shape
        dt = self.dtype
        # the queries are cast first and then scaled in the compute dtype, as
        # JAX multiplies a bf16 array by a (weakly typed) Python float
        q_scaled = self.cls_token[0].to(dt) * torch.tensor(self.scale, dtype=dt)
        if os.environ.get("EP_TPU_EP_FUSED"):
            if self.v.bias is not None or return_attn:
                raise ValueError(
                    "EP_TPU_EP_FUSED is set, but the fused EP kernel projects "
                    "the values without a bias and computes no attention "
                    "map, and this call asks for "
                    + ("return_attn" if return_attn else "qkv_bias=True")
                    + "; unset it to run the unfused route")
            out = ep_pool_proj_attend(q_scaled, x.to(dt), self.v.weight)
            return out.reshape(B, self.c_prime)
        v = self.v(x).reshape(B, N, self.num_queries, self.cq)
        if return_attn:
            out, attn = ep_pool_attend_ref(q_scaled, x.to(dt), v,
                                           return_attn=True)
            return out.reshape(B, self.c_prime), attn
        out = ep_pool_attend(q_scaled, x.to(dt), v)
        return out.reshape(B, self.c_prime)
