"""ABMILP: gated attention-MIL pooling.

Counterpart of ``ep_tpu/poolings/abmilp.py``:

* an optional one-head self-attention pre-pass (fused qkv without bias, an
  output projection with a zero-initialised bias; ``ops/attention.py::mha``);
* an MLP attention predictor, ``depth - 1`` times [Linear D→D, tanh or ReLU]
  then Linear D→1, softmax over the tokens in f32;
* the weighted sum of the self-attended tokens (``--abmilp_sa both``) or of
  the raw tokens (``none``, ``map``);
* ``--abmilp_cond pe``: the fixed 2-D sin-cos position embedding added to the
  predictor's input (``utils/pos_embed.py``), with a [CLS] row unless
  ``--abmilp_content patch`` drops the first token.

``return_attn`` gives the (B, N, 1) map in the tokens' dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ep_tpu_torch.ops.attention import mha
from ep_tpu_torch.utils.pos_embed import get_2d_sincos_pos_embed
from .common import Dense


class _SelfAttention1Head(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.qkv = Dense(dim, 3 * dim, bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        self.qkv.init_weights(generator)
        self.proj.init_weights(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        D = x.shape[-1]
        qkv = self.qkv(x)[:, None]  # one head: channel slices of (B, 1, N, 3D)
        out = mha(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:],
                  D ** -0.5)[:, 0]
        return self.proj(out)


class ABMILPHead(nn.Module):
    def __init__(self, dim: int, self_attention_apply_to: str = "both",
                 activation: str = "tanh", depth: int = 2,
                 cond: Optional[str] = None, content: str = "all",
                 num_patches: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.sa = self_attention_apply_to
        self.activation = activation
        self.depth = depth
        self.cond = cond
        self.content = content
        if self.sa != "none":
            self.self_attn = _SelfAttention1Head(dim, dtype)
        if cond == "pe":  # fixed: a buffer that moves with the module
            pe = get_2d_sincos_pos_embed(dim, int(num_patches ** 0.5),
                                         cls_token=content != "patch")
            self.register_buffer("pe", torch.from_numpy(pe)[None],
                                 persistent=False)
        for i in range(depth):
            out = dim if i < depth - 1 else 1
            setattr(self, f"attention_predictor_{2 * i}",
                    Dense(dim, out, dtype=dtype, fan_in=dim))

    def _predictors(self) -> list[Dense]:
        return [getattr(self, f"attention_predictor_{2 * i}")
                for i in range(self.depth)]

    def init_weights(self, generator: torch.Generator) -> None:
        if self.sa != "none":
            self.self_attn.init_weights(generator)
        for m in self._predictors():
            m.init_weights(generator)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        if self.content == "patch":
            x = x[:, 1:]
        x_attn = self.self_attn(x) if self.sa != "none" else x
        h = x_attn if self.sa in ("map", "both") else x
        if self.cond == "pe":
            h = h + self.pe.to(h.dtype)
        *hidden, last = self._predictors()
        for layer in hidden:
            h = layer(h)
            h = torch.tanh(h) if self.activation == "tanh" else torch.relu(h)
        attn_map = torch.softmax(last(h).float(), dim=1).to(x.dtype)
        x_out = x_attn if self.sa == "both" else x
        out = (x_out * attn_map).float().sum(dim=1).to(x_out.dtype)
        return (out, attn_map) if return_attn else out
