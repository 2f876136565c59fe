"""Initialisers, layers and the pooled attention shared by the pooling zoo and
the backbone.

Counterpart of ``ep_tpu/poolings/common.py``. The heads train from scratch,
so their initial distributions are the JAX package's, drawn from a
``torch.Generator``:

* ``Dense`` weight: torch's ``nn.Linear`` default, U(±1/√fan_in), unless a
  module gives its own (``weight_init``);
* ``Dense`` bias: U(±1/√fan_in) where the JAX package passes ``fan_in`` to
  ``dense()``, zeros where it leaves the flax default;
* :func:`trunc_normal_` is flax's ``truncated_normal(std)``: a standard
  normal cut at ±2, times ``std``. It is not rescaled, so its deviation is
  0.88 ``std`` (timm's ``trunc_normal_`` cuts at ±2 absolute instead);
* :func:`lecun_normal_` is flax's default convolution kernel init, the same
  cut normal rescaled to a deviation of √(1/fan_in).

Every layer keeps float32 master parameters and computes in its ``dtype``,
as flax's ``dtype=`` does; :class:`LayerNorm` takes its statistics in f32
and casts at the end. The products that the JAX package accumulates with
``preferred_element_type=f32`` multiply bf16 values widened to f32 here
(every product of two bf16 values is exact in f32), so no logit rounds to
bf16; the dense projections stay ``F.linear`` in the compute dtype.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ep_tpu_torch.ops.attention import scaled

# deviation of a standard normal cut at ±2 (flax's variance_scaling constant)
_TRUNC_STD = 0.87962566103423978


def torch_linear_init_(weight: torch.Tensor,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(-1/√fan_in, +1/√fan_in) in place, fan_in = weight.shape[1]."""
    bound = 1.0 / math.sqrt(weight.shape[1])
    with torch.no_grad():
        return weight.uniform_(-bound, bound, generator=generator)


def torch_bias_init_(bias: torch.Tensor, fan_in: int,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return bias.uniform_(-bound, bound, generator=generator)


def normal_(t: torch.Tensor, std: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, std, generator=generator)


def trunc_normal_(t: torch.Tensor, std: float,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``truncated_normal(std)``: N(0, 1) cut at ±2 (by the inverse
    CDF of a uniform draw, as ``jax.random.truncated_normal``), times std."""
    lo, hi = (math.erf(b / math.sqrt(2.0)) for b in (-2.0, 2.0))
    with torch.no_grad():
        t.uniform_(lo, hi, generator=generator).erfinv_().mul_(math.sqrt(2.0))
        return t.clamp_(-2.0, 2.0).mul_(std)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``lecun_normal()`` (the default of ``nn.Conv``): the cut normal
    rescaled to a deviation of √(1/fan_in)."""
    return trunc_normal_(t, math.sqrt(1.0 / fan_in) / _TRUNC_STD, generator)


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` while its parameters stay in
    their own (f32 master) dtype, as flax's ``nn.Dense(dtype=...)`` does.

    :meth:`init_weights` follows the JAX ``dense()`` rule: the weight from
    ``weight_init(weight, generator)`` (default U(±1/√in)), the bias
    U(±1/√fan_in) with ``fan_in`` given, zeros without it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 fan_in: Optional[int] = None,
                 weight_init: Optional[Callable] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.fan_in = fan_in
        self.weight_init = weight_init or torch_linear_init_

    def init_weights(self, generator: torch.Generator) -> None:
        self.weight_init(self.weight, generator)
        if self.bias is not None:
            if self.fan_in:
                torch_bias_init_(self.bias, self.fan_in, generator)
            else:
                with torch.no_grad():
                    self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(epsilon, dtype)``: statistics and the affine map in
    f32, the result cast to ``dtype``; scale ones and bias zeros."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def init_weights(self, generator: torch.Generator = None) -> None:
        self.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


def mean_f32(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean`` of a bf16 array: summed in f32, cast back."""
    return x.float().mean(dim=dim, keepdim=keepdim).to(x.dtype)


@functools.lru_cache(maxsize=None)
def head_mask(num_heads: int, dim: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """(H, C): row h is 1 on head h's channels (made once a shape)."""
    head = torch.arange(dim, device=device) // (dim // num_heads)
    return (head[None] == torch.arange(num_heads, device=device)[:, None]
            ).to(dtype)


def pooled_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               num_heads: int, scale: float, scale_after: bool = False):
    """Multi-head cross-attention for a few query tokens
    (``ep_tpu/poolings/common.py::pooled_mha``).

    q (B, Qn, C); k, v (B, N, C), before the head split. Returns (out (B, Qn,
    C) in v's dtype, attn (B, H, Qn, N) f32). The heads are block-diagonal
    masks over the channels: a query row zero outside its head's channels
    (exact, the zeros add nothing), and each output channel read from its
    head's row of the full product. ``scale_after`` scales the f32 logits
    instead of q. The logits and the softmax are f32, the probabilities are
    cast to v's dtype, and both products sum in f32."""
    B, Qn, C = q.shape
    N = k.shape[1]
    H = num_heads
    mask = head_mask(H, C, q.dtype, q.device)
    if not scale_after:
        q = scaled(q, scale)
    qh = (q[:, :, None, :] * mask).reshape(B, Qn * H, C)
    logits = torch.einsum("brc,bnc->brn", qh.float(), k.float())
    if scale_after:
        logits = logits * scale
    attn = torch.softmax(logits, dim=-1)  # (B, Qn*H, N)
    full = torch.einsum("brn,bnc->brc", attn.to(v.dtype).float(), v.float())
    out = (full.reshape(B, Qn, H, C) * mask).sum(dim=2).to(v.dtype)
    attn4 = attn.reshape(B, Qn, H, N).transpose(1, 2)
    return out, attn4


def tokens_to_grid(x: torch.Tensor) -> torch.Tensor:
    """(B, N, C) tokens -> (B, H, W, C) square grid (NHWC)."""
    B, N, C = x.shape
    hw = int(round(N ** 0.5))
    assert hw * hw == N, f"N={N} must be a perfect square"
    return x.reshape(B, hw, hw, C)
