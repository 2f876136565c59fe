"""Multi-head attention over split heads, in plain PyTorch.

Counterpart of ``ep_tpu/ops/attention.py::mha``, which the JAX package
leaves to XLA; the pooling heads that run a self-attention of their own
(dinovit, abmilp) call it, and so does the backbone's plain ``Attention``
where it adds a relative-position bias or returns the last block's
probabilities (``models/vit.py``); every other backbone block runs the
kernels of ``ops/attn_block.py`` and ``ops/attn_fused.py``.
"""
from __future__ import annotations

from typing import Optional

import torch



def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N,m,k) @ (N,k,n) with f32 sums and an f32 result: on the card the
    product of the operands in their dtype with an f32 output (bf16 operands
    stay on the tensor cores); on the CPU the operands widened to f32, where
    every product of two bf16 values is exact."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def scaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x * scale`` as JAX computes it for a weakly typed Python float: the
    constant in x's dtype first. The constant is a 0-d CPU tensor, which a
    card's tensor takes by value: made on the card, it would be a copy from
    pageable memory that waits for the work queued before it."""
    return x * torch.tensor(scale, dtype=x.dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
        temperature: float = 1.0, bias: Optional[torch.Tensor] = None,
        return_probs: bool = False):
    """Attention over (B, H, T, Dh) tensors: f32 logits of ``q * scale``
    (the scale in q's dtype) and k, an f32 softmax, and the probabilities in
    v's dtype times v summed in f32, cast to v's dtype. With
    ``return_probs``, (out, probs f32 (B, H, T, T))."""
    logits = torch.einsum("bhqd,bhkd->bhqk", scaled(q, scale).float(),
                          k.float())
    logits = logits / temperature
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    if return_probs:
        return out, probs
    return out
