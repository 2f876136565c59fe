"""Multi-head attention over split heads, in plain PyTorch, and the
attention statistics of the attention-statistics CLI.

Counterpart of ``ep_tpu/ops/attention.py``, which the JAX package leaves to
XLA. The pooling heads that run a self-attention of their own (dinovit,
abmilp) call ``mha``, and so does the backbone's plain ``Attention`` where it
adds a relative-position bias, returns probabilities or runs with
``attn_impl="xla"`` (``models/vit.py``); every other backbone block runs the
kernels of ``ops/attn_block.py`` and ``ops/attn_fused.py``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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


class AttnStats(NamedTuple):
    """Per-block attention diagnostics, the reference's 5-kind stack
    (models_vit.py:246-264): [attn_diag, attn_diag_adj_for_cls,
    cls_all_attn, all_cls_attn, entropy]."""

    stats: torch.Tensor  # (5, B, 1, H, T)
    magnitudes: torch.Tensor  # (2, B, 1, T): input norm, attn-branch norm


def attn_stats_from_probs(probs: torch.Tensor) -> torch.Tensor:
    """The 5-kind stack from (B, H, T, T) probabilities, in f32, as
    (5, B, 1, H, T) (``ep_tpu/ops/attention.py::attn_stats_from_probs``):
    self-attention, self-attention over the patch keys' mass, [CLS] to every
    token, every token to [CLS], and the entropy over the patch keys."""
    probs = probs.float()
    diag = probs.diagonal(dim1=2, dim2=3)  # (B, H, T)
    wo_cls = probs[:, :, :, 1:]
    denom = wo_cls.sum(dim=3, keepdim=True) + 1e-6
    wo_cls = wo_cls / denom
    entropy = -(wo_cls * torch.log(wo_cls + 1e-6)).sum(dim=3)
    # the diagonal of probs / denom, without the (B, H, T, T) quotient
    diag_adj = diag / denom[..., 0]
    stats = torch.stack([diag, diag_adj, probs[:, :, 0, :], probs[:, :, :, 0],
                         entropy])  # (5, B, H, T)
    return stats[:, :, None]
