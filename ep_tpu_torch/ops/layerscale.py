"""LayerScale and the residual: ``x + gamma * y``, the closing of both halves
of a LayerScale block.

No TPU kernel: the JAX package leaves ``x + y * gamma.astype(y.dtype)`` to
XLA, which fuses it. On the card :func:`ls_residual` is one pass of
``csrc/ls_residual.cu``, which reads x and y once and writes the sum once,
with the chain's rounding points (the product rounded to bf16, then the
sum), so it equals the chain bit for bit; on CPU tensors it is
:func:`ls_residual_ref`, that chain. ``models/vit.py::LayerScale`` takes the
kernel where :func:`takes_ls_kernel` says and the chain, which autograd
differentiates, everywhere else. Each launch adds one to
``LAUNCHES["ls_residual"]``.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, check, use_kernel
from ._build import call, stream_ptr

# csrc/ls_residual.cu: 2 vectors of 8 columns a thread, 256 threads; the
# widest model of the family (DINOv3 ViT-7B/16) is 4096 wide
MAX_D = 4096


def takes_ls_kernel(x: torch.Tensor, y: torch.Tensor,
                    gamma: torch.Tensor) -> bool:
    """Whether ``x + gamma * y`` goes to the kernel: x and y CUDA bf16
    tensors of one shape, contiguous and 16-byte aligned, whose rows are
    D % 8 == 0 columns wide (D at most MAX_D); gamma (D,) on the card in f32
    or bf16; and no gradient needed (grad mode off, or none of x, y and
    gamma requiring one)."""
    D = y.shape[-1] if y.dim() else 0
    return ({t.device.type for t in (x, y, gamma)} == {"cuda"}
            and x.dtype == y.dtype == torch.bfloat16
            and x.shape == y.shape and 0 < D <= MAX_D and D % 8 == 0
            and gamma.shape == (D,) and gamma.is_contiguous()
            and gamma.dtype in (torch.float32, torch.bfloat16)
            and all(t.is_contiguous() and t.data_ptr() % 16 == 0
                    for t in (x, y))
            and not (torch.is_grad_enabled() and (
                x.requires_grad or y.requires_grad or gamma.requires_grad)))


def ls_residual(x: torch.Tensor, y: torch.Tensor,
                gamma: torch.Tensor) -> torch.Tensor:
    """``x + y * gamma.to(y.dtype)`` as a new tensor; y is left as it is.
    The kernel takes bf16 x and y of one shape, contiguous, with rows of
    D % 8 == 0 columns (at most MAX_D), and gamma (D,) in f32 or bf16, which
    it rounds to bf16 itself. CPU tensors go to :func:`ls_residual_ref`."""
    if not use_kernel(x, y, gamma):
        return ls_residual_ref(x, y, gamma)
    D = y.shape[-1]
    if D % 8 or D > MAX_D:
        raise NotImplementedError(
            f"ls_residual: the kernel needs a row width D % 8 == 0 (16-byte "
            f"vectors) and at most {MAX_D}; got D={D}")
    check(x, "x", tuple(y.shape), torch.bfloat16)
    check(y, "y", tuple(x.shape), torch.bfloat16)
    if gamma.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gamma: expected float32 or bfloat16, got "
                        f"{gamma.dtype}")
    if gamma.shape != (D,) or not gamma.is_contiguous():
        raise ValueError(f"gamma: expected a contiguous ({D},) tensor, got "
                         f"{tuple(gamma.shape)}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    call("ep_ls_residual", x.data_ptr(), y.data_ptr(), gamma.data_ptr(),
         out.data_ptr(), x.numel() // D, D, int(gamma.dtype == torch.float32),
         stream_ptr(x))
    LAUNCHES["ls_residual"] += 1
    return out


def ls_residual_ref(x: torch.Tensor, y: torch.Tensor,
                    gamma: torch.Tensor) -> torch.Tensor:
    """Plain version: LayerScale in y's dtype, then the residual, as the JAX
    package computes ``x + y * gamma.astype(y.dtype)``."""
    return x + y * gamma.to(y.dtype)
