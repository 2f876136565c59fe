"""fc1 of the bf16 MLP half with its bias and tanh GELU in the library
product's epilogue.

No TPU kernel: the JAX package leaves the MLP half to XLA. On the card, a
frozen encoder's fc1 is one cuBLASLt product whose epilogue (``GELU_BIAS``)
adds the bias to the f32 accumulator and applies the tanh GELU before the
one bf16 rounding (``torch._addmm_activation(..., use_gelu=True)``), so the
hidden tensor is written once and not read back for the activation.
``models/vit.py::Mlp`` takes it where :func:`takes_gelu_epilogue` says;
every other call keeps ``F.linear`` then ``F.gelu``. The epilogue keeps no
pre-activation, so it has no backward: a call that needs a gradient keeps
the old route. Each call adds one to ``LAUNCHES["fc1_gelu_epilogue"]``.
"""
from __future__ import annotations

import torch

from . import LAUNCHES


def takes_gelu_epilogue(device: torch.device, dtype: torch.dtype, act: str,
                        cut: bool, needs_grad: bool) -> bool:
    """Whether fc1 and its activation go to the epilogue: on the card, in
    bf16, for GELU (the tanh GELU, as the JAX package computes it there) or
    the tanh GELU at every precision (``"gelu_tanh"``, SigLIP's), not
    QuickGELU, in a block not cut over a model axis, and where no gradient
    is needed."""
    return (device.type == "cuda" and dtype == torch.bfloat16
            and act in ("gelu", "gelu_tanh") and not cut and not needs_grad)


def fc1_gelu(x: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
    """``gelu_tanh(x @ weight.T + bias)`` as one product: x (..., D), weight
    (H, D), bias (H,) contiguous, all bf16 on the card. PyTorch takes
    cuBLASLt's epilogue only for a 2-d input and a contiguous 1-d bias (else
    it runs the product, then the GELU), so x's rows are a view of x."""
    rows = x.reshape(-1, x.shape[-1])
    h = torch._addmm_activation(bias, rows, weight.t(), use_gelu=True)
    LAUNCHES["fc1_gelu_epilogue"] += 1
    return h.view(*x.shape[:-1], weight.shape[0])
