"""SwiGLU's gate: silu(x1) * x2 on the two halves of w12's output.

No TPU kernel: the JAX package leaves the gate to XLA, which fuses it. On CUDA
tensors it is one pass of ``csrc/swiglu_gate.cu``, which reads each row
``[x1 | x2]`` once and writes the gate in bf16 with the plain chain's
rounding steps (the sigmoid, then ``x1 * s``, then ``* x2``); on CPU tensors
it is :func:`swiglu_gate_ref`, that chain. ``models/vit.py::SwiGLUMlp`` takes
the kernel where no gradient is needed and the chain, which autograd
differentiates, where one is.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, check, use_kernel
from ._build import call, stream_ptr


def swiglu_gate(x12: torch.Tensor) -> torch.Tensor:
    """(..., 2H) rows ``[x1 | x2]`` -> (..., H): ``x1 * sigmoid(x1) * x2``.
    The kernel takes bf16 rows with H a multiple of 8."""
    if not use_kernel(x12):
        return swiglu_gate_ref(x12)
    *lead, W = x12.shape
    H = W // 2
    if W % 16:
        raise NotImplementedError(
            f"swiglu_gate: the kernel needs a hidden width H % 8 == 0 "
            f"(16-byte vectors of each half); got 2H={W}")
    rows = x12.reshape(-1, W)
    check(rows, "x12", (None, W), torch.bfloat16)
    h = torch.empty(*lead, H, device=x12.device, dtype=x12.dtype)
    if rows.shape[0] == 0:
        return h
    call("ep_swiglu_gate", rows.data_ptr(), h.data_ptr(), rows.shape[0], H,
         stream_ptr(x12))
    LAUNCHES["swiglu_gate"] += 1
    return h


def swiglu_gate_ref(x12: torch.Tensor) -> torch.Tensor:
    """Plain version: the sigmoid rounded to x12's type, then the products,
    each rounded, as JAX computes ``silu(x1) * x2`` in bf16."""
    x1, x2 = x12.chunk(2, dim=-1)
    return x1 * torch.sigmoid(x1) * x2
