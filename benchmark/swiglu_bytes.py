"""Bytes of one call of the SwiGLU gate (``ep_tpu_torch/ops/swiglu.py``,
kernel ``csrc/swiglu_gate.cu``), counted from shapes as ``flops.py`` counts
a layer's: the ``batch * T`` rows of w12's output ``[x1 | x2]`` read once and
the gate (``batch * T``, F) written once, in bfloat16. The gate's
arithmetic is elementwise, so bytes bound it. ``F`` is the configuration's
SwiGLU hidden width (``dims``' ``ffn``, a reference that has one)."""
from __future__ import annotations

from .flops import BF16, dims


def gate_call(cfg: dict, image_size: int, batch: int) -> float:
    """Bytes one call of the gate moves at least."""
    d = dims(cfg, image_size)
    rows, F = batch * d["T"], d["ffn"]
    return float(BF16 * (rows * 2 * F + rows * F))
