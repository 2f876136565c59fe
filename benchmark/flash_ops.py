"""Operations and bytes of one call of kernel F (``attn_flash``,
``ep_tpu_torch/ops/flash_attn.py``, ``csrc/attn_flash.cu``), counted from
shapes as ``flops.py`` counts a layer's: the two products of softmax
attention, QK^T and PV, 4 * batch * H * T^2 * Dh operations (the kernel's
second sweep over the keys recomputes QK^T, which is not counted), and the
(batch, T, 3D) qkv tensor read once and the (batch, T, D) output written
once, in bfloat16."""
from __future__ import annotations

from .flops import BF16, dims


def flash_call(cfg: dict, image_size: int, batch: int) -> tuple[float, float]:
    """(operations, bytes) of one call of kernel F."""
    d = dims(cfg, image_size)
    T, D = d["T"], d["D"]
    ops = 4 * batch * T * T * D  # 4 B H T^2 Dh, with H * Dh = D
    moved = BF16 * (batch * T * 3 * D + batch * T * D)
    return float(ops), float(moved)
