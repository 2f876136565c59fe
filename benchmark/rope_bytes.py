"""Bytes of one call of the RoPE pass (``ep_tpu_torch/ops/rope.py``, kernel
``csrc/rope_qk.cu``), counted from shapes as ``flops.py`` counts a layer's:
the q and k columns of the ``batch * N`` patch rows read once and written
once in bfloat16, and the two float32 tables (sin and cos, (N, Dh) each) read
once. The rotation is elementwise, so bytes bound it. A configuration with
RoPE has a reference whose ``dims`` give ``N`` (the patches), ``D`` and
``H``."""
from __future__ import annotations

from .flops import BF16, dims

F32 = 4


def rope_call(cfg: dict, image_size: int, batch: int) -> float:
    """Bytes one call of the RoPE pass moves at least."""
    d = dims(cfg, image_size)
    N, D = d["N"], d["D"]
    return float(2 * BF16 * batch * N * 2 * D + 2 * F32 * N * (D // d["H"]))
