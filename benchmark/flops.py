"""Operations and bytes of the benchmarked work, counted from shapes.

Operations are the products' multiply-adds times two; elementwise work
(LayerNorm, softmax, GELU, residuals) is counted in bytes only. Bytes count
each input of a layer read once and each output written once, in the type
the step serves them in (bfloat16), whatever a kernel reads again.
"""
from __future__ import annotations

from .manifest import reference

BF16 = 2


def dims(cfg: dict, image_size: int) -> dict:
    return reference(cfg).dims(cfg, image_size)


def encoder_forward(d: dict) -> float:
    """Forward operations of the encoder for one image."""
    T, D, hid, p = d["T"], d["D"], d["hidden"], d["p"]
    block = (2 * T * D * 3 * D + 4 * T * T * D + 2 * T * D * D
             + 4 * T * D * hid)
    return float(2 * d["N"] * D * 3 * p * p + d["L"] * block)


def head_forward(d: dict) -> float:
    """Forward operations of the EP head for one image: the queries' logits,
    the value projection, the pool, the classifier."""
    N, D, Q = d["N"], d["D"], d["Q"]
    return float(2 * N * Q * D + 2 * N * D * D + 2 * N * D + 2 * D * d["C"])


def step_per_image(cfg: dict, image_size: int, finetuning: bool) -> float:
    """Model operations of one training step, per image: a probe step runs
    the frozen encoder forward and the head forward and backward; a
    fine-tuning step three times the forward of both. Recomputation is not
    counted."""
    d = dims(cfg, image_size)
    if finetuning:
        return 3.0 * (encoder_forward(d) + head_forward(d))
    return encoder_forward(d) + 3.0 * head_forward(d)


def attn_half(cfg: dict, image_size: int, batch: int) -> tuple[float, float]:
    """(operations, bytes) of one call of a block's attention half: LN1, the
    qkv product, QK^T, PV, the projection and the residual."""
    d = dims(cfg, image_size)
    T, D = d["T"], d["D"]
    ops = batch * (2 * T * D * 3 * D + 4 * T * T * D + 2 * T * D * D)
    weights = 3 * D * D + 3 * D + D * D + D + 2 * D
    moved = BF16 * (2 * batch * T * D + weights)
    return float(ops), float(moved)


def mlp_half(cfg: dict, image_size: int, batch: int) -> tuple[float, float]:
    """(operations, bytes) of one call of a block's MLP half: LN2, fc1,
    GELU, fc2 and the residual."""
    d = dims(cfg, image_size)
    T, D, hid = d["T"], d["D"], d["hidden"]
    ops = batch * 4 * T * D * hid
    weights = 2 * D * hid + hid + D + 2 * D
    moved = BF16 * (2 * batch * T * D + weights)
    return float(ops), float(moved)
