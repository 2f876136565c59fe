"""2D axial rotary position embedding (RoPE) on the fused qkv tensor.

No TPU kernel: the JAX package has no RoPE. DINOv3 (``dinov3/layers/
rope_position_encoding.py``, ``vision_transformer.py``'s ``rope_apply``)
rotates q and k of the patch tokens by angles of their row and column in
the patch grid; [CLS] and the register tokens before the patches keep theirs.

:func:`rope_tables` builds the sines and cosines of a grid, as the hub's
``RopePositionEmbedding.forward`` does at inference (no shift, jitter or
rescale of the coordinates, which it draws in training only). On CUDA
tensors :func:`rope_qk` is one pass of ``csrc/rope_qk.cu`` over the q and k
columns of the patch rows, in place, with the plain chain's rounding; on CPU
tensors it is :func:`rope_qk_ref`, that chain: f32 arithmetic, one rounding
to the input's type. ``models/vit.py::Attention`` takes the kernel where no
gradient is needed and the chain, which autograd differentiates, where one
is.
"""
from __future__ import annotations

import math

import torch

from . import LAUNCHES, check, use_kernel
from ._build import call, stream_ptr


def rope_periods(head_dim: int, base: float, device=None) -> torch.Tensor:
    """``periods[i] = base ** (2i / (Dh/2))`` for i < Dh/4, f32 (the hub's
    ``rope_embed.periods``)."""
    return base ** (2 * torch.arange(head_dim // 4, device=device,
                                     dtype=torch.float32) / (head_dim // 2))


def rope_tables(grid_h: int, grid_w: int, head_dim: int, base: float,
                device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos), each (grid_h * grid_w, head_dim) f32 on ``device``, the
    patches in row-major order: a patch's coordinates ``2 * (r + 0.5) / H -
    1`` and ``2 * (c + 0.5) / W - 1``; its angles ``2 pi * [h / periods, w /
    periods]`` (:func:`rope_periods`), Dh/2 of them, tiled twice to Dh."""
    if head_dim % 4:
        raise ValueError(f"RoPE needs a head width divisible by 4; got "
                         f"{head_dim}")
    dd = dict(device=device, dtype=torch.float32)
    periods = rope_periods(head_dim, base, device)
    coords_h = torch.arange(0.5, grid_h, **dd) / grid_h
    coords_w = torch.arange(0.5, grid_w, **dd) / grid_w
    coords = torch.stack(torch.meshgrid(coords_h, coords_w, indexing="ij"),
                         dim=-1).flatten(0, 1)
    coords = 2.0 * coords - 1.0
    angles = 2 * math.pi * coords[:, :, None] / periods[None, None, :]
    angles = angles.flatten(1, 2).tile(2)
    return torch.sin(angles), torch.cos(angles)


def _sizes(qkv: torch.Tensor, sin: torch.Tensor, num_heads: int):
    """(B, T, prefix, D, Dh) of a (B, T, 3*H*Dh) qkv tensor whose last
    ``sin.shape[0]`` rows are the patches."""
    B, T, C = qkv.shape
    if C % (3 * num_heads):
        raise ValueError(f"rope: last dimension {C} is not 3 x {num_heads} "
                         "heads")
    D = C // 3
    Dh = D // num_heads
    prefix = T - sin.shape[0]
    if prefix < 0 or sin.shape[-1] != Dh:
        raise ValueError(f"rope: tables {tuple(sin.shape)} for {T} tokens of "
                         f"head width {Dh}")
    return B, T, prefix, D, Dh


def rope_qk(qkv: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
            num_heads: int) -> torch.Tensor:
    """RoPE on q and k of the patch rows (the last ``sin.shape[0]`` of each
    image) of (B, T, 3*H*Dh) qkv. The kernel rotates bf16 qkv in place and
    returns it, with head widths a multiple of 16; CPU tensors go to
    :func:`rope_qk_ref`."""
    if not use_kernel(qkv, sin, cos):
        return rope_qk_ref(qkv, sin, cos, num_heads)
    B, T, prefix, D, Dh = _sizes(qkv, sin, num_heads)
    if Dh % 16:
        raise NotImplementedError(
            f"rope_qk: the kernel needs a head width Dh % 16 == 0 (16-byte "
            f"vectors of each half); got {Dh}")
    check(qkv, "qkv", (B, T, 3 * D), torch.bfloat16)
    for name, t in (("sin", sin), ("cos", cos)):
        check(t, name, (T - prefix, Dh), torch.float32)
    call("ep_rope_qk", qkv.data_ptr(), sin.data_ptr(), cos.data_ptr(), B, T,
         prefix, num_heads, Dh, stream_ptr(qkv))
    LAUNCHES["rope_qk"] += 1
    return qkv


def rope_qk_ref(qkv: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                num_heads: int) -> torch.Tensor:
    """Plain version, a new tensor: the q and k columns of the patch rows in
    f32, ``x * cos + cat(-x[Dh/2:], x[:Dh/2]) * sin`` per head (the hub's
    ``rope_apply``), rounded once to qkv's type; the prefix rows and v as
    they are."""
    B, T, prefix, D, Dh = _sizes(qkv, sin, num_heads)
    n = T - prefix
    qk = qkv[:, prefix:, :2 * D].float().reshape(B, n, 2 * num_heads, Dh)
    rot = torch.cat([-qk[..., Dh // 2:], qk[..., :Dh // 2]], dim=-1)
    out = qk * cos[None, :, None] + rot * sin[None, :, None]
    out = out.to(qkv.dtype).reshape(B, n, 2 * D)
    patches = torch.cat([out, qkv[:, prefix:, 2 * D:]], dim=-1)
    return torch.cat([qkv[:, :prefix], patches], dim=1)
