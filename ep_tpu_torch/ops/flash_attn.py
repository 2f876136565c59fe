"""Attention for any sequence length: query rows and keys both tiled.

Counterpart of ``ep_tpu/ops/flash_attn_pallas.py``, the long-sequence route of
448 px probing (T=1025), and of the row-tiled variant of the head-width-80
kernel (``attn_fused_pallas.py::_fwd_head_group_rowtile``). On CUDA tensors
both are kernel F (``csrc/attn_flash.cu``): persistent blocks over (192-row
query tile, head, image), K and V streamed by TMA through an mbarrier ring to
three ``wgmma`` warpgroups (at head width 128, DINOv3's, 128-row tiles and
two warpgroups; at head width 72, SigLIP2's, width 80's tiles with the
query's 8 rest columns zeroed), two sweeps over the keys so that the softmax
is normalised before PV as in the TPU kernels. No (T, T) tensor in device or
shared memory, and no head-split copies: the kernel reads the natural-layout
(B, T, 3D) qkv tensor, as kernel B does.

:func:`attn_flash` is the wrapper on that layout, which
``attn_fused.py::attention_core`` routes to; its plain version is
``attn_fused.py::attention_qkv_fused_ref``, the one kernel B is held to.
:func:`flash_attention` is the JAX module's public function on pre-split
(B, H, T, Dh) tensors; on the card it packs them into the natural layout and
launches F. Its backward is a plain-torch recompute, as the JAX module's
``_bwd`` is left to XLA.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, check, use_kernel
from ._build import call, stream_ptr

HEAD_DIMS = (64, 72, 80, 128)  # head widths csrc/attn_flash.cu is built for


def flash_head_dim(shape: tuple, num_heads: int, scale: float,
                   temperature: float = 1.0) -> int:
    """The head width kernel F runs a (B, T, 3*H*Dh) qkv tensor at; raises
    for what it does not take: a last dimension that is not 3*H*Dh, an empty
    batch or sequence, a head width other than 64, 72, 80 or 128, or a
    non-positive scale/temperature (the kernel takes each row's max of the
    logits before scaling). Every T >= 1 is taken."""
    B, T, C = shape
    if num_heads < 1 or C % (3 * num_heads):
        raise ValueError(f"attn_flash: last dimension {C} is not 3 x "
                         f"{num_heads} heads")
    if B < 1 or T < 1:
        raise ValueError(f"attn_flash: empty batch or sequence {tuple(shape)}")
    Dh = C // (3 * num_heads)
    if Dh not in HEAD_DIMS:
        raise NotImplementedError(
            f"attn_flash is built for head widths {HEAD_DIMS}; got head width "
            f"{Dh}")
    if not scale / temperature > 0:
        raise ValueError(f"attn_flash: scale/temperature must be positive; got "
                         f"{scale}/{temperature}")
    return Dh


def attn_flash(qkv: torch.Tensor, num_heads: int, scale: float,
               temperature: float = 1.0) -> torch.Tensor:
    """Kernel F on CUDA tensors: (B, T, 3*H*Dh) bf16 qkv -> (B, T, H*Dh), any
    T."""
    if not qkv.is_cuda:
        raise ValueError("attn_flash launches kernel F and takes CUDA tensors; "
                         "attention_core routes CPU tensors to the plain version")
    B, T, _ = qkv.shape
    Dh = flash_head_dim(qkv.shape, num_heads, scale, temperature)
    check(qkv, "qkv", (B, T, 3 * num_heads * Dh), torch.bfloat16)
    out = torch.empty(B, T, num_heads * Dh, device=qkv.device, dtype=qkv.dtype)
    call("ep_attn_flash", qkv.data_ptr(), out.data_ptr(), B, T, num_heads, Dh,
         scale / temperature, stream_ptr(qkv))
    LAUNCHES["attn_flash"] += 1
    return out


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, temperature: float = 1.0) -> torch.Tensor:
    """Plain version (``flash_attn_pallas.py::_flash_kernel``): f32 logits
    times scale/temperature, f32 softmax normalised before PV, probabilities
    cast to v's dtype, PV accumulated in f32 and cast once."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        scale / temperature)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def flash_attention_bwd_ref(q, k, v, g, scale: float, temperature: float = 1.0):
    """The recompute backward of ``flash_attn_pallas.py::_bwd``, in f32 with
    its cast points: (dq, dk, dv)."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    logits = torch.einsum("bhqd,bhkd->bhqk", qf * scale, kf) / temperature
    a = torch.softmax(logits, dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", a, gf).to(v.dtype)
    da = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    dl = a * (da - (a * da).sum(-1, keepdim=True)) / temperature
    dq = (torch.einsum("bhqk,bhkd->bhqd", dl, kf) * scale).to(q.dtype)
    dk = (torch.einsum("bhqk,bhqd->bhkd", dl, qf) * scale).to(k.dtype)
    return dq, dk, dv


def _flash_forward(q, k, v, scale, temperature):
    if not use_kernel(q, k, v):
        return flash_attention_ref(q, k, v, scale, temperature)
    B, H, T, Dh = q.shape
    # (3, B, H, T, Dh) -> the natural layout (B, T, 3*H*Dh) that F reads
    qkv = torch.stack([q, k, v]).permute(1, 3, 0, 2, 4).reshape(B, T, 3 * H * Dh)
    out = attn_flash(qkv, H, scale, temperature)
    return out.view(B, T, H, Dh).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, temperature):
        ctx.save_for_backward(q, k, v)
        ctx.args = (scale, temperature)
        return _flash_forward(q, k, v, scale, temperature)

    @staticmethod
    def backward(ctx, g):
        return (*flash_attention_bwd_ref(*ctx.saved_tensors, g, *ctx.args),
                None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, temperature: float = 1.0) -> torch.Tensor:
    """softmax(scale * Q K^T / temperature) V over (B, H, T, Dh) tensors."""
    return _FlashAttention.apply(q, k, v, scale, temperature)
