"""Natural-layout fused attention: the (B, T, 3D) qkv tensor in, (B, T, D) out.

Counterpart of ``ep_tpu/ops/attn_fused_pallas.py::attention_qkv_fused`` and
its custom VJP. On CUDA tensors the forward is kernel B (``csrc/attn_core.cu``)
or, beyond the sequence length B holds in registers, kernel F
(``csrc/attn_flash.cu``, ``flash_attn.py``), and the backward kernel E
(``csrc/attn_core_bwd.cu``); all read each head straight out of the qkv rows
by TMA and write it at its column slice by TMA store: no head-split transpose
and no (B,H,T,T) tensor in device memory. On CPU tensors they are
:func:`attention_qkv_fused_ref` and :func:`attention_qkv_fused_bwd_ref`.
Head widths 64 and 80 (ViT-H) are built for all three; F also takes 72
(SigLIP2 SO400M/14) and 128 (DINOv3 ViT-7B/16), which B and E are not built
for.

B and E are ``wgmma`` designs on the wrappers of ``csrc/hopper.cuh``, with
persistent blocks of two consumer warpgroups and one TMA producer. B keeps a
64-row query tile's whole row of logits in registers: one sweep, two
products, the exact softmax normalised before PV. E runs 7 products an
(image, head) where the function needs 5: a query-stationary pass (logits and
dA once, the keys split between the two warpgroups, dQ summed across them in
a fixed order) and a key-stationary pass (dK and dV). Both are bound by bytes
on the H100; what each measured is in ``PERF.md``.

:func:`attn_route` is the routing of ``attn_fused_pallas.py::_fwd_impl``, by
shape: the TPU's memory estimates and its XLA fallback past them do not carry
over, since F takes any T. :func:`bwd_route` routes the backward the same
way: kernel E up to :data:`BWD_MAX_T` at the head widths it is built for,
and past it, or at any other width, :func:`attention_qkv_fused_bwd_long`,
plain torch tiled over query rows, as the JAX package leaves that case to
XLA (``_bwd_xla``). Kernel E's own entry refuses what it cannot hold.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from . import LAUNCHES, MAX_SMEM, check, use_kernel
from ._build import call, query, stream_ptr
from .attention import mm_f32
from .flash_attn import HEAD_DIMS as FLASH_HEAD_DIMS
from .flash_attn import attn_flash

CORE_MAX_T = 272  # csrc/attn_core.cu: a tile's rows of logits sit in registers
CORE_HEAD_DIMS = (64, 80)  # the head widths csrc/attn_core.cu is built for
# csrc/attn_core_bwd.cu stages q, k, v and dO of one head in shared memory
BWD_MAX_T = {64: 384, 80: 320}
BWD_TILE = 128  # query rows a step of attention_qkv_fused_bwd_long
KEY_ALIGN = 8  # its keys padded to 16 bytes of bf16


def _split(t: torch.Tensor, parts: int, num_heads: int):
    """(B, T, parts*H*Dh) -> ``parts`` tensors of (B, H, T, Dh)."""
    B, T, W = t.shape
    return t.reshape(B, T, parts, num_heads, W // (parts * num_heads)).permute(
        2, 0, 3, 1, 4)


def _head_dim(qkv: torch.Tensor, num_heads: int) -> int:
    return qkv.shape[-1] // (3 * num_heads)


def attn_route(T: int, head_dim: int, num_heads: int,
               variant: Optional[str] = None) -> str:
    """Which kernel takes a (B, T, 3*H*Dh) qkv tensor: ``"core"`` (kernel B)
    or ``"flash"`` (kernel F).

    F takes the sequences past kernel B's limit, and every sequence at a
    head width F is built for and B is not (72, 128). ``variant="rowtile"``
    (``EP_TPU_ATTN_VARIANT=rowtile`` in the JAX package, an A/B knob) sends
    the short sequences to F too, but only where the JAX package's head-group
    route applies, a head width that does not divide 128 with the heads a
    multiple of 8 (ViT-H); elsewhere it is ignored, as there."""
    if T > CORE_MAX_T or (head_dim in FLASH_HEAD_DIMS
                          and head_dim not in CORE_HEAD_DIMS):
        return "flash"
    if variant == "rowtile" and 128 % head_dim != 0 and num_heads % 8 == 0:
        return "flash"
    return "core"


def attention_core(qkv: torch.Tensor, num_heads: int, scale: float,
                   temperature: float = 1.0,
                   variant: Optional[str] = None) -> torch.Tensor:
    """The forward alone, outside autograd: kernel B or F by
    :func:`attn_route`, or the plain version. ``variant=None`` reads
    ``EP_TPU_ATTN_VARIANT`` on every call; ``"core"`` is the usual route
    whatever the environment says."""
    if not use_kernel(qkv):
        return attention_qkv_fused_ref(qkv, num_heads, scale, temperature)
    B, T, _ = qkv.shape
    Dh = _head_dim(qkv, num_heads)
    if variant is None:
        variant = os.environ.get("EP_TPU_ATTN_VARIANT")
    if attn_route(T, Dh, num_heads, variant) == "flash":
        return attn_flash(qkv, num_heads, scale, temperature)
    check(qkv, "qkv", (B, T, 3 * num_heads * Dh), torch.bfloat16)
    if query("ep_attn_core_smem_bytes", T, Dh) == 0:
        raise NotImplementedError(
            f"attn_core is built for head widths 64 and 80; got head width "
            f"{Dh}, T={T}")
    out = torch.empty(B, T, num_heads * Dh, device=qkv.device, dtype=qkv.dtype)
    call("ep_attn_core", qkv.data_ptr(), out.data_ptr(), B, T, num_heads, Dh,
         scale / temperature, stream_ptr(qkv))
    LAUNCHES["attn_core"] += 1
    return out


def attention_qkv_fused_bwd(qkv: torch.Tensor, g: torch.Tensor, num_heads: int,
                            scale: float, temperature: float = 1.0) -> torch.Tensor:
    """(qkv (B,T,3D), dO (B,T,D)) -> dqkv (B,T,3D): kernel E or the plain
    version. Kernel E takes head widths 64 and 80 up to :data:`BWD_MAX_T`
    and raises beyond; it is deterministic (two calls on the same inputs are
    equal bit for bit)."""
    if not use_kernel(qkv, g):
        return attention_qkv_fused_bwd_ref(qkv, g, num_heads, scale, temperature)
    B, T, _ = qkv.shape
    Dh = _head_dim(qkv, num_heads)
    check(qkv, "qkv", (B, T, 3 * num_heads * Dh), torch.bfloat16)
    check(g, "g", (B, T, num_heads * Dh), torch.bfloat16)
    smem = query("ep_attn_core_bwd_smem_bytes", T, Dh)
    if smem == 0 or smem > MAX_SMEM:
        raise NotImplementedError(
            f"attn_core_bwd is built for head widths 64 (T <= "
            f"{BWD_MAX_T[64]}) and 80 (T <= {BWD_MAX_T[80]}) and keeps q, k, v "
            f"and dO of one head in shared memory; got head width {Dh}, "
            f"T={T}; attention_backward takes longer sequences past it")
    dqkv = torch.empty_like(qkv)
    call("ep_attn_core_bwd", qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), B,
         T, num_heads, Dh, scale / temperature, stream_ptr(qkv))
    LAUNCHES["attn_core_bwd"] += 1
    return dqkv


def bwd_route(T: int, head_dim: int) -> str:
    """Which backward takes a (B, T, 3*H*Dh) qkv tensor: ``"core"`` (kernel
    E, or its plain version on the CPU) up to :data:`BWD_MAX_T` at the head
    widths E is built for, else ``"long"``
    (:func:`attention_qkv_fused_bwd_long`): past that limit, and at every T
    for a head width E is not built for (DINOv3's 128). By shape alone, on
    every device."""
    return "core" if T <= BWD_MAX_T.get(head_dim, 0) else "long"


def attention_backward(qkv: torch.Tensor, g: torch.Tensor, num_heads: int,
                       scale: float, temperature: float = 1.0) -> torch.Tensor:
    """dqkv by :func:`bwd_route`: kernel E (:func:`attention_qkv_fused_bwd`)
    or, past its limit, :func:`attention_qkv_fused_bwd_long`, whose calls on
    the card add to ``LAUNCHES["attn_bwd_long"]``."""
    if bwd_route(qkv.shape[1], _head_dim(qkv, num_heads)) == "core":
        return attention_qkv_fused_bwd(qkv, g, num_heads, scale, temperature)
    if use_kernel(qkv, g):
        LAUNCHES["attn_bwd_long"] += 1
    return attention_qkv_fused_bwd_long(qkv, g, num_heads, scale, temperature)


def attention_qkv_fused_bwd_long(qkv: torch.Tensor, g: torch.Tensor,
                                 num_heads: int, scale: float,
                                 temperature: float = 1.0) -> torch.Tensor:
    """The backward at any T, in plain torch with the cast points of
    ``attn_fused_pallas.py::_bwd_xla`` (not ``_bwd_kernel``'s): bf16 operands
    with f32 sums, dL = bf16(A * (dA - rowsum(A * dA)) / temperature), dQ =
    (dL K) * scale and dK = (dLᵀ Q) * scale scaled after their products.

    It runs :data:`BWD_TILE` query rows at a time, so the largest tensor it
    keeps is (B, H, BWD_TILE, T) f32, never (B, H, T, T); dK and dV are summed
    over the tiles in f32 and cast once. The keys are padded with zero rows to
    a multiple of :data:`KEY_ALIGN`, whose logits are masked out before the
    softmax, so that every operand of a product has rows of a multiple of 16
    bytes, which cuBLAS's Hopper kernels need (at T=1025 it falls back to an
    sm75 kernel of alignment 1 without)."""
    B, T, _ = qkv.shape
    dt = qkv.dtype
    H = num_heads
    Dh = _head_dim(qkv, H)
    coef = scale / temperature
    pad = -T % KEY_ALIGN
    q, k, v = (t.reshape(B * H, T, Dh) for t in
               _split(qkv, 3, H).contiguous())
    k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    gh = _split(g, 1, H)[0].reshape(B * H, T, Dh)
    dq = torch.empty(B * H, T, Dh, dtype=dt, device=qkv.device)
    dk = torch.zeros(B * H, T + pad, Dh, dtype=torch.float32,
                     device=qkv.device)
    dv = torch.zeros_like(dk)
    for s in range(0, T, BWD_TILE):
        qs, gs = q[:, s:s + BWD_TILE], gh[:, s:s + BWD_TILE]
        logits = mm_f32(qs, k.transpose(1, 2)).mul_(coef)
        logits[..., T:] = float("-inf")
        a = torch.softmax(logits, dim=-1)
        dv += mm_f32(a.to(dt).transpose(1, 2), gs)
        da = mm_f32(gs, v.transpose(1, 2))
        dl = da.sub_((a * da).sum(-1, keepdim=True)).mul_(a)
        if temperature != 1.0:
            dl.div_(temperature)
        dl = dl.to(dt)
        dq[:, s:s + BWD_TILE] = mm_f32(dl, k).mul_(scale).to(dt)
        dk += mm_f32(dl.transpose(1, 2), qs)
    dqkv = torch.stack([dq, dk[:, :T].mul_(scale).to(dt), dv[:, :T].to(dt)])
    return dqkv.reshape(3, B, H, T, Dh).permute(1, 3, 0, 2, 4).reshape(B, T, -1)


class _AttentionQKVFused(torch.autograd.Function):
    """Saves qkv and recomputes the softmax in the backward, as the JAX
    package's ``_fwd``/``_bwd`` pair does."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, temperature):
        ctx.save_for_backward(qkv)
        ctx.args = (num_heads, scale, temperature)
        return attention_core(qkv, num_heads, scale, temperature)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return (attention_backward(qkv, g.contiguous(), *ctx.args),
                None, None, None)


def attention_qkv_fused(qkv: torch.Tensor, num_heads: int, scale: float,
                        temperature: float = 1.0) -> torch.Tensor:
    """(B, T, 3*H*Dh) fused-qkv tensor -> (B, T, H*Dh) attention output."""
    return _AttentionQKVFused.apply(qkv, num_heads, scale, temperature)


def attention_qkv_fused_ref(qkv: torch.Tensor, num_heads: int, scale: float,
                            temperature: float = 1.0) -> torch.Tensor:
    """Plain version (``attn_fused_pallas.py::_fwd_xla``): f32 logits scaled
    by scale/temperature, f32 softmax normalised before PV, probabilities cast
    to the input dtype, PV accumulated in f32 and cast once."""
    B, T, _ = qkv.shape
    q, k, v = _split(qkv, 3, num_heads)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        scale / temperature)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return o.to(v.dtype).transpose(1, 2).reshape(B, T, -1)


def attention_qkv_fused_bwd_ref(qkv: torch.Tensor, g: torch.Tensor,
                                num_heads: int, scale: float,
                                temperature: float = 1.0) -> torch.Tensor:
    """Plain backward with the cast points of ``attn_fused_pallas.py::
    _bwd_kernel`` (not ``_bwd_xla``'s, which scales after the products): f32
    softmax A, dV = bf16(A)^T dO and dA = dO V^T in f32, dL = bf16(A * (dA -
    rowsum(A * dA)) * coef), dQ = dL K and dK = dL^T Q in f32, each cast once."""
    B, T, _ = qkv.shape
    dt = qkv.dtype
    coef = scale / temperature
    q, k, v = (t.float() for t in _split(qkv, 3, num_heads))
    (gh,) = (t.float() for t in _split(g, 1, num_heads))
    a = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) * coef, dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", a.to(dt).float(), gh)
    da = torch.einsum("bhqd,bhkd->bhqk", gh, v)
    dl = (a * (da - (a * da).sum(-1, keepdim=True)) * coef).to(dt).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", dl, k)
    dk = torch.einsum("bhqk,bhqd->bhkd", dl, q)
    dqkv = torch.stack([dq, dk, dv]).to(dt)  # (3, B, H, T, Dh)
    return dqkv.permute(1, 3, 0, 2, 4).reshape(B, T, -1)
