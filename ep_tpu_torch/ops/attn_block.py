"""Attention supercell: x + proj(attention(qkv(LN1(x)))), the attention half
of a ViT block.

Counterpart of ``ep_tpu/ops/attn_block_pallas.py::attn_supercell``. The TPU
kernel is one program per image; on Hopper one image's qkv rows do not fit a
block's shared memory, so the half-block runs as three kernels that keep its
contract (no LN output, no per-head q/k/v copies, no (B,H,T,T) tensor in
device memory):

* A ``ln_qkv`` (``csrc/attn_block_gemm.cu``): bf16(bf16(LN(x)) @ W_qkvᵀ + b);
* B ``attention_qkv_fused`` (``csrc/attn_core.cu``, see ``attn_fused.py``);
* C ``proj_residual`` (``csrc/attn_block_gemm.cu``): bf16(f32(x) + o @ W_projᵀ + b).

Weights are in the ``nn.Linear`` layout, (out, in), like every weight of the
port. The backward (``attn_block_pallas.py::_bwd``) keeps only the inputs,
recomputes qkv (A, keeping its row statistics) and the attention output (B),
takes the projection's products with cuBLAS, the attention core's gradient
from kernel E or, past E's limit, the tiled plain version
(``attn_fused.py::attention_backward``), and LN1's gradient with the
residual's from two passes of ``csrc/attn_block_gemm.cu`` (``ln1_apply``,
``ln1_bwd``; the JAX package leaves LN1's VJP to XLA, which fuses it), or
from autograd over the plain LayerNorm on the CPU (``ln1_backward_ref``).
"""
from __future__ import annotations

import torch

from . import LAUNCHES, check, use_kernel
from ._build import call, query, stream_ptr
from .attn_fused import (attention_backward, attention_core,
                         attention_qkv_fused_ref)


MAX_K_LN = 1280  # kernel A: one warp holds a row's values for its statistics


def _check_gemm(name: str, N: int, K: int, ln: bool = False) -> None:
    # csrc/attn_block_gemm.cu streams K in slices of 64 (one 128-byte swizzle
    # row of bf16) and stores columns in groups of 8
    if N % 8 or K % 64:
        raise NotImplementedError(
            f"{name}: the GEMM kernel needs N % 8 == 0 and K % 64 == 0; got "
            f"N={N}, K={K}")
    if ln and K > MAX_K_LN:
        raise NotImplementedError(
            f"{name}: the LN prologue takes K <= {MAX_K_LN}; got K={K}")


def ln_qkv(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           w_qkv: torch.Tensor, b_qkv: torch.Tensor, eps: float,
           stats: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel A: LN1 (f32 statistics) and the qkv product, (B,T,D) -> (B,T,3D).

    On the card ``stats``, an f32 (B*T, 2) tensor where given, receives each
    row's (mean, rstd) for the LN1 backward (:func:`ln1_backward`)."""
    if not use_kernel(x, gamma, beta, w_qkv, b_qkv):
        return ln_qkv_ref(x, gamma, beta, w_qkv, b_qkv, eps)
    B, T, D = x.shape
    N = w_qkv.shape[0]
    _check_gemm("ln_qkv", N, D, ln=True)
    w = w_qkv.to(x.dtype)
    check(x, "x", (B, T, D), torch.bfloat16)
    check(w, "w_qkv", (N, D), torch.bfloat16)
    b, g, bt = (t.float().contiguous() for t in (b_qkv, gamma, beta))
    check(b, "b_qkv", (N,), torch.float32)
    check(g, "gamma", (D,), torch.float32)
    check(bt, "beta", (D,), torch.float32)
    if stats is None:
        stats = torch.empty(B * T, 2, device=x.device, dtype=torch.float32)
    check(stats, "stats", (B * T, 2), torch.float32)
    out = torch.empty(B, T, N, device=x.device, dtype=x.dtype)
    call("ep_ln_qkv_gemm", x.data_ptr(), w.data_ptr(), b.data_ptr(),
         g.data_ptr(), bt.data_ptr(), stats.data_ptr(), out.data_ptr(),
         B * T, N, D, eps, stream_ptr(x))
    LAUNCHES["ln_qkv_gemm"] += 1
    return out


def layer_norm_ref(x, gamma, beta, eps):
    """LN1 with f32 statistics, rounded to x.dtype (``attn_block_pallas.py:
    35-39``)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma.float()
            + beta.float()).to(x.dtype)


def ln_qkv_ref(x, gamma, beta, w_qkv, b_qkv, eps):
    """Plain version of kernel A, with the TPU kernel's cast points
    (``attn_block_pallas.py:34-46``)."""
    xn = layer_norm_ref(x, gamma, beta, eps)
    qkv = xn.float() @ w_qkv.to(x.dtype).float().t() + b_qkv.float()
    return qkv.to(x.dtype)


def ln1_apply(x: torch.Tensor, stats: torch.Tensor, gamma: torch.Tensor,
              beta: torch.Tensor) -> torch.Tensor:
    """LN1's output from kernel A's row statistics (card only): (B,T,D) ->
    bf16((f32(x) - mean) * rstd * gamma + beta), the rounding of A's LN."""
    B, T, D = x.shape
    _check_gemm("ln1_apply", D, D, ln=True)  # kernel A's widths
    g, bt = (t.float().contiguous() for t in (gamma, beta))
    check(x, "x", (B, T, D), torch.bfloat16)
    check(stats, "stats", (B * T, 2), torch.float32)
    check(g, "gamma", (D,), torch.float32)
    check(bt, "beta", (D,), torch.float32)
    xn = torch.empty_like(x)
    call("ep_ln1_apply", x.data_ptr(), stats.data_ptr(), g.data_ptr(),
         bt.data_ptr(), xn.data_ptr(), B * T, D, stream_ptr(x))
    LAUNCHES["ln1_apply"] += 1
    return xn


def ln1_bwd(x: torch.Tensor, stats: torch.Tensor, gamma: torch.Tensor,
            dxn: torch.Tensor, g: torch.Tensor):
    """LN1's backward with the residual (card only). ``dxn`` is the gradient
    at LN1's output, ``g`` the one at the block's output, both (B,T,D) bf16.

    Returns (bf16(f32(g) + f32(dx)), dgamma, dbeta, dbp): dx LN1's input
    gradient rounded to bf16; the three f32 (D,) column sums of f32(dxn) *
    xhat, f32(dxn) and f32(g), the last the projection bias's gradient."""
    B, T, D = x.shape
    M = B * T
    _check_gemm("ln1_bwd", D, D, ln=True)
    gm = gamma.float().contiguous()
    check(x, "x", (B, T, D), torch.bfloat16)
    check(stats, "stats", (M, 2), torch.float32)
    check(gm, "gamma", (D,), torch.float32)
    check(dxn, "dxn", (B, T, D), torch.bfloat16)
    check(g, "g", (B, T, D), torch.bfloat16)
    out = torch.empty_like(x)
    part = torch.empty(query("ep_ln1_bwd_blocks", M, D), 3, D,
                       device=x.device, dtype=torch.float32)
    sums = torch.empty(3, D, device=x.device, dtype=torch.float32)
    call("ep_ln1_bwd", x.data_ptr(), stats.data_ptr(), gm.data_ptr(),
         dxn.data_ptr(), g.data_ptr(), out.data_ptr(), part.data_ptr(),
         sums.data_ptr(), M, D, stream_ptr(x))
    LAUNCHES["ln1_bwd"] += 1
    return out, sums[0], sums[1], sums[2]


def ln1_backward(x, stats, gamma, beta, dxn, g, eps):
    """LN1's gradient in the supercell's backward, with the residual's.

    Returns (xn, g + dx, dgamma, dbeta, dbp): LN1's output in x.dtype (the
    input of qkv's weight gradient), the block input's gradient, and the f32
    gradients of gamma, beta and the projection bias (the sum of g). On the
    card kernels ``ln1_apply`` and ``ln1_bwd`` from kernel A's ``stats``; on
    the CPU :func:`ln1_backward_ref` (``stats`` unused)."""
    if not use_kernel(x, gamma, beta, dxn, g):
        return ln1_backward_ref(x, gamma, beta, dxn, g, eps)
    return (ln1_apply(x, stats, gamma, beta), *ln1_bwd(x, stats, gamma, dxn, g))


def ln1_backward_ref(x, gamma, beta, dxn, g, eps):
    """Plain version of :func:`ln1_backward`: autograd over
    :func:`layer_norm_ref`'s f32 composition, dx in x.dtype, then the
    residual's sum ``g + dx`` in x.dtype, and the f32 sum of g."""
    with torch.enable_grad():
        ln_in = [t.detach().requires_grad_() for t in (x, gamma, beta)]
        xn = layer_norm_ref(*ln_in, eps)
    dx, dgamma, dbeta = torch.autograd.grad(xn, ln_in, dxn)
    return xn.detach(), g + dx, dgamma, dbeta, g.float().sum((0, 1))


def proj_residual(o: torch.Tensor, w_proj: torch.Tensor, b_proj: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Kernel C: the output projection plus the f32 residual, (B,T,D) -> (B,T,D)."""
    if not use_kernel(o, w_proj, b_proj, x):
        return proj_residual_ref(o, w_proj, b_proj, x)
    B, T, K = o.shape
    N = w_proj.shape[0]
    _check_gemm("proj_residual", N, K)
    w = w_proj.to(o.dtype)
    b = b_proj.float().contiguous()
    check(o, "o", (B, T, K), torch.bfloat16)
    check(w, "w_proj", (N, K), torch.bfloat16)
    check(b, "b_proj", (N,), torch.float32)
    check(x, "x", (B, T, N), torch.bfloat16)
    out = torch.empty_like(x)
    call("ep_proj_residual_gemm", o.data_ptr(), w.data_ptr(), b.data_ptr(),
         x.data_ptr(), out.data_ptr(), B * T, N, K, stream_ptr(o))
    LAUNCHES["proj_residual_gemm"] += 1
    return out


def proj_residual_ref(o, w_proj, b_proj, x):
    """Plain version of kernel C (``attn_block_pallas.py:74-79``)."""
    proj = o.float() @ w_proj.to(o.dtype).float().t() + b_proj.float()
    return (x.float() + proj).to(x.dtype)


def _weight_grad(g: torch.Tensor, a: torch.Tensor, like: torch.Tensor):
    """(g^T a) over all tokens in the compute dtype, then in ``like``'s dtype:
    the VJP of ``a @ w.to(dtype)^T`` for a master weight ``w``."""
    return (g.reshape(-1, g.shape[-1]).t() @ a.reshape(-1, a.shape[-1])).to(
        like.dtype)


class _AttnSupercell(torch.autograd.Function):
    """Residuals are the inputs alone, as in ``attn_block_pallas.py:194-235``."""

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, gamma, beta, w_proj, b_proj, num_heads,
                scale, temperature, eps):
        ctx.save_for_backward(x, w_qkv, b_qkv, gamma, beta, w_proj, b_proj)
        ctx.args = (num_heads, scale, temperature, eps)
        qkv = ln_qkv(x, gamma, beta, w_qkv, b_qkv, eps)
        o = attention_core(qkv, num_heads, scale, temperature)
        return proj_residual(o, w_proj, b_proj, x)

    @staticmethod
    def backward(ctx, g):
        x, w_qkv, b_qkv, gamma, beta, w_proj, b_proj = ctx.saved_tensors
        num_heads, scale, temperature, eps = ctx.args
        dt = x.dtype
        g = g.contiguous()
        # recompute the forward's intermediates: A (keeping LN1's row
        # statistics) and B on the card
        stats = (torch.empty(x.shape[0] * x.shape[1], 2, device=x.device,
                             dtype=torch.float32) if use_kernel(x) else None)
        qkv = ln_qkv(x, gamma, beta, w_qkv, b_qkv, eps, stats)
        o = attention_core(qkv, num_heads, scale, temperature)
        # out = dt(f32(x) + o @ W_proj^T + b_proj): g passes to x unchanged
        do = g @ w_proj.to(dt)
        dwp = _weight_grad(g, o, w_proj)
        dqkv = attention_backward(qkv, do, num_heads, scale, temperature)
        # qkv = dt(f32(LN1(x) @ W_qkv^T) + b_qkv)
        xn, dx, dgamma, dbeta, dbp = ln1_backward(
            x, stats, gamma, beta, dqkv @ w_qkv.to(dt), g, eps)
        dwq = _weight_grad(dqkv, xn, w_qkv)
        dbq = dqkv.sum((0, 1), dtype=torch.float32)
        return (dx, dwq, dbq.to(b_qkv.dtype), dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype), dwp, dbp.to(b_proj.dtype),
                None, None, None, None)


def attn_supercell(x, w_qkv, b_qkv, gamma, beta, w_proj, b_proj,
                   num_heads: int, scale: float, temperature: float = 1.0,
                   eps: float = 1e-6) -> torch.Tensor:
    """x + proj(attn(qkv(LN(x)))) through kernels A, B and C, differentiable
    through E.

    x (B,T,D); w_qkv (3D,D); b_qkv (3D,); gamma/beta (D,); w_proj (D,D);
    b_proj (D,). Returns (B,T,D) in x.dtype."""
    return _AttnSupercell.apply(x, w_qkv, b_qkv, gamma, beta, w_proj, b_proj,
                                num_heads, scale, temperature, eps)


def attn_supercell_ref(x, w_qkv, b_qkv, gamma, beta, w_proj, b_proj,
                       num_heads: int, scale: float, temperature: float = 1.0,
                       eps: float = 1e-6) -> torch.Tensor:
    """Plain version (``attn_block_pallas.py::_ref_forward`` with the kernel's
    cast points): the three plain versions chained, on any device."""
    qkv = ln_qkv_ref(x, gamma, beta, w_qkv, b_qkv, eps)
    o = attention_qkv_fused_ref(qkv, num_heads, scale, temperature)
    return proj_residual_ref(o, w_proj, b_proj, x)
