"""int8 MLP half: x + fc2(gelu(fc1(LN2(x)))) with int8 products, the opt-in
(``--int8_mlp``) MLP half of a frozen ViT block.

Counterpart of ``ep_tpu/ops/mlp_int8_pallas.py``. The arithmetic, rounding
where the TPU kernels round:

1. LN2 in f32 (mean, biased variance, ``rsqrt(var + eps)``, gamma, beta);
2. per-token symmetric quantisation: ``sx = max(max|h|, 1e-8) / 127``,
   ``hq = round(h / sx)`` (half to even, a true division);
3. weights per output channel (:func:`quantize_weight`), from the
   full-precision weights on every call, outside the kernels, in plain torch;
4. per hidden stripe: ``hq @ w1q`` in s32; ``a = acc*(sx*s1) + b1`` in f32;
   tanh-GELU on ``a`` rounded to bf16 and in bf16; ``sa = max(max|a|, 1e-8) /
   127`` per token and per stripe; ``aq = round(a / sa)``; ``aq @ w2q`` in s32;
   ``y += acc2*(sa*s2)`` in f32;
5. the bias and the residual in the order of the JAX package's tier:
   ``x_f32 + (y + b2)`` at the resident tier (``_kernel``), ``(x_f32 + y) +
   b2`` at the two-kernel tier (``_kernel_fc2``); then x's dtype.

The stripe count is part of the result (it sets which columns share an
activation scale), and so is the tier (it sets the order of step 5);
:func:`plan` gives both as the JAX package chooses them at a shape, so both
packages compute the same function shape for shape. The order is the tier's
and not the stripe count's: ViT-L is resident at 8 stripes, ViT-H two-kernel
at 8. Where the
JAX package would silently run the bf16 half (``plan`` answers ``fallback``),
the port raises ``NotImplementedError``.

On a CUDA device the half runs as three hand-written kernels
(``csrc/mlp_int8.cu``): :func:`ln_quant` (steps 1-2), :func:`fc1` (step 4 up
to ``aq``, ``sa``) and :func:`fc2` (the rest, on the same ``wgmma`` main loop
as ``fc1``). Only int8 codes with their f32 scales
pass between them through device memory. ``fc1`` runs each stripe's product
once: the blocks of a cluster keep the stripe's GELU outputs in shared memory
until its max is known (:func:`fc1_tiling`), and read the bf16 GELU from a
table that the kernels' own GELU arithmetic fills once a device
(:func:`gelu_table_mismatches` tries every bf16 value against it). On the CPU the plain versions below
run; they are also what the kernels are checked against on the card. Weights
are in the ``nn.Linear`` layout: w1 (DH, D), w2 (D, DH).

The backward is the straight-through estimator of the JAX package's ``_bwd``:
autograd through the bf16 half (:func:`mlp_bf16_ref`) recomputed from the
saved inputs. The JAX package has no backward kernel here, and neither has
the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import LAUNCHES, MAX_SMEM, check, use_kernel
from ._build import call, query, stream_ptr

# The tanh-GELU's constants as bf16 holds them (``jax.nn.gelu`` on a bf16
# array rounds its constants to bf16): 0.044715 and sqrt(2/pi).
GELU_K0 = 0.044677734375
GELU_K1 = 0.796875


def _div127(t: torch.Tensor) -> torch.Tensor:
    # A true division: dividing a CUDA tensor by a Python number multiplies
    # by its reciprocal instead, which can differ in the last bit.
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def quantize_weight(w: torch.Tensor):
    """(out, in) weight -> int8 codes (out, in) and (out,) f32 per-channel
    scales: ``s = max(max_in|w| / 127, 1e-8)``, ``clip(round(w / s), ±127)``."""
    wf = w.float()
    s = _div127(wf.abs().amax(dim=1)).clamp_min(1e-8)
    wq = torch.round(wf / s[:, None]).clamp(-127, 127).to(torch.int8)
    return wq, s


def plan(T: int, D: int, DH: int) -> tuple:
    """The tier and stripe count the JAX package uses at (T, D, DH).

    A copy of ``mlp_int8_pallas.plan``, kept for the tier and the stripe
    count: ``("resident", stripes)``, ``("two_kernel", 8)`` or
    ``("fallback",)``.
    Its byte estimates describe the TPU's VMEM; they say nothing about the
    H100 and choose no tile there.
    """
    stripes = 1

    def est(s):
        return (2 * D * DH + 4 * T * D * 2 + (T * (DH // s) * 4 * 2)
                + T * (DH // s) + T * D * 4)

    while est(stripes) > 12 * 1024 * 1024 and stripes < 8 \
            and (DH // (2 * stripes)) % 128 == 0:
        stripes *= 2
    if est(stripes) <= 12 * 1024 * 1024:
        return ("resident", stripes)
    ns = 8
    ds = DH // ns
    est2 = max(
        D * DH + 4 * T * D * 2 + 2 * T * DH + T * ds * 9,
        D * DH + 2 * T * DH + 4 * T * D * 2 + T * D * 8)
    if DH % ns == 0 and ds % 128 == 0 and est2 <= 15 * 1024 * 1024:
        return ("two_kernel", ns)
    return ("fallback",)


def stripes_for(T: int, D: int, DH: int) -> int:
    """The stripe count of :func:`plan`; raises where it answers fallback."""
    tier = plan(T, D, DH)
    if tier[0] == "fallback":
        raise NotImplementedError(
            f"int8 MLP half: no tier of the JAX package takes T={T}, D={D}, "
            f"DH={DH} (it runs the bf16 half there); use int8_mlp=False")
    return tier[1]


def gelu_tanh_bf16(a: torch.Tensor) -> torch.Tensor:
    """tanh-form GELU of a bf16 tensor in bf16: every elementary operation
    rounds to bf16 and the constants are bf16, as ``jax.nn.gelu(a,
    approximate=True)`` computes it on a bf16 array. (``F.gelu`` computes in
    f32 and rounds once, which moves single int8 codes.)"""
    if a.dtype != torch.bfloat16:
        raise TypeError(f"gelu_tanh_bf16: expected bfloat16, got {a.dtype}")
    x3 = (a * a) * a
    inner = a + x3 * GELU_K0
    cdf = (torch.tanh(inner * GELU_K1) + 1.0) * 0.5
    return a * cdf


def _int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) x int8 (N, K) -> the s32 product converted to f32.
    Through f64, where every sum of K products of int8 codes is exact."""
    return (a.double() @ w.double().t()).float()


def ln_quant_ref(x, gamma, beta, eps):
    """Steps 1-2: int8 codes of LN2(x), (..., D), and their scales (..., 1)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    h = (xf - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    sx = _div127(h.abs().amax(-1, keepdim=True).clamp_min(1e-8))
    return torch.round(h / sx).to(torch.int8), sx


def fc1_ref(hq, sx, w1q, s1, b1, stripes: int):
    """Step 4 up to the codes: hq (B,T,D) int8 with sx (B,T,1) -> aq (B,T,DH)
    int8 and sa (B,T,stripes) f32."""
    DH = w1q.shape[0]
    ds = DH // stripes
    aq = torch.empty(*hq.shape[:-1], DH, dtype=torch.int8, device=hq.device)
    sa = torch.empty(*hq.shape[:-1], stripes, dtype=torch.float32,
                     device=hq.device)
    b1 = b1.float()
    for s in range(stripes):
        sl = slice(s * ds, (s + 1) * ds)
        a = _int_matmul(hq, w1q[sl]) * (sx * s1[sl]) + b1[sl]
        a = gelu_tanh_bf16(a.to(torch.bfloat16)).float()
        sas = _div127(a.abs().amax(-1, keepdim=True).clamp_min(1e-8))
        aq[..., sl] = torch.round(a / sas).to(torch.int8)
        sa[..., s:s + 1] = sas
    return aq, sa


TIERS = ("resident", "two_kernel")


def _check_tier(tier: str) -> None:
    if tier not in TIERS:
        raise ValueError(f"int8 MLP half: tier {tier!r} is none of {TIERS}")


def fc2_ref(aq, sa, x, w2q, s2, b2, stripes: int, tier: str = "resident"):
    """The rest of step 4 and step 5: ``mlp_int8_pallas._kernel`` after its
    second product at the resident tier, ``_kernel_fc2`` at the two-kernel
    tier."""
    _check_tier(tier)
    ds = aq.shape[-1] // stripes
    y = None
    for s in range(stripes):
        sl = slice(s * ds, (s + 1) * ds)
        part = _int_matmul(aq[..., sl], w2q[:, sl]) * (sa[..., s:s + 1] * s2)
        y = part if y is None else y + part
    xf, b = x.float(), b2.float()
    out = (xf + y) + b if tier == "two_kernel" else xf + (y + b)
    return out.to(x.dtype)


def mlp_int8_ref(x, w1, b1, w2, b2, gamma, beta, eps: float, stripes: int,
                 tier: str = "resident"):
    """Plain version of the whole int8 half for a given stripe count and tier,
    on any device: the numbers of the JAX package's kernels of that tier."""
    w1q, s1 = quantize_weight(w1)
    w2q, s2 = quantize_weight(w2)
    hq, sx = ln_quant_ref(x, gamma, beta, eps)
    aq, sa = fc1_ref(hq, sx, w1q, s1, b1, stripes)
    return fc2_ref(aq, sa, x, w2q, s2, b2, stripes, tier)


def mlp_bf16_ref(x, w1, b1, w2, b2, gamma, beta, eps: float):
    """The same half in x's dtype without quantisation
    (``mlp_int8_pallas._ref_forward``): what the backward differentiates."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    h = ((xf - mu) * torch.rsqrt(var + eps) * gamma.float()
         + beta.float()).to(dt)
    h = F.linear(h, w1.to(dt)).float() + b1.float()
    h = F.gelu(h.to(dt), approximate="tanh")
    h = F.linear(h, w2.to(dt)).float() + b2.float()
    return (xf + h).to(dt)


def _check_shapes(D: int, DH: int, stripes: int) -> None:
    # csrc/mlp_int8.cu streams K in slices of 128 bytes and tiles each
    # stripe's columns by 128
    if D % 128 or DH % stripes or (DH // stripes) % 128:
        raise NotImplementedError(
            "int8 MLP kernels need D % 128 == 0 and (DH / stripes) % 128 == 0;"
            f" got D={D}, DH={DH}, stripes={stripes}")


# Kernel fc1 keeps a block's GELU outputs in shared memory until the stripe's
# max is known: ``tiles`` tiles of ``bn`` columns a block, and the blocks of a
# cluster split the stripe. Columns a block -> (bn, tiles).
FC1_BLOCK_COLUMNS = {384: (128, 3), 320: (160, 2), 256: (128, 2),
                     128: (128, 1)}
FC1_MAX_CLUSTER = 8


def fc1_tiling(ds: int) -> tuple[int, int, int]:
    """(tile width, tiles a block, cluster size) kernel ``fc1`` takes for a
    stripe of ``ds`` columns: the smallest cluster whose blocks' share of the
    stripe is one of ``FC1_BLOCK_COLUMNS``."""
    for c in range(1, FC1_MAX_CLUSTER + 1):
        if ds % c == 0 and ds // c in FC1_BLOCK_COLUMNS:
            return (*FC1_BLOCK_COLUMNS[ds // c], c)
    raise NotImplementedError(
        f"fc1: no tiling for a stripe of {ds} columns: it must be C blocks of "
        f"{sorted(FC1_BLOCK_COLUMNS)} columns with C <= {FC1_MAX_CLUSTER}")


_GELU_TABLES: dict = {}


def gelu_table_mismatches(device: torch.device) -> int:
    """At how many finite bf16 values kernel ``fc1``'s table-driven GELU
    differs from the kernels' GELU arithmetic (it must be 0): every value is
    tried on the card."""
    count = torch.zeros(1, device=device, dtype=torch.int32)
    call("ep_mlp_int8_gelu_check", _gelu_table(device).data_ptr(),
         count.data_ptr(), stream_ptr(count))
    return int(count)


def _gelu_table(device: torch.device) -> torch.Tensor:
    """The bf16 -> bf16 table of the GELU that kernel ``fc1`` reads, filled on
    the card by the kernels' own GELU arithmetic, once a device."""
    key = (device.type, device.index)
    if key not in _GELU_TABLES:
        table = torch.empty(query("ep_mlp_int8_gelu_table_entries"),
                            device=device, dtype=torch.int16)
        call("ep_mlp_int8_gelu_table", table.data_ptr(), stream_ptr(table))
        _GELU_TABLES[key] = table
    return _GELU_TABLES[key]


# Kernel ln_quant holds a row in one warp's registers up to D = 2048 and
# stages a wider one in shared memory, one row a warp: at most MAX_SMEM / 2
# columns.
LN_QUANT_MAX_D = MAX_SMEM // 2


def check_ln_quant_width(D: int) -> None:
    """Raise NotImplementedError unless kernel ``ln_quant`` takes rows of D."""
    if D % 128 or D > LN_QUANT_MAX_D:
        raise NotImplementedError(
            f"ln_quant: needs D % 128 == 0 and D <= {LN_QUANT_MAX_D} (a row in "
            f"one warp's share of shared memory); got D={D}")


def ln_quant(x, gamma, beta, eps: float):
    """Kernel ``ln_quant``: x (B,T,D) bf16 -> hq (B,T,D) int8, sx (B,T,1)."""
    if not use_kernel(x, gamma, beta):
        return ln_quant_ref(x, gamma, beta, eps)
    B, T, D = x.shape
    check_ln_quant_width(D)
    g, bt = gamma.float().contiguous(), beta.float().contiguous()
    check(x, "x", (B, T, D), torch.bfloat16)
    check(g, "gamma", (D,), torch.float32)
    check(bt, "beta", (D,), torch.float32)
    hq = torch.empty(B, T, D, device=x.device, dtype=torch.int8)
    sx = torch.empty(B, T, 1, device=x.device, dtype=torch.float32)
    call("ep_mlp_int8_ln_quant", x.data_ptr(), g.data_ptr(), bt.data_ptr(),
         hq.data_ptr(), sx.data_ptr(), B * T, D, eps, stream_ptr(x))
    LAUNCHES["mlp_int8_ln_quant"] += 1
    return hq, sx


def fc1(hq, sx, w1q, s1, b1, stripes: int):
    """Kernel ``fc1``: hq (B,T,D) int8 with sx (B,T,1) -> aq (B,T,DH) int8,
    sa (B,T,stripes) f32."""
    if not use_kernel(hq, sx, w1q, s1, b1):
        return fc1_ref(hq, sx, w1q, s1, b1, stripes)
    B, T, D = hq.shape
    DH = w1q.shape[0]
    _check_shapes(D, DH, stripes)
    bn, tiles, _ = fc1_tiling(DH // stripes)
    b1 = b1.float().contiguous()
    check(hq, "hq", (B, T, D), torch.int8)
    check(sx, "sx", (B, T, 1), torch.float32)
    check(w1q, "w1q", (DH, D), torch.int8)
    check(s1, "s1", (DH,), torch.float32)
    check(b1, "b1", (DH,), torch.float32)
    aq = torch.empty(B, T, DH, device=hq.device, dtype=torch.int8)
    sa = torch.empty(B, T, stripes, device=hq.device, dtype=torch.float32)
    call("ep_mlp_int8_fc1", hq.data_ptr(), sx.data_ptr(), w1q.data_ptr(),
         s1.data_ptr(), b1.data_ptr(), _gelu_table(hq.device).data_ptr(),
         aq.data_ptr(), sa.data_ptr(), B * T, D, DH, stripes, bn, tiles,
         stream_ptr(hq))
    LAUNCHES["mlp_int8_fc1"] += 1
    return aq, sa


def fc2(aq, sa, x, w2q, s2, b2, stripes: int, tier: str = "resident"):
    """Kernel ``fc2``: aq, sa, the residual x (B,T,D) bf16 -> out (B,T,D),
    the bias added in ``tier``'s order."""
    if not use_kernel(aq, sa, x, w2q, s2, b2):
        return fc2_ref(aq, sa, x, w2q, s2, b2, stripes, tier)
    _check_tier(tier)
    B, T, D = x.shape
    DH = aq.shape[-1]
    _check_shapes(D, DH, stripes)
    b2 = b2.float().contiguous()
    check(aq, "aq", (B, T, DH), torch.int8)
    check(sa, "sa", (B, T, stripes), torch.float32)
    check(x, "x", (B, T, D), torch.bfloat16)
    check(w2q, "w2q", (D, DH), torch.int8)
    check(s2, "s2", (D,), torch.float32)
    check(b2, "b2", (D,), torch.float32)
    out = torch.empty_like(x)
    call("ep_mlp_int8_fc2", aq.data_ptr(), sa.data_ptr(), w2q.data_ptr(),
         s2.data_ptr(), b2.data_ptr(), x.data_ptr(), out.data_ptr(), B * T, D,
         DH, stripes, int(tier == "two_kernel"), stream_ptr(x))
    LAUNCHES["mlp_int8_fc2"] += 1
    return out


def mlp_int8_forward(x, w1, b1, w2, b2, gamma, beta, eps: float, stripes: int,
                     tier: str = "resident"):
    """The int8 half for a given stripe count and tier: the kernels for CUDA
    tensors, the plain versions for CPU tensors. The weights are quantised
    here, in plain torch, on every call, as the JAX package leaves it to
    XLA."""
    w1q, s1 = quantize_weight(w1)
    w2q, s2 = quantize_weight(w2)
    hq, sx = ln_quant(x, gamma, beta, eps)
    aq, sa = fc1(hq, sx, w1q, s1, b1, stripes)
    return fc2(aq, sa, x, w2q, s2, b2, stripes, tier)


class _MlpInt8(torch.autograd.Function):
    """Residuals are the inputs alone; the backward recomputes the bf16 half
    (``mlp_int8_pallas._bwd``)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, gamma, beta, eps):
        ctx.save_for_backward(x, w1, b1, w2, b2, gamma, beta)
        ctx.eps = eps
        T, D, DH = x.shape[1], x.shape[2], w1.shape[0]
        return mlp_int8_forward(x, w1, b1, w2, b2, gamma, beta, eps,
                                stripes_for(T, D, DH), plan(T, D, DH)[0])

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in
                   zip(ctx.saved_tensors, ctx.needs_input_grad)]
            out = mlp_bf16_ref(*ins, ctx.eps)
        wanted = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in ins), None)


def mlp_int8_fused(x, w1, b1, w2, b2, gamma, beta,
                   eps: float = 1e-6) -> torch.Tensor:
    """x + fc2(gelu(fc1(LN(x)))) with int8 products.

    x (B,T,D); w1 (DH,D); b1 (DH,); w2 (D,DH); b2 (D,); gamma/beta (D,):
    full-precision weights in, quantised per output channel on every call.
    The tier and stripe count are :func:`plan`'s at (T, D, DH). Returns (B,T,D) in
    x.dtype; differentiable as the bf16 half (straight-through)."""
    return _MlpInt8.apply(x, w1, b1, w2, b2, gamma, beta, eps)
