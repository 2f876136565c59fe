"""One configurable Vision Transformer for the whole backbone family, in
PyTorch.

Counterpart of ``ep_tpu/models/vit.py``: patch embedding, an optional [CLS]
token and register tokens, an absolute position embedding or none, an
optional ``norm_pre`` (OpenCLIP's ln_pre), blocks, an optional final norm and
OpenCLIP's cls projection, and every feature mode of
``VisionTransformer._select_features``.

A block takes one of two routes, by the JAX package's gate
(``ep_tpu/models/vit.py:406-409``):

* the attention supercell (``ops/attn_block.py``: kernels A, B or, at long
  sequences, F, and C on the card; E in its backward) where ``attn_impl`` is
  ``"pallas"``, or ``"auto"`` in one process or on a registered mesh whose
  model axis is 1 (``ViTConfig.kernel_attention``, read when the model is
  built), and the block has a full qkv bias, no LayerScale
  and no relative-position bias, and does not capture its probabilities;
* otherwise the plain ``Attention`` route: LN1, the qkv product, the
  ``qv_only`` bias, then ``ops/attn_fused.py::attention_qkv_fused`` (kernel B
  or F on the card, E or the tiled long-T backward) where the kernels are
  enabled and there is no bias and no capture, else ``ops/attention.py::mha``
  (plain torch, as the JAX package leaves it to XLA), the projection and
  LayerScale.

``attn_impl="xla"`` (the JAX package's ``ViTConfig`` default, and MAE's
decoder) keeps every block on the plain route through ``mha``: no attention
kernel. The port's default is ``"auto"``, so that a config built directly
takes the kernels, as every path did before the field existed.

The MLP half is plain torch (GELU, QuickGELU or SwiGLU) or, with
``int8_mlp=True`` on a supercell block (``--int8_mlp``, opt-in and
approximate), the int8 half of ``ops/mlp_int8.py``. A bf16 GELU MLP on the
card that needs no gradient and is not cut computes fc1, its bias and the
tanh GELU as one library product with the activation in its epilogue
(``ops/fc1_gelu.py``). SwiGLU's gate is
``ops/swiglu.py::swiglu_gate`` (one kernel on the card) where no gradient
is needed and the block is whole, the plain chain otherwise. In a
LayerScale block, LayerScale and the residual that close each half are one
pass (``ops/layerscale.py``) on bf16 card tensors that need no gradient,
bit for bit the chain that every other call runs.

With ``rope_base`` set (DINOv3), the blocks rotate q and k of the patch
tokens by 2D axial RoPE (``ops/rope.py``) on the plain attention route,
before kernel B or F or ``mha``: the kernel pass in place where no gradient
is needed, the plain chain otherwise; the sines and cosines come from the
live patch grid, cached per grid and device. Such a block never takes the
supercell, which has no RoPE.

Register tokens sit after the [CLS] token. With ``reg_pos_embed=True`` (the
JAX package's layout) the position embedding has a row for each of them;
with ``reg_pos_embed=False`` (DINOv2's hub layout, ``prepare_tokens_with_
masks``) it covers ``[cls | patches]`` only, and the registers are inserted
after [CLS] once it has been added.

Block rematerialisation for fine-tuning (``remat_blocks``) is
``torch.utils.checkpoint`` with the JAX package's four policies
(``_remat_policy``): ``none`` recomputes the whole block; ``attn_out`` keeps
the attention half's output and recomputes the MLP half; ``attn_fc1`` also
keeps fc1's output; ``dots`` recomputes the whole block but keeps every matrix
product's output. ``scan_blocks`` is flag surface (``remat_blocks`` needs it,
and the configurations the JAX package's scan refuses raise ``ValueError``),
but the port always loops over the blocks.

Under a profiler, ``Block.attn_half`` and ``Block.mlp_half`` open the spans
``ep::attn_half`` and ``ep::mlp_half`` (``runtime/profiler.py::span``) on
every route, a recomputation in the backward included; ``SwiGLUMlp`` opens
``ep::swiglu_gate`` around its gate on either route, and ``Attention``
``ep::rope`` around RoPE.

Parameter names follow timm (``patch_embed.proj``, ``blocks.{i}.attn.qkv``,
``blocks.{i}.ls1.gamma``, ``reg_token``, ``norm``, ``norm_pre``,
``attn.q_bias``, ``mlp.w12``, ``rel_pos_bias.relative_position_bias_table``;
a per-block table is ``rel_pos_bias_{i}``, as in the flax tree) and every
weight is in the ``nn.Linear``/``nn.Conv2d`` layout but OpenCLIP's ``proj``
(D, proj_dim), used as ``x @ proj`` as open_clip does. Parameters are
created in float32; ``train/state.py::cast_frozen`` stores a frozen encoder
in the compute dtype, as the JAX package does.

``capture_stats=True`` (the attention-statistics CLI) runs every block on the
plain route with its probabilities, the MLP half without int8, and returns
the 5-kind statistics of ``ops/attention.py::attn_stats_from_probs`` and the
residual magnitudes beside the features, as the JAX package's ``_finish``
does.

A block cut over a model axis above 1 (``parallel/partition.py::
shard_state``) computes Megatron's way on its pieces: LN on the whole width,
the local qkv (or fc1, w12) product, attention on its heads (or the
activation on its hidden units), the partial proj (fc2, w3) product summed
over the model group in f32, then the bias once, LayerScale and the
residual. Under ``attn_impl="auto"`` such a block takes the plain route (the
kernel gate's mesh term); under ``"pallas"`` it joins its pieces into whole
tensors for each call and runs the kernels as one process does. Captured
probabilities are joined into head order.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, noop_context_fn

from ep_tpu_torch.ops.attention import (attn_stats_from_probs, mha, mm_f32,
                                        scaled)
from ep_tpu_torch.ops.attn_block import attn_supercell
from ep_tpu_torch.ops.attn_fused import attention_qkv_fused
from ep_tpu_torch.ops.fc1_gelu import fc1_gelu, takes_gelu_epilogue
from ep_tpu_torch.ops.layerscale import (ls_residual, ls_residual_ref,
                                         takes_ls_kernel)
from ep_tpu_torch.ops.mlp_int8 import mlp_int8_fused
from ep_tpu_torch.ops.rope import rope_qk, rope_qk_ref, rope_tables
from ep_tpu_torch.ops.swiglu import swiglu_gate, swiglu_gate_ref
from ep_tpu_torch.parallel.mesh import (MODEL_AXIS, Mesh, current_mesh,
                                        process_count)
from ep_tpu_torch.parallel.metrics import all_gather_rows, psum
from ep_tpu_torch.parallel.partition import whole_tensors
from ep_tpu_torch.poolings.common import Dense, mean_f32
from ep_tpu_torch.runtime.profiler import span
from ep_tpu_torch.utils.pos_embed import interpolate_pos_embed

# RoPE's (sin, cos) of the live patch grid, each (patches, head width) f32
Rope = Tuple[torch.Tensor, torch.Tensor]

# Pooled-feature names that consume patch tokens only / [CLS]+patch tokens.
ATTENTIVE_POOLINGS = [
    "abmilp", "simpool", "esimpool", "clip", "siglip", "aim", "ep", "cbam",
    "coca", "cait", "dinovit", "jepa", "dolg", "cae",
]
ATTENTIVE_POOLINGS_ALL = [f"{n}_all" for n in ATTENTIVE_POOLINGS]


def remap_features(return_features: str) -> str:
    """CLI name -> token-level mode (``ep_tpu/models/vit.py::remap_features``)."""
    if return_features == "pos":
        return "gap"
    if return_features in ATTENTIVE_POOLINGS:
        return "pos"
    if return_features in ATTENTIVE_POOLINGS_ALL:
        return "both"
    return return_features


@dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qkv_bias_mode: str = "full"  # full | qv_only (BEiT/SimMIM)
    class_token: bool = True
    reg_tokens: int = 0
    reg_pos_embed: bool = True  # False: DINOv2's hub layout (no register rows)
    cls_from_registers: bool = False  # CAPI: the register mean is the cls
    use_abs_pos_emb: bool = True
    rel_pos_bias: str = "none"  # none | shared | per_block
    init_values: Optional[float] = None  # LayerScale
    final_norm: str = "none"  # none | ln
    norm_eps: float = 1e-6
    # gelu (erf in f32, tanh in bf16) | gelu_tanh (tanh at every precision:
    # SigLIP) | swiglu | quick_gelu (OpenAI CLIP)
    mlp_type: str = "gelu"
    pre_norm: bool = False  # OpenCLIP ln_pre
    proj_dim: Optional[int] = None  # OpenCLIP's cls projection
    dtype: torch.dtype = torch.bfloat16  # compute dtype; parameters are f32
    scan_blocks: bool = False  # flag surface only: the port loops
    remat_blocks: bool = False  # recompute blocks in the backward
    remat_policy: str = "none"  # none | attn_out | attn_fc1 | dots
    int8_mlp: bool = False  # opt-in int8 MLP half (ops/mlp_int8.py)
    # auto | pallas: the kernels (supercell, B/F); xla: plain attention (mha).
    # "auto", not the JAX package's "xla", so a config built directly keeps
    # the kernels; MAE's decoder and --attn_impl xla ask for "xla"
    attn_impl: str = "auto"
    # 2D axial RoPE's base on q and k of the patch tokens (DINOv3: 100);
    # None: no RoPE. The port's alone: the JAX package has no RoPE
    rope_base: Optional[float] = None

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2

    @property
    def num_prefix_tokens(self) -> int:
        return (1 if self.class_token else 0) + self.reg_tokens

    @property
    def num_pos_prefix_tokens(self) -> int:
        """The position embedding's rows before the patch grid's."""
        return ((1 if self.class_token else 0)
                + (self.reg_tokens if self.reg_pos_embed else 0))

    @property
    def kernel_attention(self) -> bool:
        """Whether attention may run the kernels (``ep_tpu/models/vit.py::
        _pallas_attn_enabled``): "pallas" forces them; "auto" takes them in
        one process, or where the registered mesh's model axis is 1 (each
        rank runs them on its own rows), and the plain route otherwise, as
        the JAX package sends a tensor-parallel mesh to XLA attention."""
        if self.attn_impl == "pallas":
            return True
        if self.attn_impl != "auto":
            return False
        if process_count() == 1:
            return True
        mesh = current_mesh()
        return mesh is not None and mesh.shape[MODEL_AXIS] == 1

    @property
    def supercell(self) -> bool:
        """Whether a block may take the attention supercell: the static half
        of the JAX package's gate (``ep_tpu/models/vit.py:406-409``)."""
        return (self.kernel_attention and self.rel_pos_bias == "none"
                and self.init_values is None and self.qkv_bias
                and self.qkv_bias_mode == "full" and self.rope_base is None)

    def replace(self, **kw) -> "ViTConfig":
        return dataclasses.replace(self, **kw)


def int8_mlp_inactive_reason(c: ViTConfig) -> Optional[str]:
    """Why a requested ``int8_mlp`` would leave the MLP half in bf16, else
    None (``ep_tpu/models/vit.py::int8_mlp_inactive_reason``): the int8 half
    runs only on a supercell block. The JAX package's backend reason has no
    counterpart (the port takes its kernels by device); its mesh reason is
    given in its words."""
    if not c.int8_mlp:
        return None
    if c.mlp_type != "gelu":
        return f"mlp_type={c.mlp_type!r} (SwiGLU/QuickGELU MLPs stay bf16)"
    if c.rel_pos_bias != "none":
        return "rel-pos-bias backbones take the plain attention path"
    if c.init_values is not None:
        return "LayerScale backbones take the plain attention path"
    if c.rope_base is not None:
        return "RoPE backbones take the plain attention path"
    if not (c.qkv_bias and c.qkv_bias_mode == "full"):
        return "qkv_bias mode is not 'full' (supercell needs fused qkv bias)"
    if not c.kernel_attention:
        return ("attn_impl resolves to XLA (attn_impl='xla', or 'auto' on a "
                "tensor-parallel mesh)")
    return None


REMAT_POLICIES = ("none", "attn_out", "attn_fc1", "dots")
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def _keep_matmuls(width: Optional[int]) -> Callable:
    """``context_fn`` for ``checkpoint`` that keeps the outputs of the matrix
    products (of those ``width`` columns wide, if given) and recomputes the
    rest: the counterpart of a ``jax.checkpoint`` policy that saves dots."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        if op in _MATMULS and width in (None, args[-1].shape[-1]):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return functools.partial(create_selective_checkpoint_contexts, policy)


def _remat_policy(name: str, hidden: int):
    """``remat_policy`` -> (whether the checkpoint covers the whole block and
    not just the MLP half, its ``context_fn``)."""
    if name in ("none", ""):
        return True, noop_context_fn
    if name == "attn_out":
        return False, noop_context_fn
    if name == "attn_fc1":
        return False, _keep_matmuls(hidden)
    if name == "dots":
        return True, _keep_matmuls(None)
    raise ValueError(f"unknown remat_policy {name!r} "
                     f"({' | '.join(REMAT_POLICIES)})")


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """``norm`` in x's dtype (f32 statistics inside), its weights cast."""
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps)


def row_parallel(x: torch.Tensor, dense: Dense, mesh: Mesh) -> torch.Tensor:
    """``dense(x)`` where ``dense`` holds this rank's columns of a
    row-parallel weight and ``x`` the matching features: the partial product
    with f32 sums, summed over the model group in f32, the bias added once,
    then one rounding to the compute dtype (two bf16 partials summed would
    round twice)."""
    dt = dense.compute_dtype
    y = mm_f32(x.to(dt).reshape(1, -1, x.shape[-1]),
               dense.weight.to(dt).t()[None])[0]
    y = psum(y, MODEL_AXIS, mesh)
    if dense.bias is not None:
        y = y + dense.bias.to(dt).float()
    return y.to(dt).reshape(*x.shape[:-1], -1)


def gather_heads(probs: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's (B, H/M, T, T) probabilities joined over the model group
    into (B, H, T, T) in head order, on ``probs``' device."""
    g = all_gather_rows(probs.transpose(0, 1), MODEL_AXIS, mesh)
    return g.transpose(0, 1).to(probs.device)


def _rel_pos_index(grid: Tuple[int, int]) -> np.ndarray:
    """BEiT relative-position index over a (H, W) grid + [CLS]
    (``ep_tpu/models/vit.py::_rel_pos_index``), shape (T, T), T = H*W+1."""
    wh, ww = grid
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    idx = np.zeros((wh * ww + 1, wh * ww + 1), dtype=np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel - 3
    idx[0:, 0] = num_rel - 2
    idx[0, 0] = num_rel - 1
    return idx


class RelPosBias(nn.Module):
    """Relative-position bias table (zeros at init) -> (1, H, T, T) f32."""

    def __init__(self, grid: Tuple[int, int], num_heads: int):
        super().__init__()
        wh, ww = grid
        num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(num_rel, num_heads))
        self.register_buffer("index", torch.from_numpy(_rel_pos_index(grid)),
                             persistent=False)

    def forward(self) -> torch.Tensor:
        T = self.index.shape[0]
        table = self.relative_position_bias_table.float()
        return table[self.index.reshape(-1)].reshape(T, T, -1).permute(
            2, 0, 1)[None]


class PatchEmbed(nn.Module):
    """Conv2d(kernel = stride = patch) computed as reshape plus one matmul,
    which is exact when the stride equals the kernel. An image side that is
    not a multiple of the patch is cropped to its first floor(side / patch)
    patches, the pixels a "valid" convolution reads (SigLIP at 384 px with
    patch 14: 27 patches a side, the last 6 rows and columns dropped)."""

    def __init__(self, patch_size: int, in_chans: int, dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        B, H, W, C = x.shape  # NHWC
        p = self.patch_size
        if H % p or W % p:
            x = x[:, :H // p * p, :W // p * p]
        x = x.to(dtype).reshape(B, H // p, p, W // p, p, C)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(B, (H // p) * (W // p), C * p * p)
        w = self.proj.weight.to(dtype).reshape(self.proj.out_channels, -1)
        return F.linear(x, w) + self.proj.bias.to(dtype)


class Attention(nn.Module):
    """The attention half's parameters, and the plain route through them
    (``ep_tpu/models/vit.py::Attention``); the supercell reads the same
    ``qkv`` and ``proj``.

    Cut by head group (``parallel/partition.py::shard_block``; ``tp`` says
    how), it runs its heads: the local qkv product, its slice of a
    ``qv_only`` bias and of the relative-position table, attention on H/M
    heads, the partial ``proj`` product summed over the model group
    (:func:`row_parallel`), and its probabilities joined into head order."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        D = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.scale = (D // cfg.num_heads) ** -0.5
        self.qv_only = cfg.qkv_bias and cfg.qkv_bias_mode == "qv_only"
        self.kernel = cfg.kernel_attention
        self.qkv = Dense(D, 3 * D, bias=cfg.qkv_bias and not self.qv_only,
                         dtype=cfg.dtype)
        if self.qv_only:
            self.q_bias = nn.Parameter(torch.zeros(D))
            self.v_bias = nn.Parameter(torch.zeros(D))
        self.proj = Dense(D, D, dtype=cfg.dtype)
        self.tp = None  # parallel/partition.py::TensorParallel once cut

    def forward(self, x: torch.Tensor, temperature: float = 1.0,
                rel_bias: Optional[torch.Tensor] = None,
                return_probs: bool = False, rope: Optional[Rope] = None):
        B, T, D = x.shape
        heads = None if self.tp is None else self.tp.heads
        H = self.num_heads if heads is None else heads.stop - heads.start
        Dh = D // self.num_heads
        qkv = self.qkv(x)
        if self.qv_only:
            q_bias, v_bias = self.q_bias, self.v_bias
            if heads is not None:
                cols = slice(heads.start * Dh, heads.stop * Dh)
                q_bias, v_bias = q_bias[cols], v_bias[cols]
            bias = torch.cat([q_bias, torch.zeros_like(q_bias), v_bias])
            qkv = qkv + bias.to(qkv.dtype)
        if rope is not None:
            # every head alike, so a head slice rotates as the whole does
            with span("ep::rope"):
                qkv = (rope_qk_ref(qkv, *rope, H) if qkv.requires_grad
                       else rope_qk(qkv, *rope, H))
        if rel_bias is not None and heads is not None:
            rel_bias = rel_bias[:, heads]
        probs = None
        if self.kernel and not return_probs and rel_bias is None:
            # natural layout: kernel B or F on the card, no head split
            out = attention_qkv_fused(qkv, H, self.scale, temperature)
        else:
            q, k, v = qkv.reshape(B, T, 3, H, Dh).permute(2, 0, 3, 1, 4)
            out = mha(q, k, v, self.scale, temperature=temperature,
                      bias=rel_bias, return_probs=return_probs)
            if return_probs:
                out, probs = out
            out = out.transpose(1, 2).reshape(B, T, H * Dh)
        if heads is None:
            out = self.proj(out)
        else:
            out = row_parallel(out, self.proj, self.tp.mesh)
            if probs is not None:
                probs = gather_heads(probs, self.tp.mesh)
        return (out, probs) if return_probs else out


class LayerScale(nn.Module):
    """The residual closing a block's half: ``x + y * gamma``, the product in
    y's dtype (``ep_tpu/models/vit.py::LayerScale`` on the branch y, then the
    add). One pass of ``ops/layerscale.py``'s kernel where
    ``takes_ls_kernel`` says (bf16 on the card, no gradient needed), bit for
    bit the chain, which every other call runs."""

    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if takes_ls_kernel(x, y, self.gamma):
            return ls_residual(x, y, self.gamma)
        return ls_residual_ref(x, y, self.gamma)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype,
                 act: str = "gelu"):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, dim, dtype=dtype)
        self.act = act
        self.tp = None  # cut by hidden units: fc2 is row-parallel
        # exact (erf) GELU when computing in f32, tanh-approximate in bf16, as
        # the JAX package does (its tanh error is far below bf16's step);
        # "gelu_tanh" is the tanh GELU at every precision, a model's own
        # activation (SigLIP's gelu_pytorch_tanh)
        self.approximate = ("tanh" if act == "gelu_tanh"
                            or dtype == torch.bfloat16 else "none")

    def forward(self, x):
        fc1 = self.fc1
        dt = fc1.compute_dtype
        needs_grad = torch.is_grad_enabled() and (
            x.requires_grad or fc1.weight.requires_grad
            or fc1.bias.requires_grad)
        if takes_gelu_epilogue(x.device, dt, self.act, self.tp is not None,
                               needs_grad):
            # the bias and the activation in fc1's epilogue (a frozen encoder)
            return self.fc2(fc1_gelu(x.to(dt), fc1.weight.to(dt),
                                     fc1.bias.to(dt)))
        x = fc1(x)
        if self.act == "quick_gelu":
            # x * sigmoid(1.702 x), the constant in x's dtype as JAX rounds it
            x = x * torch.sigmoid(scaled(x, 1.702))
        else:
            x = F.gelu(x, approximate=self.approximate)
        if self.tp is not None:
            return row_parallel(x, self.fc2, self.tp.mesh)
        return self.fc2(x)


class SwiGLUMlp(nn.Module):
    """silu(x1) * x2 on w12's two halves, then w3 (DINOv2-giant). Cut over
    a model group, ``w12`` holds this rank's 1/M of each half, still
    [w1 | w2], and ``w3`` is row-parallel. The gate is the kernel's
    (``ops/swiglu.py``) where no gradient is needed and the block is whole;
    with a gradient, or cut, it is the plain chain, which autograd
    differentiates."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.w12 = Dense(dim, 2 * hidden, dtype=dtype)
        self.w3 = Dense(hidden, dim, dtype=dtype)
        self.tp = None

    def forward(self, x):
        x12 = self.w12(x)
        # silu as JAX computes it: the sigmoid rounded, then the products
        with span("ep::swiglu_gate"):
            if self.tp is None and not x12.requires_grad:
                x = swiglu_gate(x12)
            else:
                x = swiglu_gate_ref(x12)
        if self.tp is not None:
            return row_parallel(x, self.w3, self.tp.mesh)
        return self.w3(x)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        D = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.scale = (D // cfg.num_heads) ** -0.5
        self.eps = cfg.norm_eps
        self.supercell = cfg.supercell
        self.norm1 = nn.LayerNorm(D, eps=cfg.norm_eps)
        self.attn = Attention(cfg)
        self.norm2 = nn.LayerNorm(D, eps=cfg.norm_eps)
        hidden = int(D * cfg.mlp_ratio)
        if cfg.mlp_type == "swiglu":
            self.mlp = SwiGLUMlp(D, hidden, cfg.dtype)
        else:
            self.mlp = Mlp(D, hidden, cfg.dtype, act=cfg.mlp_type)
        if cfg.init_values is not None:
            self.ls1 = LayerScale(D, cfg.init_values)
            self.ls2 = LayerScale(D, cfg.init_values)
        else:
            self.ls1 = self.ls2 = None
        self.int8_mlp = (cfg.int8_mlp and cfg.mlp_type == "gelu"
                         and self.supercell)
        self.remat = (_remat_policy(cfg.remat_policy, hidden)
                      if cfg.remat_blocks else None)
        # cut over a model group with attention on the kernels
        # (parallel/partition.py::shard_block): each call joins the pieces
        # into whole tensors and runs what one process runs
        self.gather = False

    def _tensors(self):
        """The block's whole tensors for the duration of a call: joined over
        the model group where ``gather`` says so, else as they are."""
        return (whole_tensors(self.attn, self.mlp) if self.gather
                else contextlib.nullcontext())

    def attn_half(self, x: torch.Tensor, temperature: float = 1.0,
                  rel_bias: Optional[torch.Tensor] = None,
                  rope: Optional[Rope] = None) -> torch.Tensor:
        with span("ep::attn_half"):
            if self.supercell:
                a = self.attn
                return attn_supercell(x, a.qkv.weight, a.qkv.bias,
                                      self.norm1.weight, self.norm1.bias,
                                      a.proj.weight, a.proj.bias,
                                      self.num_heads, self.scale, temperature,
                                      self.eps)
            return self._attn_plain(x, temperature, rel_bias, False, rope)[0]

    def _attn_plain(self, x, temperature, rel_bias, return_probs, rope=None):
        """(x + the attention branch after LayerScale, the probabilities or
        None, the branch before LayerScale)."""
        y = self.attn(layer_norm(x, self.norm1), temperature, rel_bias,
                      return_probs, rope)
        y, probs = y if return_probs else (y, None)
        if self.ls1 is not None:
            return self.ls1(x, y), probs, y
        return x + y, probs, y

    def mlp_half(self, x: torch.Tensor, int8: bool = True) -> torch.Tensor:
        """LN2, the MLP, LayerScale and the residual; the int8 half where the
        block runs it (a supercell block; ``int8=False`` on the plain route,
        as the JAX package's capture takes it)."""
        n2 = self.norm2
        with span("ep::mlp_half"):
            if self.int8_mlp and int8:
                m = self.mlp
                return mlp_int8_fused(x, m.fc1.weight, m.fc1.bias,
                                      m.fc2.weight, m.fc2.bias, n2.weight,
                                      n2.bias, self.eps)
            m = self.mlp(layer_norm(x, n2))
            if self.ls2 is not None:
                return self.ls2(x, m)
            return x + m

    def whole(self, x: torch.Tensor, temperature: float = 1.0,
              rel_bias: Optional[torch.Tensor] = None,
              rope: Optional[Rope] = None) -> torch.Tensor:
        return self.mlp_half(self.attn_half(x, temperature, rel_bias, rope))

    def capture(self, x: torch.Tensor, temperature: float = 1.0,
                rel_bias: Optional[torch.Tensor] = None,
                rope: Optional[Rope] = None):
        """The block on the plain route, with its attention probabilities:
        (x, probs f32 (B, H, T, T), the attention branch before LayerScale,
        where the JAX package measures its magnitude)."""
        with self._tensors():
            x, probs, branch = self._attn_plain(x, temperature, rel_bias, True,
                                                rope)
            return self.mlp_half(x, int8=False), probs, branch

    def forward(self, x: torch.Tensor, temperature: float = 1.0,
                rel_bias: Optional[torch.Tensor] = None,
                rope: Optional[Rope] = None) -> torch.Tensor:
        if self.remat is None or not torch.is_grad_enabled():
            with self._tensors():
                return self.whole(x, temperature, rel_bias, rope)
        whole_block, context_fn = self.remat
        if whole_block:
            return checkpoint(self.whole, x, temperature, rel_bias, rope,
                              use_reentrant=False, context_fn=context_fn)
        return checkpoint(self.mlp_half,
                          self.attn_half(x, temperature, rel_bias, rope),
                          use_reentrant=False, context_fn=context_fn)


def _center_slice(hw: int, n: int) -> slice:
    ctr = hw // 2
    return slice(ctr - math.ceil(n / 2), ctr + math.floor(n / 2))


def select_features(mode: str, x: torch.Tensor, x_cls: torch.Tensor,
                    x_pos: torch.Tensor,
                    final_probs: Optional[torch.Tensor]) -> torch.Tensor:
    """Token-level feature selection
    (``ep_tpu/models/vit.py::VisionTransformer._select_features``): sums and
    means of the compute dtype run in f32 and are cast back, as ``jnp``'s;
    the probabilities are f32."""
    if mode == "cls":
        return x_cls
    if mode == "pos":
        return x_pos
    if mode == "gap":
        return x_pos.mean(dim=1)
    if mode == "raw":
        return x
    if mode == "both":
        return torch.cat([x_cls[:, None], x_pos], dim=1)
    dt = x_pos.dtype
    B, T, D = x_pos.shape
    if mode.startswith("cp"):
        hw = math.isqrt(T)
        assert hw * hw == T
        s = _center_slice(hw, int(mode[2:]))
        return mean_f32(x_pos.reshape(B, hw, hw, D)[:, s, s], (1, 2))
    if mode.startswith("ca"):
        hw = math.isqrt(T)
        s = _center_slice(hw, int(mode[2:]))
        attn = final_probs.mean(dim=1)[:, 1:, 1:].reshape(B, hw, hw, hw * hw)
        attn_ss = attn[:, s, s].mean(dim=(1, 2))
        attn_ss = attn_ss / (attn_ss.sum(dim=1, keepdim=True) + 1e-6)
        return mean_f32(x_pos * attn_ss[:, :, None].to(dt), 1)
    if mode.startswith("attn"):
        kind = mode.split("attn-")[1]
        cls_pos = final_probs[:, :, 0, 1:]  # (B, H, N)
        if kind == "mn":
            m = cls_pos.mean(dim=1)[:, :, None]
            m = m / m.sum(dim=1, keepdim=True)
        elif kind == "lcte":  # the head of lowest class-token entropy
            wo = cls_pos / (cls_pos.sum(dim=2, keepdim=True) + 1e-6)
            ent = -(wo * torch.log(wo + 1e-6)).sum(dim=2)  # (B, H)
            idx = ent.argmin(dim=1)
            m = cls_pos[torch.arange(B, device=idx.device), idx][:, :, None]
            m = m / m.sum(dim=1, keepdim=True)
        else:
            raise NotImplementedError(mode)
        return (m.to(dt) * x_pos).float().sum(dim=1).to(dt)
    raise NotImplementedError(mode)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        if cfg.remat_blocks and not cfg.scan_blocks:
            raise ValueError("remat_blocks=True requires scan_blocks=True")
        self.cfg = cfg
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, D)
        self.cls_token = (nn.Parameter(torch.zeros(1, 1, D))
                          if cfg.class_token else None)
        self.reg_token = (nn.Parameter(torch.zeros(1, cfg.reg_tokens, D))
                          if cfg.reg_tokens else None)
        self.pos_embed = (nn.Parameter(torch.zeros(
            1, cfg.num_pos_prefix_tokens + cfg.num_patches, D))
            if cfg.use_abs_pos_emb else None)
        self.norm_pre = (nn.LayerNorm(D, eps=cfg.norm_eps) if cfg.pre_norm
                         else None)
        grid = (cfg.grid_size, cfg.grid_size)
        self.rel_pos_bias = (RelPosBias(grid, cfg.num_heads)
                             if cfg.rel_pos_bias == "shared" else None)
        if cfg.rel_pos_bias == "per_block":
            for i in range(cfg.depth):
                self.add_module(f"rel_pos_bias_{i}",
                                RelPosBias(grid, cfg.num_heads))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = (nn.LayerNorm(D, eps=cfg.norm_eps)
                     if cfg.final_norm == "ln" else None)
        self.proj = (nn.Parameter(torch.zeros(D, cfg.proj_dim))
                     if cfg.proj_dim else None)
        self._rope = {}  # (grid_h, grid_w, device) -> (sin, cos)

    def rope_tables(self, grid_h: int, grid_w: int,
                    device: torch.device) -> Rope:
        """RoPE's (sin, cos) for a grid_h x grid_w patch grid on ``device``,
        built once a grid and device (``ops/rope.py::rope_tables``)."""
        key = (grid_h, grid_w, torch.device(device))
        if key not in self._rope:
            c = self.cfg
            self._rope[key] = rope_tables(grid_h, grid_w,
                                          c.embed_dim // c.num_heads,
                                          c.rope_base, device)
        return self._rope[key]

    def keep_blocks(self, n: int) -> None:
        """Drop the blocks past the first ``n`` (and their per-block bias
        tables): a model that always returns at block ``n - 1`` holds only
        what the JAX package creates for it."""
        del self.blocks[n:]
        for i in range(n, self.cfg.depth):
            if hasattr(self, f"rel_pos_bias_{i}"):
                delattr(self, f"rel_pos_bias_{i}")

    def forward(self, x: torch.Tensor, return_features: str = "cls",
                return_block: Optional[int] = None, *,
                shuffle_subsets: int = 1,
                shuffle_noise: Optional[torch.Tensor] = None,
                attn_temperature: float = 1.0, capture_stats: bool = False,
                return_final_attn: bool = False):
        """x (B, H, W, 3) NHWC -> features of ``return_features`` mode; with
        ``capture_stats``, (features, stats f32 (5, B, blocks, H, T),
        magnitudes f32 (2, B, blocks, T)); with ``return_final_attn``, the
        last block's probabilities and the tokens after these, as a pair.
        ``shuffle_subsets`` > 1 splits the patch tokens by the argsort of
        ``shuffle_noise`` (B, N), uniform noise drawn here where it is not
        given."""
        c = self.cfg
        dt = c.dtype
        grid = (x.shape[1] // c.patch_size, x.shape[2] // c.patch_size)
        x = self.patch_embed(x, dt)
        B, N, D = x.shape
        prefix, regs = [], None
        if self.cls_token is not None:
            prefix.append(self.cls_token.to(dt).expand(B, -1, -1))
        if self.reg_token is not None:
            regs = self.reg_token.to(dt).expand(B, -1, -1)
            if c.reg_pos_embed:
                prefix.append(regs)
                regs = None
        if prefix:
            x = torch.cat(prefix + [x], dim=1)
        if self.pos_embed is not None:
            pos = self.pos_embed
            if pos.shape[1] != x.shape[1]:
                # an image size other than the model's: resize the patch grid,
                # in the parameter's precision, before the cast
                pos = interpolate_pos_embed(pos.float(), N,
                                            c.num_pos_prefix_tokens)
            x = x + pos.to(dt)
        if regs is not None:  # the hub's layout: after [CLS], no position
            n_cls = len(prefix)
            x = torch.cat([x[:, :n_cls], regs, x[:, n_cls:]], dim=1)
        if self.norm_pre is not None:
            x = layer_norm(x, self.norm_pre)

        ss = shuffle_subsets
        n_pre = c.num_prefix_tokens
        rope = None
        if c.rope_base is not None:
            if ss > 1:
                raise ValueError("shuffle_subsets > 1 with RoPE: the subsets "
                                 "lose the patch grid that RoPE's angles "
                                 "follow")
            rope = self.rope_tables(*grid, x.device)
        if ss > 1:
            assert N % ss == 0, f"{N=} not divisible by {ss=}"
            assert return_features in ("cls", "pos", "gap")
            assert c.rel_pos_bias == "none", "subsets break the rel-pos grid"
            if shuffle_noise is None:
                shuffle_noise = torch.rand(B, N)
            ids = torch.argsort(shuffle_noise.to(x.device), dim=1)
            x_pre, x_pos = x[:, :n_pre], x[:, n_pre:]
            x_pos = torch.gather(x_pos, 1, ids[:, :, None].expand(-1, -1, D))
            x_pos = x_pos.reshape(B, ss, N // ss, D)
            x_pre = x_pre[:, None].expand(B, ss, n_pre, D)
            x = torch.cat([x_pre, x_pos], dim=2).reshape(B * ss,
                                                         n_pre + N // ss, D)

        rel_bias = self.rel_pos_bias() if self.rel_pos_bias is not None else None
        needs_final_attn = (return_final_attn
                            or return_features.startswith(("ca", "attn")))
        use_scan = (not capture_stats and not needs_final_attn
                    and (return_block is None or return_block == c.depth - 1)
                    and c.rel_pos_bias != "per_block")
        if c.scan_blocks and not use_scan:
            raise ValueError(
                "scan_blocks=True supports only the fast path: attention "
                "capture, ca*/attn-* modes, early return_block and per-block "
                "rel-pos bias need scan_blocks=False (per-layer params)")

        last_block = return_block if return_block is not None else c.depth - 1
        final_probs = None
        stats, magnitudes = [], []
        for i, blk in enumerate(self.blocks):
            if i > last_block:
                break
            bias = (getattr(self, f"rel_pos_bias_{i}")()
                    if c.rel_pos_bias == "per_block" else rel_bias)
            if capture_stats or (needs_final_attn and i == last_block):
                x_in = x
                x, final_probs, branch = blk.capture(x, attn_temperature, bias,
                                                     rope)
                if capture_stats:
                    # ||x|| and ||attention branch|| (models_vit.py:147-150)
                    stats.append(attn_stats_from_probs(final_probs))
                    magnitudes.append(torch.stack(
                        [torch.linalg.vector_norm(t.float(), dim=2)
                         for t in (x_in, branch)])[:, :, None])
            else:
                x = blk(x, attn_temperature, bias, rope)
        ret = self._finish(x, B, N, ss, return_features, final_probs,
                           return_final_attn)
        if not capture_stats:
            return ret
        if ss > 1:  # the JAX package's _finish drops them with the subsets
            return ret, None, None
        ret, extra = ret if return_final_attn else (ret, None)
        out = (ret, torch.cat(stats, dim=2), torch.cat(magnitudes, dim=2))
        return out + (extra,) if return_final_attn else out

    def _finish(self, x, B, N, ss, return_features, final_probs,
                return_final_attn):
        c = self.cfg
        D = c.embed_dim
        if self.norm is not None:
            x = layer_norm(x, self.norm)
        n_pre = c.num_prefix_tokens
        if ss > 1:
            # cls (B,ss,D); pos (B,ss,N/ss,D); gap the mean over the subsets
            xs = x.reshape(B, ss, n_pre + N // ss, D)
            x_pos = xs[:, :, n_pre:]
            if return_features == "cls":
                return (xs[:, :, 0] if c.class_token
                        else torch.zeros(B, ss, D, dtype=x.dtype,
                                         device=x.device))
            if return_features == "pos":
                return x_pos
            return x_pos.mean(dim=1)
        x_pos = x[:, n_pre:]
        if c.class_token:
            x_cls = x[:, 0]
        elif c.cls_from_registers and c.reg_tokens:
            x_cls = mean_f32(x[:, :c.reg_tokens], 1)  # CAPI's global_repr
        else:
            x_cls = torch.zeros(B, D, dtype=x.dtype, device=x.device)
        if self.proj is not None and return_features == "cls":
            # OpenCLIP: ln_post(cls) @ proj; the patch tokens stay D wide
            x_cls = x_cls @ self.proj.to(x_cls.dtype)
        ret = select_features(return_features, x, x_cls, x_pos, final_probs)
        if return_final_attn:
            return ret, (final_probs, x)
        return ret


# --- size constructors --------------------------------------------------------

def _mk(embed_dim, depth, num_heads, patch_size=16, **kw) -> ViTConfig:
    return ViTConfig(embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                     patch_size=patch_size, **kw)


def vit_tiny_patch16(**kw) -> ViTConfig:
    return _mk(192, 12, 3, **kw)


def vit_small_patch16(**kw) -> ViTConfig:
    return _mk(384, 12, 6, **kw)


def vit_base_patch16(**kw) -> ViTConfig:
    return _mk(768, 12, 12, **kw)


def vit_large_patch16(**kw) -> ViTConfig:
    return _mk(1024, 24, 16, **kw)


def vit_huge_patch14(class_token: bool = True, **kw) -> ViTConfig:
    return _mk(1280, 32, 16, patch_size=14, class_token=class_token, **kw)


def simmim_vit_base_patch16(**kw) -> ViTConfig:
    """SimMIM pretrained ViT-B: no abs pos-embed, shared rel-pos bias,
    LayerScale 0.1, q/v-only qkv bias."""
    return _mk(768, 12, 12, qkv_bias_mode="qv_only", use_abs_pos_emb=False,
               rel_pos_bias="shared", init_values=0.1, **kw)


VIT_CONFIGS = {
    "vit_tiny_patch16": vit_tiny_patch16,
    "vit_small_patch16": vit_small_patch16,
    "vit_base_patch16": vit_base_patch16,
    "vit_large_patch16": vit_large_patch16,
    "vit_huge_patch14": vit_huge_patch14,
}
