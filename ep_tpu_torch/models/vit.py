"""The plain Vision Transformer of the probing and fine-tuning paths, in
PyTorch.

Counterpart of ``ep_tpu/models/vit.py`` for the slice the main paths run:
patch embedding, [CLS] token and absolute position embedding, blocks whose
attention half is the attention supercell (``ops/attn_block.py``: kernels A, B
or, at long sequences, F, and C on the card, E in its backward) and whose MLP half is plain torch (LN2,
fc1, GELU, fc2, residual) or, with ``int8_mlp=True`` (``--int8_mlp``, opt-in
and approximate), the int8 half of ``ops/mlp_int8.py`` (its own kernels on the
card); no final norm, and the feature modes ``cls``, ``pos``, ``gap`` and
``both`` ([CLS] + patch tokens, for the ``_all`` poolings). An
image of another size than the model's gets the position embedding resized
to its patch grid (``utils/pos_embed.py``).

Block rematerialisation for fine-tuning (``remat_blocks``) is
``torch.utils.checkpoint`` with the JAX package's four policies
(``_remat_policy``): ``none`` recomputes the whole block; ``attn_out`` keeps
the supercell's output and recomputes the MLP half; ``attn_fc1`` also keeps
fc1's output; ``dots`` recomputes the whole block but keeps every matrix
product's output (fc1's and fc2's; the supercell's products are kernels).
``scan_blocks`` is accepted for the same flag surface (``remat_blocks`` needs
it, as in the JAX package) but the port always loops over the blocks.

Parameter names follow timm/MAE (``patch_embed.proj``, ``blocks.{i}.attn.qkv``,
...) and every weight is in the ``nn.Linear``/``nn.Conv2d`` layout.
Parameters are created in float32; ``train/state.py::cast_frozen`` stores a
frozen encoder in the compute dtype, as the JAX package does.

Not ported yet (ROADMAP module item 7): relative-position bias, LayerScale,
registers, SwiGLU, the OpenCLIP tower, ``return_block``, ``shuffle_subsets``
and attention capture; each raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, noop_context_fn

from ep_tpu_torch.ops.attn_block import attn_supercell
from ep_tpu_torch.ops.mlp_int8 import mlp_int8_fused
from ep_tpu_torch.poolings.common import Dense
from ep_tpu_torch.utils.pos_embed import interpolate_pos_embed

# Pooled-feature names that consume patch tokens only / [CLS]+patch tokens.
ATTENTIVE_POOLINGS = [
    "abmilp", "simpool", "esimpool", "clip", "siglip", "aim", "ep", "cbam",
    "coca", "cait", "dinovit", "jepa", "dolg", "cae",
]
ATTENTIVE_POOLINGS_ALL = [f"{n}_all" for n in ATTENTIVE_POOLINGS]
FEATURE_MODES = ("cls", "pos", "gap", "both")

_TODO_BACKBONE = "is not ported yet (ROADMAP module item 7, backbone variants)"


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
    class_token: bool = True
    norm_eps: float = 1e-6
    # variants of the JAX backbone that this slice refuses (check_ported)
    reg_tokens: int = 0
    rel_pos_bias: str = "none"
    init_values: Optional[float] = None
    mlp_type: str = "gelu"
    pre_norm: bool = False
    proj_dim: Optional[int] = None
    dtype: torch.dtype = torch.bfloat16  # compute dtype; parameters are f32
    scan_blocks: bool = False  # flag surface only: the port loops
    remat_blocks: bool = False  # recompute blocks in the backward
    remat_policy: str = "none"  # none | attn_out | attn_fc1 | dots
    int8_mlp: bool = False  # opt-in int8 MLP half (ops/mlp_int8.py)

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2

    @property
    def num_prefix_tokens(self) -> int:
        return (1 if self.class_token else 0) + self.reg_tokens

    def replace(self, **kw) -> "ViTConfig":
        return dataclasses.replace(self, **kw)

    def check_ported(self) -> None:
        """Raise for the backbone variants this slice does not cover."""
        unported = {
            "rel_pos_bias": self.rel_pos_bias != "none",
            "init_values (LayerScale)": self.init_values is not None,
            "reg_tokens": self.reg_tokens != 0,
            "mlp_type": self.mlp_type != "gelu",
            "pre_norm / proj_dim (OpenCLIP)": self.pre_norm or bool(self.proj_dim),
        }
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(f"{', '.join(bad)} {_TODO_BACKBONE}")


def int8_mlp_inactive_reason(c: ViTConfig) -> Optional[str]:
    """Why a requested ``int8_mlp`` would leave the MLP half in bf16, else
    None (``ep_tpu/models/vit.py::int8_mlp_inactive_reason``). Of the JAX
    package's reasons only the MLP type exists here: the other backbones it
    names are refused by ``check_ported``, and the port's kernels are taken by
    device, not by a backend switch."""
    if not c.int8_mlp:
        return None
    if c.mlp_type != "gelu":
        return f"mlp_type={c.mlp_type!r} (SwiGLU/QuickGELU MLPs stay bf16)"
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


class PatchEmbed(nn.Module):
    """Conv2d(kernel = stride = patch) computed as reshape plus one matmul,
    which is exact when the stride equals the kernel."""

    def __init__(self, patch_size: int, in_chans: int, dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        B, H, W, C = x.shape  # NHWC
        p = self.patch_size
        x = x.to(dtype).reshape(B, H // p, p, W // p, p, C)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(B, (H // p) * (W // p), C * p * p)
        w = self.proj.weight.to(dtype).reshape(self.proj.out_channels, -1)
        return F.linear(x, w) + self.proj.bias.to(dtype)


class Attention(nn.Module):
    """Parameter holder of the attention half; the supercell runs it."""

    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, dim, dtype=dtype)
        # exact (erf) GELU when computing in f32, tanh-approximate in bf16, as
        # the JAX package does (its tanh error is far below bf16's step)
        self.approximate = "tanh" if dtype == torch.bfloat16 else "none"

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        D = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.scale = (D // cfg.num_heads) ** -0.5
        self.eps = cfg.norm_eps
        self.norm1 = nn.LayerNorm(D, eps=cfg.norm_eps)
        self.attn = Attention(D)
        self.norm2 = nn.LayerNorm(D, eps=cfg.norm_eps)
        hidden = int(D * cfg.mlp_ratio)
        self.mlp = Mlp(D, hidden, cfg.dtype)
        self.int8_mlp = cfg.int8_mlp and cfg.mlp_type == "gelu"
        self.remat = (_remat_policy(cfg.remat_policy, hidden)
                      if cfg.remat_blocks else None)

    def attn_half(self, x: torch.Tensor) -> torch.Tensor:
        a = self.attn
        return attn_supercell(x, a.qkv.weight, a.qkv.bias, self.norm1.weight,
                              self.norm1.bias, a.proj.weight, a.proj.bias,
                              self.num_heads, self.scale, 1.0, self.eps)

    def mlp_half(self, x: torch.Tensor) -> torch.Tensor:
        n2 = self.norm2
        if self.int8_mlp:
            m = self.mlp
            return mlp_int8_fused(x, m.fc1.weight, m.fc1.bias, m.fc2.weight,
                                  m.fc2.bias, n2.weight, n2.bias, self.eps)
        h = F.layer_norm(x, n2.normalized_shape, n2.weight.to(x.dtype),
                         n2.bias.to(x.dtype), self.eps)
        return x + self.mlp(h)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp_half(self.attn_half(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat is None or not torch.is_grad_enabled():
            return self.whole(x)
        whole_block, context_fn = self.remat
        if whole_block:
            return checkpoint(self.whole, x, use_reentrant=False,
                              context_fn=context_fn)
        return checkpoint(self.mlp_half, self.attn_half(x), use_reentrant=False,
                          context_fn=context_fn)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        cfg.check_ported()
        if cfg.remat_blocks and not cfg.scan_blocks:
            raise ValueError("remat_blocks=True requires scan_blocks=True")
        self.cfg = cfg
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, D)
        self.cls_token = (nn.Parameter(torch.zeros(1, 1, D))
                          if cfg.class_token else None)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_prefix_tokens + cfg.num_patches, D))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))

    def forward(self, x: torch.Tensor, return_features: str = "cls") -> torch.Tensor:
        """x (B, H, W, 3) NHWC -> features of ``return_features`` mode."""
        if return_features not in FEATURE_MODES:
            raise NotImplementedError(
                f"feature mode {return_features!r} {_TODO_BACKBONE}")
        c = self.cfg
        dt = c.dtype
        x = self.patch_embed(x, dt)
        B = x.shape[0]
        if self.cls_token is not None:
            x = torch.cat([self.cls_token.to(dt).expand(B, -1, -1), x], dim=1)
        pos = self.pos_embed
        if pos.shape[1] != x.shape[1]:
            # an image size other than the model's: resize the patch grid, in
            # the parameter's precision, before the cast to the compute dtype
            pos = interpolate_pos_embed(pos.float(),
                                        x.shape[1] - c.num_prefix_tokens,
                                        c.num_prefix_tokens)
        x = x + pos.to(dt)
        for blk in self.blocks:
            x = blk(x)
        x_pos = x[:, c.num_prefix_tokens:]
        if return_features == "pos":
            return x_pos
        if return_features == "gap":
            return x_pos.mean(dim=1)
        x_cls = (x[:, 0] if c.class_token
                 else torch.zeros(B, c.embed_dim, dtype=dt, device=x.device))
        if return_features == "both":
            return torch.cat([x_cls[:, None], x_pos], dim=1)
        return x_cls


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


VIT_CONFIGS = {
    "vit_tiny_patch16": vit_tiny_patch16,
    "vit_small_patch16": vit_small_patch16,
    "vit_base_patch16": vit_base_patch16,
    "vit_large_patch16": vit_large_patch16,
    "vit_huge_patch14": vit_huge_patch14,
}
