"""2-D sine-cosine position embeddings and pos-embed interpolation.

Counterpart of ``ep_tpu/utils/pos_embed.py``. The three sin-cos helpers are
numpy, as there. :func:`interpolate_pos_embed` resizes the patch grid of a
(1, T, D) position embedding the way ``jax.image.resize(..., "bicubic")``
does, which is not what ``F.interpolate(mode="bicubic")`` computes: the Keys
cubic kernel with a = -0.5 (torch: -0.75), sampled at half-pixel centres, each
output's weights renormalised to sum to one (torch clamps indices at the
edges instead), and the kernel widened by the scale when shrinking
(antialias). So the (old, new) weight matrix is built here and applied on
both axes.
"""
from __future__ import annotations

import numpy as np
import torch

from ep_tpu_torch.ops import default_device


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """(M,) positions -> (M, embed_dim) sin/cos embedding."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    pos = pos.reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed_from_grid(embed_dim: int, grid: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def get_2d_sincos_pos_embed(
    embed_dim: int, grid_size: int, cls_token: bool = False
) -> np.ndarray:
    """Fixed 2-D sin-cos position embedding: (grid_size**2 [+1], embed_dim)
    float32, with a zero row prepended when ``cls_token``."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # w goes first
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size, grid_size])
    pos_embed = get_2d_sincos_pos_embed_from_grid(embed_dim, grid)
    if cls_token:
        pos_embed = np.concatenate([np.zeros([1, embed_dim]), pos_embed], axis=0)
    return pos_embed.astype(np.float32)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel (a = -0.5) on distances x >= 0."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x >= 2.0, torch.zeros_like(x),
                       torch.where(x >= 1.0, far, near))


def bicubic_weight_matrix(old: int, new: int, device=None) -> torch.Tensor:
    """(old, new) float32 matrix that resizes one axis from ``old`` to ``new``
    samples: column j holds the weights of output sample j. On ``device``
    (None: the card, as every constructor of the port)."""
    device = default_device(device)
    # Python floats, rounded to f32 where they meet a tensor, as in JAX
    inv_scale = 1.0 / (new / old)
    kernel_scale = max(inv_scale, 1.0)  # widened when shrinking
    sample = (torch.arange(new, dtype=torch.float32, device=device) + 0.5
              ) * inv_scale - 0.5
    src = torch.arange(old, dtype=torch.float32, device=device)
    w = _keys_cubic((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= old - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate_pos_embed(pos_embed: torch.Tensor, new_num_patches: int,
                          num_extra_tokens: int = 1) -> torch.Tensor:
    """Bicubic-resize the patch part of a (1, T, D) position embedding.

    Extra ([CLS]/register) tokens are kept; the grid part is resized from its
    square size to the new square size. Computed in ``pos_embed``'s dtype."""
    D = pos_embed.shape[-1]
    old = int((pos_embed.shape[-2] - num_extra_tokens) ** 0.5)
    new = int(new_num_patches ** 0.5)
    if old == new:
        return pos_embed
    extra = pos_embed[:, :num_extra_tokens]
    grid = pos_embed[:, num_extra_tokens:].reshape(old, old, D)
    w = bicubic_weight_matrix(old, new, pos_embed.device).to(pos_embed.dtype)
    grid = torch.einsum("hwd,hi,wj->ijd", grid, w, w)
    return torch.cat([extra, grid.reshape(1, new * new, D)], dim=1)
