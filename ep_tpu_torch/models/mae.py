"""The MAE masked autoencoder (encoder and decoder) in PyTorch.

Counterpart of ``ep_tpu/models/mae.py``: fixed 2-D sin-cos position
embeddings, masking by the argsort of uniform noise, a shallow decoder, and
the per-patch MSE on masked patches (optionally pixel-normalised). Probing
uses the encoder's latent (``return_latent``, a full-token pass with
``mask_ratio=0``; ``models/assembly.py``).

The encoder's blocks are the plain ViT's: ``encoder_vit`` asks for the
kernels (``attn_impl="auto"``), so on the card they take the attention
supercell (kernels A, B, C), where the JAX package's ``MAEConfig.encoder_vit``
leaves them on XLA's attention. The decoder's blocks take the plain route
(``attn_impl="xla"``, as the JAX package's decoder does): its head width is 32
at every size (512 wide, 16 heads), which kernel B is not built for, and its
attention runs in plain torch (``ops/attention.py::mha``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from ep_tpu_torch.poolings.common import Dense
from ep_tpu_torch.utils.pos_embed import get_2d_sincos_pos_embed
from .vit import Block, PatchEmbed, ViTConfig, layer_norm


@dataclass(frozen=True)
class MAEConfig:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    decoder_embed_dim: int = 512
    decoder_depth: int = 8
    decoder_num_heads: int = 16
    mlp_ratio: float = 4.0
    norm_pix_loss: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    def encoder_vit(self) -> ViTConfig:
        return ViTConfig(
            img_size=self.img_size, patch_size=self.patch_size,
            embed_dim=self.embed_dim, depth=self.depth,
            num_heads=self.num_heads, mlp_ratio=self.mlp_ratio,
            qkv_bias=True, dtype=self.dtype, attn_impl="auto",
        )

    def decoder_vit(self) -> ViTConfig:
        return ViTConfig(
            img_size=self.img_size, patch_size=self.patch_size,
            embed_dim=self.decoder_embed_dim, depth=self.decoder_depth,
            num_heads=self.decoder_num_heads, mlp_ratio=self.mlp_ratio,
            qkv_bias=True, dtype=self.dtype, attn_impl="xla",
        )


def random_masking(x: torch.Tensor, mask_ratio: float,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """Per-sample masking by the argsort of uniform ``noise`` (N, L), or of
    noise drawn from ``generator``: (kept tokens, mask (N, L) f32 with 1 on
    the removed ones, ids_restore)."""
    N, L, D = x.shape
    len_keep = int(L * (1 - mask_ratio))
    if noise is None:
        noise = torch.rand(N, L, generator=generator)
    ids_shuffle = torch.argsort(noise.to(x.device), dim=1)
    ids_restore = torch.argsort(ids_shuffle, dim=1)
    ids_keep = ids_shuffle[:, :len_keep]
    x_masked = torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, D))
    mask = torch.ones(N, L, device=x.device)
    mask[:, :len_keep] = 0
    mask = torch.gather(mask, 1, ids_restore)
    return x_masked, mask, ids_restore


class MaskedAutoencoderViT(nn.Module):
    """``decoder=False`` builds the encoder alone, as the JAX package's
    latent-only model holds it (``ProbeModel``)."""

    def __init__(self, cfg: MAEConfig, decoder: bool = True):
        super().__init__()
        self.cfg = cfg
        D, dD = cfg.embed_dim, cfg.decoder_embed_dim
        grid = int(cfg.num_patches ** 0.5)
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, D)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.blocks = nn.ModuleList(Block(cfg.encoder_vit())
                                    for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(D, eps=1e-6)
        grid_pos = [("pos_embed", D)]
        if decoder:
            self._build_decoder(cfg)
            grid_pos.append(("decoder_pos_embed", dD))
        for name, dim in grid_pos:
            pos = get_2d_sincos_pos_embed(dim, grid, cls_token=True)
            self.register_buffer(name, torch.from_numpy(pos).float()[None],
                                 persistent=False)

    def _build_decoder(self, cfg: MAEConfig) -> None:
        D, dD = cfg.embed_dim, cfg.decoder_embed_dim
        self.decoder_embed = Dense(D, dD, dtype=cfg.dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dD))
        self.decoder_blocks = nn.ModuleList(Block(cfg.decoder_vit())
                                            for _ in range(cfg.decoder_depth))
        self.decoder_norm = nn.LayerNorm(dD, eps=1e-6)
        self.decoder_pred = Dense(dD, cfg.patch_size ** 2 * cfg.in_chans,
                                  dtype=cfg.dtype)

    def patchify(self, imgs: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) NHWC -> (N, L, p*p*3), channel-last within a patch."""
        p = self.cfg.patch_size
        n, H, W, c = imgs.shape
        h, w = H // p, W // p
        x = imgs.reshape(n, h, p, w, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h * w, p * p * c)

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        p = self.cfg.patch_size
        n, L, _ = x.shape
        h = w = int(L ** 0.5)
        x = x.reshape(n, h, w, p, p, 3).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h * p, w * p, 3)

    def forward(self, imgs: torch.Tensor, mask_ratio: float = 0.75, *,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                return_latent: bool = False):
        """(loss, pred, mask); with ``return_latent``, (latent, mask,
        ids_restore). The masking draws from ``noise`` (N, L) or
        ``generator``; ``mask_ratio=0`` keeps every token in order."""
        c = self.cfg
        dt = c.dtype
        pos = self.pos_embed
        x = self.patch_embed(imgs, dt) + pos[:, 1:].to(dt)
        B, L, D = x.shape
        if mask_ratio > 0.0:
            x, mask, ids_restore = random_masking(x, mask_ratio, noise,
                                                  generator)
        else:
            mask = torch.zeros(B, L, device=x.device)
            ids_restore = torch.arange(L, device=x.device).expand(B, L)
        cls = (self.cls_token + pos[:, :1]).to(dt)
        x = torch.cat([cls.expand(x.shape[0], -1, -1), x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        latent = layer_norm(x, self.norm)
        if return_latent:
            return latent, mask, ids_restore

        y = self.decoder_embed(latent)
        n_masked = ids_restore.shape[1] + 1 - y.shape[1]
        mask_tokens = self.mask_token.to(dt).expand(B, n_masked, -1)
        y_ = torch.cat([y[:, 1:], mask_tokens], dim=1)
        y_ = torch.gather(y_, 1, ids_restore[:, :, None].expand(
            -1, -1, y.shape[2]))
        y = torch.cat([y[:, :1], y_], dim=1) + self.decoder_pos_embed.to(dt)
        for blk in self.decoder_blocks:
            y = blk(y)
        pred = self.decoder_pred(layer_norm(y, self.decoder_norm))[:, 1:]

        target = self.patchify(imgs.float())
        if c.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, unbiased=False)
            target = (target - mean) / (var + 1e-6) ** 0.5
        loss = ((pred.float() - target) ** 2).mean(dim=-1)
        loss = (loss * mask).sum() / mask.sum()
        return loss, pred, mask


def mae_vit_base_patch16(**kw) -> MAEConfig:
    return MAEConfig(embed_dim=768, depth=12, num_heads=12, **kw)


def mae_vit_large_patch16(**kw) -> MAEConfig:
    return MAEConfig(embed_dim=1024, depth=24, num_heads=16, **kw)


def mae_vit_huge_patch14(**kw) -> MAEConfig:
    return MAEConfig(patch_size=14, embed_dim=1280, depth=32, num_heads=16,
                     **kw)
