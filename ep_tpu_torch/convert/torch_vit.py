"""``--finetune <path>``: a timm/MAE-layout ViT checkpoint into the backbone.

Counterpart of ``ep_tpu/convert/torch_vit.py`` (``load_torch_state_dict``
and ``load_pretrained_backbone``, the reference's main_linprobe.py:373-411)
for the plain ViT. The port's backbone already uses timm's names and the
``nn.Linear``/``nn.Conv2d`` layouts, so the conversion is:
  * the ``model`` (or ``state_dict``) entry of the file; the ``encoder.``,
    ``module.`` and ``backbone.`` prefixes stripped; ``decoder*`` and
    ``mask_token`` dropped;
  * split q/k/v weights concatenated into qkv;
  * the position embedding bicubic-resized (``utils/pos_embed.py``) when the
    checkpoint's grid is not the model's;
  * the classifier (``head``, ``fc_norm``, ``fc.``) dropped: the probe head
    stays as initialised.
A backbone entry the file does not hold is an error, as is an entry of the
wrong shape. The OpenCLIP, CAPI and BEiTv2 layouts are ROADMAP module item 7
and raise.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import torch
import torch.nn as nn

from ep_tpu_torch.utils.pos_embed import interpolate_pos_embed

_TODO = "is not ported yet (ROADMAP module item 7, backbone variants)"
_DROPPED = ("head", "fc_norm", "oracle", "fc.", "visual_proj")


def load_torch_state_dict(path: str, checkpoint_key: str = "model"
                          ) -> Dict[str, torch.Tensor]:
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and checkpoint_key in ckpt:
        ckpt = ckpt[checkpoint_key]
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    sd = {}
    for k, v in ckpt.items():
        for pref in ("encoder.", "module.", "backbone."):
            if k.startswith(pref):
                k = k[len(pref):]
        if k.startswith(("decoder", "mask_token")):
            continue
        sd[k] = v
    return sd


def torch_vit_to_backbone(sd: Dict[str, torch.Tensor], backbone: nn.Module,
                          backbone_cfg) -> Dict[str, torch.Tensor]:
    """The backbone's state dict filled from a timm-layout ``sd``."""
    if any(k.startswith(("visual.", "transformer.resblocks.", "conv1."))
           or k in ("class_embedding", "storage_tokens", "register_tokens")
           or k.startswith("rel_pos_bias") or ".attn.q_bias" in k for k in sd):
        raise NotImplementedError(
            f"an OpenCLIP, CAPI, DINOv2 or BEiT checkpoint layout {_TODO}")
    sd = dict(sd)
    for i in range(backbone_cfg.depth):
        tp = f"blocks.{i}.attn."
        if tp + "qkv.weight" not in sd and tp + "q.weight" in sd:
            for leaf in ("weight", "bias"):
                parts = [sd.pop(f"{tp}{n}.{leaf}", None) for n in "qkv"]
                if all(p is not None for p in parts):
                    sd[f"{tp}qkv.{leaf}"] = torch.cat(parts, 0)
    template = backbone.state_dict()
    out, missing = {}, []
    for name, tgt in template.items():
        if name not in sd:
            missing.append(name)
            continue
        v = sd[name]
        if name == "pos_embed" and v.shape != tgt.shape:
            print(f"Position interpolate {tuple(v.shape)} -> {tuple(tgt.shape)}")
            v = interpolate_pos_embed(
                v.float(), backbone_cfg.num_patches,
                tgt.shape[1] - backbone_cfg.num_patches)
        if v.shape != tgt.shape:
            raise ValueError(f"--finetune: {name} has shape {tuple(v.shape)}, "
                             f"the model's is {tuple(tgt.shape)}")
        out[name] = v.to(tgt.dtype)
    if missing:
        raise KeyError(f"--finetune: the checkpoint holds no {missing[:10]}")
    leftovers = [k for k in sd if k not in template
                 and not k.startswith(_DROPPED)]
    if leftovers:
        print(f"[convert] unused checkpoint keys: {sorted(leftovers)[:10]}"
              f"{' ...' if len(leftovers) > 10 else ''}")
    return out


def load_pretrained_backbone(cfg, backbone_cfg, model: nn.Module) -> None:
    """Load ``cfg.finetune`` into ``model.backbone`` in place of its random
    initialisation (main_linprobe.py:373-411)."""
    path = cfg.finetune
    if not Path(path).exists():
        raise FileNotFoundError(
            f"--finetune {path}: timm-hub name resolution needs network "
            f"access; convert the checkpoint to a local .pth first")
    print(f"Interpreting {path} as path")
    sd = load_torch_state_dict(path, cfg.checkpoint_key)
    state = torch_vit_to_backbone(sd, model.backbone, backbone_cfg)
    model.backbone.load_state_dict(state, strict=True)
