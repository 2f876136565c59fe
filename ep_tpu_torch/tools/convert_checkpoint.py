"""Offline checkpoint converter: a hub or timm ``.pth`` -> the port's own
backbone file.

Counterpart of ``tools/convert_checkpoint.py``. It reads any layout that
``convert/torch_vit.py`` reads (MAE, SimMIM, timm/DeiT, OpenCLIP, CAPI,
DINOv2), renames, splits and resizes its entries once, and writes
``torch.save({"backbone": state_dict, "model": name})`` in the port's names:

    python -m ep_tpu_torch.tools.convert_checkpoint \\
        --model vit_base_patch16 --finetune mae_pretrain_vit_base.pth \\
        --out mae_vitb16.eptorch.pth [--simmim] [--image_size 224]

``--finetune`` of the driver (and ``--oracle_ckpt``) accepts either file: it
recognises the converted one by its ``backbone`` entry and loads it strictly.
The conversion runs on the CPU: it moves weights and computes nothing.
"""
from __future__ import annotations

import argparse

import torch

from ep_tpu_torch.configs import TrainConfig
from ep_tpu_torch.convert.torch_vit import (load_torch_state_dict,
                                            torch_vit_to_backbone)
from ep_tpu_torch.models.assembly import build_backbone_config
from ep_tpu_torch.models.mae import MAEConfig, MaskedAutoencoderViT
from ep_tpu_torch.models.vit import VisionTransformer


def convert(cfg: TrainConfig, path: str, checkpoint_key: str = "model"):
    """The backbone state dict of ``cfg``'s model filled from ``path``."""
    backbone_cfg = build_backbone_config(cfg)
    module = (MaskedAutoencoderViT(backbone_cfg, decoder=False)
              if isinstance(backbone_cfg, MAEConfig)
              else VisionTransformer(backbone_cfg))
    sd = load_torch_state_dict(path, checkpoint_key)
    state = torch_vit_to_backbone(sd, module, backbone_cfg)
    module.load_state_dict(state, strict=True)
    return state


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", required=True)
    ap.add_argument("--finetune", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--checkpoint_key", default="model")
    ap.add_argument("--simmim", action="store_true")
    ap.add_argument("--openclip", action="store_true",
                    help="OpenCLIP visual tower (--model ViT-B-16 etc.)")
    ap.add_argument("--openclip_pretrain", default="openai")
    ap.add_argument("--no_cls_token", action="store_true")
    ap.add_argument("--image_size", type=int, default=224)
    args = ap.parse_args(argv)

    cfg = TrainConfig(model=args.model, simmim=args.simmim,
                      openclip=args.openclip,
                      openclip_pretrain=args.openclip_pretrain,
                      no_cls_token=args.no_cls_token,
                      image_size=args.image_size, amp="float32")
    state = convert(cfg, args.finetune, args.checkpoint_key)
    torch.save({"backbone": state, "model": args.model}, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
