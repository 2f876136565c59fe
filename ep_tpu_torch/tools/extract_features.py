"""Batch feature extraction: frozen backbone (+ optional trained pooling
head) over a dataset split -> .npz of descriptors + labels.

Counterpart of ``tools/extract_features.py`` with the same flags and keys:

    python -m ep_tpu_torch.tools.extract_features --model vit_base_patch16 \\
        --finetune mae_vitb16.pth --dataset_name imagenet1k \\
        --data_path /data/in1k --cls_features cls --split val \\
        --out feats_val.npz [--head_ckpt checkpoint-.pth] [--device cpu]

With --head_ckpt (a ``checkpoint-*.pth`` of ``main_linprobe_torch.py``) the
trained probe head runs too and the npz also holds the head's logits;
without it the raw pooled backbone features are written (cls/pos/gap modes
need no trained weights). Features and logits are written in float32. It
runs on the card unless ``--device cpu`` is given; there the EP path
launches kernels A, B and C once a block and D once a batch.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ep_tpu_torch.cli.linprobe import run_device
from ep_tpu_torch.configs import config_from_args, get_args_parser
from ep_tpu_torch.data.datasets import build_datasets
from ep_tpu_torch.data.loader import DataLoader
from ep_tpu_torch.data.transforms import build_transforms
from ep_tpu_torch.models.assembly import build_backbone_config, init_probe_model
from ep_tpu_torch.train.engine import to_device
from ep_tpu_torch.train.state import cast_frozen


def build_probe(cfg, head_ckpt: str = ""):
    """The probe model of ``cfg`` on its device, in eval mode: weights drawn
    from ``cfg.seed``, the backbone from ``cfg.finetune``, the head (and the
    whole model under ``--finetuning``) from ``head_ckpt``; a frozen bf16
    backbone stored in bf16, as the driver stores it."""
    device = run_device(cfg)
    backbone_cfg = build_backbone_config(cfg)
    model = init_probe_model(cfg, cfg.seed, backbone_cfg, device=device)
    if cfg.finetune:
        from ep_tpu_torch.convert.torch_vit import load_pretrained_backbone
        load_pretrained_backbone(cfg, backbone_cfg, model)
    if head_ckpt:
        from ep_tpu_torch.runtime.checkpoint import load_model
        load_model(cfg.replace(resume=head_ckpt, eval=True), model, None)
    if not cfg.finetuning and cfg.amp == "bfloat16":
        cast_frozen(model, torch.bfloat16)
    return model.eval(), device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 parents=[get_args_parser()])
    ap.add_argument("--split", choices=["train", "val"], default="val")
    ap.add_argument("--out", required=True)
    ap.add_argument("--head_ckpt", default="",
                    help="trained probe checkpoint (writes logits too)")
    args = ap.parse_args(argv)
    cfg = config_from_args(args)
    model, device = build_probe(cfg, args.head_ckpt)

    _, transform_val = build_transforms(cfg)
    ds_train, ds_val = build_datasets(cfg)
    dataset = ds_train if args.split == "train" else ds_val
    loader = DataLoader(dataset, cfg.batch_size, transform_val,
                        num_workers=cfg.num_workers)

    feats_all, logits_all, labels_all = [], [], []
    for i, (images, labels, valid) in enumerate(iter(loader)):
        with torch.no_grad():
            logits, feats = model(to_device(images, device, False, cfg),
                                  return_backbone_features=True)
        keep = valid > 0
        feats_all.append(feats.float().cpu().numpy()[keep])
        logits_all.append(logits.float().cpu().numpy()[keep])
        labels_all.append(labels[keep])
        if i % 20 == 0:
            print(f"[extract] batch {i}/{len(loader)}")

    feats = np.concatenate(feats_all)
    labels = np.concatenate(labels_all)
    payload = {"features": feats, "labels": labels,
               "cls_features": cfg.cls_features, "model": cfg.model}
    if args.head_ckpt:
        payload["logits"] = np.concatenate(logits_all)
    np.savez(args.out, **payload)
    print(f"[extract] wrote {args.out}: features {feats.shape}, "
          f"labels {labels.shape}")
    return payload


if __name__ == "__main__":
    main()
