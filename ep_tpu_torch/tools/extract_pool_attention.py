"""Extract pooling-head attention maps (the paper's qualitative figures).

Counterpart of ``tools/extract_pool_attention.py``: runs the probe model on a
batch of validation images and saves the head's attention over the patch
grid (EP: per-query maps (B, Q, N); other attentive heads: their own
layout) with the labels and the predictions, plus an optional PNG grid.

    python -m ep_tpu_torch.tools.extract_pool_attention --dataset_name fake \\
        --cls_features ep --ep_queries 4 --resume checkpoint-.pth \\
        --out attn.npz [--png attn.png] [--device cpu]

The map is the head's ``return_attn`` output (EP's from the plain pool,
``ops/pool_attn.py::ep_pool_attend_ref``, as in the JAX package, since no
kernel computes the probabilities); the predictions come from the head's
usual route on the same features (kernel D for EP on the card). It runs on
the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ep_tpu_torch.configs import config_from_args, get_args_parser
from ep_tpu_torch.data.datasets import build_datasets
from ep_tpu_torch.data.loader import DataLoader
from ep_tpu_torch.data.transforms import build_transforms
from ep_tpu_torch.tools.extract_features import build_probe
from ep_tpu_torch.train.engine import to_device


def extract(model, images: torch.Tensor):
    """(logits f32, the head's attention map or None) of ``images``."""
    with torch.no_grad():
        _, feats, attn = model(images, return_backbone_features=True,
                               return_attn=True)
        logits = model.head(feats)
    return logits, attn


def main(argv=None):
    ap = argparse.ArgumentParser(parents=[get_args_parser()])
    ap.add_argument("--out", default="pool_attention.npz")
    ap.add_argument("--png", default="")
    ap.add_argument("--n_images", type=int, default=8)
    args = ap.parse_args(argv)
    cfg = config_from_args(args)
    model, device = build_probe(cfg, cfg.resume)

    _, dataset_val = build_datasets(cfg)
    _, transform_val = build_transforms(cfg)
    loader = DataLoader(dataset_val, args.n_images, transform_val,
                        num_workers=cfg.num_workers)
    images, labels, _ = next(iter(loader))

    logits, attn = extract(model, to_device(images, device, False, cfg))
    if attn is None:
        sys.exit(f"--cls_features {cfg.cls_features} has no attention map "
                 f"(plain LP or grid-conv head)")
    attn = attn.float().cpu().numpy()
    preds = logits.argmax(-1).cpu().numpy()
    np.savez(args.out, attention=attn, labels=labels, preds=preds)
    print(f"wrote {args.out}: attention {attn.shape}, "
          f"acc {float((preds == labels).mean()):.2f}")

    if args.png:
        _render(images, attn, args.png)
    return attn, labels, preds


def _render(images, attn, path):
    """PNG grid: image rows x (image + per-query heatmaps)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ep_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

    a = attn
    if a.ndim == 2:  # (B, N) single map
        a = a[:, None, :]
    elif a.ndim == 4:  # (B, H, Q, N) multi-head -> mean heads
        a = a.mean(axis=1)
    B, Q, N = a.shape[:3]
    hw = int(round(N ** 0.5))
    n_show = min(4, B)
    q_show = min(4, Q)
    fig, axes = plt.subplots(n_show, q_show + 1,
                             figsize=(2 * (q_show + 1), 2 * n_show),
                             squeeze=False)
    for i in range(n_show):
        img = images[i] * IMAGENET_STD + IMAGENET_MEAN
        axes[i][0].imshow(np.clip(img, 0, 1))
        axes[i][0].set_axis_off()
        for qi in range(q_show):
            axes[i][qi + 1].imshow(a[i, qi].reshape(hw, hw), cmap="viridis")
            axes[i][qi + 1].set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
