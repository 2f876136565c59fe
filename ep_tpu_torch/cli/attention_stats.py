"""Attention-statistics driver — the main_attention_stats.py equivalent.

Counterpart of ``ep_tpu/cli/attention_stats.py``: collects per-block attention
diagnostics over the val set through the backbone's capture mode
(``VisionTransformer(..., capture_stats=True)``: the 5-kind stack of
models_vit.py:246-264 plus residual magnitudes), reduces each batch to a
(10, blocks) table on the device, averages the tables over the batches, logs
per-block line charts to wandb when configured, writes a JSON summary, and
optionally draws a t-SNE scatter of the [CLS] features
(main_attention_stats.py:66-293).

Every block runs the plain route with its probabilities, as in the JAX
package: no attention kernel. It runs on the card unless ``--device cpu`` is
given.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ep_tpu_torch.cli.linprobe import run_device
from ep_tpu_torch.configs import TrainConfig
from ep_tpu_torch.data.datasets import build_datasets
from ep_tpu_torch.data.loader import DataLoader
from ep_tpu_torch.data.transforms import build_transforms_v2
from ep_tpu_torch.models.assembly import (SkipDefaultInit,
                                          build_backbone_config, init_backbone)
from ep_tpu_torch.models.vit import ViTConfig, VisionTransformer
from ep_tpu_torch.train.engine import to_device
from ep_tpu_torch.utils.logging import maybe_setup_wandb


def get_args_parser():
    p = argparse.ArgumentParser("attention statistics", add_help=False)
    p.add_argument("--batch_size", default=512, type=int)
    p.add_argument("--model", default="vit_base_patch16", type=str)
    p.add_argument("--input_size", default=224, type=int)
    p.add_argument("--simmim", action="store_true", default=False)
    p.add_argument("--finetune", default="")
    p.add_argument("--checkpoint_key", default="model", type=str)
    p.add_argument("--data_path", default="/datasets01/imagenet", type=Path)
    p.add_argument("--dataset_name", default="imagenet1k", type=str)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--num_workers", default=10, type=int)
    p.add_argument("--max_batches", default=0, type=int,
                   help="cap the number of val batches (0 = all)")
    p.add_argument("--draw_2d_embeddings", action="store_true", default=False)
    p.add_argument("--amp", default="bfloat16", type=str)
    p.add_argument("--dino_aug", action="store_true", default=False,
                   help="DINO-style train augmentation in the v2 dataset "
                        "builder (util/datasets.py:21-34); the stats pass "
                        "itself always reads the val split")
    p.add_argument("--device", default="cuda",
                   help="cpu, or the CUDA device (the default)")
    return p


def block_table(stats: torch.Tensor, magnitudes: torch.Tensor) -> torch.Tensor:
    """stats (5, B, blocks, H, T) and magnitudes (2, B, blocks, T) -> the
    (10, blocks) table of :data:`STAT_NAMES`: means over the batch and the
    heads, [CLS] apart from the patch tokens."""
    s = stats.float()
    m = magnitudes.float()
    return torch.stack([
        s[0, :, :, :, 0].mean(dim=(0, 2)),       # cls self-attention
        s[0, :, :, :, 1:].mean(dim=(0, 2, 3)),   # pos self-attention
        s[1, :, :, :, 0].mean(dim=(0, 2)),       # the same over the patch
        s[1, :, :, :, 1:].mean(dim=(0, 2, 3)),   # keys' mass
        s[2, :, :, :, 1:].mean(dim=(0, 2, 3)),   # cls -> pos
        s[3, :, :, :, 1:].mean(dim=(0, 2, 3)),   # pos -> cls
        s[4, :, :, :, 0].mean(dim=(0, 2)),       # cls entropy over pos
        s[4, :, :, :, 1:].mean(dim=(0, 2, 3)),   # pos entropy over pos
        m[:, :, :, 0].mean(dim=(0, 1)),          # cls magnitudes
        m[:, :, :, 1:].mean(dim=(0, 1, 3)),      # pos magnitudes
    ])


def collect_features(model, loader, device, max_batches=0, cfg=None):
    """Per-batch capture of ([CLS] features, the (10, blocks) table),
    averaged over the batches (main_attention_stats.py:225-286). The table is
    reduced on the device, so only (B, D) features and 10 x blocks numbers
    leave it; padded rows of the last batch are dropped from the features
    (``valid``), as in the JAX package."""
    feats_all, labels_all, blocks_sum, n = [], [], None, 0
    for i, (images, labels, valid) in enumerate(iter(loader)):
        if max_batches and i >= max_batches:
            break
        with torch.no_grad():
            feats, stats, magn = model(to_device(images, device, False, cfg),
                                       "cls", capture_stats=True)
            pb = block_table(stats, magn).cpu().numpy()
        keep = valid > 0
        feats_all.append(feats.float().cpu().numpy()[keep])
        labels_all.append(labels[keep])
        blocks_sum = pb if blocks_sum is None else blocks_sum + pb
        n += 1
    return (np.concatenate(feats_all), np.concatenate(labels_all),
            blocks_sum / max(n, 1))


STAT_NAMES = [
    "cls_cls_attention", "pos_self_attention",
    "cls_cls_attention_adj_for_cls", "pos_self_attention_adj_for_cls",
    "cls_pos_attention", "pos_cls_attention",
    "cls_pos_entropy", "pos_pos_entropy",
    "cls_magnitude", "pos_magnitude",
]


def build_model(cfg: TrainConfig, device: torch.device) -> VisionTransformer:
    """The backbone of ``cfg`` with weights drawn from ``cfg.seed``, or
    ``cfg.finetune``'s, on ``device``."""
    backbone_cfg = build_backbone_config(cfg)
    if not isinstance(backbone_cfg, ViTConfig):
        raise ValueError(f"--model {cfg.model}: attention statistics read a "
                         "VisionTransformer, not an autoencoder")
    with SkipDefaultInit():  # init_backbone draws every parameter
        model = VisionTransformer(backbone_cfg)
    init_backbone(model, torch.Generator().manual_seed(cfg.seed))
    if cfg.finetune:
        from ep_tpu_torch.convert.torch_vit import load_backbone_file
        load_backbone_file(cfg.finetune, cfg.checkpoint_key, model,
                           backbone_cfg)
    return model.to(device).eval()


def main(args):
    print(f"attention-stats config: {args}")
    cfg = TrainConfig(
        model=args.model, simmim=args.simmim, finetune=args.finetune,
        checkpoint_key=args.checkpoint_key, image_size=args.input_size,
        dataset_name=args.dataset_name, data_path=args.data_path,
        amp=args.amp, batch_size=args.batch_size,
        num_workers=args.num_workers, seed=args.seed,
        device=getattr(args, "device", "cuda"),
    )
    device = run_device(cfg)
    model = build_model(cfg, device)

    # the v2 (DINO-style) dataset builder's val protocol: Resize(16/14) +
    # CenterCrop, or plain Normalize(0.5,0.5) for cifar
    # (main_attention_stats.py:81 -> util/datasets.py:13-63)
    _, transform_val = build_transforms_v2(
        cfg.image_size, cfg.dataset_name, getattr(args, "dino_aug", False))
    _, dataset_val = build_datasets(cfg)
    loader = DataLoader(dataset_val, cfg.batch_size, transform_val,
                        num_workers=cfg.num_workers)

    if args.output_dir:
        maybe_setup_wandb(args.output_dir, cfg, job_type="attn_stats")

    feats, labels, per_block = collect_features(
        model, loader, device, args.max_batches, cfg)

    summary = {name: per_block[i].tolist()
               for i, name in enumerate(STAT_NAMES)}
    try:
        import wandb
        if wandb.run is not None:
            for b in range(per_block.shape[1]):
                wandb.log({f"test_attn/{n}": float(per_block[i, b])
                           for i, n in enumerate(STAT_NAMES)} |
                          {"test_attn/vit_block": b})
    except ImportError:
        pass

    if args.output_dir:
        out = Path(args.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / "attention_stats.json").write_text(json.dumps(summary, indent=2))
        print(f"wrote {out / 'attention_stats.json'}")
        if args.draw_2d_embeddings:
            _draw_tsne(feats, labels, out)
    return summary


def _draw_tsne(feats, labels, out: Path):
    from sklearn.manifold import TSNE
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    latent_2d = TSNE().fit_transform(feats)
    fig, ax = plt.subplots()
    for label in range(10):
        sub = latent_2d[labels == label][:25]
        ax.scatter(sub[:, 0], sub[:, 1], label=label)
    ax.legend()
    fig.savefig(out / "tsne.png", dpi=150, bbox_inches="tight")
    print(f"wrote {out / 'tsne.png'}")


def cli():
    parser = argparse.ArgumentParser(parents=[get_args_parser()])
    main(parser.parse_args())


if __name__ == "__main__":
    cli()
