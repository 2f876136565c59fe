"""Zoo sweep: train EVERY pooling head for a few epochs on the synthetic
dataset and print an accuracy table — fast end-to-end proof that each
--cls_features value trains (the reference's zoo sweep protocol at demo
scale).

Counterpart of ``tools/validate_zoo.py``, on the port's driver
(``ep_tpu_torch/cli/linprobe.py::main``) with the same heads, the same tiny
backbone (16 px, patch 4, width 48, depth 2, 4 heads, ``attn_impl="xla"``:
plain attention in every block) and the same table:

    python -m ep_tpu_torch.tools.validate_zoo [--epochs 4] [--device cpu] [--out FILE]

It runs on the card unless ``--device cpu`` is given. On the CPU it computes
in float32, as the JAX tool does; on the card in bfloat16, the dtype the
port's kernels take (kernel D pools the EP heads' tokens).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

import ep_tpu_torch.cli.linprobe as linprobe
from ep_tpu_torch.configs import TrainConfig
from ep_tpu_torch.models.vit import ViTConfig

HEADS = ["cls", "pos", "ep", "ep_all", "abmilp", "simpool", "esimpool",
         "siglip", "aim", "cbam", "coca", "cait", "dinovit", "jepa",
         "dolg", "cae"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--blr", type=float, default=8.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    amp = "float32" if args.device == "cpu" else "bfloat16"
    dtype = torch.float32 if amp == "float32" else torch.bfloat16
    tiny = ViTConfig(img_size=16, patch_size=4, embed_dim=48, depth=2,
                     num_heads=4, dtype=dtype, attn_impl="xla")
    linprobe.build_backbone_config = lambda cfg: tiny

    results = {}
    for head in HEADS:
        cfg = TrainConfig(
            dataset_name="fake", nb_classes=4, image_size=16, batch_size=32,
            cls_features=head, epochs=args.epochs, warmup_epochs=1,
            blr=args.blr, num_heads=4, ep_queries=4, output_dir="",
            num_workers=2, amp=amp, seed=0, pallas_pool=False,
            device=args.device)
        t0 = time.time()
        try:
            res = linprobe.main(cfg)
            results[head] = {"max_acc": round(res["max_accuracy"], 2),
                             "seconds": round(time.time() - t0, 1)}
        except Exception as e:  # keep sweeping; report the failure
            results[head] = {"error": f"{type(e).__name__}: {e}"}
        print(f"ZOO {head:12s} -> {results[head]}", flush=True)

    print("\n| head | max acc (4 classes, chance 25%) | time (s) |")
    print("|---|---:|---:|")
    for head, r in results.items():
        if "error" in r:
            print(f"| {head} | ERROR: {r['error'][:60]} | - |")
        else:
            print(f"| {head} | {r['max_acc']} | {r['seconds']} |")
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=2))
    failures = [h for h, r in results.items() if "error" in r]
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
