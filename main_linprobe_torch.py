#!/usr/bin/env python3
"""CLI shim of the PyTorch port, with the flags of ``main_linprobe.py``:

    python main_linprobe_torch.py --model vit_base_patch16 --cls_features ep ...

It trains on the CUDA device unless ``--device cpu`` is given. The
implementation lives in ep_tpu_torch/cli/linprobe.py.
"""
from ep_tpu_torch.cli.linprobe import cli

if __name__ == "__main__":
    cli()
