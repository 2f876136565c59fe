#!/usr/bin/env python3
"""CLI shim of the PyTorch port, with the flags of ``main_attention_stats.py``:

    python main_attention_stats_torch.py --model vit_base_patch16 ...

It runs on the CUDA device unless ``--device cpu`` is given. The
implementation lives in ep_tpu_torch/cli/attention_stats.py.
"""
from ep_tpu_torch.cli.attention_stats import cli

if __name__ == "__main__":
    cli()
