#!/usr/bin/env python3
"""LR grid search of the PyTorch port — search_linprobe.py's counterpart.

Runs the port's linprobe driver (``ep_tpu_torch/cli/linprobe.py``) once per
blr in the grid, each into ``{output_dir}/trial_{n}/``, and reads "Max
Accuracy" back from training_log.txt (search_linprobe.py:14-51). Uses
optuna's GridSampler when optuna is installed; otherwise a plain sequential
grid with the same behaviour and result files. It takes the flags of
``main_linprobe_torch.py`` and trains on the CUDA device unless
``--device cpu`` is given:

    python search_linprobe_torch.py --model vit_base_patch16 \\
        --cls_features ep --output_dir runs/search ...
"""
import argparse
import dataclasses
import os
import re

from ep_tpu_torch.cli.linprobe import main as linprobe_main
from ep_tpu_torch.configs import config_from_args, get_args_parser

# LARS search space (reference search_linprobe.py:60); override with
# EP_SEARCH_BLRS="0.1,0.5,1.0"
SEARCH_SPACE = {"blr": [0.1, 0.2, 0.5, 0.7, 1.0, 1.2, 1.5]}
if os.environ.get("EP_SEARCH_BLRS"):
    SEARCH_SPACE = {"blr": [float(v) for v in
                            os.environ["EP_SEARCH_BLRS"].split(",")]}


def read_max_accuracy(output_dir: str) -> float:
    log_path = os.path.join(output_dir, "training_log.txt")
    with open(log_path) as f:
        for line in f:
            if "Max Accuracy" in line:
                return float(re.findall(r"[\d.]+", line)[0])
    return 0.0


def run_trial(base_cfg, blr: float, trial_number: int) -> float:
    cfg = dataclasses.replace(
        base_cfg, blr=blr, lr=None,
        output_dir=os.path.join(base_cfg.output_dir, f"trial_{trial_number}"))
    os.makedirs(cfg.output_dir, exist_ok=True)
    linprobe_main(cfg)
    return read_max_accuracy(cfg.output_dir)


def main(argv=None):
    parser = argparse.ArgumentParser(parents=[get_args_parser()])
    base_cfg = config_from_args(parser.parse_args(argv))

    try:
        import optuna
        from optuna.samplers import GridSampler

        def objective(trial):
            blr = trial.suggest_categorical("blr", SEARCH_SPACE["blr"])
            return run_trial(base_cfg, blr, trial.number)

        study = optuna.create_study(direction="maximize",
                                    sampler=GridSampler(SEARCH_SPACE))
        study.optimize(objective, n_trials=len(SEARCH_SPACE["blr"]))
        best_blr, best_acc = study.best_params["blr"], study.best_value
    except ImportError:
        print("[search] optuna not installed — sequential grid fallback")
        results = {}
        for n, blr in enumerate(SEARCH_SPACE["blr"]):
            results[blr] = run_trial(base_cfg, blr, n)
            print(f"trial_{n}: blr={blr} max_acc={results[blr]:.2f}")
        best_blr = max(results, key=results.get)
        best_acc = results[best_blr]
    print("Best BLR:", best_blr)
    print("Best Validation Accuracy:", best_acc)
    return best_blr, best_acc


if __name__ == "__main__":
    main()
