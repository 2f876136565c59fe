"""Checkpoint / resume with the reference's head-only semantics.

Counterpart of ``ep_tpu/runtime/checkpoint.py`` (util/misc.py:304-359 +
main_linprobe.py:639-653,706-713,764-773):
  * during probing only the HEAD (its parameters and the BN running
    statistics) is saved, with the optimizer's state, the epoch and the
    global step; ``--finetuning`` saves everything;
  * resume tries a strict restore and falls back to a lenient one (every
    entry whose name and shape match) when the checkpoint does not hold
    exactly what the model trains;
  * ``--auto_resume`` picks the newest ``checkpoint*`` in ``--output_dir``.

The file is ``checkpoint-{suffix}.pth``, the reference's own format, written
with ``torch.save`` and read with ``torch.load(weights_only=True)``: plain
tensors, numbers and JSON strings. ``model`` holds the saved entries of the
model's ``state_dict()`` by name; ``optimizer`` holds each trainable
parameter's optimizer state by the parameter's name (``mu``, and ``nu`` for
AdamW), with the optimizer's step count and micro-step, so the state of a
JAX-package checkpoint converts by the same name mapping as its parameters.
"""
from __future__ import annotations

import glob
import json
import os
import re
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ep_tpu_torch.train.state import split_params
from ep_tpu_torch.utils.logging import is_main_process

CKPT_SUFFIX = ".pth"


def saved_names(model: nn.Module, finetuning: bool) -> list[str]:
    """The ``state_dict()`` entries a checkpoint holds: the head's (its
    parameters and BN buffers) when probing, every entry when fine-tuning."""
    names = list(model.state_dict())
    return names if finetuning else [k for k in names if k.startswith("head.")]


def optimizer_state(model: nn.Module, optimizer, finetuning: bool) -> dict:
    """The optimizer's state keyed by parameter name."""
    names = {id(p): k for k, p in split_params(model, finetuning)[0].items()}
    group = optimizer.param_groups[0]
    return {
        "state": {names[id(p)]: {k: v.detach().cpu().clone()
                                 for k, v in optimizer.state[p].items()}
                  for g in optimizer.param_groups for p in g["params"]
                  if optimizer.state[p]},
        "count": int(group["count"]),
        "mini_step": int(group["mini_step"]),
    }


def load_optimizer_state(model: nn.Module, optimizer, finetuning: bool,
                         saved: dict) -> None:
    """Inverse of :func:`optimizer_state`; raises KeyError or ValueError
    where the saved state is not that of these parameters."""
    params = split_params(model, finetuning)[0]
    if set(saved["state"]) - set(params):
        raise KeyError(f"optimizer state for unknown parameters "
                       f"{sorted(set(saved['state']) - set(params))[:5]}")
    for name, st in saved["state"].items():
        p = params[name]
        for k, v in st.items():
            if k != "acc_grad" and v.shape != p.shape:
                raise ValueError(f"optimizer state {name}.{k}: shape "
                                 f"{tuple(v.shape)}, parameter {tuple(p.shape)}")
    for name, st in saved["state"].items():
        optimizer.state[params[name]] = {k: v.to(params[name].device)
                                         for k, v in st.items()}
    for group in optimizer.param_groups:
        group["count"] = int(saved["count"])
        group["mini_step"] = int(saved["mini_step"])


def save_model(cfg, epoch: int, model: nn.Module, optimizer, step: int,
               test_stats: Optional[Dict] = None,
               include_epoch_in_filename: bool = False) -> Optional[str]:
    if not cfg.output_dir or not is_main_process():
        return None
    epoch_name = (f"{cfg.suffix}_{epoch}" if include_epoch_in_filename
                  else cfg.suffix)
    path = Path(cfg.output_dir) / f"checkpoint-{epoch_name}{CKPT_SUFFIX}"
    sd = model.state_dict()
    payload = {
        "model": {k: sd[k].detach().cpu().clone()
                  for k in saved_names(model, cfg.finetuning)},
        "optimizer": optimizer_state(model, optimizer, cfg.finetuning),
        "epoch": epoch,
        "step": int(step),
        "test_stats": json.dumps(_jsonable(test_stats or {})),
        "config": json.dumps(_jsonable(
            {f: getattr(cfg, f) for f in cfg.__dataclass_fields__})),
    }
    Path(cfg.output_dir).mkdir(parents=True, exist_ok=True)
    torch.save(payload, path)
    return str(path)


def _jsonable(d: Dict) -> Dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, (str, int, float, bool, type(None))):
            out[k] = v
        elif isinstance(v, Path):
            out[k] = str(v)
        elif isinstance(v, (np.floating, np.integer)):
            out[k] = v.item()
        elif isinstance(v, dict):
            out[k] = _jsonable(v)
    return out


def load_model(cfg, model: nn.Module, optimizer):
    """Resume from cfg.resume into ``model`` and ``optimizer`` in place.
    Returns (start_epoch, global step, test_stats)."""
    if not cfg.resume:
        return cfg.start_epoch, 0, None
    payload = torch.load(cfg.resume, map_location="cpu", weights_only=True)

    saved = payload["model"]
    expected = saved_names(model, cfg.finetuning)
    current = model.state_dict()
    try:
        if set(saved) != set(expected):
            raise KeyError(f"missing {sorted(set(expected) - set(saved))[:5]}, "
                           f"unexpected {sorted(set(saved) - set(expected))[:5]}")
        for k in expected:
            if saved[k].shape != current[k].shape:
                raise ValueError(f"{k}: shape {tuple(saved[k].shape)}, model "
                                 f"{tuple(current[k].shape)}")
        model.load_state_dict(saved, strict=False)
        strict_ok = True
    except (KeyError, ValueError) as err:  # head-only / shape-mismatch
        print(f"[load_model] strict restore failed: {err}\n→ retrying leniently")
        model.load_state_dict(_merge_lenient(current, saved))
        strict_ok = False

    start_epoch, step, test_stats = cfg.start_epoch, 0, None
    if "optimizer" in payload and not cfg.eval and not cfg.knn_eval:
        try:
            load_optimizer_state(model, optimizer, cfg.finetuning,
                                 payload["optimizer"])
            step = int(payload.get("step", 0))
            start_epoch = int(payload["epoch"]) + 1
            test_stats = json.loads(payload.get("test_stats", "{}"))
            print("With optim & sched!")
        except (KeyError, ValueError) as err:
            if strict_ok:
                raise
            print(f"[load_model] optimizer restore skipped: {err}")
    print(f"Resume checkpoint {cfg.resume}")
    return start_epoch, step, test_stats


def _merge_lenient(template: dict, loaded: dict) -> dict:
    """``template`` with each entry whose name and shape ``loaded`` matches
    taken from ``loaded``; extra entries of ``loaded`` are ignored."""
    return {k: loaded[k] if k in loaded
            and tuple(loaded[k].shape) == tuple(t.shape) else t
            for k, t in template.items()}


def find_auto_resume(output_dir: str) -> Optional[str]:
    """Newest checkpoint* file (main_linprobe.py:764-773).

    Sorted by natural (numeric-aware) name order so checkpoint-9 <
    checkpoint-10 even though no current CLI path writes numbered names;
    mtime breaks ties.
    """
    if not output_dir or not os.path.isdir(output_dir):
        return None

    def key(path):
        name = os.path.basename(path)
        natural = tuple(int(tok) if tok.isdigit() else tok
                        for tok in re.split(r"(\d+)", name))
        return (natural, os.path.getmtime(path))

    ckpts = sorted(glob.glob(os.path.join(output_dir, "checkpoint*")), key=key)
    return ckpts[-1] if ckpts else None
