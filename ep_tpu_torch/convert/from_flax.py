"""The JAX package's variables (as numpy arrays) -> the port's tensors.

``flax_to_torch(variables)`` maps ``params`` and ``batch_stats`` of an
``ep_tpu`` ProbeModel onto the parameter and buffer names of
``ep_tpu_torch.models.assembly.ProbeModel``, so both compute the same thing:

* one layout rule for dense kernels: flax (in, out) -> ``nn.Linear`` (out, in),
  including the supercell's qkv and proj weights (its kernels read the
  ``nn.Linear`` layout) and clip's fused qkv;
* every convolution kernel (kh, kw, Cin, Cout) -> ``nn.Conv2d`` (Cout, Cin,
  kh, kw): the patch embedding's and the pooling heads' (cbam, dolg);
* LayerNorm and BatchNorm ``scale`` -> ``weight`` (``bias`` keeps its name);
  ``blocks_{i}`` and MAE's ``decoder_blocks_{i}`` -> ``blocks.{i}`` and
  ``decoder_blocks.{i}``; a module's own parameters (cait's
  ``blocks_token_only_0_gamma_1``, the extras' 0-d ones, ``q_bias``,
  ``v_bias``, the rel-pos tables, MAE's tokens, the oracle's tree under
  ``oracle``) keep name and shape;
* the backbone's names that timm spells otherwise: LayerScale's
  ``ls1/gamma_1`` -> ``ls1.gamma``, ``reg_tokens`` -> ``reg_token``;
  OpenCLIP's ``proj`` (D, proj_dim) keeps its layout (it is no dense
  kernel);
* BatchNorm ``mean``/``var`` -> ``running_mean``/``running_var``.

Both block layouts are read: the loop layout ``blocks_{i}`` and the scan
layout ``blocks/block`` with a leading depth axis (unstacked as
``ep_tpu/models/vit.py::unstack_block_params`` does, without jax).
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ep_tpu_torch.ops import default_device


def unstack_block_params(backbone: dict) -> dict:
    """Scan layout (``blocks/block`` stacked on a depth axis) -> loop layout."""
    if "blocks" not in backbone:
        return dict(backbone)
    stacked = backbone["blocks"]["block"]
    depth = next(iter(_flatten(stacked).values())).shape[0]

    def pick(tree, i):
        if hasattr(tree, "items"):
            return {k: pick(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    out = {k: v for k, v in backbone.items() if k != "blocks"}
    for i in range(depth):
        out[f"blocks_{i}"] = pick(stacked, i)
    return out


def _flatten(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _param(path: tuple, arr: np.ndarray) -> tuple[str, np.ndarray]:
    *mods, leaf = path
    mods = [re.sub(r"^((?:decoder_)?blocks)_(\d+)$", r"\1.\2", m)
            for m in mods]
    if mods[-1:] in (["ls1"], ["ls2"]) and leaf in ("gamma_1", "gamma_2"):
        leaf = "gamma"  # LayerScale: flax ls1/gamma_1 -> timm ls1.gamma
    elif leaf == "reg_tokens":
        leaf = "reg_token"
    if leaf == "kernel":
        leaf = "weight"
        if arr.ndim == 4:  # conv (ph, pw, Cin, D) -> (D, Cin, ph, pw)
            arr = arr.transpose(3, 2, 0, 1)
            if mods[-1:] == ["patch_embed"]:
                mods.append("proj")
        elif arr.ndim == 2:  # dense (in, out) -> (out, in)
            arr = arr.T
    elif leaf == "scale":  # LayerNorm, BatchNorm
        leaf = "weight"
    elif leaf == "bias" and mods[-1:] == ["patch_embed"]:
        mods.append("proj")
    return ".".join(mods + [leaf]), arr


def flax_to_torch(variables: dict, device=None) -> tuple[dict, dict]:
    """(state_dict of parameters, dict of buffers) for ``ProbeModel``, as
    tensors on ``device`` (None: the card; raises where there is none)."""
    device = default_device(device)
    params = dict(variables.get("params", {}))
    if "backbone" in params:
        params["backbone"] = unstack_block_params(params["backbone"])
    state = {}
    for path, arr in _flatten(params).items():
        name, arr = _param(path, arr)
        state[name] = torch.from_numpy(np.array(arr)).to(device)
    buffers = {}
    for path, arr in _flatten(variables.get("batch_stats", {})).items():
        *mods, leaf = path
        prefix = ".".join(mods)
        buffers[f"{prefix}.running_{leaf}"] = torch.from_numpy(
            np.array(arr)).to(device)
        buffers[f"{prefix}.num_batches_tracked"] = torch.tensor(0, device=device)
    return state, buffers
