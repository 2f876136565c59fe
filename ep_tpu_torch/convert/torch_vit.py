"""``--finetune <path>`` and ``--oracle_ckpt <path>``: a torch ViT checkpoint
into the backbone or the DINO oracle.

Counterpart of ``ep_tpu/convert/torch_vit.py`` (the reference's
main_linprobe.py:373-411). The port's backbone already uses timm's names and
the ``nn.Linear``/``nn.Conv2d`` layouts, so the conversion is:
  * the ``model`` (or ``state_dict``) entry of the file; a full CLIP
    checkpoint's vision tower (``visual.``); the ``encoder.``, ``module.`` and
    ``backbone.`` prefixes stripped; ``decoder*`` and ``mask_token`` dropped;
  * OpenCLIP's names (``conv1``, ``class_embedding``,
    ``positional_embedding``, ``ln_pre``, ``transformer.resblocks.{i}``,
    ``ln_post``, ``proj``) mapped to timm's (:func:`_remap_openclip`);
  * transformers' SigLIP vision tower (``SiglipVisionModel``, or a whole
    ``SiglipModel``'s ``vision_model.``) mapped to timm's
    (:func:`_remap_siglip`), its MAP head dropped;
  * CAPI's and DINOv3's ``storage_tokens`` and DINOv2's ``register_tokens``
    into ``reg_token``;
  * DINOv3's ``mlp.w1`` and ``mlp.w2`` concatenated into ``mlp.w12``, and
    what it holds for training alone dropped (:func:`_drop_dinov3_training`):
    ``rope_embed.periods`` (checked against the config's), ``mask_token``,
    ``attn.qkv.bias_mask`` and ``local_cls_norm``;
  * split q/k/v weights and biases concatenated into qkv;
  * BEiT/SimMIM's ``gamma_1``/``gamma_2`` into ``ls1.gamma``/``ls2.gamma``
    (DINOv2's ``ls1.gamma`` is already the port's name), its per-block
    ``attn.relative_position_bias_table`` into ``rel_pos_bias_{i}``;
  * the position embedding bicubic-resized (``utils/pos_embed.py``) when the
    checkpoint's grid is not the model's;
  * the classifier (``head``, ``fc_norm``, ``fc.``) dropped: the probe head
    stays as initialised.
A backbone entry the file does not hold is an error, as is an entry of the
wrong shape; but for the patch embedding's bias (CLIP's conv1 has none),
which keeps its initialisation, as in the JAX package.

A file that ``ep_tpu_torch/tools/convert_checkpoint.py`` wrote,
``{"backbone": state_dict, "model": name}`` in the port's own names, is
recognised by its ``backbone`` entry and loaded as it is, strictly
(:func:`load_backbone_file`), as the JAX driver sniffs its msgpack.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import torch
import torch.nn as nn

from ep_tpu_torch.ops.rope import rope_periods
from ep_tpu_torch.utils.pos_embed import interpolate_pos_embed

_DROPPED = ("head", "fc_norm", "oracle", "fc.")
# backbone entries a checkpoint may lack; they keep their initialisation
_OPTIONAL = ("patch_embed.proj.bias",)


def load_torch_state_dict(path: str, checkpoint_key: str = "model"
                          ) -> Dict[str, torch.Tensor]:
    return _state_dict_of(torch.load(path, map_location="cpu",
                                     weights_only=True), checkpoint_key)


def _state_dict_of(ckpt, checkpoint_key: str) -> Dict[str, torch.Tensor]:
    """The backbone's entries of a loaded torch checkpoint, prefixes and the
    decoder dropped."""
    if isinstance(ckpt, dict) and checkpoint_key in ckpt:
        ckpt = ckpt[checkpoint_key]
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    if any(k.startswith("visual.") for k in ckpt):
        # a full CLIP checkpoint: the vision tower only (the text tower has
        # its own transformer.resblocks)
        ckpt = {k[len("visual."):]: v for k, v in ckpt.items()
                if k.startswith("visual.")}
    sd = {}
    for k, v in ckpt.items():
        for pref in ("encoder.", "module.", "backbone."):
            if k.startswith(pref):
                k = k[len(pref):]
        if k.startswith(("decoder", "mask_token")):
            continue
        sd[k] = v
    return sd


def _remap_openclip(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """OpenCLIP visual-tower keys -> timm's (``ep_tpu/convert/torch_vit.py::
    _remap_openclip``); ``proj`` becomes ``visual_proj``."""
    top = {"conv1.weight": "patch_embed.proj.weight",
           "ln_pre.weight": "norm_pre.weight", "ln_pre.bias": "norm_pre.bias",
           "ln_post.weight": "norm.weight", "ln_post.bias": "norm.bias",
           "proj": "visual_proj"}
    block = {"ln_1.weight": "norm1.weight", "ln_1.bias": "norm1.bias",
             "attn.in_proj_weight": "attn.qkv.weight",
             "attn.in_proj_bias": "attn.qkv.bias",
             "attn.out_proj.weight": "attn.proj.weight",
             "attn.out_proj.bias": "attn.proj.bias",
             "ln_2.weight": "norm2.weight", "ln_2.bias": "norm2.bias",
             "mlp.c_fc.weight": "mlp.fc1.weight",
             "mlp.c_fc.bias": "mlp.fc1.bias",
             "mlp.c_proj.weight": "mlp.fc2.weight",
             "mlp.c_proj.bias": "mlp.fc2.bias"}
    out = {}
    for k, v in sd.items():
        if k == "class_embedding":
            out["cls_token"] = v.reshape(1, 1, -1)
        elif k == "positional_embedding":
            out["pos_embed"] = v[None]
        elif k in top:
            out[top[k]] = v
        elif k.startswith("transformer.resblocks."):
            parts = k.split(".")
            rest = ".".join(parts[3:])
            out[f"blocks.{parts[2]}.{block[rest]}" if rest in block else k] = v
        else:
            out[k] = v
    return out


def _remap_siglip(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """transformers' ``SiglipVisionTransformer`` keys -> timm's: the patch
    embedding's ``Conv2d``, the position embedding's (patches, D) table as
    (1, patches, D), ``self_attn.{q,k,v}_proj`` as split q/k/v (concatenated
    into ``attn.qkv`` below), ``out_proj``, ``layer_norm1/2``, ``mlp.fc1/2``
    and ``post_layernorm``. A whole ``SiglipModel``'s text tower and its
    ``logit_scale`` and ``logit_bias`` are not the vision tower's."""
    if any(k.startswith("vision_model.") for k in sd):
        sd = {k[len("vision_model."):]: v for k, v in sd.items()
              if k.startswith("vision_model.")}
    top = {"embeddings.patch_embedding.weight": "patch_embed.proj.weight",
           "embeddings.patch_embedding.bias": "patch_embed.proj.bias",
           "post_layernorm.weight": "norm.weight",
           "post_layernorm.bias": "norm.bias"}
    block = {"layer_norm1": "norm1", "layer_norm2": "norm2",
             "self_attn.q_proj": "attn.q", "self_attn.k_proj": "attn.k",
             "self_attn.v_proj": "attn.v", "self_attn.out_proj": "attn.proj",
             "mlp.fc1": "mlp.fc1", "mlp.fc2": "mlp.fc2"}
    out = {}
    for k, v in sd.items():
        if k.startswith("head."):
            # the MAP head (probe, attention, layernorm, mlp): the model's own
            # attentive pool over the patch tokens, which the probe head
            # replaces; the tower's output is post_layernorm's
            continue
        if k == "embeddings.position_ids":  # a buffer of older checkpoints
            continue
        if k == "embeddings.position_embedding.weight":
            out["pos_embed"] = v[None]
        elif k in top:
            out[top[k]] = v
        elif k.startswith(("encoder.layers.", "layers.")):
            # "layers." where the file's "encoder." prefix was stripped
            _, i, *mod, leaf = k.removeprefix("encoder.").split(".")
            mod = ".".join(mod)
            out[f"blocks.{i}.{block[mod]}.{leaf}" if mod in block else k] = v
        else:
            out[k] = v
    return out


def _to_port_names(sd: Dict[str, torch.Tensor], depth: int
                   ) -> Dict[str, torch.Tensor]:
    """Every supported layout's names -> the port's (timm's)."""
    if any(k.startswith("transformer.resblocks.") or k == "class_embedding"
           for k in sd):
        sd = _remap_openclip(sd)
    if any(k.startswith(("vision_model.", "embeddings.patch_embedding."))
           for k in sd):
        sd = _remap_siglip(sd)
    sd = dict(sd)
    for name in ("storage_tokens", "register_tokens"):  # CAPI, DINOv2
        if name in sd:
            sd["reg_token"] = sd.pop(name)
    if "visual_proj" in sd:  # (D, proj_dim), used as x @ proj: no transpose
        sd["proj"] = sd.pop("visual_proj")
    for i in range(depth):
        tp = f"blocks.{i}."
        a = tp + "attn."
        if a + "qkv.weight" not in sd and a + "q.weight" in sd:
            for leaf in ("weight", "bias"):
                parts = [sd.pop(f"{a}{n}.{leaf}", None) for n in "qkv"]
                if all(p is not None for p in parts):
                    sd[f"{a}qkv.{leaf}"] = torch.cat(parts, 0)
        m = tp + "mlp."
        if m + "w12.weight" not in sd and m + "w1.weight" in sd:  # DINOv3
            for leaf in ("weight", "bias"):
                parts = [sd.pop(f"{m}{n}.{leaf}", None) for n in ("w1", "w2")]
                if all(p is not None for p in parts):
                    sd[f"{m}w12.{leaf}"] = torch.cat(parts, 0)
        for g, ls in (("gamma_1", "ls1"), ("gamma_2", "ls2")):
            if tp + g in sd:
                sd[f"{tp}{ls}.gamma"] = sd.pop(tp + g)
        if a + "relative_position_bias_table" in sd:
            sd[f"rel_pos_bias_{i}.relative_position_bias_table"] = sd.pop(
                a + "relative_position_bias_table")
    return sd


def _drop_dinov3_training(sd: Dict[str, torch.Tensor], template: dict,
                          backbone_cfg) -> Dict[str, torch.Tensor]:
    """A DINOv3 checkpoint's entries that inference does not read and the
    backbone (``template``, its state dict) does not hold, dropped, each for
    its reason:

    * ``rope_embed.periods``: RoPE's periods are a function of the base and
      the head width, which the config holds (``ops/rope.py::
      rope_tables``); a checkpoint whose periods differ from those raises,
      since its model was trained with other angles;
    * ``mask_token``: the masked-image objective's token, training only;
    * ``blocks.{i}.attn.qkv.bias_mask``: ``LinearKMaskedBias``'s mask that
      zeroes a k bias; the 7B's qkv has no bias;
    * ``local_cls_norm.*``: the norm of the local crops' [CLS] in training
      (``untie_global_and_local_cls_norm``); inference normalises every
      token by ``norm``."""
    sd = dict(sd)
    periods = sd.pop("rope_embed.periods", None)
    if periods is not None:
        base = getattr(backbone_cfg, "rope_base", None)
        dh = backbone_cfg.embed_dim // backbone_cfg.num_heads
        want = None if base is None else rope_periods(dh, base)
        if want is None or periods.shape != want.shape or not torch.allclose(
                periods.float(), want, rtol=1e-6, atol=0):
            raise ValueError(
                f"--finetune: rope_embed.periods {tuple(periods.shape)} is not "
                f"RoPE at base {base} and head width {dh}, which the model "
                "computes")
    for k in list(sd):
        if k not in template and (k == "mask_token" or k.startswith(
                "local_cls_norm.") or k.endswith(".attn.qkv.bias_mask")):
            del sd[k]
    return sd


def torch_vit_to_backbone(sd: Dict[str, torch.Tensor], backbone: nn.Module,
                          backbone_cfg) -> Dict[str, torch.Tensor]:
    """The backbone's state dict filled from a torch checkpoint ``sd`` of any
    of the supported layouts."""
    template = backbone.state_dict()
    sd = _drop_dinov3_training(_to_port_names(sd, backbone_cfg.depth),
                               template, backbone_cfg)
    out, missing = {}, []
    for name, tgt in template.items():
        if name not in sd:
            if name.startswith(_OPTIONAL):
                out[name] = tgt
            else:
                missing.append(name)
            continue
        v = sd[name]
        if name == "pos_embed" and v.shape != tgt.shape:
            print(f"Position interpolate {tuple(v.shape)} -> {tuple(tgt.shape)}")
            v = interpolate_pos_embed(
                v.float(), backbone_cfg.num_patches,
                tgt.shape[1] - backbone_cfg.num_patches)
        if v.shape != tgt.shape:
            raise ValueError(f"--finetune: {name} has shape {tuple(v.shape)}, "
                             f"the model's is {tuple(tgt.shape)}")
        out[name] = v.to(tgt.dtype)
    if missing:
        raise KeyError(f"--finetune: the checkpoint holds no {missing[:10]}")
    leftovers = [k for k in sd if k not in template
                 and not k.startswith(_DROPPED)]
    if leftovers:
        print(f"[convert] unused checkpoint keys: {sorted(leftovers)[:10]}"
              f"{' ...' if len(leftovers) > 10 else ''}")
    return out


def _check_exists(path: str, flag: str) -> None:
    if not Path(path).exists():
        raise FileNotFoundError(
            f"{flag} {path}: timm-hub name resolution needs network "
            f"access; convert the checkpoint to a local .pth first")


def _converted_state(saved: Dict[str, torch.Tensor], module: nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """``module``'s state dict from a converted file: every entry by name
    and shape. Entries the module does not hold (blocks past
    ``--return_block``, OpenCLIP's ``proj`` outside ``cls`` mode) are
    left out."""
    template = module.state_dict()
    missing = [k for k in template if k not in saved]
    if missing:
        raise KeyError(f"the converted checkpoint holds no {missing[:10]}")
    for k, t in template.items():
        if saved[k].shape != t.shape:
            raise ValueError(f"the converted checkpoint's {k} has shape "
                             f"{tuple(saved[k].shape)}, the model's is "
                             f"{tuple(t.shape)}")
    return {k: saved[k].to(t.dtype) for k, t in template.items()}


def load_backbone_file(path: str, checkpoint_key: str, module: nn.Module,
                       backbone_cfg) -> None:
    """Load a backbone file into ``module`` strictly: the port's converted
    file as it is, any other torch checkpoint through
    :func:`torch_vit_to_backbone`."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if (isinstance(payload, dict) and isinstance(payload.get("backbone"), dict)
            and isinstance(payload.get("model"), str)):
        print(f"[convert] loading pre-converted {payload['model']} backbone "
              "checkpoint")
        state = _converted_state(payload["backbone"], module)
    else:
        state = torch_vit_to_backbone(_state_dict_of(payload, checkpoint_key),
                                      module, backbone_cfg)
    module.load_state_dict(state, strict=True)


def load_pretrained_backbone(cfg, backbone_cfg, model: nn.Module) -> None:
    """Load ``cfg.finetune`` into ``model.backbone`` in place of its random
    initialisation (main_linprobe.py:373-411)."""
    _check_exists(cfg.finetune, "--finetune")
    print(f"Interpreting {cfg.finetune} as path")
    load_backbone_file(cfg.finetune, cfg.checkpoint_key, model.backbone,
                       backbone_cfg)


def load_oracle(cfg, backbone_cfg, model: nn.Module) -> None:
    """Load ``cfg.oracle_ckpt`` (a timm/DINO-layout ViT) into ``model.oracle``,
    the frozen DINO teacher of ``--cls_features dino``
    (``ep_tpu/convert/torch_vit.py::load_oracle``)."""
    from ep_tpu_torch.models.assembly import oracle_config
    if getattr(model, "oracle", None) is None:
        raise ValueError("--oracle_ckpt given but the model has no oracle "
                         "(use --cls_features dino)")
    _check_exists(cfg.oracle_ckpt, "--oracle_ckpt")
    load_backbone_file(cfg.oracle_ckpt, cfg.checkpoint_key, model.oracle,
                       oracle_config(backbone_cfg))
    print(f"[convert] loaded oracle weights from {cfg.oracle_ckpt}")
