"""Every checkpoint layout of the backbone family through both converters:
the JAX package's ``torch_vit_to_flax`` (then ``from_flax.py``) and the
port's ``torch_vit_to_backbone`` must give the same backbone, equal to the
weights the checkpoint was written from.

Layouts: timm with split q/k/v (weights and biases), OpenCLIP (its own names,
conv1 without a bias, the (D, proj_dim) projection), a full CLIP file
(``visual.`` and a text tower), CAPI (``storage_tokens``), DINOv2
(``register_tokens``, ``ls1.gamma``, a ``mask_token``), BEiT/SimMIM
(``gamma_1``/``gamma_2``, ``q_bias``/``v_bias``, the shared table and a
table a block, the ``encoder.`` prefix), the SwiGLU giant (``w12``/``w3``),
and an MAE file with its decoder; then ``--finetune`` and ``--oracle_ckpt``
through both packages' loaders. Exact equality: both only rename, concatenate
and transpose.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_backbone_util as bu
from ep_tpu.configs import TrainConfig
from ep_tpu.convert import torch_vit as jconv
from ep_tpu.models.assembly import ProbeModel as FlaxProbeModel
from ep_tpu.models.vit import VisionTransformer as FlaxViT
from ep_tpu_torch.configs import TrainConfig as PortTrainConfig
from ep_tpu_torch.convert import torch_vit as pconv
from ep_tpu_torch.convert.from_flax import flax_to_torch
from ep_tpu_torch.models.assembly import ProbeModel
from ep_tpu_torch.models.vit import VisionTransformer

DEPTH = bu.DEPTH


def _split_qkv(sd, leaves=("weight",)):
    """q, k and v apart (the DINO heads' layout); the JAX converter reads
    split weights only (split biases: see the test below)."""
    out = {}
    for k, v in sd.items():
        if ".attn.qkv." in k and k.rsplit(".", 1)[-1] in leaves:
            for n, part in zip("qkv", v.chunk(3, 0)):
                out[k.replace(".qkv.", f".{n}.")] = part
        else:
            out[k] = v
    return out


def _openclip(sd):
    top = {"patch_embed.proj.weight": "conv1.weight",
           "norm_pre.weight": "ln_pre.weight", "norm_pre.bias": "ln_pre.bias",
           "norm.weight": "ln_post.weight", "norm.bias": "ln_post.bias",
           "proj": "proj"}
    block = {"norm1": "ln_1", "norm2": "ln_2", "attn.qkv.weight":
             "attn.in_proj_weight", "attn.qkv.bias": "attn.in_proj_bias",
             "attn.proj": "attn.out_proj", "mlp.fc1": "mlp.c_fc",
             "mlp.fc2": "mlp.c_proj"}
    out = {}
    for k, v in sd.items():
        if k == "cls_token":
            out["class_embedding"] = v.reshape(-1)
        elif k == "pos_embed":
            out["positional_embedding"] = v[0]
        elif k in top:
            out[top[k]] = v
        elif k.startswith("blocks."):
            _, i, rest = k.split(".", 2)
            for a, b in block.items():
                if rest.startswith(a):
                    rest = b + rest[len(a):]
                    break
            out[f"transformer.resblocks.{i}.{rest}"] = v
    return out


def _renamed(names):
    def f(sd):
        out = {}
        for k, v in sd.items():
            for a, b in names:
                k = k.replace(a, b)
            out[k] = v
        return out
    return f


def _beit(sd):
    out = _renamed([(".ls1.gamma", ".gamma_1"), (".ls2.gamma", ".gamma_2")])(sd)
    for i in range(DEPTH):
        t = out.pop(f"rel_pos_bias_{i}.relative_position_bias_table", None)
        if t is not None:
            out[f"blocks.{i}.attn.relative_position_bias_table"] = t
    return out


LAYOUTS = {
    "timm_split_qkv": (dict(), _split_qkv),
    "openclip": (dict(pre_norm=True, final_norm="ln", proj_dim=32,
                      mlp_type="quick_gelu", norm_eps=1e-5), _openclip),
    "capi": (dict(class_token=False, reg_tokens=4, cls_from_registers=True,
                  final_norm="ln"), _renamed([("reg_token", "storage_tokens")])),
    "dinov2": (dict(reg_tokens=4, init_values=1e-5, final_norm="ln"),
               _renamed([("reg_token", "register_tokens")])),
    "simmim_shared": (dict(qkv_bias_mode="qv_only", use_abs_pos_emb=False,
                           rel_pos_bias="shared", init_values=0.1), _beit),
    "beit_per_block": (dict(qkv_bias_mode="qv_only", use_abs_pos_emb=False,
                            rel_pos_bias="per_block", init_values=0.1), _beit),
    "swiglu": (dict(mlp_type="swiglu", init_values=1e-5), _split_qkv),
}


def _backbone(kw, seed):
    """(flax config, flax params, the port's backbone state) of one family,
    written from redrawn weights; the patch embedding's bias is zero, as
    both packages initialise it where a checkpoint (CLIP's) has none."""
    fcfg = bu.flax_cfg(**kw)
    v = FlaxViT(fcfg).init(jax.random.key(0), jnp.zeros((2, bu.IMG, bu.IMG, 3)),
                           "cls")
    params = bu.redraw(v["params"], seed)
    params["patch_embed"]["bias"] = np.zeros_like(params["patch_embed"]["bias"])
    state, _ = flax_to_torch({"params": params}, device="cpu")
    return fcfg, v["params"], state


def _both(sd, fcfg, template, state):
    """The two converters' backbones, each as the port's state dict."""
    flax_params = jconv.torch_vit_to_flax(
        {k: v.numpy() for k, v in sd.items()},
        jax.tree_util.tree_map(np.asarray, template), fcfg)
    theirs, _ = flax_to_torch({"params": flax_params}, device="cpu")
    pcfg = bu.port_cfg(fcfg)
    vit = VisionTransformer(pcfg)
    with torch.no_grad():
        vit.patch_embed.proj.bias.zero_()
    ours = pconv.torch_vit_to_backbone(sd, vit, pcfg)
    vit.load_state_dict(ours, strict=True)
    return ours, theirs


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_converts_like_the_jax_package(layout):
    kw, to_layout = LAYOUTS[layout]
    fcfg, template, state = _backbone(kw, seed=len(layout))
    sd = to_layout(state)
    assert set(sd) != set(state) or layout == "swiglu"
    ours, theirs = _both(sd, fcfg, template, state)
    assert ours.keys() == theirs.keys() == state.keys()
    for k in state:
        torch.testing.assert_close(ours[k], state[k], rtol=0, atol=0, msg=k)
        torch.testing.assert_close(theirs[k], state[k], rtol=0, atol=0, msg=k)


def _save(path, sd):
    torch.save(sd, path)
    return str(path)


@pytest.mark.parametrize("layout, wrap", [
    ("openclip", "full_clip"), ("dinov2", "mask_token"),
    ("simmim_shared", "encoder"), ("timm_split_qkv", "mae_decoder")])
def test_checkpoint_file_loads_like_the_jax_package(tmp_path, layout, wrap):
    """The file readers: a full CLIP checkpoint's vision tower beside its text
    tower, a DINOv2 file with its mask token, a SimMIM file under
    ``encoder.`` in ``model``, an MAE file with its decoder."""
    kw, to_layout = LAYOUTS[layout]
    fcfg, template, state = _backbone(kw, seed=3)
    sd = to_layout(state)
    if wrap == "full_clip":
        sd = {**{f"visual.{k}": v for k, v in sd.items()},
              "transformer.resblocks.0.ln_1.weight": torch.ones(8),
              "logit_scale": torch.ones(())}
    elif wrap == "mask_token":
        sd = {**sd, "mask_token": torch.zeros(1, bu.D)}
    elif wrap == "encoder":
        sd = {"model": {f"encoder.{k}": v for k, v in sd.items()}}
    else:
        sd = {"model": {**sd, "decoder_embed.weight": torch.zeros(8, bu.D),
                        "decoder_pos_embed": torch.zeros(1, 17, 8),
                        "mask_token": torch.zeros(1, 1, 8)}}
    path = _save(tmp_path / "ckpt.pth", sd)
    read_t = pconv.load_torch_state_dict(path)
    read_j = jconv.load_torch_state_dict(path)
    assert read_t.keys() == read_j.keys()
    ours, theirs = _both(read_t, fcfg, template, state)
    for k in state:
        torch.testing.assert_close(ours[k], state[k], rtol=0, atol=0, msg=k)
        torch.testing.assert_close(theirs[k], state[k], rtol=0, atol=0, msg=k)


def _probe(cfg, fcfg):
    fm = FlaxProbeModel(fcfg, cfg)
    v = fm.init(jax.random.key(0), jnp.zeros((2, bu.IMG, bu.IMG, 3)),
                train=True)
    pm = bu.load_port(ProbeModel(bu.port_cfg(fcfg),
                                 PortTrainConfig(**dataclasses.asdict(cfg))),
                      jax.tree_util.tree_map(np.asarray, v))
    return v, pm


def test_finetune_and_oracle_load_like_the_jax_package(tmp_path):
    """``--finetune`` of a DINOv2-hub-layout file into a ``dino``-mode model
    and ``--oracle_ckpt`` of a timm-layout file into its oracle, through each
    package's loader: the same backbone and oracle."""
    _, _, bb_state = _backbone(LAYOUTS["dinov2"][0], seed=11)
    # the oracle keeps the backbone's final norm (oracle_config), which a
    # timm DINO checkpoint holds
    _, _, or_state = _backbone(dict(final_norm="ln"), seed=12)
    fin = _save(tmp_path / "dinov2.pth",
                {"model": LAYOUTS["dinov2"][1](bb_state)})
    orc = _save(tmp_path / "oracle.pth", {"model": _split_qkv(or_state)})
    cfg = TrainConfig(model="vit_tiny_patch16", cls_features="dino",
                      nb_classes=5, image_size=bu.IMG, amp="float32",
                      finetune=fin, oracle_ckpt=orc)
    fcfg = bu.flax_cfg(**LAYOUTS["dinov2"][0])
    v, pm = _probe(cfg, fcfg)
    v = jconv.load_pretrained_backbone(cfg, fcfg, v)
    v = jconv.load_oracle(cfg, fcfg, v)
    theirs, _ = flax_to_torch(jax.tree_util.tree_map(np.asarray, v),
                              device="cpu")
    pcfg = PortTrainConfig(**dataclasses.asdict(cfg))
    with torch.no_grad():
        pm.backbone.patch_embed.proj.bias.zero_()
    pconv.load_pretrained_backbone(pcfg, bu.port_cfg(fcfg), pm)
    pconv.load_oracle(pcfg, bu.port_cfg(fcfg), pm)
    ours = pm.state_dict()
    for prefix, state in (("backbone.", bb_state), ("oracle.", or_state)):
        for k, t in state.items():
            torch.testing.assert_close(ours[prefix + k], t, rtol=0, atol=0)
            torch.testing.assert_close(theirs[prefix + k], t, rtol=0, atol=0)


def test_oracle_ckpt_without_an_oracle_raises(tmp_path):
    cfg = PortTrainConfig(model="vit_tiny_patch16", cls_features="ep",
                          nb_classes=5, image_size=bu.IMG,
                          oracle_ckpt=str(tmp_path / "none.pth"))
    fcfg = bu.flax_cfg()
    pm = ProbeModel(bu.port_cfg(fcfg), cfg)
    with pytest.raises(ValueError, match="no oracle"):
        pconv.load_oracle(cfg, bu.port_cfg(fcfg), pm)


def test_split_qkv_biases_are_concatenated():
    """Split q/k/v biases: the port concatenates them as it does the weights;
    the JAX converter reads only a fused ``attn.qkv.bias`` and leaves the
    bias at its initialisation (ROADMAP section 3, differences kept)."""
    fcfg, template, state = _backbone({}, seed=13)
    sd = _split_qkv(state, leaves=("weight", "bias"))
    ours, theirs = _both(sd, fcfg, template, state)
    key = "blocks.0.attn.qkv.bias"
    torch.testing.assert_close(ours[key], state[key], rtol=0, atol=0)
    assert not theirs[key].any()
