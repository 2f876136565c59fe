"""Typed configuration + argparse shim mirroring the reference CLI.

The port's own copy of ``ep_tpu/configs.py`` (standard library only): the
same ``TrainConfig`` fields with the same defaults and the same flag surface,
so a run command of the JAX package reads the same here and a reader finds
each counterpart by name. ``tests/test_torch_imports.py`` compares the two
``TrainConfig``s field by field, so the copy cannot drift unseen. Fields of
features that are not ported yet are carried for that flag surface; the
modules that would read them raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

# All pooled-feature choices the instrumented ViT understands
# (reference: models_vit.py:17-37).
POOLING_NAMES = [
    "abmilp", "simpool", "esimpool", "clip", "siglip", "aim", "ep",
    "cbam", "coca", "cait", "dinovit", "jepa", "dolg", "cae",
]
POOLING_NAMES_ALL = [f"{n}_all" for n in POOLING_NAMES]
CLS_FT_CHOICES = (
    ["cls", "pos", "both", "raw",
     "cp1", "cp2", "cp3", "cp4",
     "ca1", "ca2", "ca3", "ca4",
     "dino",
     "attn-lcte", "attn-mn",
     # accepted for CLI parity; unimplemented in the reference's
     # forward_features too (models_vit.py lists them at :23-26 but has no
     # branch — they raise NotImplementedError there as here)
     "tcut-bip", "tcut-bip-f", "tcut-eig", "tcut-eig-f",
     "tcut-eigbip", "tcut-eigbip-f", "tcut-eigsft", "tcut-eigsft-f"]
    + POOLING_NAMES
    + POOLING_NAMES_ALL
)

AMP_CHOICES = ["float16", "bfloat16", "float32", "none"]

DATASET_CHOICES = [
    "imagenet1k", "places365", "CIFAR100", "StanfordCars", "Food101",
    "FGVCAircraft", "SUN397", "DTD", "OxfordIIITPet", "CUB200", "stl10",
    "fake",  # in-memory synthetic dataset for tests/benches (ours)
]


@dataclass
class TrainConfig:
    """Every knob of a probing run. Field names match the reference flags."""

    # batching
    batch_size: int = 512
    epochs: int = 90
    accum_iter: int = 1

    # model
    model: str = "vit_large_patch16"
    openclip_pretrain: str = "openai"
    simmim: bool = False
    openclip: bool = False

    # optimizer
    weight_decay: float = 0.0
    optimizer: str = "lars"  # lars | adamw | sgd
    lr: Optional[float] = None
    blr: float = 0.1
    min_lr: float = 0.0
    warmup_epochs: int = 10

    # method
    cls_features: str = "cls"
    return_block: Optional[int] = None
    checkpoint_key: str = "model"
    no_cls_token: bool = False

    # abmilp
    abmilp_act: str = "tanh"
    abmilp_sa: str = "both"
    abmilp_depth: int = 2
    abmilp_cond: Optional[str] = None
    abmilp_content: str = "all"
    suffix: str = ""

    # EP
    ep_queries: int = 32
    d_out: int = 1

    # other poolings
    num_heads: int = 16

    # dataset
    dataset_name: str = "imagenet1k"
    data_path: Path = Path("/datasets01/imagenet_full_size/061417/")
    nb_classes: int = 1000
    train_aug: str = "default"  # default | aimv2
    image_size: int = 224

    # training
    output_dir: str = "./output_dir"
    device: str = "tpu"  # carried for the flag surface; the port places
    # tensors by the ``device`` argument of its constructors (default: CUDA)
    seed: int = 0
    finetune: str = ""
    oracle_ckpt: str = ""  # local DINO-teacher weights for --cls_features
    # dino (the reference pulls timm vit_base_patch16_224.dino from the hub,
    # models_vit.py:462-476; zero-egress: user supplies the file)
    resume: str = ""
    start_epoch: int = 0
    eval: bool = False
    dist_eval: bool = False
    num_workers: int = 10
    pin_mem: bool = True
    auto_resume: bool = False
    finetuning: bool = False

    # early stop
    early_stop: bool = False
    early_stop_patience: int = 5
    early_stop_min_delta: float = 0.1
    early_stop_min_epochs: int = 15

    # kNN
    knn_eval: bool = False
    T: float = 0.07

    # distributed / precision
    world_size: int = 1
    local_rank: int = -1
    dist_on_itp: bool = False
    dist_url: str = "env://"
    dataloader_affinity_hack: bool = False
    amp: str = "bfloat16"  # the reference's default is float16

    # extensions of the JAX package (absent in the reference)
    mesh_data: int = -1  # -1 = all devices on the data axis
    mesh_model: int = 1  # tensor-parallel axis size for huge backbones
    cache_features: bool = False  # extract frozen features once, train on cache
    cache_augs: int = 1  # augmentation draws cached per train image: K
    # extraction passes (epoch-seeded crops), epochs cycle variants e % K
    device_aug: bool = False  # RandomResizedCrop/flip/normalize on the
    # device inside the step; the host only decodes and stages a
    # deterministic u8 resize
    device_aug_stage: int = 0  # staged square side; 0 = image_size*256/224
    device_aug_cache: str = ""  # dir for the staged-u8 memmap cache (epoch 1
    # fills it, later epochs read it instead of re-running the host pipeline)
    aot_cache: str = ""  # the JAX package's cache of compiled executables;
    # PyTorch runs eagerly, so the port has nothing to cache
    pallas_pool: bool = True  # use the fused pooling kernel when it applies
    int8_mlp: bool = False  # OPT-IN int8 MLP half in the frozen backbone
    # (ops/mlp_int8.py): approximate, so off by default. Needs mlp_type gelu.
    attn_impl: str = "auto"  # encoder attention: auto | pallas (the kernels
    # on the card, their plain versions on the CPU) | xla (plain attention,
    # ops/attention.py::mha, in every block: no attention kernel)
    use_grain: bool = False  # grain-backed input pipeline (worker processes)
    scan_blocks: bool = False  # the JAX package scans over encoder layers;
    # the port always loops (remat_blocks requires the flag, as there)
    remat_blocks: bool = False  # rematerialize blocks in the backward pass
    # (--finetuning memory: per-block residuals shrink to the activations
    # carried). Requires --scan_blocks; no effect on the frozen probing path.
    remat_policy: str = "none"  # selective remat under --remat_blocks:
    # none (recompute all) | attn_out (save the attention half's output) |
    # attn_fc1 (also save the MLP fc1 output) | dots (save every
    # weight-matmul output). Memory grows left to right; see models/vit.py.
    mu_bf16: bool = False  # store the optimizer's momentum in bfloat16
    # (update math stays f32; train/lars.py), halving that buffer
    debug_nans: bool = False  # fail at the op producing NaN (JAX package)
    profile_dir: str = ""  # write a profiler trace here when set

    # filled in at runtime
    eff_batch_size: int = 0
    distributed: bool = False
    rank: int = 0

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def get_args_parser() -> argparse.ArgumentParser:
    """Argparse surface mirroring reference main_linprobe.py:58-181."""
    d = TrainConfig()
    p = argparse.ArgumentParser(
        "linear/attentive probing for image classification", add_help=False
    )
    p.add_argument("--batch_size", default=d.batch_size, type=int,
                   help="Batch size per process (effective batch = batch_size * accum_iter * #processes)")
    p.add_argument("--epochs", default=d.epochs, type=int)
    p.add_argument("--accum_iter", default=d.accum_iter, type=int)

    p.add_argument("--model", default=d.model, type=str, metavar="MODEL")
    p.add_argument("--openclip_pretrain", default=d.openclip_pretrain, type=str)
    p.add_argument("--simmim", action="store_true", default=False)
    p.add_argument("--openclip", action="store_true", default=False)

    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--optimizer", type=str, default=d.optimizer,
                   choices=["lars", "adamw", "sgd"])
    p.add_argument("--lr", type=float, default=None, metavar="LR")
    p.add_argument("--blr", type=float, default=d.blr, metavar="LR",
                   help="base lr: absolute_lr = base_lr * total_batch_size / 256")
    p.add_argument("--min_lr", type=float, default=d.min_lr, metavar="LR")
    p.add_argument("--warmup_epochs", type=int, default=d.warmup_epochs, metavar="N")

    p.add_argument("--cls_features", choices=CLS_FT_CHOICES, default=d.cls_features)
    p.add_argument("--return_block", type=int, default=None)
    p.add_argument("--checkpoint_key", default=d.checkpoint_key, type=str)
    p.add_argument("--no_cls_token", action="store_true", default=False)

    p.add_argument("--abmilp_act", choices=["tanh", "relu"], default=d.abmilp_act)
    p.add_argument("--abmilp_sa", choices=["none", "map", "both"], default=d.abmilp_sa)
    p.add_argument("--abmilp_depth", type=int, default=d.abmilp_depth)
    p.add_argument("--abmilp_cond", type=str, choices=["none", "pe"], default=None)
    p.add_argument("--abmilp_content", type=str, choices=["all", "patch"],
                   default=d.abmilp_content)
    p.add_argument("--suffix", type=str, default="")

    p.add_argument("--ep_queries", type=int, default=d.ep_queries)
    p.add_argument("--d_out", type=int, default=d.d_out)
    p.add_argument("--num_heads", type=int, default=d.num_heads)

    p.add_argument("--dataset_name", default=d.dataset_name, type=str)
    p.add_argument("--data_path", default=d.data_path, type=Path)
    p.add_argument("--nb_classes", default=d.nb_classes, type=int)
    p.add_argument("--train_aug", default=d.train_aug, type=str,
                   choices=["default", "aimv2"])
    p.add_argument("--image_size", default=d.image_size, type=int)

    p.add_argument("--output_dir", default=d.output_dir)
    p.add_argument("--device", default=d.device)
    p.add_argument("--seed", default=d.seed, type=int)
    p.add_argument("--finetune", default="")
    p.add_argument("--oracle_ckpt", default=d.oracle_ckpt, type=str,
                   help="local DINO teacher checkpoint for --cls_features "
                        "dino (.pth or converted .msgpack)")
    p.add_argument("--resume", default="")
    p.add_argument("--start_epoch", default=0, type=int, metavar="N")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--dist_eval", action="store_true", default=False)
    p.add_argument("--num_workers", default=d.num_workers, type=int)
    p.add_argument("--pin_mem", action="store_true")
    p.add_argument("--no_pin_mem", action="store_false", dest="pin_mem")
    p.set_defaults(pin_mem=True)
    p.add_argument("--auto_resume", action="store_true", default=False)
    p.add_argument("--finetuning", action="store_true", default=False)

    p.add_argument("--early_stop", action="store_true", default=False)
    p.add_argument("--early_stop_patience", type=int, default=d.early_stop_patience)
    p.add_argument("--early_stop_min_delta", type=float, default=d.early_stop_min_delta)
    p.add_argument("--early_stop_min_epochs", type=int, default=d.early_stop_min_epochs)

    p.add_argument("--knn_eval", action="store_true")
    p.add_argument("--T", type=float, default=d.T)

    p.add_argument("--world_size", default=1, type=int)
    p.add_argument("--local_rank", default=-1, type=int)
    p.add_argument("--dist_on_itp", action="store_true")
    p.add_argument("--dist_url", default="env://")
    p.add_argument("--dataloader_affinity_hack", "-dlah", action="store_true")
    p.add_argument("--amp", default=d.amp, choices=AMP_CHOICES, type=str)

    # extensions of the JAX package
    p.add_argument("--mesh_data", default=d.mesh_data, type=int)
    p.add_argument("--mesh_model", default=d.mesh_model, type=int)
    p.add_argument("--cache_features", action="store_true", default=False)
    p.add_argument("--cache_augs", type=int, default=1)
    p.add_argument("--device_aug", action="store_true", default=False,
                   help="augment on the device inside the step (host "
                        "ships staged u8)")
    p.add_argument("--device_aug_stage", default=d.device_aug_stage, type=int,
                   help="staging square side for --device_aug "
                        "(0 = image_size*256/224)")
    p.add_argument("--device_aug_cache", default=d.device_aug_cache, type=str,
                   help="dir for the staged-u8 memmap cache (epoch 1 "
                        "stages, later epochs are decode-free)")
    p.add_argument("--aot_cache", default=d.aot_cache, type=str,
                   help="dir for serialized compiled executables (JAX "
                        "package; unused by the port)")
    p.add_argument("--no_pallas_pool", action="store_false", dest="pallas_pool")
    p.set_defaults(pallas_pool=True)
    p.add_argument("--attn_impl", default=d.attn_impl,
                   choices=["auto", "xla", "pallas"])
    p.add_argument("--int8_mlp", action="store_true", default=False,
                   help="opt-in int8 MLP half in the frozen backbone "
                        "(approximate: int8 products, per-token scales)")
    p.add_argument("--use_grain", action="store_true", default=False)
    p.add_argument("--scan_blocks", action="store_true", default=False)
    p.add_argument("--remat_blocks", action="store_true", default=False)
    p.add_argument("--mu_bf16", action="store_true", default=False,
                   help="bfloat16 optimizer momentum state (halves that "
                        "buffer; update math stays f32)")
    p.add_argument("--remat_policy", default=d.remat_policy, type=str,
                   choices=["none", "attn_out", "attn_fc1", "dots"],
                   help="selective remat under --remat_blocks (what the "
                        "backward keeps instead of recomputing)")
    p.add_argument("--debug_nans", action="store_true", default=False)
    p.add_argument("--profile_dir", default="", type=str)
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: v for k, v in vars(args).items() if k in known}
    return TrainConfig(**kw)


def parse_config(argv=None) -> TrainConfig:
    parser = argparse.ArgumentParser(parents=[get_args_parser()])
    return config_from_args(parser.parse_args(argv))
