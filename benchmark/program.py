"""The system under test: the port's training step, built as its driver
builds it (``ep_tpu_torch/cli/linprobe.py``), with the benchmark's weights.

Everything the benchmark takes from the program goes through this module:
the model, the optimizer, ``make_train_step``'s ``train_step``, the names of
the model's parameters, and the instances whose calls the traced run wraps
in ranges. The port is imported inside the functions, so that the rest of
the harness, its tests included, runs where the port is absent.
"""
from __future__ import annotations

import contextlib

import torch

from .manifest import reference


def port_state(W: dict, cfg: dict, depth: int) -> tuple[dict, dict]:
    """(the port's parameter name -> tensor, the port's name -> reference
    leaf id), by the configuration's ``port_names`` ({i}: the block)."""
    names, stacked = cfg["port_names"], reference(cfg).BLOCK_KEYS
    params, leaf = {}, {}
    for k, t in W.items():
        if k in stacked:
            for i in range(depth):
                name = names[k].format(i=i)
                params[name], leaf[name] = t[i], f"blocks.{i}.{k}"
        else:
            params[names[k]], leaf[names[k]] = t, k
    return params, leaf


def train_config(cfg: dict, traffic: dict):
    """The port's ``TrainConfig`` for a configuration and a traffic mix."""
    from ep_tpu_torch.configs import TrainConfig
    o = cfg["optimizer"]
    s = o["schedule"]
    ft = traffic["step"] == "finetune"
    return TrainConfig(
        model=cfg["model"], image_size=traffic["image_size"],
        cls_features="ep", ep_queries=cfg["ep_queries"], d_out=cfg["ep_d_out"],
        nb_classes=cfg["num_classes"], amp=cfg["dtype"], optimizer="lars",
        weight_decay=o["weight_decay"], blr=s["blr"], min_lr=s["min_lr"],
        epochs=s["epochs"], warmup_epochs=s["warmup_epochs"],
        batch_size=traffic["batch"], eff_batch_size=s["eff_batch_size"],
        finetuning=ft, scan_blocks=ft and traffic.get("remat_blocks", False),
        remat_blocks=ft and traffic.get("remat_blocks", False),
        remat_policy=traffic.get("remat_policy", "none"))


class Program:
    """The port's model, optimizer and train step, built on ``device`` with
    the weights ``W`` (reference layout)."""

    def __init__(self, cfg: dict, traffic: dict, W: dict, device):
        from ep_tpu_torch.models.assembly import (ProbeModel, SkipDefaultInit,
                                                  build_backbone_config)
        from ep_tpu_torch.train.lars import LARS
        from ep_tpu_torch.train.schedule import make_lr_fn
        from ep_tpu_torch.train.state import cast_frozen, freeze
        from ep_tpu_torch.train.steps import make_train_step

        self.tcfg = tc = train_config(cfg, traffic)
        self.finetuning = tc.finetuning
        bcfg = build_backbone_config(tc)
        built = dict(hidden_size=bcfg.embed_dim, num_hidden_layers=bcfg.depth,
                     num_attention_heads=bcfg.num_heads,
                     intermediate_size=int(bcfg.embed_dim * bcfg.mlp_ratio),
                     patch_size=bcfg.patch_size)
        differ = {k: (cfg[k], v) for k, v in built.items() if cfg[k] != v}
        if differ:
            raise ValueError(f"{cfg['model']} is built with other sizes than "
                             f"the configuration's (file, built): {differ}")
        with SkipDefaultInit(), torch.device(device):
            model = ProbeModel(bcfg, tc)
        params, self.leaf = port_state(W, cfg, bcfg.depth)
        state = model.state_dict()
        if set(params) != set(dict(model.named_parameters())):
            raise RuntimeError(
                "the port's parameters are not the configuration's: "
                f"{sorted(set(params) ^ set(dict(model.named_parameters())))[:8]}")
        for name, buf in model.named_buffers():  # BN: fresh running statistics
            if name.endswith("running_var"):
                params[name] = torch.ones_like(buf)
            elif name in state:
                params[name] = torch.zeros_like(buf)
        model.load_state_dict(params, strict=True)
        trainable = freeze(model, tc.finetuning)
        if not tc.finetuning and tc.amp == "bfloat16":
            cast_frozen(model, torch.bfloat16)
        o = cfg["optimizer"]
        self.optimizer = LARS(trainable, weight_decay=o["weight_decay"],
                              momentum=o["momentum"],
                              trust_coefficient=o["trust_coefficient"])
        lr_fn = make_lr_fn(tc, o["schedule"]["steps_per_epoch"])
        self.step = make_train_step(model, self.optimizer, lr_fn)
        self.model = model
        self.trained = {n: p for n, p in model.named_parameters()
                        if p.requires_grad}
        if not tc.finetuning and set(self.leaf[n] for n in self.trained) != set(
                reference(cfg).HEAD_KEYS):
            raise RuntimeError("probing trains other parameters than the head's")

    def leaf_norms(self, tensors: dict) -> dict:
        """reference leaf id -> norm of each trained parameter's tensor in
        ``tensors`` (the port's name -> tensor), read in one transfer."""
        names = list(tensors)
        norms = torch.stack([torch.linalg.vector_norm(tensors[n].float())
                             for n in names]).tolist()
        return {self.leaf[n]: v for n, v in zip(names, norms)}

    def install_ranges(self) -> None:
        """Wrap the calls into each layer in profiler ranges: every block's
        attention and MLP halves, the head, and the model's forward. The
        wrappers sit on the instances; the program's files are unchanged."""
        m = self.model
        for blk in m.backbone.blocks:
            blk.attn_half = ranged("bench::attn_half", blk.attn_half)
            blk.mlp_half = ranged("bench::mlp_half", blk.mlp_half)
        m.head.forward = ranged("bench::head", m.head.forward)
        m.forward = ranged("bench::forward", m.forward)

    @contextlib.contextmanager
    def fault(self, name: str | None):
        """The timed path broken underneath (the correctness check's
        faults): ``"unchanged"`` returns the state unchanged from every step;
        ``"half-batch"`` leaves half the batch out of the loss, the mean
        taken over the rest."""
        if name is None:
            yield
            return
        if name == "unchanged":
            saved = self.optimizer.step
            self.optimizer.step = lambda lr: None
            try:
                yield
            finally:
                self.optimizer.step = saved
            return
        if name == "half-batch":
            from ep_tpu_torch.train import steps
            saved = steps.cross_entropy
            steps.cross_entropy = lambda logits, labels: saved(
                logits, labels)[: len(labels) // 2]
            try:
                yield
            finally:
                steps.cross_entropy = saved
            return
        raise ValueError(f"unknown fault {name!r}")


def ranged(name: str, fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped
