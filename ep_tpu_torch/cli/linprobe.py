"""Linear/attentive-probe driver — the main_linprobe.py equivalent.

Counterpart of ``ep_tpu/cli/linprobe.py`` for one process (reference
main_linprobe.py:184-777), step by step: transforms and datasets (staged u8
under ``--device_aug``, with the crop on the card), the loaders, the
backbone with ``--finetune`` loading, the freeze rule, the optimizer,
resume, the LR schedule, the ``--cache_features`` branch (the frozen encoder
once per split, then head-only epochs), the epoch loop with evaluation,
head-only checkpoints and the early stop, and the four logging sinks.
``--knn_eval`` and ``--eval`` short-circuit as in the reference.

It runs on the card unless ``--device cpu`` is given: ``cpu`` is the CPU,
any other value (the flag's default is the JAX package's ``tpu``) the CUDA
device, and without one the driver raises rather than run on the CPU.

Several processes, one card each (``parallel/mesh.py``): a launcher's
variables (torchrun's RANK, SLURM, Open MPI, or ``EP_TPU_MULTIHOST=1``)
make ``init_distributed`` join the group, and ``--mesh_data`` x
``--mesh_model`` ranks form the mesh, registered for the kernel gate and the
reductions. As in the JAX driver: seeds offset by the process index for the
host's numpy (the model's weights come from ``--seed`` alone and rank 0's
are broadcast), a loader per data index, the effective batch times the data
axis, the sinks and checkpoints on rank 0 only (a barrier after each save),
and the early stop on global metrics. ``--oracle_ckpt`` is read after
``--finetune``, as in the JAX driver.
``--aot_cache`` (the JAX package's store of compiled programs) changes no
result and is ignored; ``--debug_nans`` runs under
``torch.autograd.detect_anomaly``.
"""
from __future__ import annotations

import contextlib
import datetime
import time
from pathlib import Path

import numpy as np
import torch

from ep_tpu_torch.configs import TrainConfig, config_from_args, get_args_parser
from ep_tpu_torch.data.datasets import build_datasets
from ep_tpu_torch.data.device_aug import (DeviceAug, IdentityTransform,
                                          StagedImageCache,
                                          build_staging_transforms)
from ep_tpu_torch.data.loader import DataLoader, build_loaders
from ep_tpu_torch.data.transforms import build_transforms
from ep_tpu_torch.models.assembly import build_backbone_config, init_probe_model
from ep_tpu_torch.ops import default_device
from ep_tpu_torch.parallel.mesh import (DATA_AXIS, barrier, init_distributed,
                                        make_mesh, process_count,
                                        process_index, use_mesh)
from ep_tpu_torch.parallel.partition import replicate
from ep_tpu_torch.runtime.checkpoint import (find_auto_resume, load_model,
                                             save_model)
from ep_tpu_torch.runtime.profiler import trace
from ep_tpu_torch.train.engine import (evaluate, extract_features,
                                       knn_classifier_multi, train_one_epoch)
from ep_tpu_torch.train.feature_cache import (CachedFeatureLoader,
                                              extract_split, make_head_steps)
from ep_tpu_torch.train.lars import build_optimizer
from ep_tpu_torch.train.schedule import make_lr_fn, resolve_lr
from ep_tpu_torch.train.state import cast_frozen, freeze
from ep_tpu_torch.train.steps import (make_eval_step, make_extract_step,
                                      make_train_step)
from ep_tpu_torch.utils.logging import (TrainingLogFile, is_main_process,
                                        make_tb_writer, maybe_setup_wandb,
                                        setup_for_distributed)


def run_device(cfg: TrainConfig) -> torch.device:
    """``--device cpu`` is the CPU; anything else the card (raises without
    one)."""
    return torch.device("cpu") if cfg.device == "cpu" else default_device(None)


def main(cfg: TrainConfig) -> dict:
    init_distributed(cfg)
    device = run_device(cfg)
    # the mesh gates kernel dispatch (attn_impl=auto) and the reductions; it
    # is registered for this run only
    mesh = make_mesh(cfg.mesh_data, cfg.mesh_model)
    with contextlib.ExitStack() as stack:
        stack.enter_context(use_mesh(mesh))
        if cfg.debug_nans:
            # pinpoints the op that produced a NaN, instead of the loss-level
            # abort
            stack.enter_context(torch.autograd.detect_anomaly())
        return _main(cfg, device, mesh)


def _main(cfg: TrainConfig, device: torch.device, mesh) -> dict:
    setup_for_distributed(is_main_process())

    log_file = TrainingLogFile(cfg.output_dir)
    log_file.write_header(cfg)

    print(f"config: {cfg}")
    if cfg.aot_cache:
        print("| --aot_cache names the JAX package's store of compiled "
              "programs; PyTorch runs eagerly, so it is ignored")

    np.random.seed(cfg.seed + process_index())

    data_axis = mesh.shape[DATA_AXIS]
    if cfg.batch_size % data_axis != 0:
        raise ValueError(
            f"--batch_size {cfg.batch_size} must be divisible by the data "
            f"mesh axis ({data_axis} processes); pick a multiple of {data_axis}")

    # --- data ----------------------------------------------------------------
    device_aug = None
    if cfg.device_aug:
        if cfg.train_aug == "aimv2":
            raise ValueError("--device_aug implements the default RRC+flip "
                             "recipe only; --train_aug aimv2 (jitter + "
                             "AutoAugment) needs the host pipeline")
        if cfg.cache_features:
            # cached mode encodes each image once (or K times): the host
            # aug cost is already amortized away, so device aug buys
            # nothing there; keep the host transforms
            print("| --device_aug is a no-op with --cache_features; "
                  "using host transforms")
            cfg = cfg.replace(device_aug=False)
    if cfg.device_aug:
        device_aug = DeviceAug.from_cfg(cfg)
        transform_train, transform_val = build_staging_transforms(cfg)
        print(f"| device-side augmentation: stage {device_aug.stage_size} -> "
              f"crop {device_aug.out_size} on the {device.type} device "
              "(u8 host transfer)")
    else:
        transform_train, transform_val = build_transforms(cfg)
    dataset_train, dataset_val = build_datasets(cfg)
    if cfg.device_aug and cfg.device_aug_cache:
        # stage-once memmap cache: epochs after the first never re-decode
        # (data/device_aug.py::StagedImageCache)
        dataset_train = StagedImageCache(
            dataset_train, transform_train, cfg.device_aug_cache, "train")
        dataset_val = StagedImageCache(
            dataset_val, transform_val, cfg.device_aug_cache, "val")
        transform_train = transform_val = IdentityTransform()
    print(dataset_train)
    print(dataset_val)
    # a loader per data index: ranks that share one on a model axis above 1
    # read the same rows, as the JAX driver replicates over that axis
    loader_train, loader_val = build_loaders(
        cfg, dataset_train, dataset_val, transform_train, transform_val,
        num_processes=data_axis, process_index=mesh.data_index,
    )

    # the global batch: the JAX driver's factor is its process count, each
    # process loading its own rows; here the ranks that load their own rows
    # are the data axis' (all of them on a data-only mesh)
    eff_batch_size = cfg.batch_size * cfg.accum_iter * data_axis
    cfg = cfg.replace(eff_batch_size=eff_batch_size)

    if is_main_process() and cfg.output_dir and not cfg.eval and not cfg.knn_eval:
        maybe_setup_wandb(cfg.output_dir, cfg, job_type="linprobe_v1",
                          run_name_suffix=cfg.suffix)
    log_writer = (make_tb_writer(cfg.output_dir)
                  if not cfg.eval and not cfg.knn_eval else None)

    # --- model ---------------------------------------------------------------
    backbone_cfg = build_backbone_config(cfg)
    # the weights are drawn from an explicit CPU generator seeded by --seed
    model = init_probe_model(cfg, cfg.seed, backbone_cfg, device=device)
    if cfg.finetune:
        from ep_tpu_torch.convert.torch_vit import load_pretrained_backbone
        load_pretrained_backbone(cfg, backbone_cfg, model)
    if cfg.oracle_ckpt:
        from ep_tpu_torch.convert.torch_vit import load_oracle
        load_oracle(cfg, backbone_cfg, model)
    if process_count() > 1:
        replicate(model)  # every rank starts from rank 0's weights

    trainable = freeze(model, cfg.finetuning)
    optimizer = build_optimizer(
        cfg.optimizer, trainable, cfg.weight_decay,
        mu_dtype=torch.bfloat16 if cfg.mu_bf16 else torch.float32,
        accum_iter=cfg.accum_iter)
    if cfg.int8_mlp:
        from ep_tpu_torch.models.vit import int8_mlp_inactive_reason
        reason = int8_mlp_inactive_reason(backbone_cfg)
        if reason is not None:
            print(f"| WARNING: --int8_mlp is a NO-OP for this run — {reason}"
                  "; the MLP stays bf16")
    if not cfg.finetuning and cfg.amp == "bfloat16":
        # probing never updates the backbone: keep it in the compute dtype
        cast_frozen(model, torch.bfloat16)

    n_parameters = sum(p.numel() for p in trainable)
    print("number of params (M): %.2f" % (n_parameters / 1.0e6))
    print("base lr: %.2e" % cfg.blr)
    print("actual lr: %.2e" % resolve_lr(cfg))
    print("effective batch size: %d" % eff_batch_size)
    log_file.write_setup(eff_batch_size, n_parameters)

    # --- resume --------------------------------------------------------------
    if cfg.auto_resume and not cfg.resume and cfg.output_dir:
        found = find_auto_resume(cfg.output_dir)
        if found:
            cfg = cfg.replace(resume=found)
            print(f"[auto-resume] Will load {found}")
        else:
            print("[auto-resume] No checkpoint found - starting fresh")
    start_epoch, step, _ = load_model(cfg, model, optimizer)

    lr_fn = make_lr_fn(cfg, steps_per_epoch=max(len(loader_train), 1))
    train_step = make_train_step(model, optimizer, lr_fn, device_aug)
    eval_step = make_eval_step(model, device_aug)

    # --- feature-cache fast path ----------------------------------------------
    if cfg.cache_features and not cfg.finetuning and not cfg.eval \
            and not cfg.knn_eval:
        backbone_apply = model.features

        K = max(1, cfg.cache_augs)
        print(f"[cache] extracting frozen features (train x{K} aug "
              f"draw{'s' if K > 1 else ''} + val)")
        # per-rank sharding like build_loaders: every data index extracts
        # its own slice of the dataset; extract_split gathers each batch
        ex_train = DataLoader(dataset_train, cfg.batch_size, transform_train,
                              shuffle=False, drop_last=False,
                              num_workers=cfg.num_workers,
                              num_processes=data_axis,
                              process_index=mesh.data_index)
        # K epoch-seeded augmentation draws per image (--cache_augs): the
        # loader iterates in dataset order (shuffle=False), so labels align
        # across variants and only the crop rng changes with the epoch
        variants = []
        for k in range(K):
            ex_train.set_epoch(k)
            f_k, labels_tr = extract_split(
                backbone_apply, ex_train, device, cfg.output_dir,
                "train" if K == 1 else f"train_aug{k}", cfg=cfg)
            variants.append(f_k)
        feats_tr = variants if K > 1 else variants[0]
        feats_va, labels_va = extract_split(
            backbone_apply, loader_val, device, cfg.output_dir, "val", cfg=cfg)
        print(f"[cache] train {variants[0].shape}"
              f"{f' x{K} augs' if K > 1 else ''} val {feats_va.shape}")
        loader_train = CachedFeatureLoader(feats_tr, labels_tr, cfg.batch_size,
                                           shuffle=True, drop_last=True,
                                           seed=cfg.seed)
        loader_val = CachedFeatureLoader(feats_va, labels_va, cfg.batch_size,
                                         shuffle=False, drop_last=False)
        lr_fn = make_lr_fn(cfg, steps_per_epoch=max(len(loader_train), 1))
        train_step, eval_step = make_head_steps(model.head, optimizer, lr_fn)

    # --- kNN / eval-only modes -------------------------------------------------
    if cfg.knn_eval:
        extract_step = make_extract_step(model, device_aug)
        train_feats, train_labels = extract_features(
            extract_step, loader_train, device, cfg)
        test_feats, test_labels = extract_features(
            extract_step, loader_val, device, cfg)
        print(f"Train features shape: {train_feats.shape}")
        print(f"Test features shape: {test_feats.shape}")
        train_feats /= np.linalg.norm(train_feats, axis=1, keepdims=True) + 1e-12
        test_feats /= np.linalg.norm(test_feats, axis=1, keepdims=True) + 1e-12
        ks = [k for k in [5, 10, 15, 20, 50, 100, 200]
              if k <= len(train_labels)]
        # one device pass computes the top-max(k) neighbour list; the vote
        # for each k runs on the host
        results = knn_classifier_multi(
            train_feats, train_labels, test_feats, test_labels, ks,
            T=cfg.T, num_classes=cfg.nb_classes, device=device)
        for k in ks:
            top1, top5 = results[k]
            print(f"{k}-NN classifier result: Top1: {top1}, Top5: {top5}")
        return {"knn": results}

    if cfg.eval:
        test_stats = evaluate(eval_step, loader_val, device, cfg)
        print(f"Accuracy of the network on the {len(dataset_val)} "
              f"test images: {test_stats['acc1']:.1f}%")
        return test_stats

    # --- training loop ---------------------------------------------------------
    print(f"Start training for {cfg.epochs} epochs")
    start_time = time.time()
    max_accuracy = 0.0
    es_best, es_stale = -1.0, 0
    test_stats = {"acc1": 0.0, "acc5": 0.0, "loss": float("inf")}

    for epoch in range(start_epoch, cfg.epochs):
        loader_train.set_epoch(epoch)
        with trace(cfg.profile_dir if epoch == start_epoch else ""):
            step, train_stats = train_one_epoch(
                train_step, step, loader_train, device, epoch, cfg, log_writer)
        test_stats = evaluate(eval_step, loader_val, device, cfg)

        log_stats = {**{f"train_{k}": v for k, v in train_stats.items()},
                     **{f"test_{k}": v for k, v in test_stats.items()},
                     "epoch": epoch, "n_parameters": n_parameters}
        if cfg.output_dir:
            save_model(cfg, epoch, model, optimizer, step, log_stats)
            barrier()  # no rank runs ahead of a file it may resume from

        print(f"Accuracy of the network on the {len(dataset_val)} "
              f"test images: {test_stats['acc1']:.1f}%")
        max_accuracy = max(max_accuracy, test_stats["acc1"])
        print(f"Max accuracy: {max_accuracy:.2f}%")

        log_file.write_epoch(epoch, train_stats, test_stats)
        if log_writer is not None:
            pf = f"test_v1_{cfg.cls_features}"
            log_writer.add_scalar(f"{pf}/train_acc1", train_stats["acc1"], epoch)
            log_writer.add_scalar(f"{pf}/train_loss", train_stats["loss"], epoch)
            log_writer.add_scalar(f"{pf}/test_acc1", test_stats["acc1"], epoch)
            log_writer.add_scalar(f"{pf}/test_acc5", test_stats["acc5"], epoch)
            log_writer.add_scalar(f"{pf}/test_loss", test_stats["loss"], epoch)

        # early stop on a validation plateau; the metrics are global, so
        # every rank decides identically (main_linprobe.py:731-747)
        if cfg.early_stop:
            if test_stats["acc1"] > es_best + cfg.early_stop_min_delta:
                es_best, es_stale = test_stats["acc1"], 0
            else:
                es_stale += 1
            if (epoch + 1) >= cfg.early_stop_min_epochs and \
                    es_stale >= cfg.early_stop_patience:
                msg = (f"[early-stop] no gain > {cfg.early_stop_min_delta} pts "
                       f"for {es_stale} epochs (best {es_best:.2f}%); "
                       f"stopping at epoch {epoch} of {cfg.epochs}")
                print(msg)
                log_file.write_line(msg)
                break

    total_time = time.time() - start_time
    total_time_str = str(datetime.timedelta(seconds=int(total_time)))
    print(f"Training time {total_time_str}")
    log_file.write_final(max_accuracy, test_stats, total_time_str)
    return {"max_accuracy": max_accuracy, **test_stats}


def cli():
    import argparse
    parser = argparse.ArgumentParser(parents=[get_args_parser()])
    args = parser.parse_args()
    cfg = config_from_args(args)
    if cfg.output_dir:
        Path(cfg.output_dir).mkdir(parents=True, exist_ok=True)
    main(cfg)


if __name__ == "__main__":
    cli()
