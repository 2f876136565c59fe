#!/usr/bin/env python3
"""Smoke run of ep_tpu_torch on one CUDA card (an H100: the kernels are sm_90a).

    python3 chip_smoke.py [--batch 512] [--steps 5]

Phases, each of which must pass (any failure exits non-zero):

1. device  — require CUDA; print the card's name and power limit (nvidia-smi).
2. build   — compile ep_tpu_torch/csrc/*.cu with nvcc, one process per source
             (or reuse the library already built from the same sources);
             print the seconds and ptxas' register and spill lines. Then
             kernels: each kernel against its plain version at the paths'
             full shapes, and its time beside its bound, its plain version
             and the library (scripts/torch_hopper_gemm_check.py's checks).
3. train   — the probe-training main path as bench.py builds it: frozen
             ViT-B/16 (random weights from seed 0) + EP-32 head, BN, fc, LARS
             with the warmup-cosine LR; a few steps at --batch. Checks a finite
             loss, trainable parameters changed, frozen ones untouched, and the
             launch counters: kernels A, B, C 12x per forward, D once.
4. model   — logits of 4 images from the card's kernel path against the
             port's plain path on the CPU with the same weights.
   int8-b  — phase 3 with int8_mlp=True (bench.py with EP_TPU_BENCH_INT8=1):
             the same checks, the int8 kernels 12x per forward and no call of
             the bf16 MLP half; then phase 4's logits check on the int8 model.
   probe-h, int8-h — the same pair for a frozen ViT-H/14 (D=1280, depth 32,
             T=257) at batch 128: the bf16 step, then the int8 step (the int8
             kernels 32x per forward, 8 stripes).
   probe-h448 — frozen ViT-H/14 at 448 px (patch 14, a 32 x 32 grid, T=1025;
             full depth 32) + EP-32 at batch 64: A, F and C 32x per forward, B
             never, D once. probe-h448-fused — the same with EP_TPU_EP_FUSED=1:
             G once and D never; step 0's loss beside probe-h448's.
             probe-h-rowtile — probe-h with EP_TPU_ATTN_VARIANT=rowtile: F 32x
             and B never; step 0's loss beside probe-h's. logits-448 — 2 images
             at 448 px through a ViT-H/14-width model of depth 4 built at 224
             px (the position embedding is interpolated), fused EP route: the
             card's kernels against the plain path on the CPU.
   device-aug — phase 3 on u8 staged input (512, 256, 256, 3) with the
             --device_aug crop, flip and normalize inside the step
             (bench.py::_bench_device_aug): its img/s beside train's; then the
             crop alone at batch 512 (ms beside its bound) and the card's crop
             against the CPU's on the same step's draws.
   cached  — the --cache_features head-only step (bench.py::
             _bench_cached_mode) on device-resident ViT-B/16 tokens (512, 196,
             768) bf16: chains of 32 steps, the median of 3 gives
             cached_mode_img_s, and effective_90ep_img_s = 90 / (1/train +
             90/cached); kernel D once a step, and again with
             EP_TPU_EP_FUSED=1 (cached-fused: kernel G, D never); each
             route's head forward and gradients on 64 of the tokens against
             the CPU plain path.
   zoo     — every --cls_features pooling head (the 14 of the zoo, plain
             torch as in the JAX package) and ep_all and aim_all ([CLS] +
             patch tokens) on the frozen ViT-B/16 of phase 3 at batch 512: a
             warm-up step and --steps steps at the peak LR; a finite loss,
             every head parameter moved (but for gradients that are rounding
             noise), the pools' BatchNorm statistics moved (aim, cbam, dolg),
             the frozen encoder untouched, and the launch counters (A, B and C
             12x a forward, D once for ep and ep_all, never for another head).
             Then each head's --cache_features step on device-resident tokens
             (512, 196 or 197, 768) bf16 (chains as in cached, D for ep and
             ep_all only) with its device busy time, and the head on 8 images'
             tokens, card against CPU: bf16 logits and return_attn maps within
             5e-2 of their largest magnitude, gradients with the descriptor BN
             in eval mode and in train mode (the trained function) to cosine
             0.9999 (zoo_head_check says which). zoo-driver:
             main_linprobe_torch.py --cls_features dolg (ViT-B/16, batch 128,
             the fake dataset) for one epoch, its checkpoint with the pool's
             BatchNorm, then --eval from it printing epoch 0's val numbers.
   The backbone family (ROADMAP module item 7), at published widths and
   depths, bf16, random weights from seed 0, EP-32 but where named:
   probe-dinov2-l — frozen DINOv2-L/14 with 4 registers (D=1024, depth 24,
             LayerScale, final LN, T=261), batch 512: B 24 times a forward on
             the plain Attention route (LN1 and qkv in torch), A and C never,
             D once at (512, 256, 1024, 32); then its logits of 4 images
             against the CPU plain path. probe-dinov2-g — the SwiGLU giant
             with 4 registers at the hub's widths (D=1536, depth 40, 24
             heads, SwiGLU hidden 4096, T=261), batch 64: B and the gate
             kernel 40 times, D once. probe-dinov3-7b — DINOv3 ViT-7B/16 at
             its published widths (D=4096, 32 heads of 128, SwiGLU 8192,
             RoPE, 4 storage tokens) at 448 px (T=789), its first 2 blocks
             (--return_block 1), batch 8: the RoPE pass, F and the gate
             kernel twice, D once.
             probe-capi — CAPI-L/14 (16 registers, no [CLS], T=272: B's last
             key bin): A, B and C 24 times; then a cls-mode model (the
             register mean) against the CPU's. probe-clip-b — OpenCLIP
             ViT-B-16, openai (QuickGELU, ln_pre, ln_post), --cls_features
             cls: A, B and C 12 times, D never, a head 512 (proj_dim) wide.
             probe-simmim — SimMIM ViT-B (shared rel-pos bias, q/v bias,
             LayerScale): no attention kernel (the bias goes through the
             plain mha, as in the JAX package), D once. probe-mae-l — the MAE
             ViT-L/16 encoder's latent: A, B and C 24 times, D once.
   features-b — frozen ViT-B/16 with cp1-cp4, ca1-ca4, attn-mn, attn-lcte,
             raw, dino (the ViT-B/16 oracle) and --return_block 6: each mode's
             features of 4 images card against CPU plain path, with its
             launches (A, B, C 11 times and a plain last block for ca*/attn-*,
             23 for dino, 7 for --return_block 6), and its forward at batch
             512 timed.
5. finetune-b — full fine-tuning as bench.py's ft_b row builds it: ViT-B/16 +
             EP-32, batch 512, --finetuning --remat_blocks --remat_policy
             attn_out, LARS and the warmup-cosine LR (at its peak, the end of
             warmup), random weights from seed 0. Checks a finite loss, that
             every parameter (backbone included) changed, and the launch
             counters per step: A and B 2x depth (the forward, then again in
             each supercell backward), C, E, ln1_apply and ln1_bwd 1x depth,
             D once. Prints the
             median step time, img/s and a profiled step's device time.
6. finetune-h — the ft_h row: ViT-H/14 (D=1280, 16 heads of width 80, T=257)
             + EP-32, batch 128, bf16 LARS momentum, the same flags and checks.
   finetune-dinov2-l — DINOv2-L/14 with registers, batch 128, the same
             flags: B and E 24 times a step (the plain route's attention is
             outside the recomputed MLP half), A and C never; the LayerScale
             gammas and registers move with every other parameter.
   finetune-h448 — ViT-H/14 at 448 px (T=1025), batch 32: A and F 64 times
             a step (forward, and again in each supercell backward), C 32,
             the tiled plain backward past kernel E's limit 32, E never.
7. finetune-grads — every parameter's gradient for 4 images at ViT-B, the
             card's kernel path against the port's plain path on the CPU;
             then at DINOv2-L's width, depth 2 (LayerScale at 0.5, the
             head's BN in eval mode).
8. driver  — main_linprobe_torch.py's main, as a user runs it, in a temporary
             directory: ViT-B/16 at 224 px, EP-32, batch 128, bf16, the fake
             dataset (512 train and 128 val images made in memory), random
             weights from seed 0. Two epochs (the second profiled: the
             device's idle share), then --auto_resume to a third (from the
             saved global step), --eval from its checkpoint (epoch 2's val
             numbers exactly), one epoch at --ep_queries 128, --knn_eval on
             pooled patch tokens, and --eval with --finetune of a timm-layout
             .pth written from another seed's backbone (the logits of the
             model it was written from). Checks finite losses, a head-only
             checkpoint and each run's launch counters (A, B and C 12x a
             forward, D once, or twice at 128 queries); then --cache_features
             over 2 epochs and --cache_augs 2 over 3 (the extraction's img/s
             per split, the '[cache] train (512, 196, 768)' line, head-only
             epochs: D once a step, A, B and C only in the extraction), and
             --device_aug --device_aug_cache over 2 epochs (the staged memmap
             files); prints each epoch's wall img/s beside phase 3's step at
             batch 128, and the idle share of a profiled epoch of each mode.
   driver-dinov2 — main_linprobe_torch.py --model dinov2_vitb14_reg for one
             epoch (B 12 times a forward, D once); --eval --finetune of a
             DINOv2-hub-layout .pth (register_tokens, blocks.i.ls1.gamma, a
             mask_token) written from seed 1's backbone, whose logits the
             driver's model must give; --cls_features dino --oracle_ckpt of a
             timm-layout ViT-B/16 .pth on ViT-B/16 for one epoch (A, B and C
             23 times a forward), the oracle holding the file's weights.
   Several processes (ROADMAP module item 9) and --use_grain (item 11),
   after the driver phases:
   ddp-nccl-1 — the driver phase's first run again (two epochs, the second
             profiled) through init_distributed at world size 1
             (EP_TPU_MULTIHOST=1, WORLD_SIZE=1): an NCCL group, the
             registered (1, 1) mesh; its training_log.txt lines equal the
             one-process run's, A, B, C 12 times a forward and D once, the
             group answers an all_reduce on the card; each epoch's img/s and
             the idle share beside the driver phase's.
   ddp-gloo-2 — two ranks on the one card through gloo, started as
             subprocesses of this script (--ddp-gloo-rank R --ddp-dir D),
             each initialising its group before the port's init_distributed
             sees it: 4 train steps of phase 3's model on 256 of its 512
             images each (weights broadcast from rank 0). Step 0's loss
             equal on both ranks and within LOSS_TOL of phase 3's and of one
             process's on all 512; the heads bit-equal across ranks; BN's
             running statistics within a bf16 step of one process's; A, B, C
             12 times and D once a step on each rank; then the cached
             extraction on the fake val split (64 images a rank, batches of
             32 gathered through the host): the same (128, 196, 768) cache
             on both ranks, each rank's rows in place. Its step ms is that of
             two ranks sharing one card, no speed number.
   tp-gloo-2 — the frozen backbone cut over a model axis of 2 (ROADMAP
             module item 9b: shard_state at mesh (data 1, model 2)), two
             ranks on the one card through gloo (--tp-gloo-rank R), each
             run against one process on the same weights and batch. (a)
             DINOv2-g/14 (SwiGLU, LayerScale, 24 heads of width 64, depth
             40) at batch 16, 3 steps, attn_impl auto: each rank's backbone
             bytes (at most 0.51 of one process's) and the card's allocated
             bytes after the cut; in the forward of the features, each of
             the 40 blocks' attention and MLP branches (before LayerScale,
             whose 1e-5 rounds them away from the features in bf16) within
             ATOL + RTOL*|ref| of the same module with its pieces joined;
             step 0's loss within LOSS_TOL and the features within
             FEATURE_TOL of one process's, the heads bit-equal across ranks,
             B never and D once a step. (b)
             ViT-B/16 at batch 128, 2 steps, attn_impl pallas: every block
             joins its pieces and runs A, B and C 12 times a forward, D
             once; step 0's loss within LOSS_TOL. Step times of two ranks
             sharing one card, no speed number.
   use-grain — whether the grain package imports; where it does, one
             --use_grain driver epoch with its launches.
   Attention statistics and the tools (ROADMAP module item 8), after the
   driver phases, on frozen ViT-B/16 (bf16, random weights from seed 0):
   attn-stats-b — main_attention_stats_torch.py's main with --finetune of a
             seed-0 timm-layout .pth, the fake dataset's 128 val images at
             batch 64: no kernel launch (every block on the plain route with
             its probabilities, as in the JAX package), attention_stats.json
             written, the probability stats in [0, 1], and the (10, 12) table
             against the CPU's run of the same main (each stat within 2e-2 of
             its largest value); then the capture forward at batch 512 timed.
   extract-features — python -m ep_tpu_torch.tools.extract_features on the
             driver phase's EP checkpoint (--head_ckpt, val: A, B and C 12
             times, D once) and with --cls_features cls (train, 4 batches
             of 128: A, B and C 48 times, D never): features and logits of 4
             images against the CPU plain path, and the loop's img/s.
   pool-attention — python -m ep_tpu_torch.tools.extract_pool_attention on
             the same checkpoint, 8 images: the (8, 32, 196) map, its rows
             summing to 1 within 1e-3, against the CPU's (5e-2 of its
             largest value); the logits from kernel D.
   mae-decoder — MAE ViT-B/16 with its decoder (8 blocks of 16 heads of
             width 32, plain attention), batch 128, mask ratio 0.75: the
             loss against the CPU's on the same noise (2e-3 relative); A, B
             and C 12 times (the encoder), no attention kernel in the
             decoder; ms a forward.
   search  — search_linprobe_torch.py's main with EP_SEARCH_BLRS of two
             values, one epoch each on ViT-B/16 and the fake dataset: "Max
             Accuracy" in both trials' training_log.txt; the launches.

Every launch check also counts fc1_gelu_epilogue (ops/fc1_gelu.py: fc1
with its GELU in cuBLASLt's epilogue, a route and not a kernel) once for
each bf16 GELU MLP run without a gradient: frozen encoders, extraction and
evaluation forwards, captured blocks, MAE's decoder; never in fine-tuning,
the int8 half, QuickGELU, SwiGLU or a block cut over a model axis. Each
also counts ls_residual (ops/layerscale.py: LayerScale and the residual as
one pass) twice for each bf16 LayerScale block run without a gradient
(DINOv2, DINOv3, SimMIM; cut blocks included); never in fine-tuning.

The zoo's per-head table (train step ms and img/s, head-only step ms, img/s
and device busy ms) follows its phase. Before the last line come the whole
run's wall seconds, the card's name and power limit and a JSON line of every
phase's results (``kernels``: each kernel check with the launches of that
kernel on each path; a checked kernel no path launched fails the run); the
last line is {"ok": true, "device": {...}}. It imports nothing of JAX and
nothing of the JAX package. The kernels at the edges of their tiles are
tests/test_torch_cuda.py's (python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from benchmark.peaks import H100_SXM, bound_s

# Pass when |kernel - plain| <= ATOL + RTOL*|plain| elementwise: about two
# bf16 rounding steps at unit magnitude. Both sides round to bf16 at the same
# points; what differs is the f32 summation order, which can move a value
# across one bf16 rounding boundary.
ATOL, RTOL = 1e-2, 1e-2
# Whole model, 12 blocks of bf16 rounding differences on random weights.
MODEL_ATOL, MODEL_RTOL = 5e-2, 5e-2
# A backbone's features (features-b), against the largest magnitude of the
# plain path's: ViT-B/16's tokens reach about 16 with no final norm, where
# one bf16 step is 0.125, so MODEL_ATOL would hold single tokens (cp1) to
# under a step; 2**-5 of the largest is the CPU tests' bf16 bound.
FEATURE_TOL = 2.0 ** -5
# A whole model's gradients of 4 images, each against its tensor's largest
# magnitude, differ at single elements by more than a kernel's: the head's BN
# normalises each feature over the 4 images, so where a channel's 4 values
# nearly coincide it divides a bf16-sized difference by a small deviation, and
# the residual stream's gradient rounds to bf16 twice a block on its way back
# through 12 blocks. Measured on an H100: up to 18% of a tensor's largest
# magnitude at single elements (the head), with every cosine above 0.993.
# GRAD_TOL bounds every element and GRAD_COS the direction of every gradient.
# The scale is floored at GRAD_FLOOR of the model's largest gradient because
# a gradient that is zero in exact arithmetic (the last fc2 bias: a shift of
# every token, which the EP softmax and BN cancel) leaves only rounding noise,
# whose direction is noise; it measured 2.6e-4 of the largest, the smallest
# other gradient 3.8e-3.
GRAD_TOL, GRAD_COS, GRAD_FLOOR = 0.25, 0.99, 2e-3
# Step 0's loss of a path through another kernel route (F for B, G for D and
# F.linear) against the same model, images and weights through the usual
# route: both routes round to bf16 at the same points and sum in another
# order, which moves single features by a bf16 step; the loss is a mean over
# the batch of a log-softmax over 1000 classes near ln(1000). Measured on an
# H100: 8.4e-5 (G for D) and 5.2e-4 (F for B over 32 blocks), the same in
# every run; the bound is 4 times the larger.
LOSS_TOL = 2e-3
# One bf16 step of a value v is at most STEP*|v| (8 significant bits).
STEP = 2.0 ** -7


def log(msg: str) -> None:
    # not print: the driver phase's main replaces print with a timestamped
    # one (setup_for_distributed), and the last line must stay bare JSON
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def rand(rng, shape, scale=1.0, dtype=torch.bfloat16, device="cuda"):
    a = rng.standard_normal(shape, dtype=np.float32) * scale
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def time_ms(fn, iters: int = 10) -> float:
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name: str, out: torch.Tensor, ref: torch.Tensor,
            atol: float = ATOL, rtol: float = RTOL) -> float:
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{name}: non-finite kernel output")
    d = (out - ref).abs()
    max_abs = float(d.max())
    max_rel = max_abs / max(float(ref.abs().max()), 1e-12)
    ok = bool((d <= atol + rtol * ref.abs()).all())
    log(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"(tol |d| <= {atol:g} + {rtol:g}*|ref|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return max_abs


# bench.py:100-128: frozen backbone + EP-32. kind -> (batch (None: --batch),
# flags, steps (None: --steps), the environment knobs set for the phase, the
# attention kernel and the pool kernel its forward must go through).
_USUAL = (None, {}, "attn_core", "ep_pool")
_H448 = dict(model="vit_huge_patch14", image_size=448)  # the MAE paper's ViT-H448
PROBE_CONFIGS = {
    "train": (None, dict(model="vit_base_patch16"), *_USUAL),
    "int8-b": (None, dict(model="vit_base_patch16", int8_mlp=True), *_USUAL),
    "probe-h": (128, dict(model="vit_huge_patch14"), *_USUAL),
    "int8-h": (128, dict(model="vit_huge_patch14", int8_mlp=True), *_USUAL),
    # scripts/flash_longT_bench.py's batch
    "probe-h448": (64, _H448, 5, {}, "attn_flash", "ep_pool"),
    "probe-h448-fused": (64, _H448, 3, {"EP_TPU_EP_FUSED": "1"}, "attn_flash",
                         "ep_pool_proj"),
    "probe-h-rowtile": (128, dict(model="vit_huge_patch14"), 3,
                        {"EP_TPU_ATTN_VARIANT": "rowtile"}, "attn_flash",
                        "ep_pool"),
    # bench.py::_bench_device_aug: u8 (512, 256, 256, 3) staged input, the
    # crop, flip and normalize inside the step
    "device-aug": (None, dict(model="vit_base_patch16", device_aug=True),
                   *_USUAL),
}
INT8_KERNELS = ("mlp_int8_ln_quant", "mlp_int8_fc1", "mlp_int8_fc2")


def environment(**values):
    """Set the given variables for a ``with`` block and restore them after."""
    return mock.patch.dict(os.environ, values)


def lars_pair(updates: int) -> dict:
    """The launches of ``updates`` LARS updates on the card: the kernel pair
    of ops/lars.py once each."""
    return dict(lars_norms=updates, lars_apply=updates)


def fc1_gelu(blocks: int) -> dict:
    """The launches of ``blocks`` bf16 GELU MLPs run without a gradient on
    the card: fc1 with its GELU in cuBLASLt's epilogue (ops/fc1_gelu.py)."""
    return dict(fc1_gelu_epilogue=blocks)


def ls_closings(blocks: int) -> dict:
    """The launches of ``blocks`` bf16 LayerScale blocks run without a
    gradient on the card: LayerScale and the residual as one pass
    (ops/layerscale.py), twice a block."""
    return dict(ls_residual=2 * blocks)


def train(kind: str, B: int, steps: int, card: str):
    """The probe-training path; returns (model, images, launch counts, median
    step seconds, the steps' losses)."""
    _, flags, own_steps, env, attn_kernel, pool_kernel = PROBE_CONFIGS[kind]
    with environment(**env):
        return _train(kind, B, own_steps or steps, card, flags, attn_kernel,
                      pool_kernel)


def _train(kind, B, steps, card, flags, attn_kernel, pool_kernel,
           per_forward=None):
    """``per_forward`` (the backbone family's paths): the launches of one
    forward, every other count zero, in place of A, the attention kernel
    and C depth times and the pool once."""
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.models.assembly import build_backbone_config, init_probe_model
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.train.lars import LARS
    from ep_tpu_torch.train.schedule import make_lr_fn
    from ep_tpu_torch.train.state import cast_frozen, freeze, split_params
    from ep_tpu_torch.train.steps import make_train_step

    cfg = TrainConfig(**{**dict(
        cls_features="ep", ep_queries=32, d_out=1, nb_classes=1000,
        amp="bfloat16", pallas_pool=True, epochs=90, warmup_epochs=10, blr=0.1,
        batch_size=B, eff_batch_size=B), **flags})
    bcfg = build_backbone_config(cfg)
    t_init = time.perf_counter()
    model = init_probe_model(cfg, seed=0, backbone_cfg=bcfg)  # on the card
    t_init = time.perf_counter() - t_init
    trainable = freeze(model, cfg.finetuning)
    cast_frozen(model, torch.bfloat16)
    opt = LARS(trainable, weight_decay=0.0)
    device_aug = None
    if cfg.device_aug:
        from ep_tpu_torch.data.device_aug import DeviceAug
        device_aug = DeviceAug.from_cfg(cfg)
    step_fn = make_train_step(model, opt, make_lr_fn(cfg, 1000), device_aug)
    # calls of the bf16 MLP half (models/vit.py::Mlp), which the int8 half
    # must never reach
    bf16_mlp_calls = [0]

    def count_call(*_):
        bf16_mlp_calls[0] += 1

    for blk in model.backbone.blocks:
        blk.mlp.register_forward_hook(count_call)

    rng = np.random.default_rng(0)
    if device_aug is None:
        images = torch.from_numpy(rng.standard_normal(
            (B, bcfg.img_size, bcfg.img_size, 3), dtype=np.float32)).cuda()
    else:
        S = device_aug.stage_size
        images = torch.from_numpy(rng.integers(
            0, 256, (B, S, S, 3), dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, 1000, size=(B,))).cuda()

    train_p, frozen_p = split_params(model, cfg.finetuning)
    before_t = {k: p.detach().clone() for k, p in train_p.items()}
    before_f = {k: p.detach().clone() for k, p in frozen_p.items()}
    route = (f"launches a forward {per_forward}" if per_forward else
             f"attention through {attn_kernel}, pool through {pool_kernel}")
    name = "simmim_vit_base_patch16" if cfg.simmim else cfg.model
    log(f"[{kind}] {name} (D={bcfg.embed_dim}, depth {bcfg.depth}, "
        f"T={bcfg.num_patches + getattr(bcfg, 'num_prefix_tokens', 1)}) + "
        f"{cfg.cls_features} head, int8_mlp={getattr(bcfg, 'int8_mlp', False)}, "
        f"batch {B}, {bcfg.img_size} px"
        + (f" cropped on the card from u8 staged {tuple(images.shape)}"
           if device_aug is not None else "") + f", {steps} "
        f"steps, {route}, {sum(p.numel() for p in trainable)} trainable / "
        f"{sum(p.numel() for p in frozen_p.values())} frozen parameters, "
        f"built in {t_init:.1f} s")

    torch.cuda.synchronize()
    reset_launches()
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        m = step_fn(i, images, labels)
        loss = float(m["loss"])  # synchronises
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log(f"  step {i}: loss={loss:.5f} lr={float(m['lr']):.3e} "
            f"grad_norm={float(m['grad_norm']):.4f} {times[-1] * 1e3:.1f} ms")
    counts = dict(LAUNCHES)

    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite loss: {losses}")
    changed = [k for k, p in train_p.items() if not torch.equal(p, before_t[k])]
    if not changed:
        raise RuntimeError("no trainable parameter changed")
    moved = [k for k, p in frozen_p.items() if not torch.equal(p, before_f[k])]
    if moved:
        raise RuntimeError(f"frozen parameters changed: {moved[:5]}")
    d = len(model.backbone.blocks)  # the blocks up to --return_block
    expect = dict.fromkeys(LAUNCHES, 0)
    if per_forward:
        expect.update({k: n * steps for k, n in per_forward.items()})
    else:
        expect.update({"ln_qkv_gemm": d * steps, attn_kernel: d * steps,
                       "proj_residual_gemm": d * steps, pool_kernel: steps})
    expect.update(lars_pair(steps))
    int8 = getattr(bcfg, "int8_mlp", False)
    if int8:
        expect.update(dict.fromkeys(INT8_KERNELS, d * steps))
    elif not per_forward:
        expect.update(fc1_gelu(d * steps))
    expect_bf16 = 0 if int8 else d * steps
    log(f"  launches over {steps} steps: {counts} (expected {expect}); "
        f"calls of the bf16 MLP half: {bf16_mlp_calls[0]} (expected "
        f"{expect_bf16})")
    if counts != expect or bf16_mlp_calls[0] != expect_bf16:
        raise RuntimeError("the main path did not go through every kernel as expected")
    log(f"  trainable parameters changed: {changed}")
    med = statistics.median(times[1:]) if steps > 1 else times[0]
    log(f"  median step {med * 1e3:.2f} ms (steps 1..{steps - 1}), "
        f"{B / med:.1f} img/s at batch {B} on {card}")
    device_time(lambda: step_fn(steps, images, labels), card,
                host_rows=10 if device_aug is not None else 0)
    return model, images, counts, med, losses


def cross_check(model, images, what: str) -> None:
    model.eval()
    x = images[:4]
    with torch.no_grad():
        out = model(x)
        ref = copy.deepcopy(model).cpu()(x.cpu())
    log(f"[model] {what}: logits of {len(x)} images, card kernel path vs CPU "
        "plain path")
    compare("logits", out.cpu(), ref, MODEL_ATOL, MODEL_RTOL)


def logits_448() -> None:
    """2 images at 448 px through a ViT-H/14-width model of depth 4 built at
    224 px, so that the position embedding is interpolated, with the fused EP
    route: the card's kernels (A, F, C and G) against the plain path on the
    CPU with the same weights. The full depth would take minutes on the CPU."""
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.models.assembly import build_backbone_config, init_probe_model
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.train.state import cast_frozen, freeze

    cfg = TrainConfig(model="vit_huge_patch14", image_size=224,
                      cls_features="ep", ep_queries=32, d_out=1,
                      nb_classes=1000, amp="bfloat16")
    depth = 4
    model = init_probe_model(cfg, seed=2, backbone_cfg=build_backbone_config(
        cfg).replace(depth=depth))
    freeze(model, cfg.finetuning)
    cast_frozen(model, torch.bfloat16)
    images = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 448, 448, 3), dtype=np.float32)).cuda()
    with environment(EP_TPU_EP_FUSED="1"):
        reset_launches()
        cross_check(model, images, "ViT-H/14 width, depth 4, built at 224 px, "
                    "fed 448 px (T=1025), fused EP route")
        counts = dict(LAUNCHES)
    expect = dict.fromkeys(LAUNCHES, 0)
    expect.update(ln_qkv_gemm=depth, attn_flash=depth, proj_residual_gemm=depth,
                  ep_pool_proj=1, **fc1_gelu(depth))
    log(f"  launches of the card's forward: {counts} (expected {expect})")
    if counts != expect:
        raise RuntimeError("the 448 px forward did not go through A, F, C and G")


# bench.py:100-128 with scripts/bench_models.py's ft_* rows: batch, flags
FT_CONFIGS = {
    "finetune-b": (512, dict(model="vit_base_patch16")),
    "finetune-h": (128, dict(model="vit_huge_patch14", mu_bf16=True)),
    # the backbone family: DINOv2-L's LayerScale blocks on the plain route
    # (B, then E, 24 times a step; A and C never), and ViT-H/14 at 448 px
    # (T=1025) past kernel E's limit: F forward and again in each supercell
    # backward's recompute, the tiled plain backward, E never
    "finetune-dinov2-l": (128, dict(model="dinov2_vitl14_reg")),
    "finetune-h448": (32, dict(model="vit_huge_patch14", image_size=448)),
}
# launches a step where they are not A and B twice a block, C, E, ln1_apply
# and ln1_bwd once
FT_LAUNCHES = {
    "finetune-dinov2-l": dict(attn_core=24, attn_core_bwd=24, ep_pool=1),
    "finetune-h448": dict(ln_qkv_gemm=64, attn_flash=64, proj_residual_gemm=32,
                          attn_bwd_long=32, ln1_apply=32, ln1_bwd=32,
                          ep_pool=1),
}
FT_STEPS = 4


def finetune_config(kind: str, B: int):
    from ep_tpu_torch.configs import TrainConfig
    return TrainConfig(cls_features="ep", ep_queries=32, d_out=1,
                       nb_classes=1000, amp="bfloat16", pallas_pool=True,
                       epochs=90, warmup_epochs=10, blr=0.1, batch_size=B,
                       eff_batch_size=B, finetuning=True, scan_blocks=True,
                       remat_blocks=True, remat_policy="attn_out",
                       **FT_CONFIGS[kind][1])


def device_rows(prof) -> list[tuple[float, int, str]]:
    """(device ms, count, name) of every kernel and copy a profile saw on the
    card; not the ranges that user annotations (such as the optimizer's step)
    mirror onto the device."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3, e.count, e.key))
    return rows


def device_time(step, card: str, host_rows: int = 0) -> None:
    """One step under torch.profiler: device time by kernel over wall time;
    with ``host_rows``, also that many host operators by their own CPU
    time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    if not rows:
        log("  profiler: no device time recorded")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    groups = {"ours": 0.0, "gemm": 0.0, "other": 0.0}
    for ms, _, key in rows:
        k = key.lower()
        if "ep::" in k:  # the namespace of every kernel in ep_tpu_torch/csrc
            groups["ours"] += ms
        elif any(n in k for n in ("gemm", "nvjet", "xmma", "cutlass", "sm90")):
            groups["gemm"] += ms
        else:
            groups["other"] += ms
    log(f"  profiled step: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / (wall * 1e3):.1f}%) on {card}; hand-written kernels "
        f"{groups['ours']:.1f} ms, cuBLAS GEMMs {groups['gemm']:.1f} ms, "
        f"other (elementwise, reductions, copies) {groups['other']:.1f} ms")
    # the 12 longest, then every other hand-written kernel
    for i, (ms, n, key) in enumerate(rows):
        if i < 12 or "ep::" in key.lower():
            log(f"    {ms:9.3f} ms  x{n:<4d} {key[:110]}")
    if host_rows:
        from torch.autograd import DeviceType
        cpu = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CPU), reverse=True)
        log(f"  host: {sum(r[0] for r in cpu):.1f} ms of operators' own CPU "
            f"time in {sum(r[1] for r in cpu)} calls; the longest:")
        for ms, n, key in cpu[:host_rows]:
            log(f"    {ms:9.3f} ms  x{n:<4d} {key[:110]}")


def finetune(kind: str, B: int, steps: int, card: str):
    """The fine-tuning path; returns the launch counts of its steps."""
    from ep_tpu_torch.models.assembly import build_backbone_config, init_probe_model
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.train.lars import LARS
    from ep_tpu_torch.train.schedule import make_lr_fn
    from ep_tpu_torch.train.state import freeze
    from ep_tpu_torch.train.steps import make_train_step

    cfg = finetune_config(kind, B)
    bcfg = build_backbone_config(cfg)
    t0 = time.perf_counter()
    model = init_probe_model(cfg, seed=0, backbone_cfg=bcfg)  # on the card
    params = freeze(model, cfg.finetuning)
    opt = LARS(params, weight_decay=0.0,
               mu_dtype=torch.bfloat16 if cfg.mu_bf16 else torch.float32)
    step_fn = make_train_step(model, opt, make_lr_fn(cfg, 1000))
    # the LR at its peak (the end of warmup), so that every update shows
    first = int(cfg.warmup_epochs * 1000)

    rng = np.random.default_rng(0)
    T = bcfg.num_patches + bcfg.num_prefix_tokens
    images = torch.from_numpy(rng.standard_normal(
        (B, bcfg.img_size, bcfg.img_size, 3), dtype=np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 1000, size=(B,))).cuda()
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    log(f"[{kind}] {cfg.model} (D={bcfg.embed_dim}, depth {bcfg.depth}, "
        f"{bcfg.num_heads} heads of width {bcfg.embed_dim // bcfg.num_heads}, "
        f"T={T}) + EP32, batch {B}, remat {bcfg.remat_policy}, momentum "
        f"{opt.mu_dtype}, {sum(p.numel() for p in params)} trainable "
        f"parameters, set up in {time.perf_counter() - t0:.1f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        m = step_fn(first + i, images, labels)
        loss = float(m["loss"])  # synchronises
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log(f"  step {i}: loss={loss:.5f} lr={float(m['lr']):.3e} "
            f"grad_norm={float(m['grad_norm']):.4f} {times[-1] * 1e3:.1f} ms")
    counts = dict(LAUNCHES)

    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite loss: {losses}")
    same = [k for k, p in model.named_parameters() if torch.equal(p, before[k])]
    if same:
        raise RuntimeError(f"parameters that did not change: {same[:8]}")
    d = bcfg.depth
    expect = dict.fromkeys(LAUNCHES, 0)
    expect.update({k: n * steps for k, n in FT_LAUNCHES.get(kind, dict(
        ln_qkv_gemm=2 * d, attn_core=2 * d, proj_residual_gemm=d, ep_pool=1,
        attn_core_bwd=d, ln1_apply=d, ln1_bwd=d)).items()})
    expect.update(lars_pair(steps))
    log(f"  launches over {steps} steps: {counts} (expected {expect})")
    if counts != expect:
        raise RuntimeError("the fine-tuning path did not go through every "
                           "kernel as expected")
    log(f"  all {len(before)} parameters changed, backbone included")
    med = statistics.median(times[1:]) if steps > 1 else times[0]
    log(f"  median step {med * 1e3:.2f} ms (steps 1..{steps - 1}), "
        f"{B / med:.1f} img/s at batch {B}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on {card}")
    device_time(lambda: step_fn(first + steps, images, labels), card)
    return counts


def finetune_grads(n: int = 4, kind: str = "finetune-b",
                   depth: int | None = None) -> None:
    """Every parameter's gradient (at ViT-B, or another path's model cut to
    ``depth`` blocks at full width): card kernel path vs CPU plain path.
    LayerScale gammas start at 1e-5, which would leave every block's
    gradients under the floor of the comparison; both sides take them at
    0.5, as training grows them. A model with a final norm (``depth`` given:
    DINOv2) runs its head's BN in eval mode: in train mode the BN over 4
    images cancels a shift or a scale common to the batch, so the final
    norm's bias has a gradient that is zero in exact arithmetic and those of
    the biases before it are mostly rounding (ROADMAP section 3, traps)."""
    from ep_tpu_torch.models.assembly import build_backbone_config, init_probe_model
    from ep_tpu_torch.train.state import freeze
    from ep_tpu_torch.train.steps import cross_entropy

    cfg = finetune_config(kind, n)
    bcfg = build_backbone_config(cfg)
    if depth is not None:
        bcfg = bcfg.replace(depth=depth)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(
        (n, bcfg.img_size, bcfg.img_size, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 1000, size=(n,)))
    grads = []
    for dev in ("cuda", "cpu"):  # the same seed gives both the same weights
        m = init_probe_model(cfg, seed=1, backbone_cfg=bcfg, device=dev).train()
        if depth is not None:
            m.head.bn.eval()
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith(".gamma"):
                    p.fill_(0.5)
        freeze(m, True)
        cross_entropy(m(x.to(dev)), y.to(dev)).mean().backward()
        grads.append({k: p.grad.float().cpu() for k, p in m.named_parameters()})
    tag = "finetune-grads" if depth is None else f"{kind}-grads"
    compare_grads(f"[{tag}] {len(grads[1])} gradients of {n} images"
                  + ("" if depth is None else
                     f", {cfg.model} at depth {depth}"), *grads)


def compare_grads(what: str, card: dict, cpu: dict,
                  min_cos: float = GRAD_COS, zero: set | None = None) -> float:
    """Each gradient of the card's kernel path against the CPU plain path's:
    GRAD_TOL at every element of max(its largest magnitude, GRAD_FLOOR of the
    largest gradient's), and ``min_cos`` in direction but for the gradients
    named in ``zero``: those that are zero in exact arithmetic, whose values
    are rounding noise (by default those under GRAD_FLOOR of the largest).
    Returns the smallest cosine of the others."""
    top = max(float(g.abs().max()) for g in cpu.values())
    if zero is None:
        zero = {k for k, g in cpu.items()
                if float(g.abs().max()) < GRAD_FLOOR * top}
    log(f"{what}, card kernel path vs CPU plain path (tol {GRAD_TOL:g} of "
        f"max(|grad|, {GRAD_FLOOR:g} x model max {top:.3e}); cosine >= "
        f"{min_cos:g} but for the zeros {sorted(zero)})")
    rows, bad = [], []
    for k, ref in cpu.items():
        scale = max(float(ref.abs().max()), GRAD_FLOOR * top)
        d = float((card[k] - ref).abs().max())
        cos = float(torch.nn.functional.cosine_similarity(
            card[k].flatten().double(), ref.flatten().double(), dim=0))
        rows.append((d / scale, cos, k, k in zero))
        if d > GRAD_TOL * scale or (k not in zero and cos < min_cos):
            bad.append(k)
    rows.sort(reverse=True)
    for r, cos, k, _ in rows[:5]:
        log(f"  {k}: max |d| {r:.3e} of its scale, cosine {cos:.6f}")
    smallest = min(r[1] for r in rows if not r[3])
    log(f"  smallest cosine {smallest:.6f}")
    if bad:
        raise RuntimeError(f"gradients outside the tolerance: {bad}")
    return smallest


# bench.py::_bench_cached_mode: chains of CACHED_CHAIN head steps on
# device-resident tokens, the median of CACHED_CHAINS chains; the card's head
# step against the CPU plain path's on CACHED_CHECK images of the same tokens
CACHED_CHAIN, CACHED_CHAINS, CACHED_CHECK = 32, 3, 64


def cached_steps(card: str, paths: dict, train_img_s: float) -> dict:
    """The head-only train step of --cache_features on ViT-B/16's tokens
    (512, 196, 768) bf16 and random labels, through F.linear + kernel D and
    through kernel G (EP_TPU_EP_FUSED=1). Adds the chains' launch counts to
    ``paths``; returns the img/s of both routes and effective_90ep_img_s."""
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.models.assembly import init_probe_model
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.train.feature_cache import make_head_steps
    from ep_tpu_torch.train.lars import build_optimizer
    from ep_tpu_torch.train.schedule import make_lr_fn
    from ep_tpu_torch.train.steps import cross_entropy

    B, N, D = 512, 196, 768
    cfg = TrainConfig(model="vit_base_patch16", cls_features="ep",
                      ep_queries=32, d_out=1, nb_classes=1000, amp="bfloat16",
                      epochs=90, warmup_epochs=10, blr=0.1, batch_size=B,
                      eff_batch_size=B)
    head0 = init_probe_model(cfg, seed=1).head  # on the card
    rng = np.random.default_rng(1)
    tokens = rand(rng, (B, N, D))
    labels = torch.from_numpy(rng.integers(0, 1000, size=(B,))).cuda()
    first = int(cfg.warmup_epochs * 1000)  # the LR at its peak
    out = {}
    for name, env, kernel in (("cached", {}, "ep_pool"),
                              ("cached-fused", {"EP_TPU_EP_FUSED": "1"},
                               "ep_pool_proj")):
        head = copy.deepcopy(head0)
        opt = build_optimizer("lars", list(head.parameters()), 0.0)
        step_fn, _ = make_head_steps(head, opt, make_lr_fn(cfg, 1000))
        with environment(**env):
            for i in range(2):
                float(step_fn(first + i, tokens, labels)["loss"])
            torch.cuda.synchronize()
            reset_launches()
            chains, step = [], first + 2
            for _ in range(CACHED_CHAINS):
                t0 = time.perf_counter()
                for _ in range(CACHED_CHAIN):
                    m = step_fn(step, tokens, labels)
                    step += 1
                loss = float(m["loss"])  # synchronises
                chains.append((time.perf_counter() - t0) / CACHED_CHAIN)
            paths[name] = dict(LAUNCHES)
            want = {**dict.fromkeys(LAUNCHES, 0),
                    **lars_pair(CACHED_CHAIN * CACHED_CHAINS)}
            want[kernel] = CACHED_CHAIN * CACHED_CHAINS
            log(f"[{name}] head-only step of --cache_features, tokens "
                f"{tuple(tokens.shape)} bf16, EP-32 + BN + fc + LARS, pool "
                f"through {kernel}: chains of {CACHED_CHAIN} steps "
                f"{[round(c * 1e3, 3) for c in chains]} ms a step, loss "
                f"{loss:.5f}; launches {paths[name]} (expected {want})")
            if paths[name] != want or not math.isfinite(loss):
                raise RuntimeError(f"{name}: the head step did not go "
                                   "through its kernel as expected")
            med = statistics.median(chains)
            out[name] = dict(step_ms=med * 1e3, img_s=B / med)
            log(f"  median step {med * 1e3:.3f} ms, {B / med:.1f} img/s at "
                f"batch {B} on {card}")
            device_time(lambda: step_fn(step, tokens, labels), card,
                        host_rows=10)

            # the card's head step against the CPU plain path's
            n = CACHED_CHECK
            grads, logits = [], []
            for dev in ("cuda", "cpu"):
                h = copy.deepcopy(head0).to(dev).train()
                lg = h(tokens[:n].to(dev))
                cross_entropy(lg, labels[:n].to(dev)).mean().backward()
                logits.append(lg.detach().float().cpu())
                grads.append({k: p.grad.float().cpu()
                              for k, p in h.named_parameters()})
            log(f"[{name}] the head's forward and backward on {n} of the "
                "tokens, card kernel path vs CPU plain path")
            compare("logits", logits[0], logits[1], MODEL_ATOL, MODEL_RTOL)
            compare_grads(f"  {len(grads[1])} head gradients", *grads)
    a, b = out["cached"], out["cached-fused"]
    log(f"[steps] cached-fused (G): {b['step_ms']:.3f} ms, {b['img_s']:.1f} "
        f"img/s; cached (F.linear + D, same run): {a['step_ms']:.3f} ms, "
        f"{a['img_s']:.1f} img/s at batch {B} on {card}")
    eff = 90.0 / (1.0 / train_img_s + 90.0 / a["img_s"])
    return dict(cached_mode_img_s=a["img_s"],
                cached_mode_fused_img_s=b["img_s"],
                cached_step_ms=a["step_ms"], cached_fused_step_ms=b["step_ms"],
                effective_90ep_img_s=eff, train_img_s=train_img_s)


# The zoo phase: every --cls_features head, and ep_all and aim_all (an _all
# variant through a BatchNorm pool), on the frozen ViT-B/16 of the train path
# (random weights from seed 0). The heads are plain torch, as the JAX package
# leaves them to XLA; A, B and C run in the encoder, D in ep and ep_all only.
# Card against CPU on ZOO_CHECK images' tokens: the bf16 logits and maps within
# ZOO_TOL of their largest magnitude (the cached phase's 5e-2), the gradients
# of the bf16 head and of the head computing in f32 to ZOO_COS in direction,
# with the descriptor BN in eval and in train mode (zoo_head_check).
ZOO_HEADS = ("abmilp", "simpool", "esimpool", "clip", "siglip", "aim", "ep",
             "cbam", "coca", "cait", "dinovit", "jepa", "dolg", "cae",
             "ep_all", "aim_all")
ZOO_BN = ("aim", "cbam", "dolg")
ZOO_BATCH, ZOO_CHECK, ZOO_TOL, ZOO_COS, ZOO_FLOOR = 512, 8, 5e-2, 0.9999, 1e-5


def grad_of(p: torch.Tensor) -> torch.Tensor:
    """p's gradient, zeros where the step left it none."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


def compare_scaled(name: str, out: torch.Tensor, ref: torch.Tensor,
                   tol: float) -> float:
    """max |out - ref| <= tol * max |ref|; returns the ratio."""
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"{name}: shape {tuple(out.shape)} against "
                           f"{tuple(ref.shape)}, or non-finite values")
    r = float((out - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
    log(f"    {name}: max |d| / max |ref| = {r:.3e} (tol {tol:g}) "
        f"{'ok' if r <= tol else 'FAIL'}")
    if r > tol:
        raise RuntimeError(f"{name}: the card disagrees with the CPU")
    return r


def zoo_grads(head, x: torch.Tensor, labels: torch.Tensor, dev: str,
              bn_train: bool) -> dict:
    """The head's parameter gradients of the mean cross-entropy on ``dev``,
    the pool in train mode and the descriptor BN in train or eval mode."""
    from ep_tpu_torch.train.steps import cross_entropy
    h = copy.deepcopy(head).to(dev).train()
    h.bn.train(bn_train)
    cross_entropy(h(x.to(dev)), labels.to(dev)).mean().backward()
    return {k: grad_of(p).float().cpu() for k, p in h.named_parameters()}


def zoo_head_check(name: str, cfg, head0, tokens: torch.Tensor,
                   num_patches: int) -> dict:
    """The head on ZOO_CHECK images' tokens, card against CPU, from the same
    weights: the bf16 head's (the trained path) train-mode logits, its
    eval-mode logits and attention map (``return_attn``), and the gradients,
    the pool in train mode: with the descriptor BN in eval mode those of the
    bf16 head and of the same head computing in f32 (not for ep and ep_all:
    kernel D takes bf16 only); with that BN in train mode (the function
    trained) those of the f32 head, of the bf16 head for ep and ep_all.

    Each pass's gradients that are zero in exact arithmetic, those under
    ZOO_FLOOR of the largest of the same head's gradients computing in f64 on
    the CPU, are held to the elementwise bound only (compare_grads), the rest
    to ZOO_COS too. They are
    a k bias under the softmax's shift invariance, dolg's conv1 bias under its
    BN and, with the descriptor BN in train mode, what that BN cancels: it
    normalises the images' descriptors together, so a shift or a per-channel
    scale common to all of them (a LayerNorm's affine before it, a bias added
    to every token before a weighted mean whose weights sum to one) does not
    reach the loss. What it cancels leaves rounding in f32 well over
    ZOO_FLOOR of the largest gradient (abmilp's ``self_attn.proj.bias``),
    hence the f64 reference; a gradient it cancels in part keeps the rest,
    but in bf16 that is largely rounding, on the CPU as on the card: so in
    train mode the gradients are those of the head computing in f32. There
    cait's LayerScale gammas are grown from their initial 1e-5 to
    0.5 on both devices, as tests/test_torch_all_variants.py grows them: at
    1e-5 all 8 descriptors are nearly cait's class token, and that BN divides
    their rounding-sized differences by a deviation of the same size."""
    from ep_tpu_torch.poolings.registry import ProbeHead, base_name

    x = tokens[:ZOO_CHECK]
    labels = torch.arange(ZOO_CHECK) % 1000
    head32 = ProbeHead(cfg, x.shape[-1], num_patches, torch.float32)
    head32.load_state_dict(head0.state_dict())
    head64 = ProbeHead(cfg, x.shape[-1], num_patches, torch.float64)
    head64.load_state_dict(head0.state_dict())
    logits, evals = [], []
    for dev in ("cuda", "cpu"):
        h = copy.deepcopy(head0).to(dev).train()
        with torch.no_grad():
            logits.append(h(x.to(dev)).float().cpu())
            out, attn = h.eval()(x.to(dev), return_attn=True)
        evals.append((out.float().cpu(),
                      None if attn is None else attn.float().cpu()))
    log(f"  [zoo {name}] head on {ZOO_CHECK} images' tokens, card vs CPU")
    res = dict(logits_rel=compare_scaled("bf16 train-mode logits", *logits,
                                         ZOO_TOL))
    compare_scaled("bf16 eval-mode logits", evals[0][0], evals[1][0], ZOO_TOL)
    if (evals[0][1] is None) != (evals[1][1] is None):
        raise RuntimeError(f"{name}: a map on one device only")
    if evals[1][1] is None:
        log("    return_attn: None on both (cait keeps no map)")
    else:
        log(f"    return_attn: {tuple(evals[1][1].shape)}")
        res["attn_rel"] = compare_scaled("bf16 attention map", evals[0][1],
                                         evals[1][1], ZOO_TOL)
    for bn in ("eval", "train"):
        heads = dict(bf16=head0, f32=head32, f64=head64)
        if bn == "train" and name == "cait":
            heads = {k: copy.deepcopy(h) for k, h in heads.items()}
            for h in heads.values():
                with torch.no_grad():
                    for k, p in h.named_parameters():
                        if "_gamma_" in k:
                            p.fill_(0.5)
        exact = zoo_grads(heads.pop("f64"), x.double(), labels, "cpu",
                          bn == "train")
        top = max(float(g.abs().max()) for g in exact.values())
        zero = {k for k, g in exact.items()
                if float(g.abs().max()) < ZOO_FLOOR * top}
        for prec, head in heads.items():
            if prec == "f32" and base_name(name) == "ep" or (
                    bn == "train" and prec == "bf16"
                    and base_name(name) != "ep"):
                continue
            cpu = zoo_grads(head, x, labels, "cpu", bn == "train")
            res[f"min_cos_{prec}_bn_{bn}"] = compare_grads(
                f"    {len(cpu)} head gradients, {prec} head, descriptor BN in "
                f"{bn} mode", zoo_grads(head, x, labels, "cuda", bn == "train"),
                cpu, min_cos=ZOO_COS, zero=zero)
    return res


def zoo(card: str, paths: dict, steps: int, train_ms: float) -> dict:
    """Each head of ZOO_HEADS on the train path at batch 512 (a warm-up step,
    then ``steps`` timed steps at the peak LR), its head-only step on
    device-resident tokens (chains as ``cached_steps``), and its card-vs-CPU
    check. Adds the launch counts to ``paths``; returns the times."""
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.models.assembly import init_probe_model
    from ep_tpu_torch.models.vit import remap_features
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.poolings.registry import ProbeHead, base_name
    from ep_tpu_torch.train.feature_cache import make_head_steps
    from ep_tpu_torch.train.lars import LARS
    from ep_tpu_torch.train.schedule import make_lr_fn
    from ep_tpu_torch.train.state import cast_frozen, freeze
    from ep_tpu_torch.train.steps import make_train_step

    B = ZOO_BATCH
    base = TrainConfig(model="vit_base_patch16", cls_features="ep",
                       ep_queries=32, d_out=1, nb_classes=1000,
                       amp="bfloat16", epochs=90, warmup_epochs=10, blr=0.1,
                       batch_size=B, eff_batch_size=B)
    model = init_probe_model(base, seed=0)  # on the card
    bcfg = model.backbone.cfg
    D, N, img = bcfg.embed_dim, bcfg.num_patches, bcfg.img_size
    freeze(model, False)
    cast_frozen(model, torch.bfloat16)
    frozen = {k: p.detach().clone() for k, p in model.backbone.named_parameters()}
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.standard_normal(
        (B, img, img, 3), dtype=np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 1000, size=(B,))).cuda()
    tokens = {N: rand(rng, (B, N, D)), N + 1: rand(rng, (B, N + 1, D))}
    first = int(base.warmup_epochs * 1000)  # the LR at its peak
    lr_fn = make_lr_fn(base, 1000)
    out = {}
    for name in ZOO_HEADS:
        cfg = base.replace(cls_features=name)
        head0 = ProbeHead(cfg, D, N, torch.bfloat16)
        head0.init_weights(torch.Generator().manual_seed(0))
        model.head = copy.deepcopy(head0).cuda()
        model.mode = remap_features(name)
        head = model.head
        before = {k: v.detach().clone() for k, v in head.state_dict().items()}
        step_fn = make_train_step(
            model, LARS(list(head.parameters()), weight_decay=0.0), lr_fn)
        float(step_fn(first, images, labels)["loss"])  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        times, losses = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            losses.append(float(step_fn(first + 1 + i, images, labels)["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        paths[f"zoo-{name}"] = counts = dict(LAUNCHES)
        want = dict.fromkeys(LAUNCHES, 0)
        want.update(ln_qkv_gemm=12 * steps, attn_core=12 * steps,
                    proj_residual_gemm=12 * steps, **lars_pair(steps),
                    **fc1_gelu(12 * steps))
        if base_name(name) == "ep":
            want["ep_pool"] = steps
        med = statistics.median(times)
        log(f"[zoo {name}] ViT-B/16 + {name} head "
            f"({sum(p.numel() for p in head.parameters())} trainable), "
            f"{'[CLS] + ' if name.endswith('_all') else ''}patch tokens, "
            f"batch {B}: losses {[round(v, 5) for v in losses]}, steps "
            f"{[round(t * 1e3, 2) for t in times]} ms; launches "
            f"{ {k: v for k, v in counts.items() if v} } (expected "
            f"{ {k: v for k, v in want.items() if v} })")
        if counts != want or not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"zoo {name}: a non-finite loss or launches "
                               "other than expected")
        # every head parameter moved, but for those whose gradient is zero
        # in exact arithmetic (a k bias under the softmax's shift
        # invariance): rounding noise under GRAD_FLOOR of the largest
        top = max(float(grad_of(p).abs().max()) for p in head.parameters())
        still = [k for k, p in head.named_parameters()
                 if torch.equal(p, before[k])
                 and float(grad_of(p).abs().max()) >= GRAD_FLOOR * top]
        if still:
            raise RuntimeError(f"zoo {name}: parameters did not move: {still}")
        if base_name(name) in ZOO_BN:
            stats = [k for k in before if "pool." in k and "running_" in k]
            if not stats or any(torch.equal(head.state_dict()[k], before[k])
                                for k in stats):
                raise RuntimeError(f"zoo {name}: the pool's BatchNorm "
                                   f"statistics did not move: {stats}")
        rec = dict(train_ms=med * 1e3, train_img_s=B / med, losses=losses)

        # the head-only step on device-resident tokens
        x = tokens[N + name.endswith("_all")]
        h = copy.deepcopy(head0).cuda()
        hstep, _ = make_head_steps(
            h, LARS(list(h.parameters()), weight_decay=0.0), lr_fn)
        for i in range(2):
            float(hstep(first + i, x, labels)["loss"])
        torch.cuda.synchronize()
        reset_launches()
        chains, step = [], first + 2
        for _ in range(CACHED_CHAINS):
            t0 = time.perf_counter()
            for _ in range(CACHED_CHAIN):
                m = hstep(step, x, labels)
                step += 1
            loss = float(m["loss"])
            chains.append((time.perf_counter() - t0) / CACHED_CHAIN)
        paths[f"zoo-cached-{name}"] = counts = dict(LAUNCHES)
        want = {**dict.fromkeys(LAUNCHES, 0),
                **lars_pair(CACHED_CHAIN * CACHED_CHAINS)}
        if base_name(name) == "ep":
            want["ep_pool"] = CACHED_CHAIN * CACHED_CHAINS
        if counts != want or not math.isfinite(loss):
            raise RuntimeError(f"zoo {name}: the head-only step launched "
                               f"{counts}, expected {want}")
        split = zoo_busy_ms(lambda: hstep(step, x, labels))
        busy = split["busy"]
        hmed = statistics.median(chains)
        rec.update(head_ms=hmed * 1e3, head_img_s=B / hmed,
                   head_busy_ms=busy,
                   head_split_ms={k: v for k, v in split.items() if k != "busy"})
        log(f"  train step {rec['train_ms']:.2f} ms ({rec['train_img_s']:.1f} "
            f"img/s; train, EP-32 at bs {B} earlier in this run: "
            f"{train_ms:.2f} ms); head-only step on {tuple(x.shape)} tokens: "
            f"chains {[round(c * 1e3, 3) for c in chains]} ms a step, median "
            f"{rec['head_ms']:.3f} ms ({rec['head_img_s']:.1f} img/s), "
            f"device busy {busy:.3f} ms of a profiled step (products "
            f"{split['products']:.3f}, copies and casts {split['copies']:.3f}, "
            f"D {split['ours']:.3f}, the rest {split['rest']:.3f}), on {card}")
        rec.update(zoo_head_check(name, cfg, head0, x, N))
        out[name] = rec
        del h, hstep, step_fn, head
        torch.cuda.empty_cache()
    moved = [k for k, p in model.backbone.named_parameters()
             if not torch.equal(p, frozen[k])]
    if moved:
        raise RuntimeError(f"zoo: frozen parameters changed: {moved[:5]}")
    log(f"[zoo] per head at batch {B} on {card} (train ms, img/s; head-only "
        "ms, img/s, device busy ms of which products, copies and casts):")
    for name, r in out.items():
        sp = r["head_split_ms"]
        log(f"  {name:9s} {r['train_ms']:8.2f} {r['train_img_s']:9.1f}  "
            f"{r['head_ms']:8.3f} {r['head_img_s']:10.1f} "
            f"{r['head_busy_ms']:8.3f} {sp['products']:7.3f} "
            f"{sp['copies']:7.3f}")
    del model, images, tokens
    torch.cuda.empty_cache()
    return out


def zoo_busy_ms(step) -> dict:
    """Device ms of one step under the profiler: busy, and split into
    products (cuBLAS in bf16 or f32, cuDNN), copies and casts (``copy`` in
    the kernel's name), our kernels (``ep::``) and the rest."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    split = dict(busy=0.0, products=0.0, copies=0.0, ours=0.0, rest=0.0)
    for ms, _, key in device_rows(prof):
        k = key.lower()
        split["busy"] += ms
        if "ep::" in k:
            split["ours"] += ms
        elif any(n in k for n in ("gemm", "nvjet", "xmma", "cutlass", "sm90",
                                  "cudnn", "conv")):
            split["products"] += ms
        elif "copy" in k:
            split["copies"] += ms
        else:
            split["rest"] += ms
    return split


def zoo_driver(card: str, paths: dict) -> dict:
    """main_linprobe_torch.py with --cls_features dolg (1x1 convolutions and
    an affine BatchNorm in the pool) on DRIVER_FLAGS for one epoch, then
    --eval from its checkpoint: the pool's BatchNorm parameters and moved
    running statistics in checkpoint-.pth, and --eval printing epoch 0's val
    numbers."""
    import ep_tpu_torch.cli.linprobe as linprobe
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.ops import LAUNCHES, reset_launches

    log(f"[zoo-driver] main_linprobe_torch.py --cls_features dolg: ViT-B/16, "
        f"batch 128, bf16, the fake dataset, 1 epoch, then --eval, on {card}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        runs = {}
        for name, kw in (("zoo-driver", {}),
                         ("zoo-driver-eval", dict(
                             eval=True,
                             resume=str(tmp / "train" / "checkpoint-.pth")))):
            out = tmp / ("train" if not kw else "eval")
            out.mkdir()
            cfg = TrainConfig(**{**DRIVER_FLAGS, "cls_features": "dolg",
                                 "epochs": 1, "output_dir": str(out), **kw})
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            runs[name] = linprobe.main(cfg)
            torch.cuda.synchronize()
            paths[name] = dict(LAUNCHES)
            forwards = DRIVER_STEPS + DRIVER_EVAL_BATCHES if not kw \
                else DRIVER_EVAL_BATCHES
            want = dict.fromkeys(LAUNCHES, 0)
            want.update(ln_qkv_gemm=12 * forwards, attn_core=12 * forwards,
                        proj_residual_gemm=12 * forwards,
                        **lars_pair(0 if kw else DRIVER_STEPS),
                        **fc1_gelu(12 * forwards))
            log(f"  [{name}] {time.perf_counter() - t0:.1f} s, launches "
                f"{ {k: v for k, v in paths[name].items() if v} }")
            if paths[name] != want:
                raise RuntimeError(f"{name}: launches {paths[name]}, expected "
                                   f"{want}")
        rows = (tmp / "train" / "training_log.txt").read_text().splitlines()
        line = [float(v) for r in rows if r.startswith("0,")
                for v in r.split(", ")[1:]]
        ckpt = torch.load(tmp / "train" / "checkpoint-.pth", weights_only=True)
        model = ckpt["model"]
    bn = {k: model.get(f"head.pool.bn.{k}") for k in (
        "weight", "bias", "running_mean", "running_var")}
    if (len(line) != 5 or not all(math.isfinite(v) for v in line)
            or any(v is None for v in bn.values())
            or not all(k.startswith("head.") for k in model)
            or torch.equal(bn["running_mean"], torch.zeros_like(
                bn["running_mean"]))
            or torch.equal(bn["running_var"], torch.ones_like(
                bn["running_var"]))):
        raise RuntimeError(f"zoo-driver: epoch line {line}, checkpoint "
                           f"entries {sorted(model)[:8]}")
    stats = runs["zoo-driver-eval"]
    got = [round(stats["loss"], 4), round(stats["acc1"], 2),
           round(stats["acc5"], 2)]
    log(f"  epoch 0: {line}; the checkpoint holds {len(model)} head.* "
        f"entries with the pool's BN weight, bias and moved running "
        f"statistics; --eval: {got}")
    if got != line[2:]:
        raise RuntimeError("zoo-driver-eval: not epoch 0's val numbers")
    return dict(epoch0=line, eval=got)


# The device crop against its CPU plain version: f32 output, so that the
# comparison sees the crop and not the final bf16 rounding. Both sum f32
# products of bf16 values in another order; where a y-pass sum lies within
# that difference of a bf16 rounding boundary, its bf16 value moves by one
# step (1.0 up to 256, 2.0 where the bicubic lobes overshoot past it), which
# the x-pass carries to the output elements that read it, times their weights
# (at most about 1.2 in all) over 255*std (0.225 at the least): under 0.042.
# A magnified crop spreads one source column over up to 45 outputs, so the
# moved elements are a share of a percent (measured on an H100: 0.74% past
# AUG_CLOSE, at most 3.4e-2). AUG_TOL bounds every element, at most AUG_SHARE
# of them may lie past AUG_CLOSE, and the mean |d| stays under AUG_MEAN: a
# wrong box or flip moves most elements by tenths.
AUG_TOL, AUG_CLOSE, AUG_SHARE, AUG_MEAN = 5e-2, 1e-3, 2e-2, 1e-4


def device_aug_check(card: str, n_check: int = 128) -> dict:
    """The --device_aug train transform at batch 512 (u8 (512, 256, 256, 3) to
    (512, 224, 224, 3)): its time on the card, and the card's output against
    the CPU's on the same step's draws."""
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.data.device_aug import DeviceAug

    cfg = TrainConfig(model="vit_base_patch16", image_size=224,
                      amp="bfloat16", device_aug=True, seed=0)
    aug = DeviceAug.from_cfg(cfg)
    S, out, B = aug.stage_size, aug.out_size, 512
    images = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (B, S, S, 3), dtype=np.uint8)).cuda()
    ms = time_ms(lambda: aug.train_fn(7, images))
    flops = 2 * B * out * S * (S * 3 + out * 3)
    moved = images.numel() + B * out * out * 3 * 2
    bound_ms = bound_s(flops, moved, H100_SXM) * 1e3
    log(f"[device-aug] the train transform (crop, flip, normalize) at batch "
        f"{B}, u8 {tuple(images.shape)} to bf16 ({B}, {out}, {out}, 3): "
        f"{ms:.3f} ms ({flops / 1e9:.1f} GFLOP of products on bf16 values "
        f"in f32; bound {bound_ms:.3f} ms at the bf16 peak or the memory "
        f"rate) on {card}")
    f32 = dataclasses.replace(aug, dtype=torch.float32)
    got = f32.train_fn(7, images[:n_check]).cpu()
    ref = f32.train_fn(7, images[:n_check].cpu())
    d = (got - ref).abs()
    past = int((d > AUG_CLOSE).sum())
    ok = (float(d.max()) <= AUG_TOL and past <= AUG_SHARE * d.numel()
          and float(d.mean()) <= AUG_MEAN)
    log(f"  card vs CPU on the same draws ({n_check} images, f32 out): max "
        f"|d| {float(d.max()):.3e} (tol {AUG_TOL:g}), {past} of {d.numel()} "
        f"past {AUG_CLOSE:g} (tol a share of {AUG_SHARE:g}), mean |d| "
        f"{float(d.mean()):.3e} (tol {AUG_MEAN:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the card's crop disagrees with the CPU's")
    return dict(crop_ms=ms, crop_max_abs_err=float(d.max()),
                bound_ms=bound_ms)


# The driver phase: main_linprobe_torch.py's main on the fake dataset (512
# train and 128 val images made in memory), ViT-B/16 at 224 px, EP-32,
# batch 128, bf16, random weights from --seed 0: 4 steps an epoch (the last
# train batch is dropped, as the reference does) and 1 val batch.
DRIVER_FLAGS = dict(dataset_name="fake", nb_classes=10, image_size=224,
                    model="vit_base_patch16", cls_features="ep",
                    ep_queries=32, batch_size=128, amp="bfloat16", epochs=2,
                    warmup_epochs=1, blr=0.1, num_workers=8, seed=0)
DRIVER_STEPS, DRIVER_EVAL_BATCHES = 4, 1


def epoch_timer(run_epoch, epochs: list, profiled: dict):
    """A stand-in for the driver's train_one_epoch that times each epoch on
    the host clock, appends its record to ``epochs``, and profiles the epoch
    ``profiled["at"]`` names ((output_dir, epoch)): the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    def timed_epoch(train_step, step, loader, device, epoch, cfg, writer):
        prof = None
        if profiled["at"] == (cfg.output_dir, epoch):
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_epoch(train_step, step, loader, device, epoch, cfg, writer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = len(loader) * cfg.batch_size
        rec = dict(run=Path(cfg.output_dir).name, epoch=epoch,
                   first_step=step, images=n, wall_s=wall, img_s=n / wall)
        if prof is not None:
            prof.__exit__(None, None, None)
            busy = sum(r[0] for r in device_rows(prof))
            rec.update(busy_ms=busy, idle_share=1 - busy / (wall * 1e3))
        epochs.append(rec)
        log(f"  epoch {epoch} of {rec['run']}: {n} images in {wall:.3f} s, "
            f"{rec['img_s']:.1f} img/s"
            + (f"; profiled: device busy {rec['busy_ms']:.1f} ms of "
               f"{wall * 1e3:.1f}, idle share {rec['idle_share']:.3f}"
               if prof is not None else ""))
        return out
    return timed_epoch


def epoch_lines(out: Path) -> dict:
    """The epoch lines of a run's training_log.txt: {epoch: [numbers]}."""
    rows = (out / "training_log.txt").read_text().splitlines()
    return {int(r.split(",")[0]): [float(v) for v in r.split(", ")[1:]]
            for r in rows if r[:1].isdigit()}


def driver(card: str, paths: dict, keep) -> list[dict]:
    """Run the probe-training driver as a user runs it and check what it
    writes. Adds each run's launch counts to ``paths``; returns each epoch's
    wall time and img/s, the device's idle share over one profiled epoch,
    and the epoch lines of its first run's training_log.txt. Copies the EP
    checkpoint of its first run (after --auto_resume: epoch 2) to ``keep``,
    for the tools' phases."""
    import ep_tpu_torch.cli.linprobe as linprobe
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.pool_attn import query_groups
    from ep_tpu_torch.train.state import cast_frozen

    epochs, built, extracted = [], [], []
    profiled = {"at": None}
    build_model = linprobe.init_probe_model
    timed_epoch = epoch_timer(linprobe.train_one_epoch, epochs, profiled)
    run_extract = linprobe.extract_split

    def timed_extract(backbone_apply, loader, device, cache_dir, name, **kw):
        """The driver's extract_split on the host clock."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats, labels = run_extract(backbone_apply, loader, device, cache_dir,
                                    name, **kw)
        wall = time.perf_counter() - t0
        rec = dict(run=Path(cache_dir).name, split=name,
                   shape=list(feats.shape), dtype=str(feats.dtype),
                   wall_s=wall, img_s=len(feats) / wall)
        extracted.append(rec)
        log(f"  extraction of {rec['run']}'s {name}: {len(feats)} images to "
            f"{tuple(feats.shape)} {feats.dtype} in {wall:.3f} s, "
            f"{rec['img_s']:.1f} img/s")
        return feats, labels

    def keep_model(*a, **kw):
        built.append(build_model(*a, **kw))
        return built[-1]

    def run(name, out, **kw):
        cfg = TrainConfig(**{**DRIVER_FLAGS, "output_dir": str(out), **kw})
        out.mkdir(parents=True, exist_ok=True)
        torch.cuda.synchronize()
        said = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(sys.stdout, said)):
            res = linprobe.main(cfg)
        torch.cuda.synchronize()
        printed[name] = said.getvalue()
        paths[name] = dict(LAUNCHES)
        log(f"  [{name}] {time.perf_counter() - t0:.1f} s, launches "
            f"{ {k: v for k, v in paths[name].items() if v} }")
        return res

    def expect(name, forwards, pool="ep_pool", per_forward=1, pools=None,
               updates=0):
        """A, B, C and fc1's GELU epilogue 12 times a forward; the pool
        per_forward times a forward, or ``pools`` times in all (cached epochs
        pool without a forward); LARS's pair once an update."""
        want = dict.fromkeys(LAUNCHES, 0)
        want.update(ln_qkv_gemm=12 * forwards, attn_core=12 * forwards,
                    proj_residual_gemm=12 * forwards, **lars_pair(updates),
                    **fc1_gelu(12 * forwards))
        if pool:
            want[pool] = per_forward * forwards if pools is None else pools
        if paths[name] != want:
            raise RuntimeError(f"{name}: launches {paths[name]}, expected {want}")

    def check_run(name, out, want_lines, ckpt_epoch_step):
        """Finite epoch lines, and a head-only checkpoint at the epoch and
        global step given."""
        got = epoch_lines(out)
        if list(got) != want_lines or not all(
                math.isfinite(v) for row in got.values() for v in row):
            raise RuntimeError(f"{name}: epoch lines {got}")
        ckpt = torch.load(out / "checkpoint-.pth", weights_only=True)
        if not ckpt["model"] or not all(k.startswith("head.")
                                        for k in ckpt["model"]):
            raise RuntimeError(f"{name}: the checkpoint holds more than the "
                               "head")
        if (ckpt["epoch"], ckpt["step"]) != ckpt_epoch_step:
            raise RuntimeError(f"{name}: checkpoint at epoch {ckpt['epoch']}, "
                               f"step {ckpt['step']}")
        return got, ckpt

    printed = {}
    per_epoch = DRIVER_STEPS + DRIVER_EVAL_BATCHES
    with mock.patch.object(linprobe, "train_one_epoch", timed_epoch), \
            mock.patch.object(linprobe, "init_probe_model", keep_model), \
            mock.patch.object(linprobe, "extract_split", timed_extract), \
            tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        log("[driver] main_linprobe_torch.py's main: ViT-B/16, 224 px, EP-32, "
            "batch 128, bf16, the fake dataset (512 train, 128 val images), "
            f"on {card}")
        # 1. two epochs, the second one profiled
        profiled["at"] = (str(tmp / "train"), 1)
        res = run("driver", tmp / "train")
        expect("driver", 2 * per_epoch, updates=2 * DRIVER_STEPS)
        first, ckpt = check_run("driver", tmp / "train", [0, 1],
                                (1, 2 * DRIVER_STEPS))
        log(f"  epoch lines {first}; the checkpoint holds "
            f"{len(ckpt['model'])} head.* entries, epoch 1, step "
            f"{ckpt['step']}; max accuracy {res['max_accuracy']:.2f}% (random "
            "weights: no accuracy gate)")

        # 2. --auto_resume to 3 epochs: epoch 2 from the saved global step
        run("driver-resume", tmp / "train", epochs=3, auto_resume=True)
        expect("driver-resume", per_epoch, updates=DRIVER_STEPS)
        resumed = epoch_lines(tmp / "train")
        last = epochs[-1]
        if list(resumed) != [2] or (last["epoch"], last["first_step"]) != (
                2, 2 * DRIVER_STEPS):
            raise RuntimeError(f"driver-resume: lines {resumed}, epoch "
                               f"{last['epoch']} from step {last['first_step']}")
        after = torch.load(tmp / "train" / "checkpoint-.pth", weights_only=True)
        if (after["epoch"], after["step"]) != (2, 3 * DRIVER_STEPS):
            raise RuntimeError("driver-resume: the checkpoint did not advance")
        log(f"  resumed at epoch 2 from global step {last['first_step']}: "
            f"{resumed[2]}")
        shutil.copyfile(tmp / "train" / "checkpoint-.pth", keep)

        # 3. --eval from the checkpoint: epoch 2's val numbers as printed
        stats = run("driver-eval", tmp / "eval", eval=True,
                    resume=str(tmp / "train" / "checkpoint-.pth"))
        expect("driver-eval", DRIVER_EVAL_BATCHES)
        got = [round(stats["loss"], 4), round(stats["acc1"], 2),
               round(stats["acc5"], 2)]
        log(f"  --eval: {got}; epoch 2's line {resumed[2][2:]}")
        if got != resumed[2][2:]:
            raise RuntimeError("driver-eval: not epoch 2's val numbers")

        # 4. one epoch at --ep_queries 128: kernel D in groups of 64 queries
        groups = len(query_groups(128))
        run("driver-q128", tmp / "q128", ep_queries=128, epochs=1)
        expect("driver-q128", per_epoch, per_forward=groups,
               updates=DRIVER_STEPS)
        q128 = epoch_lines(tmp / "q128")
        if not all(math.isfinite(v) for v in q128[0]):
            raise RuntimeError(f"driver-q128: {q128}")
        log(f"  --ep_queries 128: {q128[0]}; kernel D {groups} launches a "
            "forward, one a group of 64 queries")

        # 5. --knn_eval on the mean of the patch tokens
        knn = run("driver-knn", tmp / "knn", knn_eval=True,
                  cls_features="pos")["knn"]
        expect("driver-knn", (512 + 128) // 128, pool=None)
        if sorted(knn) != [5, 10, 15, 20, 50, 100, 200] or not all(
                0 <= t1 <= t5 <= 100 for t1, t5 in knn.values()):
            raise RuntimeError(f"driver-knn: {knn}")
        log(f"  --knn_eval: {knn}")

        # 6. --finetune of a timm-layout .pth written from seed 1's backbone:
        # the driver's model (seed 0's head) gives the logits of the model
        # the file was written from, with seed 0's head
        cfg = TrainConfig(**DRIVER_FLAGS)
        bcfg = linprobe.build_backbone_config(cfg)
        source = build_model(cfg, 1, bcfg)
        source.head.load_state_dict(build_model(cfg, 0, bcfg).head.state_dict())
        pth = tmp / "mae_vit_base.pth"
        torch.save({"model": {
            **{f"module.{k}": v.cpu()
               for k, v in source.backbone.state_dict().items()},
            "module.decoder_embed.weight": torch.zeros(8, 768),
            "module.mask_token": torch.zeros(1, 1, 768)}}, pth)
        built.clear()
        run("driver-finetune", tmp / "finetune", finetune=str(pth), eval=True)
        expect("driver-finetune", DRIVER_EVAL_BATCHES)
        cast_frozen(source, torch.bfloat16)
        images = rand(np.random.default_rng(3), (8, 224, 224, 3),
                      dtype=torch.float32)
        with torch.no_grad():
            got, ref = built[0].eval()(images), source.eval()(images)
        compare("--finetune: the driver's logits against the written model's",
                got, ref)
        del source, built[:]

        # 7. --cache_features: the encoder once over each split (4 train and
        # 1 val batches), then head-only epochs on the cached tokens (kernel
        # D once a step); the second epoch profiled. Then --cache_augs 2
        # over 3 epochs: two train draws, epochs 0 and 2 on the first.
        for name, K, n_epochs in (("driver-cached", 1, 2),
                                  ("driver-cached-augs", 2, 3)):
            out = tmp / name
            profiled["at"] = (str(out), 1)
            run(name, out, cache_features=True, cache_augs=K, epochs=n_epochs)
            expect(name, K * DRIVER_STEPS + DRIVER_EVAL_BATCHES,
                   pools=n_epochs * per_epoch, updates=n_epochs * DRIVER_STEPS)
            got, _ = check_run(name, out, list(range(n_epochs)),
                               (n_epochs - 1, n_epochs * DRIVER_STEPS))
            said = ("[cache] train (512, 196, 768)"
                    + (f" x{K} augs" if K > 1 else "") + " val (128, 196, 768)")
            if said not in printed[name]:
                raise RuntimeError(f"{name}: no line '{said}'")
            log(f"  {name}: '{said}'; epoch lines {got}; a head-only "
                f"checkpoint at step {n_epochs * DRIVER_STEPS}")

        # 8. --device_aug --device_aug_cache: u8 staged images, the crop on
        # the card; epoch 0 stages into the cache, epoch 1 (profiled) reads it
        out = tmp / "driver-device-aug"
        profiled["at"] = (str(out), 1)
        run("driver-device-aug", out, device_aug=True,
            device_aug_cache=str(tmp / "staged"))
        expect("driver-device-aug", 2 * per_epoch, updates=2 * DRIVER_STEPS)
        got, _ = check_run("driver-device-aug", out, [0, 1],
                           (1, 2 * DRIVER_STEPS))
        staged = sorted(p.name for p in (tmp / "staged").glob("staged_*.npy"))
        if staged != ["staged_train_512x256x256x3.npy",
                      "staged_val_128x224x224x3.npy"]:
            raise RuntimeError(f"driver-device-aug: staged files {staged}")
        log(f"  --device_aug: epoch lines {got}; staged {staged}")
    torch.cuda.empty_cache()
    return epochs, extracted, first


# --- data parallelism (ROADMAP module item 9) and --use_grain (item 11) ------

def ddp_nccl_1(card: str, paths: dict, driver_epochs: list,
               driver_lines: dict) -> list[dict]:
    """The driver phase's first run (two epochs, the second profiled) again,
    through init_distributed at world size 1 (EP_TPU_MULTIHOST=1,
    WORLD_SIZE=1): NCCL, the registered (1, 1) mesh and the multi-process
    path's branches. Its training_log.txt must hold the driver phase's epoch
    lines; each epoch's img/s and the profiled epoch's idle share are printed
    beside the driver phase's. Returns its epochs' records."""
    import torch.distributed as dist
    import ep_tpu_torch.cli.linprobe as linprobe
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.ops import reset_launches

    epochs, profiled, seen = [], {"at": None}, {}
    make_mesh = linprobe.make_mesh

    def spy_mesh(*a):
        """The driver's mesh, and the group it was built over."""
        seen.update(mesh=make_mesh(*a), backend=dist.get_backend(),
                    world=dist.get_world_size())
        return seen["mesh"]

    per_epoch = DRIVER_STEPS + DRIVER_EVAL_BATCHES
    with tempfile.TemporaryDirectory() as tmp, \
            environment(EP_TPU_MULTIHOST="1", WORLD_SIZE="1", LOCAL_RANK="0"), \
            mock.patch.object(linprobe, "train_one_epoch", epoch_timer(
                linprobe.train_one_epoch, epochs, profiled)), \
            mock.patch.object(linprobe, "make_mesh", spy_mesh):
        out = Path(tmp) / "ddp-nccl-1"
        out.mkdir()
        profiled["at"] = (str(out), 1)
        log("[ddp-nccl-1] the driver phase's first run through "
            "init_distributed at world size 1 (NCCL): ViT-B/16, EP-32, batch "
            f"128, two epochs, on {card}")
        torch.cuda.synchronize()
        reset_launches()
        try:
            res = linprobe.main(TrainConfig(**{
                **DRIVER_FLAGS, "output_dir": str(out),
                "dist_url": f"file://{tmp}/store"}))
            torch.cuda.synchronize()
            # at one rank no step reduces anything: the group answers one
            # all_reduce on the card
            probe = torch.arange(4.0, device="cuda")
            dist.all_reduce(probe)
            seen["all_reduce"] = probe.tolist()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        paths["ddp-nccl-1"] = dict(launch_counts())
        if (seen.get("backend"), seen.get("world"), seen["mesh"].shape,
                seen["all_reduce"]) != ("nccl", 1, {"data": 1, "model": 1},
                                        [0.0, 1.0, 2.0, 3.0]):
            raise RuntimeError(f"ddp-nccl-1: ran on {seen}")
        _launches_equal("ddp-nccl-1", paths,
                        ln_qkv_gemm=24 * per_epoch, attn_core=24 * per_epoch,
                        proj_residual_gemm=24 * per_epoch,
                        ep_pool=2 * per_epoch, **lars_pair(2 * DRIVER_STEPS),
                        **fc1_gelu(24 * per_epoch))
        got = epoch_lines(out)
        log(f"  epoch lines {got}; the driver phase's {driver_lines}; max "
            f"accuracy {res['max_accuracy']:.2f}%")
        if got != driver_lines:
            raise RuntimeError("ddp-nccl-1: training_log.txt's epoch lines are "
                               "not the non-distributed run's")
        if not (out / "checkpoint-.pth").exists():
            raise RuntimeError("ddp-nccl-1: no checkpoint")
    plain = {e["epoch"]: e for e in driver_epochs if e["run"] == "train"
             and e["epoch"] in (0, 1)}
    for e in epochs:
        p = plain[e["epoch"]]
        log(f"[steps] ddp-nccl-1 epoch {e['epoch']}: {e['img_s']:.1f} img/s"
            + (f", idle share {e['idle_share']:.3f}" if "idle_share" in e
               else "")
            + f"; driver (one process, same run): {p['img_s']:.1f} img/s"
            + (f", idle share {p['idle_share']:.3f}" if "idle_share" in p
               else "") + f" on {card}")
    return epochs


def launch_counts() -> dict:
    from ep_tpu_torch.ops import LAUNCHES
    return dict(LAUNCHES)


GLOO_STEPS, GLOO_BATCH = 4, 512  # the global batch: 256 images a rank


def gloo_config(batch: int):
    """The train phase's configuration at ``batch`` images a rank of a
    global batch of GLOO_BATCH (the LR follows the global batch)."""
    from ep_tpu_torch.configs import TrainConfig
    return TrainConfig(model="vit_base_patch16", cls_features="ep",
                       ep_queries=32, d_out=1, nb_classes=1000,
                       amp="bfloat16", pallas_pool=True, epochs=90,
                       warmup_epochs=10, blr=0.1, batch_size=batch,
                       eff_batch_size=GLOO_BATCH)


def gloo_steps(batch: int, rows: slice, steps: int):
    """``steps`` train steps of the train phase's model (seed 0, on the
    card) on ``rows`` of its GLOO_BATCH images and labels (the same numpy
    draws); under a registered two-rank mesh its weights are broadcast from
    rank 0 first. Returns (model, losses, step seconds, launch counts)."""
    from ep_tpu_torch.models.assembly import (build_backbone_config,
                                              init_probe_model)
    from ep_tpu_torch.ops import reset_launches
    from ep_tpu_torch.parallel.mesh import current_mesh, shard_batch
    from ep_tpu_torch.parallel.partition import shard_state
    from ep_tpu_torch.train.lars import LARS
    from ep_tpu_torch.train.schedule import make_lr_fn
    from ep_tpu_torch.train.state import cast_frozen, freeze
    from ep_tpu_torch.train.steps import make_train_step

    cfg = gloo_config(batch)
    model = init_probe_model(cfg, seed=0, backbone_cfg=build_backbone_config(cfg))
    if current_mesh() is not None:
        shard_state(model, current_mesh())
    opt = LARS(freeze(model, False), weight_decay=0.0)
    cast_frozen(model, torch.bfloat16)
    step_fn = make_train_step(model, opt, make_lr_fn(cfg, 1000))
    rng = np.random.default_rng(0)  # phase 3's images and labels
    images = rng.standard_normal((GLOO_BATCH, 224, 224, 3), dtype=np.float32)
    labels = rng.integers(0, 1000, size=(GLOO_BATCH,))
    x, y = shard_batch((images[rows], labels[rows]))
    torch.cuda.synchronize()
    reset_launches()
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step_fn(i, x, y)["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return model, losses, times, launch_counts()


def ddp_gloo_worker(rank: int, tmp: str) -> None:
    """One of ddp-gloo-2's two ranks (``chip_smoke.py --ddp-gloo-rank R
    --ddp-dir D``): joins a gloo group of two through a file store, lets the
    port's init_distributed see it (and take this rank's card), runs
    GLOO_STEPS train steps on its half of the global batch, then the cached
    extraction's gather on the fake val split, and saves what it saw."""
    import torch.distributed as dist
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.data.datasets import build_datasets
    from ep_tpu_torch.data.loader import DataLoader
    from ep_tpu_torch.data.transforms import build_transforms
    from ep_tpu_torch.ops import _build, reset_launches
    from ep_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                            use_mesh)
    from ep_tpu_torch.train.feature_cache import extract_split

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the card")
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=2)
    init_distributed()
    _build.library()
    half = GLOO_BATCH // 2
    with use_mesh(make_mesh(2, 1)):
        model, losses, times, counts = gloo_steps(
            half, slice(rank * half, (rank + 1) * half), GLOO_STEPS)
        out = dict(losses=losses, times=times, counts=counts,
                   head={k: v.cpu() for k, v in
                         model.head.state_dict().items()})
        # the cached extraction: each rank its 64 of the 128 val images in
        # batches of 32, every batch gathered through the host (gloo)
        cfg = TrainConfig(**{**DRIVER_FLAGS, "batch_size": 32})
        _, val = build_datasets(cfg)
        loader = DataLoader(val, 32, build_transforms(cfg)[1],
                            num_workers=4, num_processes=2,
                            process_index=rank)
        torch.cuda.synchronize()
        reset_launches()
        feats, labels = extract_split(model.features, loader,
                                      torch.device("cuda"), "", "val",
                                      cfg=cfg)
        torch.cuda.synchronize()
        out["extract_counts"] = launch_counts()
        with torch.no_grad():  # this rank's first batch, ungathered
            first = next(iter(loader))[0]
            own = model.features(torch.from_numpy(first).to(
                "cuda", torch.bfloat16)).float().cpu()
        f = torch.from_numpy(np.asarray(feats))
        out.update(extract_shape=tuple(feats.shape), labels=labels,
                   extract_sum=float(f.double().sum()),
                   extract_abs=float(f.double().abs().sum()),
                   own_rows_equal=bool(torch.equal(
                       f[rank * 32:(rank + 1) * 32], own)))
    torch.save(out, Path(tmp) / f"gloo{rank}.pth")
    dist.destroy_process_group()


def start_ranks(flag: str, tmp: str) -> list:
    """Start this script twice as the ranks of a gloo group on the one card
    (``flag`` R ``--ddp-dir tmp``); returns their processes."""
    env = {**os.environ, "WORLD_SIZE": "2", "GLOO_SOCKET_IFNAME": "lo"}
    env.pop("EP_TPU_MULTIHOST", None)
    return [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), flag, str(r),
         "--ddp-dir", tmp],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]


def wait_ranks(procs: list, phase: str, lines: int = 20) -> None:
    """Wait for the ranks start_ranks started, log the last ``lines`` lines
    each printed, and raise unless both exited 0."""
    try:
        said = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, said)):
        for line in text.splitlines()[-lines:]:
            log(f"  [rank {r}] {line}")
        if p.returncode != 0:
            raise RuntimeError(f"{phase}: rank {r} exited with {p.returncode}")


def ddp_gloo_2(card: str, paths: dict, train_loss) -> dict:
    """Two ranks on the one card through gloo, launched as subprocesses
    (ddp_gloo_worker): the train step at full width, 256 images a rank of
    the train phase's 512. Step 0's loss equal on both ranks and within
    LOSS_TOL of the train phase's; the heads bit-equal after GLOO_STEPS
    steps; BN's running statistics within bf16 rounding of one process's
    after the same steps on all 512 images; A to D on each rank; the
    extraction's gathered cache the same on both ranks. The step's ms is
    that of two ranks sharing one card: no speed number."""
    model, ref_losses, _, _ = gloo_steps(GLOO_BATCH, slice(None), GLOO_STEPS)
    ref_bn = {k: getattr(model.head.bn, k).cpu()
              for k in ("running_mean", "running_var")}
    del model
    torch.cuda.empty_cache()
    log(f"[ddp-gloo-2] two ranks on one card (gloo), ViT-B/16 EP-32, "
        f"{GLOO_BATCH // 2} images a rank, {GLOO_STEPS} steps, on {card}; "
        f"one process at batch {GLOO_BATCH}: losses {ref_losses}")
    with tempfile.TemporaryDirectory() as tmp:
        wait_ranks(start_ranks("--ddp-gloo-rank", tmp), "ddp-gloo-2")
        ranks = [torch.load(Path(tmp) / f"gloo{r}.pth", weights_only=False)
                 for r in range(2)]
    r0, r1 = ranks
    log(f"  losses rank 0 {r0['losses']}, rank 1 {r1['losses']}")
    if r0["losses"] != r1["losses"]:
        raise RuntimeError("ddp-gloo-2: the ranks' losses differ")
    # train_loss: the train phase's step 0 at batch 512 (None at another
    # --batch); ref_losses[0]: one process here
    for what, loss in (("the train phase's", train_loss),
                       ("one process's", ref_losses[0])):
        if loss is None:
            continue
        d = abs(r0["losses"][0] - loss)
        log(f"  step 0's loss against {what} {loss:.5f}: |d| {d:.2e} (tol "
            f"{LOSS_TOL:g})")
        if d > LOSS_TOL:
            raise RuntimeError(f"ddp-gloo-2: step 0's loss is not {what}")
    if not all(torch.equal(v, r1["head"][k]) for k, v in r0["head"].items()):
        raise RuntimeError("ddp-gloo-2: the heads differ across ranks")
    for k, ref in ref_bn.items():
        got = r0["head"][f"bn.{k}"]
        bound = STEP * ref.abs() + STEP * ref.abs().mean()
        worst = float(((got - ref).abs() - bound).max())
        log(f"  BN {k}: max |d| {float((got - ref).abs().max()):.3e} against "
            f"one process (bound: a bf16 step of the value and of the mean "
            f"magnitude)")
        if worst > 0:
            raise RuntimeError(f"ddp-gloo-2: BN {k} is not one process's")
    per_step = dict(ln_qkv_gemm=12 * GLOO_STEPS, attn_core=12 * GLOO_STEPS,
                    proj_residual_gemm=12 * GLOO_STEPS, ep_pool=GLOO_STEPS,
                    **lars_pair(GLOO_STEPS), **fc1_gelu(12 * GLOO_STEPS))
    extract = dict(ln_qkv_gemm=12 * 2, attn_core=12 * 2,
                   proj_residual_gemm=12 * 2, **fc1_gelu(12 * 2))
    for r, res in enumerate(ranks):
        paths[f"ddp-gloo-2-rank{r}"] = res["counts"]
        _launches_equal(f"ddp-gloo-2-rank{r}", paths, **per_step)
        paths[f"ddp-gloo-2-extract-rank{r}"] = res["extract_counts"]
        _launches_equal(f"ddp-gloo-2-extract-rank{r}", paths, **extract)
    same = all(r0[k] == r1[k] for k in ("extract_shape", "extract_sum",
                                         "extract_abs")) and \
        np.array_equal(r0["labels"], r1["labels"])
    log(f"  the gathered val cache: {r0['extract_shape']} on both ranks, "
        f"equal: {same}; each rank's own rows in place: "
        f"{r0['own_rows_equal']}, {r1['own_rows_equal']}")
    if not (same and r0["extract_shape"] == (128, 196, 768)
            and r0["own_rows_equal"] and r1["own_rows_equal"]):
        raise RuntimeError("ddp-gloo-2: the gathered cache is wrong")
    med = statistics.median(r0["times"][1:])
    log(f"[steps] ddp-gloo-2: {med * 1e3:.2f} ms a step, two ranks sharing "
        f"one card through gloo ({GLOO_BATCH // 2} images each; not a speed "
        f"number) on {card}")
    return dict(losses=r0["losses"], ref_losses=ref_losses,
                step_ms_two_ranks_sharing_one_card=med * 1e3)


# tp-gloo-2's two runs: run -> (TrainConfig flags, batch, steps, launches a
# step on each rank). (a) DINOv2-g/14 (SwiGLU, LayerScale, 24 heads of width
# 64, depth 40) under "auto": each rank computes its 12 heads and its half
# of w1 and w2 on the plain route, 80 f32 all-reduces of (16, 257, 1536) a
# forward; (b) ViT-B/16 under "pallas": every block joins its pieces and
# runs A, B, C and fc1's GELU epilogue as one process does.
TP_RUNS = {
    "a": (dict(model="dinov2_vitg14"), 16, 3,
          dict(ep_pool=1, lars_norms=1, lars_apply=1, **ls_closings(40))),
    "b": (dict(model="vit_base_patch16", attn_impl="pallas"), 128, 2,
          dict(ln_qkv_gemm=12, attn_core=12, proj_residual_gemm=12,
               ep_pool=1, lars_norms=1, lars_apply=1, **fc1_gelu(12))),
}


def tp_run(run: str, mesh=None) -> dict:
    """One run of tp-gloo-2 on the card: TP_RUNS[run]'s probe model (seed 0,
    EP-32, bf16), built with ``mesh`` registered and cut by shard_state where
    it is given; the backbone's parameter bytes counted from its tensors (and
    the card's allocated bytes after the cut); the backbone's features of the
    batch (run a); then the steps, their losses and times, the launches over
    them and the head. On a cut model, run a's features come with
    ``branch_check``: DINOv2's LayerScale gammas start at 1e-5, where every
    block's branch rounds away in bf16 (the features are the patch
    embedding's whatever the blocks compute), so the blocks' own compute is
    checked before LayerScale."""
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.models.assembly import init_probe_model
    from ep_tpu_torch.ops import reset_launches
    from ep_tpu_torch.parallel.mesh import use_mesh
    from ep_tpu_torch.parallel.partition import shard_state
    from ep_tpu_torch.train.lars import LARS
    from ep_tpu_torch.train.schedule import make_lr_fn
    from ep_tpu_torch.train.state import cast_frozen, freeze
    from ep_tpu_torch.train.steps import make_train_step

    flags, B, steps, _ = TP_RUNS[run]
    cfg = TrainConfig(cls_features="ep", ep_queries=32, d_out=1,
                      nb_classes=1000, amp="bfloat16", pallas_pool=True,
                      epochs=90, warmup_epochs=10, blr=0.1, batch_size=B,
                      eff_batch_size=B, **flags)
    out = {}
    with use_mesh(mesh):
        t0 = time.perf_counter()
        model = init_probe_model(cfg, seed=0)  # built under the mesh
        opt = LARS(freeze(model, False), weight_decay=0.0)
        cast_frozen(model, torch.bfloat16)
        torch.cuda.synchronize()
        out["built_s"] = time.perf_counter() - t0
        if mesh is not None:
            t0 = time.perf_counter()
            shard_state(model, mesh)
            torch.cuda.synchronize()
            out["cut_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            out["allocated"] = torch.cuda.memory_allocated()
        out["backbone_bytes"] = sum(p.numel() * p.element_size()
                                    for p in model.backbone.parameters())
        step_fn = make_train_step(model, opt, make_lr_fn(cfg, 1000))
        rng = np.random.default_rng(0)
        images = torch.from_numpy(rng.standard_normal(
            (B, 224, 224, 3), dtype=np.float32)).cuda()
        labels = torch.from_numpy(rng.integers(0, 1000, size=(B,))).cuda()
        if run == "a":
            with branch_check(model, mesh is not None) as out["branches"]:
                with torch.no_grad():
                    out["feats"] = model.features(images).float().cpu()
        torch.cuda.synchronize()
        reset_launches()
        out["losses"], out["times"] = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            out["losses"].append(float(step_fn(i, images, labels)["loss"]))
            torch.cuda.synchronize()
            out["times"].append(time.perf_counter() - t0)
        out["counts"] = launch_counts()
        out["head"] = {k: v.cpu() for k, v in model.head.state_dict().items()}
    return out


@contextlib.contextmanager
def branch_check(model, cut: bool):
    """While a forward runs (where ``cut``), hold each block's attention and
    MLP branch (before LayerScale) to the same module run on the same input
    with its pieces joined, which is what one process computes (the plain
    route, F.linear where the cut module sums its partial products in f32):
    within ATOL + RTOL*|ref| everywhere. Yields {kind: [the largest |d|, the
    largest |d| - (ATOL + RTOL*|ref|), the modules checked]}."""
    from ep_tpu_torch.parallel.partition import whole_tensors
    worst = {"attn": [0.0, -math.inf, 0], "mlp": [0.0, -math.inf, 0]}

    def hook(kind):
        def check(module, args, out):
            with whole_tensors(module):
                ref = type(module).forward(module, *args).float()
            d = (out.float() - ref).abs()
            w = worst[kind]
            w[0] = max(w[0], float(d.max()))
            w[1] = max(w[1], float((d - ATOL - RTOL * ref.abs()).max()))
            w[2] += 1
        return check

    handles = [m.register_forward_hook(hook(kind))
               for blk in (model.backbone.blocks if cut else ())
               for kind, m in (("attn", blk.attn), ("mlp", blk.mlp))]
    try:
        yield worst
    finally:
        for h in handles:
            h.remove()


def tp_gloo_worker(rank: int, tmp: str) -> None:
    """One of tp-gloo-2's two ranks (``chip_smoke.py --tp-gloo-rank R
    --ddp-dir D``): joins a gloo group of two through a file store, lets the
    port's init_distributed see it, runs both TP_RUNS on the mesh (data 1,
    model 2) and saves what it saw."""
    import torch.distributed as dist
    from ep_tpu_torch.ops import _build
    from ep_tpu_torch.parallel.mesh import init_distributed, make_mesh

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the card")
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=2)
    init_distributed()
    _build.library()
    mesh = make_mesh(1, 2)
    out = {}
    for run in TP_RUNS:
        out[run] = tp_run(run, mesh)
        print(f"tp-gloo-2 ({run}) rank {rank}: losses {out[run]['losses']}, "
              f"built in {out[run]['built_s']:.1f} s, replicated and cut in "
              f"{out[run]['cut_s']:.1f} s", flush=True)
    torch.save(out, Path(tmp) / f"tp{rank}.pth")
    dist.destroy_process_group()


def tp_gloo_2(card: str, paths: dict) -> dict:
    """The frozen backbone cut over a model axis of 2 (shard_state), two
    ranks on the one card through gloo (tp_gloo_worker), against one process
    on the same weights and batch: (a) DINOv2-g/14 at batch 16 under "auto",
    each rank's backbone bytes at most 0.51 of one process's, every block's
    attention and MLP branch within ATOL + RTOL*|ref| of the same module with
    its pieces joined (branch_check), step 0's loss within LOSS_TOL and the
    features within FEATURE_TOL of one process's, the heads bit-equal, B
    never and D once a step; (b) ViT-B/16 at batch
    128 under "pallas" (the joined pieces through A, B and C), A, B and C 12
    times and D once a step, step 0's loss within LOSS_TOL. The step times
    are those of two ranks sharing one card with their sums through the
    host: no speed number."""
    with tempfile.TemporaryDirectory() as tmp:
        # the ranks build their models while this process runs the same
        # steps as one process
        procs = start_ranks("--tp-gloo-rank", tmp)
        refs = {}
        try:
            for run in TP_RUNS:
                refs[run] = tp_run(run)
                torch.cuda.empty_cache()
        finally:
            wait_ranks(procs, "tp-gloo-2", lines=4)
        ranks = [torch.load(Path(tmp) / f"tp{r}.pth", weights_only=False)
                 for r in range(2)]
    log(f"[tp-gloo-2] two ranks on one card (gloo), mesh (data 1, model 2), "
        f"on {card}; one process (beside the ranks): (a) DINOv2-g/14 losses "
        f"{refs['a']['losses']}, (b) ViT-B/16 losses {refs['b']['losses']}")
    out = {}
    for run, (flags, B, steps, per_step) in TP_RUNS.items():
        ref, (r0, r1) = refs[run], (ranks[0][run], ranks[1][run])
        what = f"tp-gloo-2 ({run}) {flags['model']} batch {B}"
        log(f"  {what}: losses rank 0 {r0['losses']}, rank 1 {r1['losses']}")
        if r0["losses"] != r1["losses"]:
            raise RuntimeError(f"{what}: the ranks' losses differ")
        if not all(torch.equal(v, r1["head"][k]) for k, v in r0["head"].items()):
            raise RuntimeError(f"{what}: the heads differ across ranks")
        d = abs(r0["losses"][0] - ref["losses"][0])
        log(f"  step 0's loss against one process's {ref['losses'][0]:.5f}: "
            f"|d| {d:.2e} (tol {LOSS_TOL:g})")
        if d > LOSS_TOL:
            raise RuntimeError(f"{what}: step 0's loss is not one process's")
        for r, res in enumerate((r0, r1)):
            share = res["backbone_bytes"] / ref["backbone_bytes"]
            log(f"  rank {r}: backbone parameters {res['backbone_bytes']} bytes"
                f", {share:.4f} of one process's {ref['backbone_bytes']}; "
                f"allocated on the card after the cut "
                f"{res['allocated'] / 2 ** 30:.3f} GiB")
            if run == "a" and share > 0.51:
                raise RuntimeError(f"{what}: rank {r} holds {share:.4f} of the "
                                   "backbone's bytes")
            name = f"tp-gloo-2-{run}-rank{r}"
            paths[name] = res["counts"]
            _launches_equal(name, paths,
                            **{k: n * steps for k, n in per_step.items()})
        if run == "a":
            for r, res in enumerate((r0, r1)):
                for kind, (err, over, n) in res["branches"].items():
                    log(f"  rank {r}: {n} {kind} branches (before LayerScale)"
                        f" against the same modules with their pieces "
                        f"joined: max |d| {err:.3e}, worst |d| - (tol "
                        f"{ATOL:g} + {RTOL:g}*|ref|) {over:.3e}")
                    if n != 40 or over > 0:
                        raise RuntimeError(f"{what}: rank {r}'s cut {kind} "
                                           "branches are not one process's")
            scale = float(ref["feats"].abs().max())
            err = float((r0["feats"] - ref["feats"]).abs().max())
            log(f"  features {tuple(r0['feats'].shape)} against one "
                f"process's: max |d| {err:.3e} (tol {FEATURE_TOL:g} of the "
                f"largest, {scale:.3f}; at LayerScale 1e-5 the branches "
                f"round away in bf16, which the branch check does not)")
            if err > FEATURE_TOL * scale:
                raise RuntimeError(f"{what}: the features are not one "
                                   "process's")
        med = statistics.median(r0["times"][1:])
        log(f"[steps] tp-gloo-2 ({run}): {med * 1e3:.2f} ms a step, two ranks "
            f"sharing one card through gloo ({B} images each; not a speed "
            f"number); one process at batch {B} beside them "
            f"{statistics.median(ref['times'][1:]) * 1e3:.2f} ms, on {card}")
        out[run] = dict(
            losses=r0["losses"], ref_losses=ref["losses"],
            backbone_bytes=[r0["backbone_bytes"], r1["backbone_bytes"]],
            ref_backbone_bytes=ref["backbone_bytes"],
            allocated_after_cut=[r0["allocated"], r1["allocated"]],
            step_ms_two_ranks_sharing_one_card=med * 1e3,
            one_process_step_ms_beside_the_ranks=statistics.median(
                ref["times"][1:]) * 1e3)
    return out


def grain_phase(card: str, paths: dict) -> dict:
    """--use_grain where the grain package imports: one driver epoch (ViT-B/16,
    batch 128) on the grain loader; where it does not, one line says so."""
    import importlib.util
    found = importlib.util.find_spec("grain") is not None
    log(f"[use-grain] the grain package imports on this machine: {found}")
    if not found:
        log("[use-grain] not run: no grain package (--use_grain raises "
            "without it, as in the JAX package)")
        return dict(grain=False)
    import ep_tpu_torch.cli.linprobe as linprobe
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.ops import reset_launches
    epochs = []
    with tempfile.TemporaryDirectory() as tmp, mock.patch.object(
            linprobe, "train_one_epoch",
            epoch_timer(linprobe.train_one_epoch, epochs, {"at": None})):
        reset_launches()
        linprobe.main(TrainConfig(**{**DRIVER_FLAGS, "epochs": 1,
                                     "num_workers": 2, "use_grain": True,
                                     "output_dir": tmp}))
        paths["use-grain"] = launch_counts()
        lines = epoch_lines(Path(tmp))
    per_epoch = DRIVER_STEPS + DRIVER_EVAL_BATCHES
    _launches_equal("use-grain", paths, ln_qkv_gemm=12 * per_epoch,
                    attn_core=12 * per_epoch,
                    proj_residual_gemm=12 * per_epoch, ep_pool=per_epoch,
                    **lars_pair(DRIVER_STEPS), **fc1_gelu(12 * per_epoch))
    if list(lines) != [0] or not all(math.isfinite(v) for v in lines[0]):
        raise RuntimeError(f"use-grain: epoch lines {lines}")
    log(f"[steps] use-grain epoch 0: {epochs[0]['img_s']:.1f} img/s on {card}")
    return dict(grain=True, epochs=epochs)


# --- the backbone family (DINOv2, CAPI, OpenCLIP, SimMIM, MAE) ---------------

# The backbone family's probe paths at published widths and depths: batch,
# TrainConfig flags, the launches of one forward (every other count zero)
_DINOV2_L = dict(model="dinov2_vitl14_reg")
BACKBONE_CONFIGS = {
    "probe-dinov2-l": (512, _DINOV2_L, dict(attn_core=24, ep_pool=1,
                                            **fc1_gelu(24), **ls_closings(24))),
    "probe-dinov2-g": (64, dict(model="dinov2_vitg14_reg"),
                       dict(attn_core=40, swiglu_gate=40, ep_pool=1,
                            **ls_closings(40))),
    "probe-dinov3-7b": (8, dict(model="dinov3_vit7b16", image_size=448,
                                return_block=1),
                        dict(rope_qk=2, attn_flash=2, swiglu_gate=2,
                             ep_pool=1, **ls_closings(2))),
    "probe-capi": (512, dict(model="capi_vitl14"),
                   dict(ln_qkv_gemm=24, attn_core=24, proj_residual_gemm=24,
                        ep_pool=1, **fc1_gelu(24))),
    "probe-clip-b": (512, dict(model="ViT-B-16", openclip=True,
                               cls_features="cls"),
                     dict(ln_qkv_gemm=12, attn_core=12, proj_residual_gemm=12)),
    "probe-simmim": (512, dict(simmim=True), dict(ep_pool=1, **fc1_gelu(12),
                                                  **ls_closings(12))),
    "probe-mae-l": (512, dict(model="mae_vit_large_patch16"),
                    dict(ln_qkv_gemm=24, attn_core=24, proj_residual_gemm=24,
                         ep_pool=1, **fc1_gelu(24))),
}


def backbone_probes(card: str, paths: dict, steps: int) -> dict:
    """The probe-training step of each backbone family (``_train`` with the
    family's launches), and the logits of 4 images against the CPU plain
    path for DINOv2-L and, in cls mode (the register mean), CAPI."""
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.models.assembly import init_probe_model
    from ep_tpu_torch.train.state import cast_frozen, freeze
    out = {}
    for kind, (B, flags, per_forward) in BACKBONE_CONFIGS.items():
        model, images, paths[kind], med, _ = _train(
            kind, B, steps, card, flags, None, None, per_forward=per_forward)
        out[kind] = dict(batch=B, step_ms=med * 1e3, img_s=B / med)
        if kind == "probe-dinov2-l":
            cross_check(model, images, "DINOv2-L/14 with registers, the plain "
                        "route (B), EP-32")
        if kind == "probe-clip-b" and model.head.fc.weight.shape[1] != 512:
            raise RuntimeError("probe-clip-b: the head is not proj_dim wide")
        if kind == "probe-capi":
            cfg = TrainConfig(cls_features="cls", nb_classes=1000,
                              amp="bfloat16", **flags)
            cls_model = init_probe_model(cfg, seed=0)
            freeze(cls_model, False)
            cast_frozen(cls_model, torch.bfloat16)
            cross_check(cls_model, images, "CAPI-L/14 cls mode (the mean of "
                        "16 registers), A, B, C")
            del cls_model
        del model, images
        torch.cuda.empty_cache()
    return out


FEATURE_MODES = ("cp1", "cp2", "cp3", "cp4", "ca1", "ca2", "ca3", "ca4",
                 "attn-mn", "attn-lcte", "raw", "dino", "rb6")


def features_b(card: str, paths: dict) -> dict:
    """Every feature mode past cls/pos/gap on frozen ViT-B/16 (seed 0) and
    the DINO oracle (a ViT-B/16, seed 0's draw after the backbone):
    ``cp*``, ``ca*``, ``attn-*``, ``raw``, ``dino`` and ``--return_block 6``
    (``rb6``, cls features). Each mode's features of 4 images on the card
    against the CPU plain path (one CPU forward of the backbone with its last
    block's probabilities, the oracle's, and 7 blocks for rb6), with its
    launches; then its forward at batch 512 timed. The capturing modes take
    A, B and C 11 times and the last block on the plain route; dino adds the
    oracle's forward (its last block captured); rb6 runs 7 blocks. The 4
    images are the first of 16 whose two lowest head entropies (attn-lcte's
    argmin) differ by 1e-3 or more on the card. Each mode's features are held
    to FEATURE_TOL of their largest magnitude."""
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.models.assembly import init_probe_model
    from ep_tpu_torch.models.vit import select_features
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.poolings.common import mean_f32
    from ep_tpu_torch.train.state import cast_frozen, freeze

    cfg = TrainConfig(model="vit_base_patch16", cls_features="dino",
                      nb_classes=1000, amp="bfloat16")
    pm = init_probe_model(cfg, seed=0)
    freeze(pm, False)
    cast_frozen(pm, torch.bfloat16)
    pm.eval()
    rng = np.random.default_rng(4)
    pool = torch.from_numpy(rng.standard_normal((16, 224, 224, 3),
                                                dtype=np.float32)).cuda()
    with torch.no_grad():
        _, (probs, _) = pm.backbone(pool, "cls", return_final_attn=True)
        cls_pos = probs[:, :, 0, 1:]
        wo = cls_pos / (cls_pos.sum(2, keepdim=True) + 1e-6)
        ent = (-(wo * torch.log(wo + 1e-6)).sum(2)).sort(dim=1).values
        gap = (ent[:, 1] - ent[:, 0]).cpu()
    keep = [i for i in range(16) if gap[i] >= 1e-3][:4]
    if len(keep) < 4:
        raise RuntimeError(f"features-b: entropy gaps {gap.tolist()}")
    x = pool[keep]
    log(f"[features-b] ViT-B/16 + the ViT-B/16 oracle, bf16, images {keep} "
        f"of 16 (entropy gaps {[round(float(gap[i]), 4) for i in keep]}) "
        f"on {card}")
    cpu = copy.deepcopy(pm).cpu()
    xc = x.cpu()
    with torch.no_grad():
        _, (p_c, tok_c) = cpu.backbone(xc, "cls", return_final_attn=True)
        _, (d_c, _) = cpu.oracle(xc, "cls", return_final_attn=True)
        rb_c = cpu.backbone(xc, "cls", 6)
    fm = tok_c[:, 1:]
    ref = {m: select_features(m, tok_c, tok_c[:, 0], fm, p_c)
           for m in FEATURE_MODES[:11]}
    ref["dino"] = mean_f32(fm[:, None] * d_c[:, :, 0, 1:, None].to(fm.dtype),
                           (1, 2))
    ref["rb6"] = rb_c
    # the captured last block's MLP takes the epilogue too
    per_forward = {m: dict(ln_qkv_gemm=11, attn_core=11, proj_residual_gemm=11,
                           **fc1_gelu(12))
                   for m in FEATURE_MODES[4:10]}  # ca*, attn-*
    per_forward.update({m: dict(ln_qkv_gemm=12, attn_core=12,
                                proj_residual_gemm=12, **fc1_gelu(12))
                        for m in FEATURE_MODES[:4] + ("raw",)})
    per_forward.update(
                       dino=dict(ln_qkv_gemm=23, attn_core=23,
                                 proj_residual_gemm=23, **fc1_gelu(24)),
                       rb6=dict(ln_qkv_gemm=7, attn_core=7,
                                proj_residual_gemm=7, **fc1_gelu(7)))
    big = torch.from_numpy(rng.standard_normal((512, 224, 224, 3),
                                               dtype=np.float32)).cuda()
    out = {}
    for m in FEATURE_MODES:
        pm.mode, pm.return_block = ("cls", 6) if m == "rb6" else (m, None)
        reset_launches()
        with torch.no_grad():
            got = pm.features(x)
        counts = dict(LAUNCHES)
        want = {**dict.fromkeys(LAUNCHES, 0), **per_forward[m]}
        log(f"  {m}: launches {({k: v for k, v in counts.items() if v})} "
            f"(expected {per_forward[m]})")
        if counts != want:
            raise RuntimeError(f"features-b {m}: launches {counts}")
        compare(f"{m} features {tuple(got.shape)}", got.cpu(), ref[m],
                atol=FEATURE_TOL * float(ref[m].float().abs().max()), rtol=0)
        with torch.no_grad():
            ms = time_ms(lambda: pm.features(big), 3)
        out[m] = dict(batch=512, forward_ms=ms, img_s=512e3 / ms)
        log(f"    forward at batch 512: {ms:.2f} ms, {512e3 / ms:.1f} img/s "
            f"on {card}")
    del pm, cpu, pool, big
    torch.cuda.empty_cache()
    return out


def driver_backbones(card: str, paths: dict) -> list[dict]:
    """main_linprobe_torch.py's main on the backbone family: --model
    dinov2_vitb14_reg --cls_features ep for one epoch (B 12 times a forward,
    A and C never); --eval --finetune of a DINOv2-hub-layout .pth
    (``register_tokens``, ``blocks.i.ls1.gamma``, a ``mask_token``) written
    from seed 1's backbone, whose logits the driver's model must give; then
    --cls_features dino --oracle_ckpt of a timm-layout ViT-B/16 .pth written
    from seed 2's backbone, one epoch on ViT-B/16 (A, B and C 23 times a
    forward: 12 for the backbone, 11 for the oracle)."""
    import ep_tpu_torch.cli.linprobe as linprobe
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.train.state import cast_frozen

    built, runs = [], []
    build_model = linprobe.init_probe_model

    def keep_model(*a, **kw):
        built.append(build_model(*a, **kw))
        return built[-1]

    def run(name, out, **kw):
        cfg = TrainConfig(**{**DRIVER_FLAGS, "epochs": 1,
                             "output_dir": str(out), **kw})
        out.mkdir(parents=True, exist_ok=True)
        built.clear()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = linprobe.main(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        paths[name] = dict(LAUNCHES)
        runs.append(dict(run=name, wall_s=wall))
        log(f"  [{name}] {wall:.1f} s, launches "
            f"{ {k: v for k, v in paths[name].items() if v} }")
        return res

    def expect(name, forwards, updates=0, **per_forward):
        want = {**dict.fromkeys(LAUNCHES, 0), **lars_pair(updates)}
        want.update({k: n * forwards for k, n in per_forward.items()})
        if paths[name] != want:
            raise RuntimeError(f"{name}: launches {paths[name]}, expected {want}")

    per_epoch = DRIVER_STEPS + DRIVER_EVAL_BATCHES
    images = rand(np.random.default_rng(3), (8, 224, 224, 3),
                  dtype=torch.float32)
    with mock.patch.object(linprobe, "init_probe_model", keep_model), \
            tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        log(f"[driver-dinov2] main_linprobe_torch.py's main: "
            f"dinov2_vitb14_reg, EP-32, batch 128, the fake dataset, on {card}")
        res = run("driver-dinov2", tmp / "dinov2", model="dinov2_vitb14_reg")
        expect("driver-dinov2", per_epoch, DRIVER_STEPS, attn_core=12,
               ep_pool=1, **fc1_gelu(12), **ls_closings(12))
        if not math.isfinite(res["loss"]):
            raise RuntimeError(f"driver-dinov2: {res}")
        log(f"  one epoch: {res}")

        cfg = TrainConfig(**{**DRIVER_FLAGS, "model": "dinov2_vitb14_reg"})
        bcfg = linprobe.build_backbone_config(cfg)
        source = build_model(cfg, 1, bcfg)
        source.head.load_state_dict(build_model(cfg, 0, bcfg).head.state_dict())
        hub = {("register_tokens" if k == "reg_token" else k): v.cpu()
               for k, v in source.backbone.state_dict().items()}
        hub["mask_token"] = torch.zeros(1, 768)
        if "blocks.0.ls1.gamma" not in hub:
            raise RuntimeError("driver-dinov2: no hub LayerScale names")
        pth = tmp / "dinov2_vitb14_reg4_pretrain.pth"
        torch.save(hub, pth)
        run("driver-dinov2-finetune", tmp / "dinov2-ft", model="dinov2_vitb14_reg",
            finetune=str(pth), eval=True)
        expect("driver-dinov2-finetune", DRIVER_EVAL_BATCHES, attn_core=12,
               ep_pool=1, **fc1_gelu(12), **ls_closings(12))
        cast_frozen(source, torch.bfloat16)
        with torch.no_grad():
            got, ref = built[0].eval()(images), source.eval()(images)
        compare("--finetune of the hub layout: the driver's logits against "
                "the written model's", got, ref)
        del source, built[:]

        cfg = TrainConfig(**DRIVER_FLAGS)
        oracle_src = build_model(cfg, 2, linprobe.build_backbone_config(cfg))
        written = {k: v.cpu() for k, v in oracle_src.backbone.state_dict().items()}
        pth = tmp / "dino_vitb16.pth"
        torch.save({"model": written}, pth)
        del oracle_src
        res = run("driver-dino", tmp / "dino", cls_features="dino",
                  oracle_ckpt=str(pth))
        expect("driver-dino", per_epoch, DRIVER_STEPS, ln_qkv_gemm=23,
               attn_core=23, proj_residual_gemm=23, **fc1_gelu(24))
        held = built[0].oracle.state_dict()  # cast to bf16 for probing
        same = all(torch.equal(held[k].cpu(), v.to(held[k].dtype))
                   for k, v in written.items())
        if not same or not math.isfinite(res["loss"]):
            raise RuntimeError(f"driver-dino: oracle loaded {same}, {res}")
        log(f"  --cls_features dino --oracle_ckpt: the oracle holds the "
            f"file's {len(written)} tensors; one epoch: {res}")
        del built[:]
    torch.cuda.empty_cache()
    return runs


# --- attention statistics and the tools (ROADMAP module item 8) --------------

# The attention-statistics table, card against CPU: each of the 10 stats of
# every block within ATTN_STATS_TOL of that stat's largest value over the
# blocks. Both sides compute the same plain route in bf16 with f32 logits,
# softmax and statistics; what differs is the summation order of the bf16
# products, which moves single probabilities by about a bf16 step of their
# logits, and a table entry is a mean over 64 x 12 x 196 of them.
ATTN_STATS_TOL = 2e-2
# The pool's attention map of the EP head, card against CPU, against its
# largest value (the zoo phase's bound for return_attn maps).
POOL_MAP_TOL = 5e-2
# Rows of a probability map sum to 1 within this.
ROW_SUM_TOL = 1e-3
# MAE's loss, card against CPU, relative: a mean over 128 x 147 masked
# patches of 768 squared errors.
MAE_LOSS_RTOL = 2e-3
TOOL_FLAGS = ["--model", "vit_base_patch16", "--dataset_name", "fake",
              "--nb_classes", "10", "--image_size", "224", "--amp",
              "bfloat16", "--num_workers", "8"]


def _launches_equal(name: str, paths: dict, **want) -> None:
    from ep_tpu_torch.ops import LAUNCHES
    full = {**dict.fromkeys(LAUNCHES, 0), **want}
    log(f"  {name}: launches {({k: v for k, v in paths[name].items() if v})} "
        f"(expected {want})")
    if paths[name] != full:
        raise RuntimeError(f"{name}: launches {paths[name]}, expected {full}")


def attn_stats_b(card: str, paths: dict, tmp) -> dict:
    """main_attention_stats_torch.py's main on frozen ViT-B/16 at full width
    and depth, its weights from a seed-0 timm-layout checkpoint (--finetune),
    on ``fake``'s 128 val images at batch 64 (2 batches): no kernel launches
    (every block takes the plain route with its probabilities, as in the JAX
    package), the JSON written, the probability stats in [0, 1], and the
    (10, 12) table against the CPU's run of the same main on the same
    weights and images (each stat within ATTN_STATS_TOL of its largest
    value). Then the capture forward alone at batch 512 on random images."""
    import ep_tpu_torch.cli.attention_stats as AS
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.ops import LAUNCHES, reset_launches

    cfg = TrainConfig(model="vit_base_patch16", image_size=224)
    src = AS.build_model(cfg, torch.device("cpu"))
    pth = tmp / "vit_base_seed0.pth"
    torch.save({"model": {f"module.{k}": v
                          for k, v in src.state_dict().items()}}, pth)
    del src
    log(f"[attn-stats-b] main_attention_stats_torch.py's main: ViT-B/16 "
        f"(--finetune of a seed-0 timm-layout .pth), the fake dataset's 128 "
        f"val images, batch 64, bf16, on {card}")
    summaries = {}
    for dev in ("cuda", "cpu"):
        args = AS.get_args_parser().parse_args(
            ["--model", "vit_base_patch16", "--dataset_name", "fake",
             "--batch_size", "64", "--max_batches", "2", "--finetune",
             str(pth), "--output_dir", str(tmp / f"attn-{dev}"),
             "--num_workers", "8", "--device", dev])
        reset_launches()
        t0 = time.perf_counter()
        summaries[dev] = AS.main(args)
        wall = time.perf_counter() - t0
        log(f"  the {dev} run: {wall:.1f} s")
        if dev == "cuda":
            paths["attn-stats-b"] = dict(LAUNCHES)
    _launches_equal("attn-stats-b", paths, **fc1_gelu(12 * 2))
    written = json.loads((tmp / "attn-cuda" / "attention_stats.json")
                         .read_text())
    if written != summaries["cuda"] or list(written) != AS.STAT_NAMES:
        raise RuntimeError("attn-stats-b: attention_stats.json")
    got = np.array([written[n] for n in AS.STAT_NAMES])
    ref = np.array([summaries["cpu"][n] for n in AS.STAT_NAMES])
    probs = got[:6]
    if got.shape != (10, 12) or not np.isfinite(got).all() or (
            probs.min() < 0 or probs.max() > 1):
        raise RuntimeError(f"attn-stats-b: table {got.tolist()}")
    rel = np.abs(got - ref).max(1) / np.abs(ref).max(1)
    ok = bool((rel <= ATTN_STATS_TOL).all())
    for n, r, row in zip(AS.STAT_NAMES, rel, got):
        log(f"    {n:32s} blocks 0, 5, 11: {row[0]:.5f} {row[5]:.5f} "
            f"{row[11]:.5f}; card vs CPU max |d| / max |ref| {r:.2e}")
    log(f"  the (10, 12) table, card against CPU: worst {rel.max():.2e} of "
        f"a stat's largest value (tol {ATTN_STATS_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("attn-stats-b: the card's table is not the CPU's")

    model = AS.build_model(cfg.replace(finetune=str(pth)), torch.device("cuda"))
    x = rand(np.random.default_rng(5), (512, 224, 224, 3))
    with torch.no_grad():
        ms = time_ms(lambda: model(x, "cls", capture_stats=True), 3)
    log(f"  the capture forward (12 blocks with probabilities, statistics "
        f"and magnitudes) at batch 512: {ms:.2f} ms, {512e3 / ms:.1f} img/s "
        f"on {card}")
    del model, x
    torch.cuda.empty_cache()
    return dict(table_rel_err=float(rel.max()), batch=512, capture_ms=ms,
                capture_img_s=512e3 / ms)


def _timed_tool(main, argv, name: str, paths: dict) -> tuple:
    """A tool's main on the card, its launches in ``paths[name]``, and the
    seconds from its first batch on the card to its end (the loop)."""
    import ep_tpu_torch.tools.extract_features as EF
    import ep_tpu_torch.tools.extract_pool_attention as PA
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    first = []
    real = EF.to_device

    def stamped(*a, **kw):
        if not first:
            torch.cuda.synchronize()
            first.append(time.perf_counter())
        return real(*a, **kw)

    reset_launches()
    with mock.patch.object(EF, "to_device", stamped), \
            mock.patch.object(PA, "to_device", stamped):
        out = main(argv)
    torch.cuda.synchronize()
    loop = time.perf_counter() - first[0]
    paths[name] = dict(LAUNCHES)
    return out, loop


def _cpu_probe(flags: list, head_ckpt: str, split: str, n: int):
    """The tools' probe model on the CPU (the plain path) with the tools'
    flags and checkpoint, and the first ``n`` images of ``split`` as the
    tools' loader gives them (the val transform, in order)."""
    import argparse

    import ep_tpu_torch.tools.extract_features as EF
    from ep_tpu_torch.configs import config_from_args, get_args_parser
    from ep_tpu_torch.data.datasets import build_datasets
    from ep_tpu_torch.data.transforms import build_transforms

    cfg = config_from_args(argparse.ArgumentParser(
        parents=[get_args_parser()]).parse_args(flags + ["--device", "cpu"]))
    model, _ = EF.build_probe(cfg, head_ckpt)
    transform_val = build_transforms(cfg)[1]
    ds = build_datasets(cfg)[0 if split == "train" else 1]
    x = np.stack([transform_val(ds[i][0]) for i in range(n)])
    return model, torch.from_numpy(x).to(torch.bfloat16)


def extract_features_phase(card: str, paths: dict, ckpt, tmp) -> dict:
    """python -m ep_tpu_torch.tools.extract_features on the driver phase's
    EP checkpoint (--head_ckpt, the val split: one batch of 128; A, B and C
    12 times, D once) and with --cls_features cls and no head (the train
    split: 4 batches of 128; A, B and C 48 times, D never); the features of
    the first 4 images against the CPU plain path's on the same weights
    within FEATURE_TOL of their largest magnitude (features-b's bound), the
    logits within MODEL_ATOL + MODEL_RTOL*|ref|; img/s from the first batch
    on the card to the written file."""
    import ep_tpu_torch.tools.extract_features as EF

    log(f"[extract-features] python -m ep_tpu_torch.tools.extract_features: "
        f"ViT-B/16, the fake dataset, batch 128, bf16, on {card}")
    runs = {  # name -> (model flags, head checkpoint, split, launches)
        "extract-features": (["--cls_features", "ep", "--ep_queries", "32"],
                             str(ckpt), "val",
                             dict(ln_qkv_gemm=12, attn_core=12,
                                  proj_residual_gemm=12, ep_pool=1,
                                  **fc1_gelu(12))),
        "extract-features-cls": (["--cls_features", "cls"], "", "train",
                                 dict(ln_qkv_gemm=48, attn_core=48,
                                      proj_residual_gemm=48,
                                      **fc1_gelu(48))),
    }
    out = {}
    for name, (mode, head, split, want) in runs.items():
        flags = TOOL_FLAGS + ["--batch_size", "128"] + mode
        argv = flags + ["--split", split, "--out", str(tmp / f"{name}.npz")]
        if head:
            argv += ["--head_ckpt", head]
        payload, loop = _timed_tool(EF.main, argv, name, paths)
        _launches_equal(name, paths, **want)
        n = len(payload["labels"])
        log(f"  {name}: {n} images to features "
            f"{tuple(payload['features'].shape)} in {loop:.3f} s from the "
            f"first batch on the card to the written file, "
            f"{n / loop:.1f} img/s on {card}")
        model, x = _cpu_probe(flags, head, split, 4)
        with torch.no_grad():
            logits, feats = model(x, return_backbone_features=True)
        # tokens without a final norm reach about 16 (features-b's bound)
        compare(f"{name} features {tuple(feats.shape)} of 4 images, card "
                "vs CPU", torch.from_numpy(payload["features"][:4]), feats,
                FEATURE_TOL * float(feats.float().abs().max()), 0)
        if head:
            compare(f"{name} logits of 4 images, card vs CPU",
                    torch.from_numpy(payload["logits"][:4]), logits,
                    MODEL_ATOL, MODEL_RTOL)
        out[name] = dict(images=n, loop_s=loop, img_s=n / loop)
        del model
    return out


def pool_attention_phase(card: str, paths: dict, ckpt, tmp) -> dict:
    """python -m ep_tpu_torch.tools.extract_pool_attention on the driver
    phase's EP checkpoint (--resume), 8 val images: the map (B, Q, N) from
    the plain pool, its rows summing to 1 within ROW_SUM_TOL, within
    POOL_MAP_TOL of its largest value of the CPU's map on the same weights
    and images; the logits from kernel D (A, B and C 12 times, D once)."""
    import ep_tpu_torch.tools.extract_pool_attention as PA

    log(f"[pool-attention] python -m ep_tpu_torch.tools."
        f"extract_pool_attention: ViT-B/16 + EP-32, 8 val images, bf16, "
        f"on {card}")
    flags = TOOL_FLAGS + ["--cls_features", "ep", "--ep_queries", "32"]
    (attn, labels, preds), _ = _timed_tool(
        PA.main, flags + ["--resume", str(ckpt), "--n_images", "8", "--out",
                          str(tmp / "pool_attention.npz")],
        "pool-attention", paths)
    _launches_equal("pool-attention", paths, ln_qkv_gemm=12, attn_core=12,
                    proj_residual_gemm=12, ep_pool=1, **fc1_gelu(12))
    saved = np.load(tmp / "pool_attention.npz")
    rows = np.abs(attn.sum(-1) - 1).max()
    ok = attn.shape == (8, 32, 196) and rows <= ROW_SUM_TOL and np.array_equal(
        saved["attention"], attn)
    log(f"  map {attn.shape}, rows sum to 1 within {rows:.2e} (tol "
        f"{ROW_SUM_TOL:g}), written {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("pool-attention: the map")
    model, x = _cpu_probe(flags, str(ckpt), "val", 8)
    logits, ref = PA.extract(model, x)
    compare("the pool's map (8, 32, 196), card vs CPU",
            torch.from_numpy(attn), ref,
            POOL_MAP_TOL * float(ref.abs().max()), 0)
    agree = int((logits.argmax(-1).numpy() == preds).sum())
    log(f"  predictions: {agree} of 8 as on the CPU")
    return dict(shape=list(attn.shape), row_sum_err=float(rows),
                preds_as_cpu=agree)


def mae_decoder(card: str, paths: dict, B: int = 128) -> dict:
    """MAE ViT-B/16 with its decoder (8 blocks 512 wide, 16 heads of width
    32, the plain route), random weights from seed 0, batch ``B``, bf16,
    mask ratio 0.75: the loss on the card against the CPU's on the same
    images and masking noise (MAE_LOSS_RTOL), the encoder's launches (A, B
    and C 12 times) and none for the decoder; ms a forward."""
    from ep_tpu_torch.models.assembly import SkipDefaultInit, init_backbone
    from ep_tpu_torch.models.mae import MaskedAutoencoderViT, mae_vit_base_patch16
    from ep_tpu_torch.ops import LAUNCHES, reset_launches

    with SkipDefaultInit():  # init_backbone draws every parameter
        cpu = MaskedAutoencoderViT(mae_vit_base_patch16())
    init_backbone(cpu, torch.Generator().manual_seed(0))
    model = copy.deepcopy(cpu).cuda()
    if any(b.supercell for b in model.decoder_blocks) or not all(
            b.supercell for b in model.blocks):
        raise RuntimeError("mae-decoder: routes")
    x = rand(np.random.default_rng(6), (B, 224, 224, 3), dtype=torch.float32,
             device="cpu")
    noise = torch.rand(B, 196, generator=torch.Generator().manual_seed(7))
    xc = x.cuda()
    log(f"[mae-decoder] MAE ViT-B/16 with its decoder (8 blocks of 16 heads "
        f"of width 32, plain attention), batch {B}, bf16, mask ratio 0.75, "
        f"on {card}")
    with torch.no_grad():
        reset_launches()
        loss, pred, mask = model(xc, 0.75, noise=noise)
        torch.cuda.synchronize()
        paths["mae-decoder"] = dict(LAUNCHES)
        _launches_equal("mae-decoder", paths, ln_qkv_gemm=12, attn_core=12,
                        proj_residual_gemm=12, **fc1_gelu(12 + 8))
        ms = time_ms(lambda: model(xc, 0.75, noise=noise), 5)
        ref = cpu(x, 0.75, noise=noise)[0].item()
    got = loss.item()
    d = abs(got - ref) / abs(ref)
    ok = math.isfinite(got) and d <= MAE_LOSS_RTOL and tuple(pred.shape) == (
        B, 196, 768) and int(mask.sum()) == B * 147
    log(f"  loss {got:.6f} against the CPU's {ref:.6f}, |d|/|ref| {d:.2e} "
        f"(tol {MAE_LOSS_RTOL:g}); pred {tuple(pred.shape)}, "
        f"{int(mask.sum())} masked patches {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("mae-decoder: the card's loss is not the CPU's")
    log(f"  forward and loss at batch {B}: {ms:.2f} ms, {B * 1e3 / ms:.1f} "
        f"img/s on {card}")
    del model, cpu, xc
    torch.cuda.empty_cache()
    return dict(batch=B, forward_ms=ms, img_s=B * 1e3 / ms, loss_rel_err=d)


SEARCH_BLRS = "0.05,0.1"


def search(card: str, paths: dict, tmp) -> dict:
    """search_linprobe_torch.py's main with EP_SEARCH_BLRS holding two
    values: one epoch of main_linprobe_torch.py's main a trial (ViT-B/16,
    EP-32, the fake dataset, batch 128), each trial_{n}/training_log.txt
    carrying "Max Accuracy", and the launches of both trials (A, B and C 12
    times and D once a forward)."""
    import importlib

    from ep_tpu_torch.ops import LAUNCHES, reset_launches

    log(f"[search] search_linprobe_torch.py's main: blr in {SEARCH_BLRS}, "
        f"ViT-B/16, EP-32, batch 128, the fake dataset, one epoch a trial, "
        f"on {card}")
    with mock.patch.dict(os.environ, {"EP_SEARCH_BLRS": SEARCH_BLRS}):
        sys.modules.pop("search_linprobe_torch", None)
        SL = importlib.import_module("search_linprobe_torch")
    flags = [f"--{k}={v}" for k, v in DRIVER_FLAGS.items()
             if k not in ("epochs",)]
    reset_launches()
    t0 = time.perf_counter()
    best_blr, best_acc = SL.main(flags + ["--epochs", "1", "--output_dir",
                                          str(tmp / "search")])
    wall = time.perf_counter() - t0
    paths["search"] = dict(LAUNCHES)
    forwards = 2 * (DRIVER_STEPS + DRIVER_EVAL_BATCHES)
    _launches_equal("search", paths, ln_qkv_gemm=12 * forwards,
                    attn_core=12 * forwards, proj_residual_gemm=12 * forwards,
                    ep_pool=forwards, **lars_pair(2 * DRIVER_STEPS),
                    **fc1_gelu(12 * forwards))
    found = []
    for n in range(2):
        text = (tmp / "search" / f"trial_{n}" / "training_log.txt").read_text()
        found.append("Max Accuracy" in text)
    ok = all(found) and SL.SEARCH_SPACE["blr"] == [0.05, 0.1]
    log(f"  two trials in {wall:.1f} s; 'Max Accuracy' in each "
        f"training_log.txt: {found}; best blr {best_blr}, "
        f"{best_acc:.2f}% (random weights: no accuracy gate) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("search: the trials' logs")
    return dict(wall_s=wall, best_blr=best_blr)


class _Tee(io.TextIOBase):
    """Writes to two streams: the driver's printed lines to the log and to
    a buffer the checks read."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=5)
    # ddp-gloo-2 and tp-gloo-2 start this script once a rank with these
    ap.add_argument("--ddp-gloo-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--tp-gloo-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--ddp-dir", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.ddp_gloo_rank is not None:
        ddp_gloo_worker(args.ddp_gloo_rank, args.ddp_dir)
        return 0
    if args.tp_gloo_rank is not None:
        tp_gloo_worker(args.tp_gloo_rank, args.ddp_dir)
        return 0

    t_start = time.perf_counter()
    walls = {}

    def mark(phase: str) -> None:
        """The seconds since the start at the end of ``phase``."""
        walls[phase] = time.perf_counter() - t_start
        log(f"[wall] {phase} done at {walls[phase]:.1f} s")

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from ep_tpu_torch.ops import LAUNCHES, _build
    path, secs, compiled = _build.build()
    log(f"[build] {'compiled' if compiled else 'reused'} "
        f"{[p.name for p in _build.sources()]} -> {path.name} in {secs:.1f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  {line.strip()}")
    _build.library()
    mark("build")
    from scripts import torch_hopper_gemm_check as kernel_check
    if not kernel_check.run():
        raise RuntimeError("a kernel disagrees with its plain version")
    mark("kernels")

    paths, steps_ms, first_loss = {}, {}, {}
    for kind, (B, *_) in PROBE_CONFIGS.items():
        B = B or args.batch
        model, images, paths[kind], med, losses = train(kind, B, args.steps, card)
        steps_ms[kind] = dict(batch=B, step_ms=med * 1e3, img_s=B / med)
        first_loss[kind] = losses[0]
        if kind == "train":
            cross_check(model, images, "bf16 MLP half")
        elif kind == "int8-b":
            cross_check(model, images, "int8 MLP half (CPU: the plain int8 half)")
        del model, images
        torch.cuda.empty_cache()
    for bf16, int8 in (("train", "int8-b"), ("probe-h", "int8-h")):
        a, b = steps_ms[bf16], steps_ms[int8]
        log(f"[steps] {int8}: {b['step_ms']:.2f} ms, {b['img_s']:.1f} img/s; "
            f"{bf16} (bf16 MLP half, same run): {a['step_ms']:.2f} ms, "
            f"{a['img_s']:.1f} img/s at batch {a['batch']} on {card}")
    a, b = steps_ms["device-aug"], steps_ms["train"]
    log(f"[steps] device-aug: {a['step_ms']:.2f} ms, {a['img_s']:.1f} img/s "
        f"(u8 staged input, the crop on the card); train (same run): "
        f"{b['step_ms']:.2f} ms, {b['img_s']:.1f} img/s at batch {a['batch']} "
        f"on {card}")
    mark("probe paths")
    crop = device_aug_check(card)
    cached = cached_steps(card, paths, steps_ms["train"]["img_s"])
    mark("device-aug, cached")
    zoo_steps = zoo(card, paths, args.steps, steps_ms["train"]["step_ms"])
    zoo_run = zoo_driver(card, paths)
    mark("zoo")
    backbone_steps = backbone_probes(card, paths, args.steps)
    feature_modes = features_b(card, paths)
    mark("backbone probes, features-b")
    for route, usual in (("probe-h448-fused", "probe-h448"),
                         ("probe-h-rowtile", "probe-h")):
        a, b = steps_ms[route], steps_ms[usual]
        d = abs(first_loss[route] - first_loss[usual])
        ok = d <= LOSS_TOL
        log(f"[steps] {route}: {a['step_ms']:.2f} ms, {a['img_s']:.1f} img/s; "
            f"{usual} (same run): {b['step_ms']:.2f} ms, {b['img_s']:.1f} "
            f"img/s at batch {a['batch']} on {card}; step 0's loss "
            f"{first_loss[route]:.5f} against {first_loss[usual]:.5f}, |d| "
            f"{d:.2e} (tol {LOSS_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{route}: step 0's loss is not {usual}'s")
    logits_448()
    for kind, (B, _) in FT_CONFIGS.items():
        paths[kind] = finetune(kind, B, FT_STEPS, card)
    finetune_grads()
    finetune_grads(kind="finetune-dinov2-l", depth=2)
    mark("fine-tuning")
    work = tempfile.TemporaryDirectory()
    tmp = Path(work.name)
    driver_epochs, extracted, driver_lines = driver(card, paths,
                                                    tmp / "driver_ep.pth")
    backbone_runs = driver_backbones(card, paths)
    mark("driver")
    ddp = dict(nccl_1=ddp_nccl_1(card, paths, driver_epochs, driver_lines))
    mark("ddp-nccl-1")
    ddp["gloo_2"] = ddp_gloo_2(
        card, paths, first_loss["train"] if args.batch == GLOO_BATCH else None)
    mark("ddp-gloo-2")
    ddp["tp_gloo_2"] = tp_gloo_2(card, paths)
    mark("tp-gloo-2")
    ddp["use_grain"] = grain_phase(card, paths)
    mark("use-grain")
    tools = dict(attn_stats=attn_stats_b(card, paths, tmp))
    mark("attn-stats-b")
    tools["extract_features"] = extract_features_phase(
        card, paths, tmp / "driver_ep.pth", tmp)
    tools["pool_attention"] = pool_attention_phase(
        card, paths, tmp / "driver_ep.pth", tmp)
    mark("extract-features, pool-attention")
    tools["mae_decoder"] = mae_decoder(card, paths)
    mark("mae-decoder")
    tools["search"] = search(card, paths, tmp)
    mark("search")
    work.cleanup()
    # phase 3's step at the driver's batch, beside the driver's epochs
    *_, med, _ = train("train", DRIVER_FLAGS["batch_size"], args.steps, card)
    step_b = dict(batch=DRIVER_FLAGS["batch_size"], step_ms=med * 1e3,
                  img_s=DRIVER_FLAGS["batch_size"] / med)
    for e in driver_epochs:
        log(f"[steps] driver {e['run']} epoch {e['epoch']}: "
            f"{e['img_s']:.1f} img/s on the wall clock; the train step at "
            f"batch {step_b['batch']} (same run): {step_b['img_s']:.1f} img/s "
            f"({step_b['step_ms']:.2f} ms) on {card}")

    if "jax" in sys.modules or any(
            k == "ep_tpu" or k.startswith("ep_tpu.") for k in sys.modules):
        raise RuntimeError("jax or the JAX package was imported")
    launched = {k: {p: n[k] for p, n in paths.items() if n.get(k)}
                for k in {r["kernel"] for r in kernel_check.ROWS}}
    idle = [k for k, by in launched.items() if k in LAUNCHES and not by]
    if idle:
        raise RuntimeError(f"checked, but no path launched {sorted(idle)}")
    log(f"[wall] the whole run: {time.perf_counter() - t_start:.1f} s on {card}")
    log(card)
    log(json.dumps({"kernels": [dict(r, launches=launched[r["kernel"]])
                                for r in kernel_check.ROWS],
                    "probe_steps": steps_ms,
                    "input_modes": {**cached, "device_aug_img_s": steps_ms[
                        "device-aug"]["img_s"], "device_aug_crop": crop},
                    "zoo": {"heads": zoo_steps, "driver_dolg": zoo_run},
                    "backbones": {"probe_steps": backbone_steps,
                                  "feature_modes": feature_modes,
                                  "driver": backbone_runs},
                    "tools": tools, "walls_s": walls, "ddp": ddp,
                    "driver": {"epochs": driver_epochs,
                               "extraction": extracted,
                               "train_step": step_b}}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
