#!/usr/bin/env python3
"""Smoke run of ep_tpu_torch on one CUDA card (an H100: the kernels are sm_90a).

    python3 chip_smoke.py [--batch 512] [--steps 5]

Phases, each of which must pass (any failure exits non-zero):

1. device  — require CUDA; print the card's name and power limit (nvidia-smi).
2. build   — compile ep_tpu_torch/csrc/*.cu with nvcc, one process per source
             (or reuse the library already built from the same sources);
             print the seconds and ptxas' register and spill lines.
3. kernels — every kernel against its plain PyTorch version on the same bf16
             inputs on the card: max abs / rel error beside the stated
             tolerance, and kernel time beside plain time at the main paths'
             shapes: A, B, C and D at ViT-B; B at ViT-H (head width 80,
             T=257); E, the attention backward, at ViT-B and ViT-H; the
             supercell's gradients (forward and backward) at both.
4. train   — the probe-training main path as bench.py builds it: frozen
             ViT-B/16 (random weights from seed 0) + EP-32 head, BN, fc, LARS
             with the warmup-cosine LR; a few steps at --batch. Checks a finite
             loss, trainable parameters changed, frozen ones untouched, and the
             launch counters: kernels A, B, C 12x per forward, D once.
5. model   — logits of 4 images from the card's kernel path against the
             port's plain path on the CPU with the same weights.
6. finetune-b — full fine-tuning as bench.py's ft_b row builds it: ViT-B/16 +
             EP-32, batch 512, --finetuning --remat_blocks --remat_policy
             attn_out, LARS and the warmup-cosine LR (at its peak, the end of
             warmup), random weights from seed 0. Checks a finite loss, that
             every parameter (backbone included) changed, and the launch
             counters per step: A and B 2x depth (the forward, then again in
             each supercell backward), C and E 1x depth, D once. Prints the
             median step time, img/s and a profiled step's device time.
7. finetune-h — the ft_h row: ViT-H/14 (D=1280, 16 heads of width 80, T=257)
             + EP-32, batch 128, bf16 LARS momentum, the same flags and checks.
8. finetune-grads — every parameter's gradient for 4 images at ViT-B, the
             card's kernel path against the port's plain path on the CPU.

The last two lines are a JSON summary of the kernels and the device line
{"ok": true, "device": {...}}. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Pass when |kernel - plain| <= ATOL + RTOL*|plain| elementwise: about two
# bf16 rounding steps at unit magnitude. Both sides round to bf16 at the same
# points; what differs is the f32 summation order, which can move a value
# across one bf16 rounding boundary.
ATOL, RTOL = 1e-2, 1e-2
# Whole model, 12 blocks of bf16 rounding differences on random weights.
MODEL_ATOL, MODEL_RTOL = 5e-2, 5e-2
# Gradients, each against its tensor's largest magnitude: the attention
# backward's dq and dk sum T products of a bf16-rounded dL (E: 1e-2); the
# supercell's weight gradients sum B*T bf16 products (2e-2). A whole model's
# gradients of 4 images differ more at single elements: the head's BN
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
BWD_TOL, CELL_TOL = 1e-2, 2e-2
GRAD_TOL, GRAD_COS, GRAD_FLOOR = 0.25, 0.99, 2e-3


def log(msg: str) -> None:
    print(msg, flush=True)


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


def check_kernels(B: int, BH: int, rng) -> list[dict]:
    from ep_tpu_torch.ops.attn_block import (attn_supercell, attn_supercell_ref,
                                             ln_qkv, ln_qkv_ref, proj_residual,
                                             proj_residual_ref)
    from ep_tpu_torch.ops.attn_fused import (attention_qkv_fused,
                                             attention_qkv_fused_bwd,
                                             attention_qkv_fused_bwd_ref,
                                             attention_qkv_fused_ref)
    from ep_tpu_torch.ops.pool_attn import ep_pool_attend, ep_pool_attend_ref

    T, D, H = 197, 768, 12
    Dh = D // H
    scale = Dh ** -0.5
    err = {}

    def block_weights(D):
        return dict(w_qkv=rand(rng, (3 * D, D), D ** -0.5),
                    b_qkv=rand(rng, (3 * D,), 0.02, torch.float32),
                    gamma=1 + rand(rng, (D,), 0.1, torch.float32),
                    beta=rand(rng, (D,), 0.1, torch.float32),
                    w_proj=rand(rng, (D, D), D ** -0.5),
                    b_proj=rand(rng, (D,), 0.02, torch.float32))

    log("[kernels] B: attn_core (attention_qkv_fused)")
    for b, t, h in ((8, T, H), (3, 5, 2), (B, T, H)):
        qkv = rand(rng, (b, t, 3 * h * Dh))
        e = compare(f"attn_core B={b} T={t} H={h}",
                    attention_qkv_fused(qkv, h, scale),
                    attention_qkv_fused_ref(qkv, h, scale))
        err["attn_core"] = max(err.get("attn_core", 0.0), e)
    times = {"attn_core": (time_ms(lambda: attention_qkv_fused(qkv, H, scale)),
                           time_ms(lambda: attention_qkv_fused_ref(qkv, H, scale), 3))}

    log("[kernels] A, C and the supercell (attn_supercell)")
    w = block_weights(D)
    for b in (8, B):
        x = rand(rng, (b, T, D))
        a_args = (x, w["gamma"], w["beta"], w["w_qkv"], w["b_qkv"], 1e-6)
        err["ln_qkv_gemm"] = max(err.get("ln_qkv_gemm", 0.0), compare(
            f"ln_qkv_gemm B={b}", ln_qkv(*a_args), ln_qkv_ref(*a_args)))
        c_args = (rand(rng, (b, T, D)), w["w_proj"], w["b_proj"], x)
        err["proj_residual_gemm"] = max(
            err.get("proj_residual_gemm", 0.0),
            compare(f"proj_residual_gemm B={b}", proj_residual(*c_args),
                    proj_residual_ref(*c_args)))
        args = (x, w["w_qkv"], w["b_qkv"], w["gamma"], w["beta"], w["w_proj"],
                w["b_proj"], H, scale)
        compare(f"attn_supercell B={b}", attn_supercell(*args),
                attn_supercell_ref(*args))
    times["ln_qkv_gemm"] = (time_ms(lambda: ln_qkv(*a_args)),
                            time_ms(lambda: ln_qkv_ref(*a_args), 3))
    times["proj_residual_gemm"] = (time_ms(lambda: proj_residual(*c_args)),
                                   time_ms(lambda: proj_residual_ref(*c_args), 3))
    t_cell = (time_ms(lambda: attn_supercell(*args)),
              time_ms(lambda: attn_supercell_ref(*args), 3))
    log(f"  attn_supercell B={B}: kernels {t_cell[0]:.3f} ms, plain {t_cell[1]:.3f} ms")

    log("[kernels] D: ep_pool (ep_pool_attend), forward and gradients")
    for b, n, c, q in ((16, 196, 768, 32), (3, 37, 128, 4), (B, 196, 768, 32)):
        cq = c // q
        qs = rand(rng, (q, c), c ** -0.5)
        # the main path hands the kernel the patch-token view x[:, 1:]
        tok = rand(rng, (b, n + 1, c))[:, 1:]
        v = rand(rng, (b, n, q, cq))
        err["ep_pool"] = max(err.get("ep_pool", 0.0), compare(
            f"ep_pool B={b} N={n} C={c} Q={q}", ep_pool_attend(qs, tok, v),
            ep_pool_attend_ref(qs, tok, v)))
        if b <= 16:
            grads = []
            for fn in (ep_pool_attend, ep_pool_attend_ref):
                qg = qs.clone().requires_grad_(True)
                vg = v.clone().requires_grad_(True)
                (fn(qg, tok, vg).float() ** 2).sum().backward()
                grads.append((qg.grad, vg.grad))
            for i, gname in enumerate(("d q_scaled", "d v")):
                ref = grads[1][i]
                scale_g = float(ref.float().abs().max())
                compare(f"ep_pool {gname} B={b}", grads[0][i], ref,
                        atol=ATOL * scale_g, rtol=RTOL)
    times["ep_pool"] = (time_ms(lambda: ep_pool_attend(qs, tok, v)),
                        time_ms(lambda: ep_pool_attend_ref(qs, tok, v), 3))

    log("[kernels] B at ViT-H: attn_core, head width 80")
    TH, DH, HH = 257, 1280, 16
    scale_h = (DH // HH) ** -0.5
    for b, t, h in ((8, TH, HH), (3, 9, 8), (BH, TH, HH)):
        qkv = rand(rng, (b, t, 3 * h * 80))
        err["attn_core_dh80"] = max(err.get("attn_core_dh80", 0.0), compare(
            f"attn_core B={b} T={t} H={h} Dh=80",
            attention_qkv_fused(qkv, h, scale_h),
            attention_qkv_fused_ref(qkv, h, scale_h)))
    times["attn_core_dh80"] = (
        time_ms(lambda: attention_qkv_fused(qkv, HH, scale_h)),
        time_ms(lambda: attention_qkv_fused_ref(qkv, HH, scale_h), 3))

    log("[kernels] E: attn_core_bwd (attention_qkv_fused_bwd)")
    for name, cases in (
            ("attn_core_bwd", ((8, T, H, 64), (3, 5, 2, 64), (B, T, H, 64))),
            ("attn_core_bwd_dh80",
             ((8, TH, HH, 80), (3, 9, 8, 80), (BH, TH, HH, 80)))):
        for b, t, h, dh in cases:
            qkv = rand(rng, (b, t, 3 * h * dh))
            g = rand(rng, (b, t, h * dh))
            ref = attention_qkv_fused_bwd_ref(qkv, g, h, dh ** -0.5)
            e = compare(f"{name} B={b} T={t} H={h} Dh={dh}",
                        attention_qkv_fused_bwd(qkv, g, h, dh ** -0.5), ref,
                        atol=BWD_TOL * float(ref.float().abs().max()),
                        rtol=BWD_TOL)
            err[name] = max(err.get(name, 0.0), e)
            del ref
        times[name] = (
            time_ms(lambda: attention_qkv_fused_bwd(qkv, g, h, dh ** -0.5)),
            time_ms(lambda: attention_qkv_fused_bwd_ref(qkv, g, h, dh ** -0.5), 3))

    log("[kernels] supercell gradients (A, B recomputed, E), f32 master weights")
    for b, t, d, h, tag in ((8, T, D, H, "ViT-B"), (B, T, D, H, "ViT-B"),
                            (8, TH, DH, HH, "ViT-H"), (BH, TH, DH, HH, "ViT-H")):
        w = block_weights(d)
        leaves = [rand(rng, (b, t, d))] + [
            w[k].float() for k in ("w_qkv", "b_qkv", "gamma", "beta", "w_proj",
                                   "b_proj")]
        leaves = [x.requires_grad_(True) for x in leaves]
        g = rand(rng, (b, t, d))
        sc = (d // h) ** -0.5

        def fwd_bwd(fn):
            out = fn(*leaves, h, sc)
            return torch.autograd.grad(out, leaves, g)

        grads = [fwd_bwd(attn_supercell), fwd_bwd(attn_supercell_ref)]
        for gname, a, r in zip(("x", "w_qkv", "b_qkv", "gamma", "beta",
                                "w_proj", "b_proj"), *grads):
            compare(f"supercell {tag} B={b} d{gname}", a, r,
                    atol=CELL_TOL * float(r.float().abs().max()), rtol=CELL_TOL)
        del grads
        if b > 8:  # time at the path's batch
            times[f"supercell_fwd_bwd_{tag}"] = (
                time_ms(lambda: fwd_bwd(attn_supercell), 5),
                time_ms(lambda: fwd_bwd(attn_supercell_ref), 2))

    for k, (t_k, t_p) in times.items():
        log(f"  time {k}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms")
    names = ("ln_qkv_gemm", "attn_core", "attn_core_dh80", "proj_residual_gemm",
             "ep_pool", "attn_core_bwd", "attn_core_bwd_dh80")
    return [dict(name=k, err=err[k], ms=times[k][0], plain_ms=times[k][1])
            for k in names]


def train(B: int, steps: int, card: str):
    from ep_tpu.configs import TrainConfig
    from ep_tpu_torch.models.assembly import build_backbone_config, init_probe_model
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.train.lars import LARS
    from ep_tpu_torch.train.schedule import make_lr_fn
    from ep_tpu_torch.train.state import cast_frozen, freeze, split_params
    from ep_tpu_torch.train.steps import make_train_step

    cfg = TrainConfig(model="vit_base_patch16", cls_features="ep", ep_queries=32,
                      d_out=1, nb_classes=1000, amp="bfloat16", pallas_pool=True,
                      epochs=90, warmup_epochs=10, blr=0.1, batch_size=B,
                      eff_batch_size=B)
    bcfg = build_backbone_config(cfg)
    model = init_probe_model(cfg, seed=0, backbone_cfg=bcfg)
    trainable = freeze(model, cfg.finetuning)
    cast_frozen(model, torch.bfloat16)
    model.cuda()
    opt = LARS(trainable, weight_decay=0.0)
    step_fn = make_train_step(model, opt, make_lr_fn(cfg, 1000))

    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.standard_normal((B, 224, 224, 3), dtype=np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 1000, size=(B,))).cuda()

    train_p, frozen_p = split_params(model, cfg.finetuning)
    before_t = {k: p.detach().clone() for k, p in train_p.items()}
    before_f = {k: p.detach().clone() for k, p in frozen_p.items()}
    log(f"[train] ViT-B/16 + EP32, batch {B}, {steps} steps, "
        f"{sum(p.numel() for p in trainable)} trainable / "
        f"{sum(p.numel() for p in frozen_p.values())} frozen parameters")

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
    expect = {"ln_qkv_gemm": 12 * steps, "attn_core": 12 * steps,
              "proj_residual_gemm": 12 * steps, "ep_pool": steps,
              "attn_core_bwd": 0}
    log(f"  launches over {steps} forwards: {counts} (expected {expect})")
    if counts != expect:
        raise RuntimeError("the main path did not go through every kernel as expected")
    log(f"  trainable parameters changed: {changed}")
    med = statistics.median(times[1:]) if steps > 1 else times[0]
    log(f"  median step {med * 1e3:.2f} ms (steps 1..{steps - 1}), "
        f"{B / med:.1f} img/s at batch {B} on {card}")
    return model, images, counts


def cross_check(model, images) -> None:
    model.eval()
    x = images[:4]
    with torch.no_grad():
        out = model(x)
        ref = copy.deepcopy(model).cpu()(x.cpu())
    log("[model] logits of 4 images, card kernel path vs CPU plain path")
    compare("logits", out.cpu(), ref, MODEL_ATOL, MODEL_RTOL)


# bench.py:100-128 with scripts/bench_models.py's ft_* rows: batch, flags
FT_CONFIGS = {
    "finetune-b": (512, dict(model="vit_base_patch16")),
    "finetune-h": (128, dict(model="vit_huge_patch14", mu_bf16=True)),
}
FT_STEPS = 4


def finetune_config(kind: str, B: int):
    from ep_tpu.configs import TrainConfig
    return TrainConfig(cls_features="ep", ep_queries=32, d_out=1,
                       nb_classes=1000, amp="bfloat16", pallas_pool=True,
                       epochs=90, warmup_epochs=10, blr=0.1, batch_size=B,
                       eff_batch_size=B, finetuning=True, scan_blocks=True,
                       remat_blocks=True, remat_policy="attn_out",
                       **FT_CONFIGS[kind][1])


def device_time(step, card: str) -> None:
    """One step under torch.profiler: device time by kernel over wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # kernels and copies on the card; not the ranges user annotations
        # (such as the optimizer's step) mirror onto the device
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3, e.count, e.key))
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
    for ms, n, key in rows[:12]:
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
    model = init_probe_model(cfg, seed=0, backbone_cfg=bcfg)
    params = freeze(model, cfg.finetuning)
    model.cuda()
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
    expect = {"ln_qkv_gemm": 2 * d * steps, "attn_core": 2 * d * steps,
              "proj_residual_gemm": d * steps, "ep_pool": steps,
              "attn_core_bwd": d * steps}
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


def finetune_grads(n: int = 4) -> None:
    """Every parameter's gradient at ViT-B: card kernel path vs CPU plain path."""
    from ep_tpu_torch.models.assembly import init_probe_model
    from ep_tpu_torch.train.state import freeze
    from ep_tpu_torch.train.steps import cross_entropy

    cfg = finetune_config("finetune-b", n)
    model = init_probe_model(cfg, seed=1)
    freeze(model, True)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((n, 224, 224, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 1000, size=(n,)))
    grads = []
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev).train()
        cross_entropy(m(x.to(dev)), y.to(dev)).mean().backward()
        grads.append({k: p.grad.float().cpu() for k, p in m.named_parameters()})
    card, cpu = grads
    top = max(float(g.abs().max()) for g in cpu.values())
    log(f"[finetune-grads] {len(cpu)} gradients of {n} images, card kernel path "
        f"vs CPU plain path (tol {GRAD_TOL:g} of max(|grad|, "
        f"{GRAD_FLOOR:g} x model max {top:.3e}); cosine >= {GRAD_COS:g})")
    rows, bad = [], []
    for k, ref in cpu.items():
        own = float(ref.abs().max())
        scale = max(own, GRAD_FLOOR * top)
        d = float((card[k] - ref).abs().max())
        cos = float(torch.nn.functional.cosine_similarity(
            card[k].flatten().double(), ref.flatten().double(), dim=0))
        noise = own < GRAD_FLOOR * top
        rows.append((d / scale, cos, k, noise))
        if d > GRAD_TOL * scale or (not noise and cos < GRAD_COS):
            bad.append(k)
    rows.sort(reverse=True)
    for r, cos, k, _ in rows[:5]:
        log(f"  {k}: max |d| {r:.3e} of its scale, cosine {cos:.6f}")
    log(f"  smallest cosine {min(r[1] for r in rows if not r[3]):.6f}; "
        f"under the floor (rounding noise): "
        f"{[r[2] for r in rows if r[3]]}")
    if bad:
        raise RuntimeError(f"gradients outside the tolerance: {bad}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from ep_tpu_torch.ops import _build
    path, secs, compiled = _build.build()
    log(f"[build] {'compiled' if compiled else 'reused'} "
        f"{[p.name for p in _build.sources()]} -> {path.name} in {secs:.1f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  {line.strip()}")
    _build.library()

    rng = np.random.default_rng(0)
    results = check_kernels(args.batch, FT_CONFIGS["finetune-h"][0], rng)
    model, images, counts = train(args.batch, args.steps, card)
    cross_check(model, images)
    del model, images
    paths = {"train": counts}
    for kind, (B, _) in FT_CONFIGS.items():
        paths[kind] = finetune(kind, B, FT_STEPS, card)
    finetune_grads()

    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")
    replaces = {  # name -> (source, TPU kernel, the path whose count is shown)
        "ln_qkv_gemm": ("ep_tpu_torch/csrc/attn_block_gemm.cu",
                        "ep_tpu/ops/attn_block_pallas.py:30", "finetune-b"),
        "attn_core": ("ep_tpu_torch/csrc/attn_core.cu",
                      "ep_tpu/ops/attn_fused_pallas.py:31", "finetune-b"),
        "attn_core_dh80": ("ep_tpu_torch/csrc/attn_core.cu",
                           "ep_tpu/ops/attn_fused_pallas.py:62", "finetune-h"),
        "proj_residual_gemm": ("ep_tpu_torch/csrc/attn_block_gemm.cu",
                               "ep_tpu/ops/attn_block_pallas.py:30", "finetune-b"),
        "ep_pool": ("ep_tpu_torch/csrc/ep_pool.cu",
                    "ep_tpu/ops/pool_attn_pallas.py:30", "finetune-b"),
        "attn_core_bwd": ("ep_tpu_torch/csrc/attn_core_bwd.cu",
                          "ep_tpu/ops/attn_fused_pallas.py:334", "finetune-b"),
        "attn_core_bwd_dh80": ("ep_tpu_torch/csrc/attn_core_bwd.cu",
                               "ep_tpu/ops/attn_fused_pallas.py:385",
                               "finetune-h"),
    }
    kernels = []
    for r in results:
        src, tpu, path_name = replaces[r["name"]]
        counter = r["name"].replace("_dh80", "")
        kernels.append({
            "name": r["name"], "route": "cuda", "source": src, "replaces": tpu,
            "launches": paths[path_name][counter], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "launches_by_path": {k: v[counter] for k, v in paths.items()}})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
