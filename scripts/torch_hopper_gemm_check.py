#!/usr/bin/env python3
"""Quick check of ep_tpu_torch's wgmma + TMA kernels on one H100.

    python3 scripts/torch_hopper_gemm_check.py [--no-time] [--big]
                               [--only gemm fc1 fc2 flash core bwd]

Builds ep_tpu_torch/csrc, prints ptxas' lines for the wgmma kernels
(registers, spills, warnings), then runs kernel A (ln_qkv), kernel C
(proj_residual), the int8 fc1 and fc2, and the attention kernels F
(attn_flash), B (attn_core) and E (attn_core_bwd, also twice, to be equal bit
for bit) against their plain versions at small, ragged and full shapes (fc1: codes and scales
equal bit for bit, with a token at the scale's floor; its GELU table against
the GELU arithmetic at every bf16 value; fc2 equal bit for bit in its tier's
bias order), and times each at the paths' shapes beside the PyTorch call that
computes the same function (F.layer_norm + F.linear, F.linear + add,
torch._int_mm, scaled_dot_product_attention and its backward). The last fc1
shape is ViT-B's
with 8 stripes: the same work without clusters. Half a minute of card time:
the first thing to run after a change to hopper.cuh.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

ATOL = RTOL = 1e-2
GROUPS = ("gemm", "fc1", "fc2", "flash", "core", "bwd")


def rand(rng, shape, scale=1.0, dtype=torch.bfloat16):
    a = rng.standard_normal(shape, dtype=np.float32) * scale
    return torch.from_numpy(a).to(device="cuda", dtype=dtype)


def time_ms(fn, iters=10):
    fn()
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def close(name, out, ref):
    torch.cuda.synchronize()
    d = (out.float() - ref.float()).abs()
    ok = bool((d <= ATOL + RTOL * ref.float().abs()).all()) and bool(
        torch.isfinite(out.float()).all())
    print(f"  {name}: max_abs_err {float(d.max()):.3e} {'ok' if ok else 'FAIL'}",
          flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--big", action="store_true",
                    help="only the paths' shapes (batch >= 64)")
    ap.add_argument("--only", nargs="+", choices=GROUPS, default=GROUPS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    from ep_tpu_torch.ops import _build
    from ep_tpu_torch.ops import mlp_int8 as m
    from ep_tpu_torch.ops.attn_block import (ln_qkv, ln_qkv_ref, proj_residual,
                                             proj_residual_ref)
    path, secs, _ = _build.build()
    print(f"built in {secs:.1f} s")
    show = False
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line:
            show = any(k in line for k in (
                "gemm_kernel", "fc1_kernel", "fc2_kernel", "attn_flash_kernel",
                "attn_core_kernel", "attn_core_bwd_kernel"))
        if show and any(k in line for k in ("registers", "Compiling", "spill")) or (
                "warning" in line.lower() or "serializ" in line.lower()):
            print("  " + line.strip()[:200])
    _build.library()
    rng = np.random.default_rng(0)
    ok = True

    print("A ln_qkv and C proj_residual")
    for b, t, d in ((1, 5, 64), (3, 197, 768), (8, 197, 768), (3, 257, 1024),
                    (2, 1025, 1280), (512, 197, 768), (128, 257, 1280),
                    (64, 1025, 1280)):
        if "gemm" not in args.only or (args.big and b < 64):
            continue
        x = rand(rng, (b, t, d))
        w = rand(rng, (3 * d, d), d ** -0.5)
        bq = rand(rng, (3 * d,), 0.02, torch.float32)
        g = 1 + rand(rng, (d,), 0.1, torch.float32)
        be = rand(rng, (d,), 0.1, torch.float32)
        a_args = (x, g, be, w, bq, 1e-6)
        ok &= close(f"A ({b},{t},{d})", ln_qkv(*a_args), ln_qkv_ref(*a_args))
        o = rand(rng, (b, t, d))
        wp = rand(rng, (d, d), d ** -0.5)
        bp = rand(rng, (d,), 0.02, torch.float32)
        ok &= close(f"C ({b},{t},{d})", proj_residual(o, wp, bp, x),
                    proj_residual_ref(o, wp, bp, x))
        if b >= 64 and not args.no_time:
            g16, be16, bq16, bp16 = (v.bfloat16() for v in (g, be, bq, bp))
            flop = 2 * b * t * d * d
            ta = time_ms(lambda: ln_qkv(*a_args))
            tc = time_ms(lambda: proj_residual(o, wp, bp, x))
            la = time_ms(lambda: F.linear(F.layer_norm(x, (d,), g16, be16, 1e-6),
                                          w, bq16))
            lc = time_ms(lambda: x + F.linear(o, wp, bp16))
            print(f"  time ({b},{t},{d}): A {ta:.3f} ms ({3 * flop / ta / 1e9:.0f} "
                  f"TFLOP/s), library {la:.3f}; C {tc:.3f} ms "
                  f"({flop / tc / 1e9:.0f} TFLOP/s), library {lc:.3f}", flush=True)
        del x, w, o
        torch.cuda.empty_cache()

    bad = m.gelu_table_mismatches(torch.device("cuda"))
    print(f"fc1's GELU by table against the GELU arithmetic, every finite "
          f"bf16 value: {bad} differ {'ok' if bad == 0 else 'FAIL'}")
    ok &= bad == 0
    print("fc1 (codes and scales equal to the plain version's)")
    for b, t, d, s in ((3, 7, 128, 1), (3, 7, 128, 2), (3, 197, 768, 1),
                       (2, 197, 1024, 8), (1, 257, 1280, 8), (512, 197, 768, 1),
                       (128, 197, 1024, 8), (128, 257, 1280, 8),
                       (512, 197, 768, 8)):
        if "fc1" not in args.only or (args.big and b < 64):
            continue
        dh = 4 * d
        hq = torch.from_numpy(rng.integers(-127, 128, (b, t, d), dtype=np.int8)).cuda()
        hq[0, t // 2] = 0
        sx = rand(rng, (b, t, 1), 0.01, torch.float32).abs() + 1e-3
        w1q, s1 = m.quantize_weight(rand(rng, (dh, d), d ** -0.5))
        b1 = rand(rng, (dh,), 0.1, torch.float32)
        b1[: dh // s] = 0  # with the zero row: a stripe whose GELU is all zero
        aq, sa = m.fc1(hq, sx, w1q, s1, b1, s)
        torch.cuda.synchronize()
        aq_r, sa_r = m.fc1_ref(hq, sx, w1q, s1, b1, s)
        diff = int((aq != aq_r).sum())
        same = diff == 0 and bool(torch.equal(sa, sa_r))
        print(f"  fc1 ({b},{t},{d}) S={s} tiling {m.fc1_tiling(dh // s)}: codes "
              f"differing {diff}, scales equal {bool(torch.equal(sa, sa_r))}, "
              f"floor row sa {float(sa[0, t // 2, 0]):.3e} "
              f"{'ok' if same else 'FAIL'}", flush=True)
        ok &= same
        if b >= 64 and not args.no_time:
            tk = time_ms(lambda: m.fc1(hq, sx, w1q, s1, b1, s))
            tl = time_ms(lambda: torch._int_mm(hq.view(-1, d), w1q.t()))
            ops = 2 * b * t * d * dh
            print(f"  time: fc1 {tk:.3f} ms ({ops / tk / 1e9:.0f} TOP/s), "
                  f"torch._int_mm {tl:.3f} ms", flush=True)
        del hq, aq, aq_r, w1q
        torch.cuda.empty_cache()
    print("fc2 (equal to the plain version's in the tier's bias order)")
    for b, t, d, s in ((3, 37, 768, 1), (1, 64, 1280, 8), (3, 37, 1024, 8),
                       (512, 197, 768, 1), (128, 197, 1024, 8),
                       (128, 257, 1280, 8)):
        if "fc2" not in args.only or (args.big and b < 64):
            continue
        dh = 4 * d
        tier = m.plan(t, d, dh)[0]
        aq = torch.from_numpy(rng.integers(-127, 128, (b, t, dh), dtype=np.int8)).cuda()
        sa = rand(rng, (b, t, s), 0.01, torch.float32).abs() + 1e-3
        w2q, s2 = m.quantize_weight(rand(rng, (d, dh), dh ** -0.5))
        x, b2 = rand(rng, (b, t, d)), rand(rng, (d,), 0.1, torch.float32)
        out = m.fc2(aq, sa, x, w2q, s2, b2, s, tier)
        same = bool(torch.equal(out, m.fc2_ref(aq, sa, x, w2q, s2, b2, s, tier)))
        print(f"  fc2 ({b},{t},{d}) S={s} {tier}: equal {same} "
              f"{'ok' if same else 'FAIL'}", flush=True)
        ok &= same
        if b >= 64 and not args.no_time:
            tk = time_ms(lambda: m.fc2(aq, sa, x, w2q, s2, b2, s, tier))
            tl = time_ms(lambda: torch._int_mm(aq.view(-1, dh), w2q.t()))
            ops = 2 * b * t * d * dh
            print(f"  time: fc2 {tk:.3f} ms ({ops / tk / 1e9:.0f} TOP/s), "
                  f"torch._int_mm {tl:.3f} ms", flush=True)
        del aq, w2q, x
        torch.cuda.empty_cache()

    from ep_tpu_torch.ops.attn_fused import attention_qkv_fused_ref
    from ep_tpu_torch.ops.flash_attn import attn_flash
    print("F attn_flash")
    for b, t, h, dh in ((1, 1, 1, 80), (2, 65, 2, 64), (2, 257, 2, 80),
                        (2, 1025, 16, 80), (64, 1025, 16, 80),
                        (64, 785, 12, 64), (128, 257, 16, 80)):
        if "flash" not in args.only or (args.big and b < 64):
            continue
        qkv = rand(rng, (b, t, 3 * h * dh))
        sc = dh ** -0.5
        ok &= close(f"F ({b},{t},{h}x{dh})", attn_flash(qkv, h, sc, 1.5),
                    attention_qkv_fused_ref(qkv, h, sc, 1.5))
        if b >= 64 and not args.no_time:
            q, k, v = (u.contiguous() for u in
                       qkv.view(b, t, 3, h, dh).permute(2, 0, 3, 1, 4).unbind(0))
            tk = time_ms(lambda: attn_flash(qkv, h, sc))
            tl = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=sc))
            flop = 4 * b * h * t * t * dh
            print(f"  time: F {tk:.3f} ms ({flop / tk / 1e9:.0f} TFLOP/s of the "
                  f"two products), SDPA {tl:.3f} ms", flush=True)
            del q, k, v
        del qkv
        torch.cuda.empty_cache()
    from ep_tpu_torch.ops.attn_fused import (attention_core,
                                             attention_qkv_fused_bwd,
                                             attention_qkv_fused_bwd_ref)
    print("B attn_core")
    for b, t, h, dh in ((1, 1, 1, 64), (2, 63, 2, 80), (2, 65, 2, 64),
                        (2, 129, 3, 80), (2, 197, 12, 64), (2, 257, 16, 80),
                        (3, 272, 2, 80), (200, 33, 2, 64), (512, 197, 12, 64),
                        (128, 256, 16, 80), (128, 257, 16, 80)):
        if "core" not in args.only or (args.big and b < 64):
            continue
        qkv = rand(rng, (b, t, 3 * h * dh))
        sc = dh ** -0.5
        ok &= close(f"B ({b},{t},{h}x{dh})",
                    attention_core(qkv, h, sc, 1.5, variant="core"),
                    attention_qkv_fused_ref(qkv, h, sc, 1.5))
        if b >= 64 and t > 64 and not args.no_time:
            q, k, v = (u.contiguous() for u in
                       qkv.view(b, t, 3, h, dh).permute(2, 0, 3, 1, 4).unbind(0))
            tk = time_ms(lambda: attention_core(qkv, h, sc, variant="core"))
            tl = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=sc))
            print(f"  time: B {tk:.3f} ms, SDPA {tl:.3f} ms", flush=True)
            del q, k, v
        del qkv
        torch.cuda.empty_cache()
    print("E attn_core_bwd (rtol 1e-2, atol 1e-2 of max |ref|; twice, equal)")
    for b, t, h, dh in ((1, 1, 1, 64), (2, 65, 2, 80), (3, 129, 2, 64),
                        (2, 197, 12, 64), (2, 257, 16, 80), (1, 320, 2, 80),
                        (1, 384, 2, 64), (300, 5, 1, 80), (512, 197, 12, 64),
                        (128, 257, 16, 80)):
        if "bwd" not in args.only or (args.big and b < 64):
            continue
        qkv = rand(rng, (b, t, 3 * h * dh))
        g = rand(rng, (b, t, h * dh))
        sc = dh ** -0.5
        out = attention_qkv_fused_bwd(qkv, g, h, sc, 1.5)
        again = attention_qkv_fused_bwd(qkv, g, h, sc, 1.5)
        ref = attention_qkv_fused_bwd_ref(qkv, g, h, sc, 1.5)
        torch.cuda.synchronize()
        d = (out.float() - ref.float()).abs()
        scale = float(ref.float().abs().max())
        good = bool((d <= 1e-2 * scale + 1e-2 * ref.float().abs()).all()) and bool(
            torch.isfinite(out.float()).all())
        same = bool(torch.equal(out, again))
        print(f"  E ({b},{t},{h}x{dh}): max_abs_err {float(d.max()):.3e} of "
              f"max |ref| {scale:.3e}, repeat equal {same} "
              f"{'ok' if good and same else 'FAIL'}", flush=True)
        ok &= good and same
        del ref, again, d
        if b >= 64 and not args.no_time:
            tk = time_ms(lambda: attention_qkv_fused_bwd(qkv, g, h, sc))
            ql = [u.detach().requires_grad_(True) for u in
                  qkv.view(b, t, 3, h, dh).permute(2, 0, 3, 1, 4).unbind(0)]
            ol = F.scaled_dot_product_attention(*ql, scale=sc)
            gl = g.view(b, t, h, dh).transpose(1, 2)
            tl = time_ms(lambda: torch.autograd.grad(ol, ql, gl, retain_graph=True))
            print(f"  time: E {tk:.3f} ms, SDPA's backward {tl:.3f} ms", flush=True)
            del ql, ol, gl
        del qkv, g, out
        torch.cuda.empty_cache()
    print("ALL OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
