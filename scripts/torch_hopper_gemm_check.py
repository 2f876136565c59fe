#!/usr/bin/env python3
"""Quick check of ep_tpu_torch's wgmma + TMA kernels on one H100.

    python3 scripts/torch_hopper_gemm_check.py [--no-time] [--big]
                               [--only gemm fc1 fc2 flash core bwd pool lnq proj]
                               [--root DIR]

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
with 8 stripes: the same work without clusters. Then kernel D (ep_pool: N
from 1 to 1025, Q from 4 to 64, the patch-token view) and the int8 ln_quant
(D from 128 to 2176, past the rows held in registers; a zero row; codes at
exact halves), each twice, to be equal bit for bit, and each timed beside its
bound (and D beside SDPA). Then kernel G (ep_pool_proj: N at its panels' edges
and past 16 panels, cq of 8 to 40, Q from 4 to 64), twice, to be equal bit
for bit, and timed at the paths' shapes beside its bound and the unfused pair
it replaces (F.linear, then kernel D). Half a minute of card time: the first
thing to run after a change to hopper.cuh.

--root DIR imports ep_tpu_torch from another checkout (an earlier commit
unpacked beside this one) and builds that tree's kernels, so that one call can
time two versions of a kernel with the same script and inputs.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


ATOL = RTOL = 1e-2
GROUPS = ("gemm", "fc1", "fc2", "flash", "core", "bwd", "pool", "lnq", "proj")
PEAK_BF16 = 989e12  # dense bf16 operations a second, an H100 SXM
HBM_RATE = 3.35e12  # bytes a second, an H100 SXM's memory


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
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the checkout whose ep_tpu_torch is checked")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
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
                "attn_core_kernel", "attn_core_bwd_kernel", "ep_pool_kernel",
                "ep_pool_proj_kernel", "ln_quant"))
        if show and any(k in line for k in ("registers", "Compiling", "spill")) or (
                "warning" in line.lower() or "serializ" in line.lower()):
            print("  " + line.strip()[:320])
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
    if "pool" in args.only:
        ok &= check_pool(rng, args)
    if "lnq" in args.only:
        ok &= check_ln_quant(rng, args, m)
    if "proj" in args.only:
        ok &= check_proj(rng, args)
    print("ALL OK" if ok else "FAILED")
    return 0 if ok else 1


def check_pool(rng, args) -> bool:
    """Kernel D against its plain version, twice (equal bit for bit), and its
    time beside its bound and one SDPA call at the paths' shapes."""
    from ep_tpu_torch.ops import _build
    from ep_tpu_torch.ops import pool_attn as pa
    print("D ep_pool (the patch-token view x[:, 1:]; twice, equal)")
    ok = True
    for b, n, c, q in ((3, 1, 128, 4), (3, 37, 128, 4), (2, 63, 768, 32),
                       (2, 64, 768, 32), (2, 65, 1024, 32), (4, 196, 768, 32),
                       (2, 256, 1280, 32), (2, 1024, 1280, 32),
                       (2, 1025, 1280, 32), (2, 100, 1280, 64),
                       (2, 70, 192, 12), (3, 50, 1408, 32), (512, 196, 768, 32),
                       (128, 256, 1280, 32), (64, 1024, 1280, 32),
                       (16, 196, 1024, 32)):
        if args.big and b < 16:
            continue
        cq = c // q
        qs = rand(rng, (q, c), c ** -0.5)
        tok = rand(rng, (b, n + 1, c))[:, 1:]
        v = rand(rng, (b, n, q, cq))
        out = pa.ep_pool_attend(qs, tok, v)
        again = pa.ep_pool_attend(qs, tok, v)
        tiling = ""
        if hasattr(pa, "ep_pool_tiling"):
            cl, tl_ = pa.ep_pool_tiling(n, c, q, c)
            tiling = (f" tiling {(cl, tl_)}, resident clusters "
                      f"{_build.query('ep_pool_resident_clusters', q, c, cl, tl_)}")
        same = bool(torch.equal(out, again))
        ok &= close(f"D ({b},{n},{c},{q}){tiling}, repeat equal {same}", out,
                    pa.ep_pool_attend_ref(qs, tok, v)) and same
        if b >= 16 and not args.no_time:
            tk = time_ms(lambda: pa.ep_pool_attend(qs, tok, v))
            tl = time_ms(lambda: F.scaled_dot_product_attention(
                qs[None, :, None, :].expand(b, -1, -1, -1),
                tok[:, None].expand(-1, q, -1, -1), v.permute(0, 2, 1, 3),
                scale=1.0))
            bound = (2 * b * n * c + 2 * b * n * q * cq + 2 * q * c
                     + 2 * b * q * cq) / HBM_RATE * 1e3
            print(f"  time: D {tk:.3f} ms, bound {bound:.3f} ms (bytes, "
                  f"{bound / tk:.0%}), SDPA {tl:.3f} ms", flush=True)
        del qs, tok, v, out, again
        torch.cuda.empty_cache()
    return ok


def check_proj(rng, args) -> bool:
    """Kernel G against its plain version (ATOL, RTOL), twice (equal bit for
    bit), and its time beside its bound (operations), the unfused pair
    (F.linear, then kernel D) and F.linear alone at the paths' shapes. A
    checkout whose G refuses a shape says so and goes on."""
    from ep_tpu_torch.ops import _build
    from ep_tpu_torch.ops import pool_attn as pa
    print("G ep_pool_proj (the patch-token view x[:, 1:]; twice, equal)")
    ok = True
    # (B, N, C, Q, QC): N at the edges of the 128-token panels and past 16 of
    # them (2100: two panels a block), cq = 12 and 20 (d_out 2 at ViT-B and
    # ViT-H), 33 and 8, Q of 4, 33 and 64; then the paths' shapes
    for b, n, c, q, qc in ((3, 1, 128, 4, 128), (3, 127, 128, 4, 128),
                           (2, 128, 768, 32, 768), (2, 129, 768, 32, 768),
                           (2, 1025, 1280, 32, 1280), (2, 2100, 768, 32, 768),
                           (4, 196, 768, 32, 384), (2, 256, 1280, 32, 640),
                           (2, 70, 128, 33, 264), (2, 100, 1280, 64, 1280),
                           (3, 37, 192, 12, 192), (512, 196, 768, 32, 768),
                           (128, 256, 1280, 32, 1280), (64, 1024, 1280, 32, 1280)):
        if args.big and b < 16:
            continue
        qs = rand(rng, (q, c), c ** -0.5)
        tok = rand(rng, (b, n + 1, c))[:, 1:]
        w = rand(rng, (qc, c), c ** -0.5)
        tiling, resident = "", 0
        if hasattr(pa, "ep_pool_proj_tiling"):
            cl, panels = pa.ep_pool_proj_tiling(n, c, q, qc)
            resident = cl * _build.query("ep_pool_proj_resident_clusters", q,
                                         qc, cl)
            tiling = (f" tiling {(cl, panels)}, "
                      f"{pa.ep_pool_proj_smem_bytes(q, qc, cl)} bytes a block, "
                      f"{resident} blocks resident")
        try:
            out = pa.ep_pool_proj_attend(qs, tok, w)
        except NotImplementedError as e:
            print(f"  G ({b},{n},{c},{q},{qc}): refused: {e}", flush=True)
            continue
        again = pa.ep_pool_proj_attend(qs, tok, w)
        same = bool(torch.equal(out, again))
        ok &= close(f"G ({b},{n},{c},{q},{qc}){tiling}, repeat equal {same}", out,
                    pa.ep_pool_proj_attend_ref(qs, tok, w)) and same
        if b >= 16 and not args.no_time:
            flop = 2 * b * n * c * (qc + q)
            tk = time_ms(lambda: pa.ep_pool_proj_attend(qs, tok, w))
            tu = time_ms(lambda: pa.ep_pool_attend(
                qs, tok, F.linear(tok, w).view(b, n, q, -1)))
            tl = time_ms(lambda: F.linear(tok, w))
            bound = flop / PEAK_BF16 * 1e3
            print(f"  time: G {tk:.3f} ms ({flop / tk / 1e9:.0f} TFLOP/s), bound "
                  f"{bound:.3f} ms (operations, {bound / tk:.0%}); unfused pair "
                  f"{tu:.3f} ms, F.linear {tl:.3f} ms", flush=True)
            if resident:
                # what the resident blocks read again for each column tile
                # (a panel each) and all of them for every tile (W), beside
                # the 50 MB L2; computed from the shapes, not measured
                mb = (resident * 128 * c * 2 + qc * c * 2) / 1e6
                print(f"  re-read working set: {mb:.1f} MB (the resident "
                      f"blocks' panels and W) of the 50 MB L2", flush=True)
        del qs, tok, w, out, again
        torch.cuda.empty_cache()
    return ok


def check_ln_quant(rng, args, m) -> bool:
    """ln_quant against its plain version: codes differing by at most one step
    in under 1e-3 of them, scales within 1e-5; a zero row (the scale's floor);
    gamma = 0 with betas at odd multiples of sx / 2 (every quotient a half:
    rounded half to even); twice, equal bit for bit; timed beside its bound."""
    print("ln_quant (codes and scales against the plain version; twice, equal)")
    ok = True
    eps = 1e-6
    cases = [(1, d) for d in (128, 384, 768, 1024, 1280, 1408, 2176)] + [
        (111, d) for d in (128, 384, 768, 1024, 1280, 1408, 2176)] + [
        (512 * 197, 768), (128 * 257, 1280), (128 * 197, 1024), (512 * 197, 1408)]
    for mrows, d in cases:
        if args.big and mrows < 1000:
            continue
        x = rand(rng, (1, mrows, d))
        g = 1 + rand(rng, (d,), 0.1, torch.float32)
        be = rand(rng, (d,), 0.1, torch.float32)
        if mrows > 1:
            x[0, mrows // 2] = 0  # with beta = 0 below: the floor of the scale
        hq, sx = m.ln_quant(x, g, be, eps)
        hq2, sx2 = m.ln_quant(x, g, be, eps)
        hq_r, sx_r = m.ln_quant_ref(x, g, be, eps)
        d_codes = (hq.int() - hq_r.int()).abs()
        share = float((d_codes != 0).float().mean())
        rel = float(((sx - sx_r).abs() / sx_r).max())
        same = bool(torch.equal(hq, hq2)) and bool(torch.equal(sx, sx2))
        good = (int(d_codes.max()) <= 1 and share < 1e-3 and rel <= 1e-5
                and same)
        print(f"  ln_quant M={mrows} D={d}: codes differing {share:.2e}, "
              f"largest {int(d_codes.max())}, sx rel {rel:.1e}, repeat equal "
              f"{same} {'ok' if good else 'FAIL'}", flush=True)
        ok &= good
        if mrows < 1000:
            # every h = beta (gamma = 0): quotients at exact halves, and a
            # row of zeros with beta = 0 at the scale's floor
            half = torch.arange(d, device="cuda", dtype=torch.float32)
            be_h = ((half % 254) - 127 + 0.5) / 64  # odd multiples of 1/128
            be_h[0] = 127 / 64                      # sx = 1/64 exactly
            z = torch.zeros_like(g)
            hq, sx = m.ln_quant(x, z, be_h, eps)
            hq_r, sx_r = m.ln_quant_ref(x, z, be_h, eps)
            hz, sz = m.ln_quant(x, g, z, eps)
            hz_r, sz_r = m.ln_quant_ref(x, g, z, eps)
            floor = float(sz[0, mrows // 2]) if mrows > 1 else None
            good = (bool(torch.equal(hq, hq_r)) and bool(torch.equal(sx, sx_r))
                    and (mrows == 1 or not bool(hz[0, mrows // 2].any())))
            print(f"    halves: codes equal {bool(torch.equal(hq, hq_r))}, "
                  f"scales equal {bool(torch.equal(sx, sx_r))}; zero row's "
                  f"scale {floor} (plain "
                  f"{float(sz_r[0, mrows // 2]) if mrows > 1 else None}) "
                  f"{'ok' if good else 'FAIL'}", flush=True)
            ok &= good
        if mrows >= 1000 and not args.no_time:
            tk = time_ms(lambda: m.ln_quant(x, g, be, eps))
            bound = (3 * mrows * d + 8 * d + 4 * mrows) / HBM_RATE * 1e3
            print(f"  time: ln_quant {tk:.3f} ms, bound {bound:.3f} ms (bytes, "
                  f"{bound / tk:.0%})", flush=True)
        del x, hq, hq2, hq_r
        torch.cuda.empty_cache()
    return ok


if __name__ == "__main__":
    sys.exit(main())
