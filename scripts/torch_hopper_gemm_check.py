#!/usr/bin/env python3
"""Each of ep_tpu_torch's kernels against its plain version on one H100, and
its time beside its bound, its plain version and the library.

    python3 scripts/torch_hopper_gemm_check.py [--no-time]
                               [--only gemm cell fc1 fc2 half flash core bwd
                                       pool lnq proj ln1 swiglu fc1_gelu lars
                                       rope ls backbone]
                               [--root DIR]

Builds ep_tpu_torch/csrc and prints ptxas' lines for the wgmma kernels
(registers, spills, warnings). Then, group by group, at the paths' full
shapes (the edges of the kernels' tiles and small ragged shapes are
tests/test_torch_cuda.py's; chip_smoke.py runs these checks too): kernels A
(ln_qkv) and C (proj_residual), with A's row statistics; the supercell
forward and gradients (A, B, C, E, LN1's gradient); the int8 fc1 (codes and
scales equal bit for bit), fc2 (equal bit for bit in its tier's bias order)
and the whole int8 half in the tier ops/mlp_int8.py::plan gives it; the
attention kernels F (attn_flash; at head widths 72 and 128 too), B
(attn_core) and E (attn_core_bwd, twice, equal bit for bit) and the tiled
backward past E's limit; kernel D (ep_pool) and the int8 ln_quant, twice,
equal bit for bit; kernel G
(ep_pool_proj), D and G also at 128 queries;
LN1's gradient (ln1_apply, ln1_bwd) at fine-tuning's ViT-B/16 and ViT-H/14
shapes; SwiGLU's gate at DINOv2-g/14's probe shape; fc1 with its GELU in
cuBLASLt's epilogue (fc1_gelu_epilogue, a route and not a kernel) at the
probe cells' MLP shapes, beside F.linear + F.gelu; LARS's kernel pair over
ViT-B/16's fine-tuning leaves and the gradient norm; the RoPE pass at
DINOv3 ViT-7B/16's 448-px shape (equal bit for bit to its plain chain),
beside the chain; LayerScale and the residual as one pass at the DINOv2-g
and DINOv3 probe cells' shapes (equal bit for bit to the chain), beside the
chain; and the backbone
family's shapes (B at T=261 and 272, D at DINOv2-L's and DINOv2-g's). Each
is timed beside its bound (benchmark/peaks.py's bound_s, at the
H100's int8 rate for the int8 products and its f32 rate for elementwise
work) and the PyTorch call that computes the same function. Every check
adds a row to ROWS (its kernel, shape, pass, error and times); the last
line says ALL OK or FAILED. A few minutes of card time: the first thing to
run after a change to a kernel.

--root DIR imports ep_tpu_torch from another checkout (an earlier commit
unpacked beside this one) and builds that tree's kernels, so that one call can
time two versions of a kernel with the same script and inputs; the peaks
stay this checkout's.
"""
from __future__ import annotations

import argparse
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from benchmark.peaks import H100_SXM, bound_s  # noqa: E402

# |kernel - plain| <= ATOL + RTOL*|plain|: about two bf16 steps at unit size
# (both round to bf16 at the same points and sum in another order).
ATOL = RTOL = 1e-2
# Where an output averages hundreds of keys or tokens (kernels F, D and G at
# 448 px and ViT-H), its values are around 0.05 and ATOL is a quarter of
# them. So beside ATOL, RTOL at most STEP_SHARE of the elements, and never
# fewer than STEP_FLOOR, may lie past one bf16 step of the value (2**-7 of
# it) plus one at the plain version's mean magnitude. A key or token dropped
# from such an average moves it by about 1e-3, past that bound at about half
# of the elements. A row's largest probability that rounds to the other bf16
# neighbour moves single elements that far (measured on an H100: at most 2
# of kernel D's 163,840 outputs at ViT-H), so the bound grows with the
# element count and has a floor of a few elements.
STEP, STEP_SHARE, STEP_FLOOR = 2.0 ** -7, 1e-5, 4
GROUPS = ("gemm", "cell", "fc1", "fc2", "half", "flash", "core", "bwd", "pool",
          "lnq", "proj", "ln1", "swiglu", "fc1_gelu", "lars", "rope", "ls",
          "backbone")
# kernel B at the paths' shapes, and at the backbone family's: DINOv2-L's
# T = 1 + 4 registers + 256 and CAPI's 16 registers + 256 (B's last key bin)
CORE_SHAPES = ((512, 197, 12, 64), (128, 256, 16, 80), (128, 257, 16, 80))
CORE_BACKBONE = ((512, 261, 16, 64), (512, 272, 16, 64))
# kernel D: (B, N, C, Q, prefix tokens before the N pooled ones); ep_all
# pools every token of ViT-B/16 at batch 512
POOL_SHAPES = ((512, 196, 768, 32, 1), (128, 256, 1280, 32, 1),
               (64, 1024, 1280, 32, 1), (16, 196, 1024, 32, 1),
               (512, 197, 768, 32, 0), (512, 196, 768, 128, 1))
POOL_BACKBONE = ((512, 256, 1024, 32, 5), (64, 256, 1536, 32, 1))
# One row per check: chip_smoke.py prints them as its ``kernels`` line.
ROWS: list[dict] = []


def record(kernel, shape, ok, **numbers) -> dict:
    """A check of ``kernel`` (its LAUNCHES name where it has one) at
    ``shape``: whether it passed, and its numbers (max_abs_err, ms, bound_ms,
    library_ms, ...), which the caller may add to the row it returns."""
    ROWS.append(dict(kernel=kernel, shape=str(shape), ok=bool(ok), **numbers))
    return ROWS[-1]


def bound_ms(ops, moved, rate="bf16_flops"):
    """benchmark/peaks.py's bound_s in ms, with the operations at the H100's
    peak ``rate`` (int8_ops for the int8 kernels, f32_flops for f32
    elementwise work), and whether operations or bytes bound it."""
    peak = dict(H100_SXM, bf16_flops=H100_SXM[rate])
    by = ("operations" if ops / peak["bf16_flops"] >= moved / peak["hbm_bytes"]
          else "bytes")
    return bound_s(ops, moved, peak) * 1e3, by


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


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


def graph_ms(fn, iters=20, replays=5):
    """Device ms a call of ``fn``, its ``iters`` calls captured in one CUDA
    graph and replayed: for a kernel shorter than its launch's host time,
    which time_ms would measure instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (iters * replays)


def steps_past(out, ref) -> tuple[int, int]:
    """The elements of ``out`` past STEP*mean|ref| + STEP*|ref|, and how many
    may be: STEP_SHARE of them, STEP_FLOOR whatever the count."""
    out, ref = out.float(), ref.float()
    past = int(((out - ref).abs() > STEP * ref.abs().mean()
                + STEP * ref.abs()).sum())
    return past, max(math.ceil(STEP_SHARE * ref.numel()), STEP_FLOOR)


def close(kernel, shape, out, ref, steps=False, atol=ATOL, rtol=RTOL,
          note="") -> dict:
    """|out - ref| <= atol + rtol*|ref| and out finite; with ``steps``, also
    steps_past's bound. Prints and records the check."""
    torch.cuda.synchronize()
    d = (out.float() - ref.float()).abs()
    ok = bool((d <= atol + rtol * ref.float().abs()).all()) and bool(
        torch.isfinite(out.float()).all())
    if steps:
        past, limit = steps_past(out, ref)
        ok = ok and past <= limit
        note += f", {past} past one bf16 step (at most {limit})"
    print(f"  {kernel} {shape}{note}: max_abs_err {float(d.max()):.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return record(kernel, shape, ok, max_abs_err=float(d.max()))


def scaled(kernel, shape, out, ref, tol=1e-2, note="") -> dict:
    """``close`` with atol ``tol`` of ref's largest magnitude and rtol ``tol``:
    for gradients, which sum many bf16 products."""
    return close(kernel, shape, out, ref, atol=tol * float(
        ref.float().abs().max()), rtol=tol, note=note)


def check(kernel, shape, ok, text, **numbers) -> dict:
    print(f"  {kernel} {shape}: {text} {'ok' if ok else 'FAIL'}", flush=True)
    return record(kernel, shape, ok, **numbers)


def run(only=GROUPS, timed=True) -> bool:
    """Build the kernels, then run the checks of the groups in ``only``, each
    timed where ``timed``. True where every check passed; each is a row of
    ROWS."""
    from ep_tpu_torch.ops import _build
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
    first = len(ROWS)
    checks = dict(gemm=check_gemm, cell=check_cell, fc1=check_fc1,
                  fc2=check_fc2, half=check_half, flash=check_flash,
                  core=lambda r, t: check_core(r, t, CORE_SHAPES),
                  bwd=check_bwd, pool=lambda r, t: check_pool(r, t, POOL_SHAPES),
                  lnq=check_ln_quant, proj=check_proj, ln1=check_ln1,
                  swiglu=check_swiglu, fc1_gelu=check_fc1_gelu,
                  lars=check_lars, rope=check_rope, ls=check_ls,
                  backbone=check_backbone)
    for group in GROUPS:
        if group in only:
            checks[group](rng, timed)
            torch.cuda.empty_cache()
    ok = all(r["ok"] for r in ROWS[first:])
    print("ALL OK" if ok else "FAILED", flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-time", action="store_true")
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
    return 0 if run(args.only, not args.no_time) else 1


def check_gemm(rng, timed) -> None:
    """Kernels A and C against their plain versions at the paths' shapes, A's
    row statistics against the f32 mean and rsqrt(var + eps) (within 1e-5 +
    1e-5 rel), and the times beside the library's LayerNorm + linear and
    linear + add."""
    from ep_tpu_torch.ops import _build
    from ep_tpu_torch.ops.attn_block import (ln_qkv, ln_qkv_ref, proj_residual,
                                             proj_residual_ref)
    print("A ln_qkv and C proj_residual")
    for b, t, d in ((512, 197, 768), (128, 257, 1280), (64, 1025, 1280)):
        x = rand(rng, (b, t, d))
        w = rand(rng, (3 * d, d), d ** -0.5)
        bq = rand(rng, (3 * d,), 0.02, torch.float32)
        g = 1 + rand(rng, (d,), 0.1, torch.float32)
        be = rand(rng, (d,), 0.1, torch.float32)
        a_args = (x, g, be, w, bq, 1e-6)
        ra = close("ln_qkv_gemm", (b, t, d), ln_qkv(*a_args), ln_qkv_ref(*a_args))
        o = rand(rng, (b, t, d))
        wp = rand(rng, (d, d), d ** -0.5)
        bp = rand(rng, (d,), 0.02, torch.float32)
        rc = close("proj_residual_gemm", (b, t, d), proj_residual(o, wp, bp, x),
                   proj_residual_ref(o, wp, bp, x))
        m = b * t
        stats = torch.empty(m, 2, device="cuda", dtype=torch.float32)

        def row_stats():
            _build.call("ep_ln_row_stats", x.data_ptr(), stats.data_ptr(), m, d,
                        1e-6, _build.stream_ptr(x))

        row_stats()
        xf = x.float().view(m, d)
        want = torch.stack([xf.mean(-1), torch.rsqrt(
            xf.var(-1, unbiased=False) + 1e-6)], -1)
        rs = close("ln_qkv_gemm", f"row statistics ({m}, {d})", stats, want,
                   atol=1e-5, rtol=1e-5)
        del xf, want
        if timed:
            g16, be16, bq16, bp16 = (v.bfloat16() for v in (g, be, bq, bp))
            flop = 2 * m * d * d
            ra.update(ms=time_ms(lambda: ln_qkv(*a_args)), library_ms=time_ms(
                lambda: F.linear(F.layer_norm(x, (d,), g16, be16, 1e-6), w, bq16)))
            rc.update(ms=time_ms(lambda: proj_residual(o, wp, bp, x)),
                      library_ms=time_ms(lambda: x + F.linear(o, wp, bp16)))
            ra["bound_ms"], by_a = bound_ms(3 * flop, nbytes(x, w, bq, g, be)
                                            + 3 * nbytes(x))
            rc["bound_ms"], by_c = bound_ms(flop, nbytes(o, wp, bp, x) + nbytes(x))
            rs["ms"] = time_ms(row_stats)
            print(f"  time ({b},{t},{d}): A {ra['ms']:.3f} ms, bound "
                  f"{ra['bound_ms']:.3f} ({by_a}), library {ra['library_ms']:.3f}, "
                  f"its row statistics alone {rs['ms']:.3f}; C {rc['ms']:.3f} "
                  f"ms, bound {rc['bound_ms']:.3f} ({by_c}), library "
                  f"{rc['library_ms']:.3f}", flush=True)
        del x, w, o, stats
        torch.cuda.empty_cache()


def check_cell(rng, timed) -> None:
    """The supercell (kernels A, B, C forward; A and B recomputed, E, cuBLAS
    products and LN1's gradient backward) against its plain version at
    fine-tuning's ViT-B/16 and ViT-H/14 shapes, f32 master weights: the
    output within ATOL, RTOL, each gradient within 2e-2 of its largest
    magnitude (they sum B*T bf16 products); forward and backward timed
    beside the plain version's."""
    from ep_tpu_torch.ops.attn_block import attn_supercell, attn_supercell_ref
    print("the supercell, forward and gradients")
    for b, t, d, h in ((512, 197, 768, 12), (128, 257, 1280, 16)):
        f32 = torch.float32
        leaves = [v.requires_grad_(True) for v in (
            rand(rng, (b, t, d)), rand(rng, (3 * d, d), d ** -0.5, f32),
            rand(rng, (3 * d,), 0.02, f32), 1 + rand(rng, (d,), 0.1, f32),
            rand(rng, (d,), 0.1, f32), rand(rng, (d, d), d ** -0.5, f32),
            rand(rng, (d,), 0.02, f32))]
        g, sc = rand(rng, (b, t, d)), (d // h) ** -0.5

        def fwd_bwd(fn):
            out = fn(*leaves, h, sc)
            return (out.detach(), *torch.autograd.grad(out, leaves, g))

        got, ref = fwd_bwd(attn_supercell), fwd_bwd(attn_supercell_ref)
        row = close("attn_supercell", (b, t, d), got[0], ref[0])
        for name, a, r in zip(("x", "w_qkv", "b_qkv", "gamma", "beta",
                               "w_proj", "b_proj"), got[1:], ref[1:]):
            scaled("attn_supercell", (b, t, d), a, r, 2e-2, f" d{name}")
        del got, ref
        if timed:
            row.update(ms=time_ms(lambda: fwd_bwd(attn_supercell), 5),
                       plain_ms=time_ms(lambda: fwd_bwd(attn_supercell_ref), 2))
            print(f"  time: forward and backward {row['ms']:.3f} ms, the plain "
                  f"version's {row['plain_ms']:.3f} ms", flush=True)
        del leaves, g
        torch.cuda.empty_cache()


def check_fc1(rng, timed) -> None:
    """fc1's codes and scales equal to its plain version's, with a token at
    the scale's floor and a stripe whose GELU is all zero, at the paths'
    shapes (and ViT-B's with 8 stripes: the same work without clusters);
    timed beside torch._int_mm and its bound at the int8 rate."""
    from ep_tpu_torch.ops import mlp_int8 as m
    print("fc1 (codes and scales equal to the plain version's)")
    for b, t, d, s in ((512, 197, 768, 1), (128, 197, 1024, 8),
                       (128, 257, 1280, 8), (512, 197, 768, 8)):
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
        row = check("mlp_int8_fc1", (b, t, d, s), diff == 0 and bool(
            torch.equal(sa, sa_r)), f"tiling {m.fc1_tiling(dh // s)}: codes "
            f"differing {diff}, scales equal {bool(torch.equal(sa, sa_r))}, "
            f"floor row sa {float(sa[0, t // 2, 0]):.3e}")
        if timed:
            ops = 2 * b * t * d * dh
            row.update(ms=time_ms(lambda: m.fc1(hq, sx, w1q, s1, b1, s)),
                       library_ms=time_ms(lambda: torch._int_mm(hq.view(-1, d),
                                                               w1q.t())))
            row["bound_ms"], by = bound_ms(
                ops, nbytes(hq, sx, w1q, s1, b1, aq, sa), "int8_ops")
            print(f"  time: fc1 {row['ms']:.3f} ms ({ops / row['ms'] / 1e9:.0f} "
                  f"TOP/s), bound {row['bound_ms']:.3f} ms ({by}, "
                  f"{row['bound_ms'] / row['ms']:.0%}), torch._int_mm "
                  f"{row['library_ms']:.3f} ms", flush=True)
        del hq, aq, aq_r, w1q
        torch.cuda.empty_cache()


def check_fc2(rng, timed) -> None:
    """fc2 equal to its plain version in its tier's bias order, timed beside
    torch._int_mm and its bound at the int8 rate."""
    from ep_tpu_torch.ops import mlp_int8 as m
    print("fc2 (equal to the plain version's in the tier's bias order)")
    for b, t, d, s in ((512, 197, 768, 1), (128, 197, 1024, 8),
                       (128, 257, 1280, 8)):
        dh = 4 * d
        tier = m.plan(t, d, dh)[0]
        aq = torch.from_numpy(rng.integers(-127, 128, (b, t, dh), dtype=np.int8)).cuda()
        sa = rand(rng, (b, t, s), 0.01, torch.float32).abs() + 1e-3
        w2q, s2 = m.quantize_weight(rand(rng, (d, dh), dh ** -0.5))
        x, b2 = rand(rng, (b, t, d)), rand(rng, (d,), 0.1, torch.float32)
        out = m.fc2(aq, sa, x, w2q, s2, b2, s, tier)
        same = bool(torch.equal(out, m.fc2_ref(aq, sa, x, w2q, s2, b2, s, tier)))
        row = check("mlp_int8_fc2", (b, t, d, s), same, f"{tier}: equal {same}")
        if timed:
            ops = 2 * b * t * d * dh
            row.update(ms=time_ms(lambda: m.fc2(aq, sa, x, w2q, s2, b2, s, tier)),
                       library_ms=time_ms(lambda: torch._int_mm(aq.view(-1, dh),
                                                               w2q.t())))
            row["bound_ms"], by = bound_ms(
                ops, nbytes(aq, sa, w2q, s2, b2, x, out), "int8_ops")
            print(f"  time: fc2 {row['ms']:.3f} ms ({ops / row['ms'] / 1e9:.0f} "
                  f"TOP/s), bound {row['bound_ms']:.3f} ms ({by}, "
                  f"{row['bound_ms'] / row['ms']:.0%}), torch._int_mm "
                  f"{row['library_ms']:.3f} ms", flush=True)
        del aq, w2q, x, out
        torch.cuda.empty_cache()


def check_half(rng, timed) -> None:
    """The int8 MLP half at ViT-B (batch 512), ViT-L and ViT-H (128) in the
    tier ops/mlp_int8.py::plan gives each. ln_quant sums its row statistics
    in another order than torch, which moves single codes of LN2's output by
    one step, in under 1e-3 of them; fc1 on the same codes may differ in
    1e-6 of its codes (a tanh rounded otherwise; none measured); through
    the whole half a moved LN code moves hidden codes, in at most 1e-2 of
    them. The half's output within ATOL, RTOL on the tokens whose LN codes
    and scale agree, within 1e-2 of its largest value elsewhere; against the
    bf16 half (approximate by design) the JAX package's kernel gate: mean
    |d| / mean |ref| <= 3e-2, max |d| / max |ref| <= 0.6; an all-zero token
    finite. Timed beside the plain int8 half and the bf16 half."""
    from ep_tpu_torch.ops import mlp_int8 as m

    def code_diff(a, b):
        d = (a.int() - b.int()).abs()
        return float((d != 0).float().mean()), int(d.max())

    print("the int8 MLP half")
    for b, t, d, tier in ((512, 197, 768, ("resident", 1)),
                          (128, 197, 1024, ("resident", 8)),
                          (128, 257, 1280, ("two_kernel", 8))):
        dh, s, shape = 4 * d, tier[1], (b, t, d, tier[1])
        check("mlp_int8_half", shape, m.plan(t, d, dh) == tier,
              f"plan gives {m.plan(t, d, dh)}, expected {tier}")
        x = rand(rng, (b, t, d))
        x[0, t // 2] = 0.0
        w1, b1 = rand(rng, (dh, d), d ** -0.5), rand(rng, (dh,), 0.1)
        w2, b2 = rand(rng, (d, dh), dh ** -0.5), rand(rng, (d,), 0.1)
        gamma, beta = 1 + rand(rng, (d,), 0.1), rand(rng, (d,), 0.1)
        hw = (x, w1, b1, w2, b2, gamma, beta, 1e-6)
        w1q, s1 = m.quantize_weight(w1)
        hq, sx = m.ln_quant(x, gamma, beta, 1e-6)
        hq_r, sx_r = m.ln_quant_ref(x, gamma, beta, 1e-6)
        share, worst = code_diff(hq, hq_r)
        check("mlp_int8_ln_quant", shape, worst <= 1 and share < 1e-3 and bool(
            torch.isfinite(sx).all()), f"LN codes differing {share:.2e}, "
            f"largest {worst}")
        aq, sa = m.fc1(hq, sx, w1q, s1, b1, s)
        share, worst = code_diff(aq, m.fc1_ref(hq, sx, w1q, s1, b1, s)[0])
        check("mlp_int8_fc1", shape, worst <= 1 and share <= 1e-6,
              f"hidden codes on the same LN codes differing {share:.2e}")
        share, _ = code_diff(aq, m.fc1_ref(hq_r, sx_r, w1q, s1, b1, s)[0])
        check("mlp_int8_half", shape, share <= 1e-2,
              f"hidden codes through the whole half differing {share:.2e}")
        ref = m.mlp_int8_ref(*hw, s, tier[0])
        out = m.mlp_int8_forward(*hw, s, tier[0])
        same = (hq == hq_r).all(-1) & (sx == sx_r).all(-1)
        row = close("mlp_int8_half", shape, out[same], ref[same],
                    note=f", the {int(same.sum())} of {b * t} tokens whose LN "
                    "codes agree")
        if not bool(same.all()):
            scaled("mlp_int8_half", shape, out[~same], ref[~same],
                   note=", the other tokens")
        ref16 = m.mlp_bf16_ref(*hw).float()
        dd = (out.float() - ref16).abs()
        mean_rel = float(dd.mean() / ref16.abs().mean())
        max_rel = float(dd.max() / ref16.abs().max())
        check("mlp_int8_half", shape, mean_rel <= 3e-2 and max_rel <= 0.6
              and bool(torch.isfinite(out[0, t // 2]).all()),
              f"against the bf16 half: mean rel {mean_rel:.3e}, max rel "
              f"{max_rel:.3e}", mean_rel_vs_bf16=mean_rel)
        del ref, ref16, dd, hq_r, sx_r, aq, sa, out

        def bf16_half():  # the port's bf16 MLP half (models/vit.py::Block)
            h = F.layer_norm(x, (d,), gamma, beta, 1e-6)
            return x + F.linear(F.gelu(F.linear(h, w1, b1), approximate="tanh"),
                                w2, b2)

        if timed:
            row.update(ms=time_ms(lambda: m.mlp_int8_forward(*hw, s, tier[0])),
                       plain_ms=time_ms(lambda: m.mlp_int8_ref(*hw, s, tier[0]), 3),
                       library_ms=time_ms(bf16_half))
            print(f"  time: the half {row['ms']:.3f} ms, the plain int8 half "
                  f"{row['plain_ms']:.3f} ms, the bf16 half (LN2, cuBLAS fc1, "
                  f"GELU, cuBLAS fc2, residual) {row['library_ms']:.3f} ms",
                  flush=True)
        del x, w1, w2, w1q, hq, hw
        torch.cuda.empty_cache()


def check_flash(rng, timed) -> None:
    """Kernel F against kernel B's plain version at temperature 1.5 (with the
    bound on the elements past one bf16 step), timed beside SDPA and its
    bound at the paths' shapes (448 px's, the row-tiled ViT-H at 224,
    DINOv3 ViT-7B/16's head width 128 at 448 px and at a short T, and
    SigLIP2 SO400M/14's head width 72 at 384 px)."""
    from ep_tpu_torch.ops.attn_fused import attention_qkv_fused_ref
    from ep_tpu_torch.ops.flash_attn import attn_flash
    print("F attn_flash")
    for b, t, h, dh in ((64, 1025, 16, 80), (64, 785, 12, 64),
                        (128, 257, 16, 80), (8, 789, 32, 128),
                        (2, 201, 32, 128), (128, 729, 16, 72)):
        qkv = rand(rng, (b, t, 3 * h * dh))
        sc = dh ** -0.5
        row = close("attn_flash", (b, t, h, dh), attn_flash(qkv, h, sc, 1.5),
                    attention_qkv_fused_ref(qkv, h, sc, 1.5), steps=True)
        if timed:
            q, k, v = (u.contiguous() for u in
                       qkv.view(b, t, 3, h, dh).permute(2, 0, 3, 1, 4).unbind(0))
            flop = 4 * b * h * t * t * dh
            row.update(ms=time_ms(lambda: attn_flash(qkv, h, sc)),
                       library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                           q, k, v, scale=sc)))
            row["bound_ms"], by = bound_ms(flop, nbytes(qkv) + nbytes(qkv) // 3)
            print(f"  time: F {row['ms']:.3f} ms ({flop / row['ms'] / 1e9:.0f} "
                  f"TFLOP/s of the two products), bound {row['bound_ms']:.3f} ms "
                  f"({by}), SDPA {row['library_ms']:.3f} ms", flush=True)
            del q, k, v
        del qkv
        torch.cuda.empty_cache()


def check_bwd(rng, timed) -> None:
    """Kernel E against its plain backward (1e-2 of the largest |ref| plus
    1e-2 rel), twice, equal bit for bit, timed beside SDPA's backward; then
    the tiled plain backward past E's limit (attention_qkv_fused_bwd_long) at
    fine-tuning's ViT-H/14 448-px shape against the CPU's run of it on two
    images and against E's plain version, which casts dL and the scale in
    another order."""
    from ep_tpu_torch.ops.attn_fused import (attention_qkv_fused_bwd,
                                             attention_qkv_fused_bwd_long,
                                             attention_qkv_fused_bwd_ref)

    def sdpa_bwd_ms(qkv, g, b, t, h, dh, iters=10):
        ql = [u.detach().requires_grad_(True) for u in
              qkv.view(b, t, 3, h, dh).permute(2, 0, 3, 1, 4).unbind(0)]
        ol = F.scaled_dot_product_attention(*ql, scale=dh ** -0.5)
        gl = g.view(b, t, h, dh).transpose(1, 2)
        return time_ms(lambda: torch.autograd.grad(ol, ql, gl, retain_graph=True),
                       iters)

    print("E attn_core_bwd (twice, equal)")
    for b, t, h, dh in ((512, 197, 12, 64), (128, 257, 16, 80)):
        qkv = rand(rng, (b, t, 3 * h * dh))
        g = rand(rng, (b, t, h * dh))
        sc = dh ** -0.5
        out = attention_qkv_fused_bwd(qkv, g, h, sc, 1.5)
        same = bool(torch.equal(out, attention_qkv_fused_bwd(qkv, g, h, sc, 1.5)))
        row = scaled("attn_core_bwd", (b, t, h, dh), out,
                     attention_qkv_fused_bwd_ref(qkv, g, h, sc, 1.5),
                     note=f", repeat equal {same}")
        row["ok"] &= same
        if timed:
            row.update(ms=time_ms(lambda: attention_qkv_fused_bwd(qkv, g, h, sc)),
                       library_ms=sdpa_bwd_ms(qkv, g, b, t, h, dh))
            print(f"  time: E {row['ms']:.3f} ms, SDPA's backward "
                  f"{row['library_ms']:.3f} ms", flush=True)
        del qkv, g, out
        torch.cuda.empty_cache()
    print("the backward past E's limit (128 query rows a tile)")
    b, t, h, dh = 32, 1025, 16, 80
    qkv, g, sc = rand(rng, (b, t, 3 * h * dh)), rand(rng, (b, t, h * dh)), dh ** -0.5
    out = attention_qkv_fused_bwd_long(qkv, g, h, sc)[:2]
    row = scaled("attn_bwd_long", (b, t, h, dh), out.cpu(),
                 attention_qkv_fused_bwd_long(qkv[:2].cpu(), g[:2].cpu(), h, sc),
                 note=", images 0-1 against the CPU's")
    scaled("attn_bwd_long", (b, t, h, dh), out,
           attention_qkv_fused_bwd_ref(qkv[:2], g[:2], h, sc),
           note=", against E's plain version")
    if timed:
        row.update(ms=time_ms(lambda: attention_qkv_fused_bwd_long(qkv, g, h, sc), 3),
                   library_ms=sdpa_bwd_ms(qkv, g, b, t, h, dh, 3))
        row["bound_ms"], by = bound_ms(10 * b * h * t * t * dh,
                                       2 * nbytes(qkv) + nbytes(g))
        print(f"  time: {row['ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
              f"({by}), SDPA's backward {row['library_ms']:.3f} ms", flush=True)
    del qkv, g, out
    torch.cuda.empty_cache()


def check_core(rng, timed, shapes) -> None:
    """Kernel B against its plain version at temperature 1.5, a second call
    equal bit for bit, and its time beside its bound and SDPA at the paths'
    shapes."""
    from ep_tpu_torch.ops.attn_fused import (attention_core,
                                             attention_qkv_fused_ref)
    print("B attn_core")
    for b, t, h, dh in shapes:
        qkv = rand(rng, (b, t, 3 * h * dh))
        sc = dh ** -0.5
        out = attention_core(qkv, h, sc, 1.5, variant="core")
        same = bool(torch.equal(out, attention_core(qkv, h, sc, 1.5,
                                                    variant="core")))
        row = close("attn_core", (b, t, h, dh), out,
                    attention_qkv_fused_ref(qkv, h, sc, 1.5),
                    note=f", repeat equal {same}")
        row["ok"] &= same
        if timed:
            q, k, v = (u.contiguous() for u in
                       qkv.view(b, t, 3, h, dh).permute(2, 0, 3, 1, 4).unbind(0))
            tk = time_ms(lambda: attention_core(qkv, h, sc, variant="core"))
            tl = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=sc))
            bnd, by = bound_ms(4 * b * h * t * t * dh,
                               nbytes(qkv) + nbytes(qkv) // 3)
            row.update(ms=tk, bound_ms=bnd, library_ms=tl)
            print(f"  time: B {tk:.3f} ms, bound {bnd:.3f} ms ({by}, "
                  f"{bnd / tk:.0%}), SDPA {tl:.3f} ms", flush=True)
            del q, k, v
        del qkv, out
        torch.cuda.empty_cache()


def check_pool(rng, timed, shapes) -> None:
    """Kernel D against its plain version (with the bound on the elements
    past one bf16 step), twice (equal bit for bit), and its time beside its
    bound and one SDPA call at the paths' shapes."""
    from ep_tpu_torch.ops import _build
    from ep_tpu_torch.ops import pool_attn as pa
    print("D ep_pool (the tokens past the prefix: a view; twice, equal)")
    for b, n, c, q, pre in shapes:
        cq = c // q
        qs = rand(rng, (q, c), c ** -0.5)
        tok = rand(rng, (b, n + pre, c))[:, pre:]
        v = rand(rng, (b, n, q, cq))
        out = pa.ep_pool_attend(qs, tok, v)
        again = pa.ep_pool_attend(qs, tok, v)
        tiling = ""
        if hasattr(pa, "ep_pool_tiling"):  # of one launch: at most 64 queries
            qg = min(q, 64)
            cl, tl_ = pa.ep_pool_tiling(n, c, qg, qg * cq)
            resident = _build.query("ep_pool_resident_clusters", qg, qg * cq,
                                    cl, tl_)
            tiling = f" tiling {(cl, tl_)}, resident clusters {resident}"
        same = bool(torch.equal(out, again))
        row = close("ep_pool", (b, n, c, q, pre), out,
                    pa.ep_pool_attend_ref(qs, tok, v), steps=True,
                    note=f"{tiling}, repeat equal {same}")
        row["ok"] &= same
        if timed:
            tk = time_ms(lambda: pa.ep_pool_attend(qs, tok, v))
            tl = time_ms(lambda: F.scaled_dot_product_attention(
                qs[None, :, None, :].expand(b, -1, -1, -1),
                tok[:, None].expand(-1, q, -1, -1), v.permute(0, 2, 1, 3),
                scale=1.0))
            bnd, by = bound_ms(2 * b * n * (q * c + c),
                               2 * b * n * c + 2 * b * n * q * cq + 2 * q * c
                               + 2 * b * q * cq)
            row.update(ms=tk, bound_ms=bnd, library_ms=tl)
            print(f"  time: D {tk:.3f} ms, bound {bnd:.3f} ms ({by}, "
                  f"{bnd / tk:.0%}), SDPA {tl:.3f} ms", flush=True)
        del qs, tok, v, out, again
        torch.cuda.empty_cache()


def check_proj(rng, timed) -> None:
    """Kernel G against its plain version (ATOL, RTOL and the bound on the
    elements past one bf16 step), twice (equal bit for bit), at the paths'
    shapes and at 128 queries (two launches), and its time beside its bound
    (operations), the unfused pair (F.linear, then kernel D) and F.linear
    alone. A checkout whose G refuses a shape says so and goes on."""
    from ep_tpu_torch.ops import _build
    from ep_tpu_torch.ops import pool_attn as pa
    print("G ep_pool_proj (the patch-token view x[:, 1:]; twice, equal)")
    for b, n, c, q, qc in ((512, 196, 768, 32, 768), (128, 256, 1280, 32, 1280),
                           (64, 1024, 1280, 32, 1280), (512, 196, 768, 128, 768)):
        qs = rand(rng, (q, c), c ** -0.5)
        tok = rand(rng, (b, n + 1, c))[:, 1:]
        w = rand(rng, (qc, c), c ** -0.5)
        tiling, resident = "", 0
        if hasattr(pa, "ep_pool_proj_tiling"):  # of one launch: <= 64 queries
            qg, qcg = min(q, 64), qc // q * min(q, 64)
            cl, panels = pa.ep_pool_proj_tiling(n, c, qg, qcg)
            resident = cl * _build.query("ep_pool_proj_resident_clusters", qg,
                                         qcg, cl)
            tiling = (f" tiling {(cl, panels)}, "
                      f"{pa.ep_pool_proj_smem_bytes(qg, qcg, cl)} bytes a block, "
                      f"{resident} blocks resident")
        try:
            out = pa.ep_pool_proj_attend(qs, tok, w)
        except NotImplementedError as e:
            print(f"  G ({b},{n},{c},{q},{qc}): refused: {e}", flush=True)
            continue
        again = pa.ep_pool_proj_attend(qs, tok, w)
        same = bool(torch.equal(out, again))
        row = close("ep_pool_proj", (b, n, c, q, qc), out,
                    pa.ep_pool_proj_attend_ref(qs, tok, w), steps=True,
                    note=f"{tiling}, repeat equal {same}")
        row["ok"] &= same
        if timed:
            flop = 2 * b * n * c * (qc + q)
            tk = time_ms(lambda: pa.ep_pool_proj_attend(qs, tok, w))
            tu = time_ms(lambda: pa.ep_pool_attend(
                qs, tok, F.linear(tok, w).view(b, n, q, -1)))
            tl = time_ms(lambda: F.linear(tok, w))
            bnd, by = bound_ms(flop, nbytes(qs, w) + 2 * b * n * c + 2 * b * qc)
            row.update(ms=tk, bound_ms=bnd, library_ms=tu)
            print(f"  time: G {tk:.3f} ms ({flop / tk / 1e9:.0f} TFLOP/s), bound "
                  f"{bnd:.3f} ms ({by}, {bnd / tk:.0%}); unfused pair "
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


def check_ln_quant(rng, timed) -> None:
    """ln_quant against its plain version at the paths' rows (ViT-B and
    ViT-g at batch 512, ViT-H and ViT-L at 128): codes differing by at most
    one step in under 1e-3 of them, scales within 1e-5, a zero row; twice,
    equal bit for bit; timed beside its bound."""
    from ep_tpu_torch.ops import mlp_int8 as m
    print("ln_quant (codes and scales against the plain version; twice, equal)")
    eps = 1e-6
    for mrows, d in ((512 * 197, 768), (128 * 257, 1280), (128 * 197, 1024),
                     (512 * 197, 1408)):
        x = rand(rng, (1, mrows, d))
        g = 1 + rand(rng, (d,), 0.1, torch.float32)
        be = rand(rng, (d,), 0.1, torch.float32)
        x[0, mrows // 2] = 0
        hq, sx = m.ln_quant(x, g, be, eps)
        hq2, sx2 = m.ln_quant(x, g, be, eps)
        hq_r, sx_r = m.ln_quant_ref(x, g, be, eps)
        d_codes = (hq.int() - hq_r.int()).abs()
        share = float((d_codes != 0).float().mean())
        rel = float(((sx - sx_r).abs() / sx_r).max())
        same = bool(torch.equal(hq, hq2)) and bool(torch.equal(sx, sx2))
        row = check("mlp_int8_ln_quant", (mrows, d), int(d_codes.max()) <= 1
                    and share < 1e-3 and rel <= 1e-5 and same,
                    f"codes differing {share:.2e}, largest "
                    f"{int(d_codes.max())}, sx rel {rel:.1e}, repeat equal {same}")
        if timed:
            tk = time_ms(lambda: m.ln_quant(x, g, be, eps))
            bnd, by = bound_ms(10 * mrows * d, 3 * mrows * d + 8 * d + 4 * mrows,
                               "f32_flops")
            row.update(ms=tk, bound_ms=bnd)
            print(f"  time: ln_quant {tk:.3f} ms, bound {bnd:.3f} ms ({by}, "
                  f"{bnd / tk:.0%})", flush=True)
        del x, hq, hq2, hq_r
        torch.cuda.empty_cache()


def check_ln1(_, timed) -> None:
    """LN1's gradient (ln1_apply, ln1_bwd) at fine-tuning's shapes, ViT-B/16
    at batch 512 and ViT-H/14 at 128, against the plain version (bf16
    outputs within 1e-2 of their largest magnitude, f32 sums within 1e-3),
    twice (equal bit for bit), and timed beside its bound, the plain chain
    and the library's LayerNorm backward."""
    from ep_tpu_torch.ops.attn_block import (ln1_apply, ln1_backward_ref,
                                             ln1_bwd)
    print("ln1_apply and ln1_bwd (twice, equal)")
    rng = np.random.default_rng(21)
    for b, t, d in ((512, 197, 768), (128, 257, 1280)):
        m = b * t
        first = len(ROWS)
        x = rand(rng, (b, t, d), 2.0) + 0.5
        gamma = 1 + rand(rng, (d,), 0.1, torch.float32)
        beta = rand(rng, (d,), 0.1, torch.float32)
        dxn, g = rand(rng, (b, t, d)), rand(rng, (b, t, d))
        xf = x.float().view(m, d)
        stats = torch.stack([xf.mean(-1), torch.rsqrt(
            xf.var(-1, unbiased=False) + 1e-6)], -1).contiguous()
        del xf
        got, again = ((ln1_apply(x, stats, gamma, beta),
                       *ln1_bwd(x, stats, gamma, dxn, g)) for _ in range(2))
        for name, a, r, a2 in zip(("xn", "g + dx", "dgamma", "dbeta", "dbp"),
                                  got, ln1_backward_ref(x, gamma, beta, dxn, g,
                                                        1e-6), again):
            same = bool(torch.equal(a, a2))
            scaled("ln1_apply" if name == "xn" else "ln1_bwd", (b, t, d), a, r,
                   RTOL if a.dtype == torch.bfloat16 else 1e-3,
                   f" {name}, repeat equal {same}")["ok"] &= same
        del got, again
        if timed:
            plain = time_ms(lambda: ln1_backward_ref(x, gamma, beta, dxn, g,
                                                     1e-6), 3)
            leaves = [x.detach().requires_grad_(True),
                      gamma.bfloat16().requires_grad_(True),
                      beta.bfloat16().requires_grad_(True)]
            y = F.layer_norm(leaves[0], (d,), leaves[1], leaves[2], 1e-6)
            lib = time_ms(lambda: torch.autograd.grad(y, leaves, dxn,
                                                      retain_graph=True))
            del y, leaves
            for name, fn, moved in (
                    ("ln1_apply", lambda: ln1_apply(x, stats, gamma, beta),
                     nbytes(x, stats, gamma, beta) + nbytes(x)),
                    ("ln1_bwd", lambda: ln1_bwd(x, stats, gamma, dxn, g),
                     nbytes(x, stats, gamma, dxn, g) + nbytes(x) + 3 * d * 4)):
                tk = time_ms(fn)
                bnd, by = bound_ms(12 * m * d, moved, "f32_flops")
                ROWS[first if name == "ln1_apply" else first + 1].update(
                    ms=tk, bound_ms=bnd, plain_ms=plain, library_ms=lib)
                print(f"  time: {name} ({m}, {d}) {tk:.3f} ms, bound {bnd:.3f} "
                      f"ms ({by}, {bnd / tk:.0%}); the plain chain (both) "
                      f"{plain:.3f} ms, the library's LN backward {lib:.3f} ms",
                      flush=True)
        del x, dxn, g, stats
        torch.cuda.empty_cache()


def check_swiglu(_, timed) -> None:
    """SwiGLU's gate at DINOv2-g/14's probe shape (128 images of 261 tokens,
    H=4096) against the plain bf16 chain (equal bit for bit on 99.9% of the
    elements, within a bf16 step on the rest), twice (equal bit for bit), and
    timed beside its bound and the chain."""
    from ep_tpu_torch.ops.swiglu import swiglu_gate, swiglu_gate_ref
    print("swiglu_gate (twice, equal)")
    b, t, h = 128, 261, 4096
    x12 = rand(np.random.default_rng(22), (b, t, 2 * h), 3.0)
    got = swiglu_gate(x12)
    g, w = got.float(), swiglu_gate_ref(x12).float()
    same = float((g == w).float().mean())
    step = torch.exp2(torch.frexp(torch.maximum(g.abs(), w.abs()))[1] - 8.0)
    row = check("swiglu_gate", (b, t, 2 * h), same >= 0.999 and bool(
        ((g - w).abs() <= step).all()) and bool(torch.equal(
            got, swiglu_gate(x12))), f"{same:.6f} of the elements equal bit "
        "for bit, the rest within a bf16 step, repeat equal",
        max_abs_err=float((g - w).abs().max()))
    del got, g, w, step
    if timed:
        tk = time_ms(lambda: swiglu_gate(x12))
        bnd, by = bound_ms(0, nbytes(x12) * 3 // 2)
        row.update(ms=tk, bound_ms=bnd, plain_ms=time_ms(
            lambda: swiglu_gate_ref(x12), 3))
        print(f"  time: swiglu_gate ({b * t}, {h}) {tk:.3f} ms, bound {bnd:.3f} "
              f"ms ({by}, {bnd / tk:.0%}); the plain chain "
              f"{row['plain_ms']:.3f} ms", flush=True)
    del x12
    torch.cuda.empty_cache()


def check_rope(_, timed) -> None:
    """The RoPE pass at DINOv3 ViT-7B/16's 448-px probe shape (8 images of
    [CLS], 4 storage tokens and 784 patches, 32 heads of 128) against its
    plain chain (equal bit for bit), twice (equal bit for bit), and timed
    beside its bound (benchmark/rope_bytes.py's bytes) and the chain."""
    from ep_tpu_torch.ops.rope import rope_qk, rope_qk_ref, rope_tables
    print("rope_qk (twice, equal)")
    b, prefix, grid, h, dh = 8, 5, 28, 32, 128
    sin, cos = rope_tables(grid, grid, dh, 100.0, "cuda")
    qkv = rand(np.random.default_rng(26), (b, prefix + grid * grid,
                                           3 * h * dh), 2.0)
    want = rope_qk_ref(qkv, sin, cos, h)
    got = rope_qk(qkv.clone(), sin, cos, h)
    row = check("rope_qk", (b, prefix + grid * grid, h, dh),
                bool(torch.equal(got, want)) and bool(torch.equal(
                    got, rope_qk(qkv.clone(), sin, cos, h))),
                "equal bit for bit to the chain, repeat equal",
                max_abs_err=float((got.float() - want.float()).abs().max()))
    del got, want
    if timed:
        work = qkv.clone()
        tk = time_ms(lambda: rope_qk(work, sin, cos, h))  # rotates in place
        moved = 2 * 2 * b * grid * grid * 2 * h * dh + nbytes(sin, cos)
        bnd, by = bound_ms(0, moved)
        row.update(ms=tk, bound_ms=bnd, plain_ms=time_ms(
            lambda: rope_qk_ref(qkv, sin, cos, h), 3))
        print(f"  time: rope_qk ({b}, {prefix}+{grid * grid}, {h}x{dh}) "
              f"{tk:.4f} ms, bound {bnd:.4f} ms ({by}, {bnd / tk:.0%}); the "
              f"plain chain {row['plain_ms']:.3f} ms", flush=True)
        del work
    del qkv
    torch.cuda.empty_cache()


# LayerScale's closings (rows, D): DINOv2-g/14 at batch 128 (261 tokens) and
# DINOv3 ViT-7B/16 at 448 px and batch 8 (789 tokens)
LS_SHAPES = ((128 * 261, 1536), (8 * 789, 4096))


def check_ls(_, timed) -> None:
    """LayerScale and the residual as one pass (ops/layerscale.py) at the
    LayerScale probe cells' shapes, gamma stored in bf16 as a frozen encoder
    holds it, against the chain (equal bit for bit), twice (equal bit for
    bit), and timed beside its bound (x and y read, out written, bf16) and
    the chain, both from CUDA graphs (a call's host time is longer than the
    kernel's)."""
    from ep_tpu_torch.ops.layerscale import ls_residual, ls_residual_ref
    print("ls_residual (twice, equal)")
    for m, d in LS_SHAPES:
        r = np.random.default_rng(28)
        x, y = rand(r, (m, d), 4.0), rand(r, (m, d), 4.0)
        gamma = (1.0 + rand(r, (d,), 0.05, torch.float32)).bfloat16()
        got = ls_residual(x, y, gamma)
        want = ls_residual_ref(x, y, gamma)
        row = check("ls_residual", (m, d), bool(torch.equal(got, want)) and bool(
            torch.equal(got, ls_residual(x, y, gamma))),
            "equal bit for bit to the chain, repeat equal",
            max_abs_err=float((got.float() - want.float()).abs().max()))
        del got, want
        if timed:
            tk = graph_ms(lambda: ls_residual(x, y, gamma))
            bnd, by = bound_ms(0, 3 * nbytes(x))
            row.update(ms=tk, bound_ms=bnd, plain_ms=graph_ms(
                lambda: ls_residual_ref(x, y, gamma)))
            print(f"  time: ls_residual ({m}, {d}) {tk:.4f} ms, bound "
                  f"{bnd:.4f} ms ({by}, {bnd / tk:.0%}); the chain "
                  f"{row['plain_ms']:.4f} ms", flush=True)
        del x, y
    torch.cuda.empty_cache()


# fc1 of the probe cells' MLP halves: (rows, D), hidden 4D (ViT-B/16 at
# batch 512, ViT-H/14 at 224 px and batch 128, at 448 px and batch 64)
FC1_GELU_SHAPES = ((512 * 197, 768), (128 * 257, 1280), (64 * 1025, 1280))


def check_fc1_gelu(_, timed) -> None:
    """fc1 with its bias and tanh GELU in cuBLASLt's epilogue
    (ops/fc1_gelu.py) at the probe cells' MLP shapes, against the old route
    (F.linear, then F.gelu(approximate="tanh")): each against the f32
    product and GELU of the same bf16 values, in bf16 steps of the
    reference (floored at the step of its mean magnitude), the epilogue no
    more than one step further than the old route; the share equal bit for
    bit to the old route's; the profiler's kernels of one call, none of them
    PyTorch's GELU. Timed beside its bound and the old route."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ep_tpu_torch.ops.fc1_gelu import fc1_gelu
    print("fc1 + GELU in cuBLASLt's epilogue against F.linear + F.gelu")
    for m, d in FC1_GELU_SHAPES:
        h_dim = 4 * d
        rng = np.random.default_rng(24 + d)
        x = rand(rng, (m, d))
        w, b = rand(rng, (h_dim, d), d ** -0.5), rand(rng, (h_dim,), 0.5)

        def old():
            return F.gelu(F.linear(x, w, b), approximate="tanh")

        got, was = fc1_gelu(x, w, b), old()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fc1_gelu(x, w, b)
            torch.cuda.synchronize()
        kernels = [e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        same = float((got == was).float().mean())
        ref = F.gelu(F.linear(x.float(), w.float(), b.float()),
                     approximate="tanh")
        step = torch.exp2(torch.floor(torch.log2(torch.maximum(
            ref.abs(), ref.abs().mean()))) - 7.0)
        new_err = float(((got.float() - ref).abs() / step).max())
        old_err = float(((was.float() - ref).abs() / step).max())
        del ref, step
        row = check("fc1_gelu_epilogue", (m, d, h_dim), new_err <= old_err + 1
                    and bool(torch.isfinite(got).all())
                    and not any("Gelu" in k for k in kernels),
                    f"{same:.4f} of the elements equal bit for bit to the old "
                    f"route's; from the f32 reference {new_err:.2f} bf16 steps "
                    f"at most (the old route {old_err:.2f}); kernels of one "
                    f"call {[k[:90] for k in kernels]}",
                    max_abs_err=float((got.float() - was.float()).abs().max()),
                    equal_share=same)
        del got, was
        if timed:
            ops = 2 * m * d * h_dim
            row["bound_ms"], by = bound_ms(ops, nbytes(x, w, b) + 2 * m * h_dim)
            row.update(ms=time_ms(lambda: fc1_gelu(x, w, b)),
                       library_ms=time_ms(old))
            print(f"  time: the epilogue {row['ms']:.3f} ms "
                  f"({ops / row['ms'] / 1e9:.0f} TFLOP/s), bound "
                  f"{row['bound_ms']:.3f} ms ({by}, "
                  f"{row['bound_ms'] / row['ms']:.0%}); F.linear + F.gelu "
                  f"{row['library_ms']:.3f} ms", flush=True)
        del x, w, b
        torch.cuda.empty_cache()


def check_lars(_, timed) -> None:
    """LARS's kernel pair (lars_norms + lars_apply) over ViT-B/16's
    fine-tuning leaves (f32) at the benchmark's hyperparameters: one step
    against the plain per-leaf loop from the same state (within 1e-5 of each
    value and of its leaf's largest), twice (equal bit for bit); the pair's
    device time (profiler) beside its bound, LARS.step back to back and the
    host's part of it, and the plain loop; the gradient norm (one
    multi-tensor pass) beside the per-leaf sum it replaced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.models.assembly import (ProbeModel, SkipDefaultInit,
                                              build_backbone_config)
    from ep_tpu_torch.train.lars import LARS, RawUpdateOptimizer
    from ep_tpu_torch.train.state import freeze
    from ep_tpu_torch.train.steps import global_grad_norm

    class PlainLARS(LARS):
        _apply_updates = RawUpdateOptimizer._apply_updates

    print("LARS's kernel pair over ViT-B/16's fine-tuning leaves (twice, equal)")
    cfg = TrainConfig(model="vit_base_patch16", cls_features="ep",
                      ep_queries=32, nb_classes=1000, amp="bfloat16",
                      finetuning=True)
    with SkipDefaultInit(), torch.device("meta"):
        shapes = [tuple(p.shape) for p in freeze(
            ProbeModel(build_backbone_config(cfg), cfg), True)]
    rng = np.random.default_rng(23)
    start = [rand(rng, s, 0.02, torch.float32) for s in shapes]
    grads = [rand(rng, s, 1e-3, torch.float32) for s in shapes]
    n = sum(p.numel() for p in start)

    def fresh(cls):
        ps = [torch.nn.Parameter(p.clone()) for p in start]
        for p, g in zip(ps, grads):
            p.grad = g
        return ps, cls(ps, weight_decay=0.0)

    (got, opt), (again, opt2), (ref, ref_opt) = (
        fresh(c) for c in (LARS, LARS, PlainLARS))
    for o in (opt, opt2, ref_opt):
        o.step(1.6)
    err, ok = 0.0, all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    for a, r in zip(got, ref):
        for x, y in ((a, r), (opt.state[a]["mu"], ref_opt.state[r]["mu"])):
            d = (x - y).detach().abs()
            err = max(err, float(d.max()))
            ok &= bool((d <= 1e-5 * (y.abs() + y.abs().max())).all())
    row = check("lars_apply", f"{len(shapes)} leaves, {n} parameters", ok,
                f"max |d| against the plain loop {err:.3e}, repeat equal",
                max_abs_err=err)

    def per_leaf_norm():
        return torch.sqrt(sum(g.float().square().sum() for g in grads))

    norm, per_leaf = float(global_grad_norm(grads)), float(per_leaf_norm())
    nrow = check("global_grad_norm", f"{len(shapes)} leaves",
                 abs(norm / per_leaf - 1) <= 1e-5, "against the per-leaf sum: "
                 f"relative difference {abs(norm / per_leaf - 1):.2e}")
    if timed:
        scaled = sum(p.numel() for p in start if p.ndim > 1)
        # f32 p and g read by the first pass (the ranks that take the trust
        # ratio); p, g and mu read, mu and p written by the second
        bnd, by = bound_ms(0, 8 * scaled + 20 * n)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                opt.step(1.6)
            torch.cuda.synchronize()
        pair = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "lars_" in e.key
                   ) / 5e3
        t0 = time.perf_counter()
        for _ in range(5):
            opt.step(1.6)
        host = (time.perf_counter() - t0) / 5 * 1e3
        row.update(ms=pair, bound_ms=bnd, plain_ms=time_ms(
            lambda: ref_opt.step(1.6), 3))
        nrow.update(ms=time_ms(lambda: global_grad_norm(grads)),
                    plain_ms=time_ms(per_leaf_norm))
        print(f"  time: the pair {pair:.3f} device ms (profiler), bound "
              f"{bnd:.3f} ms ({by}, {bnd / pair:.0%}); LARS.step "
              f"{time_ms(lambda: opt.step(1.6)):.3f} ms back to back, "
              f"{host:.3f} ms of it the host's; the plain per-leaf loop "
              f"{row['plain_ms']:.3f} ms", flush=True)
        print(f"  time: the gradient norm {nrow['ms']:.3f} ms, the per-leaf "
              f"sum {nrow['plain_ms']:.3f} ms", flush=True)
    del got, again, ref, opt, opt2, ref_opt, start, grads
    torch.cuda.empty_cache()


def check_backbone(rng, timed) -> None:
    """B and D at the backbone family's shapes."""
    print("the backbone family's shapes")
    check_core(rng, timed, CORE_BACKBONE)
    check_pool(rng, timed, POOL_BACKBONE)


if __name__ == "__main__":
    sys.exit(main())
