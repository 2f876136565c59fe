"""ep_tpu_torch's CUDA kernels against their plain versions, on the card.

Marked ``cuda`` and skipped without a CUDA device. On a machine with one card
(and no jax), run them with:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: both sides round to bf16 at the same points; the f32 sums run in
another order, which can move a value across one bf16 rounding boundary, so
|kernel - plain| <= 1e-2 + 1e-2*|plain| (about two bf16 steps at unit size).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, dev, scale=1.0, dtype=torch.bfloat16, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a * scale).to(dev, dtype)


def _close_in_steps(out, ref):
    """TOL at every element, and the paths' step bound (its reason is at
    scripts/torch_hopper_gemm_check.py::STEP_SHARE)."""
    from scripts.torch_hopper_gemm_check import steps_past
    torch.testing.assert_close(out, ref, **TOL)
    past, limit = steps_past(out, ref)
    assert past <= limit, f"{past} of {ref.numel()} elements past one bf16 step"


def _counts(**launched):
    """LAUNCHES as expected: the named kernels, every other one zero."""
    from ep_tpu_torch.ops import LAUNCHES
    return {**dict.fromkeys(LAUNCHES, 0), **launched}


# The tile edges of kernels B and E: a single row, one row short of a 64-row
# tile, one tile, one row past it, B's key bins (32, 64, 128, 208, 256, 272)
# and E's staged rows (128, 256, 320, 384, its limit at head width 64); 3
# images of 48 heads are more (image, head) pairs than the card has SMs, so
# every persistent block takes several items.
CORE_EDGES = [(3, t, 48, dh) for dh in (64, 80)
              for t in (1, 63, 64, 65, 129, 197, 256, 257, 272)]
BWD_EDGES = [(3, t, 48, dh) for dh in (64, 80)
             for t in (1, 5, 16, 63, 64, 65, 128, 129, 197, 257, 300, 320)] + [
                 (3, 384, 48, 64)]


@pytest.mark.parametrize("B, T, H, Dh", [
    (2, 197, 12, 64), (3, 5, 2, 64), (1, 64, 1, 64), (2, 100, 3, 64),
    (1, 256, 2, 64), (2, 257, 16, 80), (3, 9, 8, 80), (1, 272, 2, 80),
    (2, 261, 2, 64)] + CORE_EDGES)
def test_attn_core(dev, B, T, H, Dh):
    """Kernel B against its plain version, and a second call equal bit for
    bit."""
    from ep_tpu_torch.ops.attn_fused import (attention_qkv_fused,
                                             attention_qkv_fused_ref)
    qkv = _rand((B, T, 3 * H * Dh), dev)
    out = attention_qkv_fused(qkv, H, Dh ** -0.5, 1.5)
    assert torch.equal(out, attention_qkv_fused(qkv, H, Dh ** -0.5, 1.5))
    torch.testing.assert_close(out,
                               attention_qkv_fused_ref(qkv, H, Dh ** -0.5, 1.5),
                               **TOL)


@pytest.mark.parametrize("B, T, H, Dh", [
    (2, 1025, 16, 80), (1, 785, 12, 64), (2, 257, 16, 80), (3, 5, 2, 64),
    (1, 64, 1, 64), (1, 65, 2, 80), (1, 1025, 2, 64), (1, 300, 2, 80),
    (1, 2049, 1, 64), (3, 70, 2, 64), (2, 130, 8, 80)] + [
        (2, t, 2, dh) for dh in (64, 80)
        for t in (1, 63, 65, 129, 257, 785, 1025)] + [
    (9, 70, 16, 80), (12, 33, 12, 64)] + [
    (8, 789, 32, 128), (2, 201, 32, 128)] + [
        (2, t, 2, 128) for t in (1, 63, 65, 128, 129, 130, 257, 789)] + [
    (9, 70, 16, 128)])
def test_attn_flash(dev, B, T, H, Dh):
    """Kernel F at the slice's shapes (T=1025 and 785 at 448 px, T=257 for the
    row-tiled variant; DINOv3 ViT-7B/16's (8, 789, 32x128) at 448 px and a
    short (2, 201, 32x128)), at the edges of its tiles at every head width
    (a single key; one key tile narrowed to 16, 32 or 64 columns; a query
    tile whose second warpgroup has no row or one row; at width 128 tiles of
    128 query rows over two warpgroups) and with more (image, head) pairs
    than the card has SMs, so that its persistent blocks take several items,
    against the plain version that kernel B is held to, with the bound on
    the elements past one bf16 step."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.attn_fused import attention_qkv_fused_ref
    from ep_tpu_torch.ops.flash_attn import attn_flash
    qkv = _rand((B, T, 3 * H * Dh), dev)
    reset_launches()
    out = attn_flash(qkv, H, Dh ** -0.5, 1.5)
    assert dict(LAUNCHES) == _counts(attn_flash=1)
    _close_in_steps(out, attention_qkv_fused_ref(qkv, H, Dh ** -0.5, 1.5))


@pytest.mark.parametrize("T", [1, 16, 63, 64, 65, 256, 729, 1025])
def test_attn_flash_at_head_width_72(dev, T):
    """Kernel F at SigLIP2's head width 72, 3 images of 16 heads, against the
    plain version head by head. F reads each head through width 80's boxes,
    so the 8 columns past a head (the next head's first 8, k's or v's first
    8 past the last head, the row's end past the last v head) come in with
    it; here q's and k's of every odd head are large (16 times the rest),
    so that a rest column left in the logits (a query fragment not zeroed)
    would move the even heads far past the bound; a rest column stored
    into the output would overwrite the next head's first 8. Only q's and
    k's are scaled: scaled v columns would scale the odd heads' rounding of
    their probabilities past the bound too. Two calls equal bit for bit."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.attn_fused import attention_qkv_fused_ref
    from ep_tpu_torch.ops.flash_attn import attn_flash
    B, H, Dh = 3, 16, 72
    qkv = _rand((B, T, 3, H, Dh), dev, seed=73)
    qkv[:, :, :2, 1::2, :8] *= 16
    qkv = qkv.reshape(B, T, 3 * H * Dh)
    reset_launches()
    out = attn_flash(qkv, H, Dh ** -0.5, 1.5)
    assert dict(LAUNCHES) == _counts(attn_flash=1)
    assert torch.equal(out, attn_flash(qkv, H, Dh ** -0.5, 1.5))
    ref = attention_qkv_fused_ref(qkv, H, Dh ** -0.5, 1.5)
    for h in range(H):
        cols = slice(h * Dh, (h + 1) * Dh)
        _close_in_steps(out[..., cols], ref[..., cols])


@pytest.mark.parametrize("T, H, Dh, variant, kernel", [
    (272, 2, 80, None, "attn_core"), (273, 2, 80, None, "attn_flash"),
    (273, 2, 64, None, "attn_flash"), (1025, 2, 64, None, "attn_flash"),
    (4100, 1, 80, None, "attn_flash"), (257, 16, 80, "rowtile", "attn_flash"),
    (197, 12, 64, "rowtile", "attn_core"), (257, 16, 80, "env", "attn_flash"),
    (201, 4, 128, None, "attn_flash"), (21, 2, 128, None, "attn_flash"),
    (256, 16, 72, None, "attn_flash"), (729, 16, 72, None, "attn_flash")])
def test_attention_core_takes_b_or_f_for_every_t(dev, monkeypatch, T, H, Dh,
                                                 variant, kernel):
    """On a CUDA tensor ``attention_core`` raises for no T at head widths 64
    and 80: kernel B up to its limit, kernel F beyond, and F at the short
    ViT-H shape with the row-tiled variant (given, or read from the
    environment); at head widths 72 and 128 F at every T."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.attn_fused import (attention_core,
                                             attention_qkv_fused_ref)
    if variant == "env":
        monkeypatch.setenv("EP_TPU_ATTN_VARIANT", "rowtile")
        variant = None
    qkv = _rand((1, T, 3 * H * Dh), dev)
    reset_launches()
    out = attention_core(qkv, H, Dh ** -0.5, 1.0, variant=variant)
    assert dict(LAUNCHES) == _counts(**{kernel: 1})
    torch.testing.assert_close(
        out, attention_qkv_fused_ref(qkv, H, Dh ** -0.5, 1.0), **TOL)


@pytest.mark.parametrize("B, N, prefix, H, Dh", [
    (8, 784, 5, 32, 128), (3, 16, 5, 2, 64), (2, 16, 1, 3, 16), (1, 9, 0, 1, 32),
    (5, 1, 2, 4, 128)])
def test_rope_qk(dev, B, N, prefix, H, Dh):
    """The RoPE pass in place against its plain chain, bit for bit (both
    round x * cos and x' * sin in f32, then their sum, then once to bf16),
    at DINOv3 ViT-7B/16's 448-px shape (784 patches after [CLS] and 4
    storage tokens, 32 heads of 128), small ragged ones, no prefix and a
    single patch; the prefix rows and v untouched; twice, bit for bit."""
    import math

    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.rope import rope_qk, rope_qk_ref, rope_tables
    side = math.isqrt(N)
    grid = (side, N // side)
    sin, cos = rope_tables(*grid, Dh, 100.0, dev)
    qkv = _rand((B, prefix + N, 3 * H * Dh), dev, 2.0, seed=90)
    want = rope_qk_ref(qkv, sin, cos, H)
    reset_launches()
    got = rope_qk(qkv.clone(), sin, cos, H)
    assert dict(LAUNCHES) == _counts(rope_qk=1)
    assert torch.equal(got, want)
    assert torch.equal(rope_qk(qkv.clone(), sin, cos, H), got)
    assert torch.equal(got[:, :prefix], qkv[:, :prefix])
    assert torch.equal(got[..., 2 * H * Dh:], qkv[..., 2 * H * Dh:])
    x = qkv.clone()
    assert rope_qk(x, sin, cos, H).data_ptr() == x.data_ptr()  # in place


def test_rope_qk_refuses_what_it_cannot_take(dev):
    from ep_tpu_torch.ops.rope import rope_qk, rope_tables
    sin, cos = rope_tables(2, 2, 24, 100.0, dev)
    with pytest.raises(NotImplementedError, match="Dh % 16"):
        rope_qk(_rand((1, 5, 3 * 24), dev), sin, cos, 1)
    sin, cos = rope_tables(2, 2, 32, 100.0, dev)
    with pytest.raises(TypeError):
        rope_qk(_rand((1, 5, 3 * 32), dev, dtype=torch.float32), sin, cos, 1)


def test_dinov3_blocks_on_the_card(dev):
    """A 2-block DINOv3 at head width 128 and 448 px (T=789): every block
    takes RoPE's kernel, F, the SwiGLU gate and the LayerScale closing of
    both halves without a gradient, and its logits agree with the CPU's
    plain versions from the same weights; with a gradient RoPE and the
    closings are the chains and the backward the tiled one."""
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.models.assembly import (build_backbone_config,
                                              init_probe_model)
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.train.state import cast_frozen, freeze
    cfg = TrainConfig(model="dinov3_vit7b16", cls_features="ep",
                      ep_queries=32, nb_classes=10, image_size=448,
                      amp="bfloat16")
    bcfg = build_backbone_config(cfg).replace(embed_dim=512, depth=2,
                                              num_heads=4)
    x = _rand((2, 448, 448, 3), dev, seed=91)
    outs = {}
    for where in ("cpu", dev):
        model = init_probe_model(cfg, 0, bcfg, device=where)
        freeze(model, False)
        cast_frozen(model, torch.bfloat16)
        model.eval()
        reset_launches()
        with torch.no_grad():
            outs[str(where)] = model(x.to(where)).float().cpu()
    assert dict(LAUNCHES) == _counts(rope_qk=2, attn_flash=2, swiglu_gate=2,
                                     ls_residual=4, ep_pool=1)
    ref = outs["cpu"]
    torch.testing.assert_close(outs[str(dev)], ref, rtol=0.05,
                               atol=0.05 * float(ref.abs().max()))
    ft = init_probe_model(cfg.replace(finetuning=True), 0, bcfg, device=dev)
    reset_launches()
    ft(x).float().sum().backward()
    assert LAUNCHES["rope_qk"] == 0 and LAUNCHES["attn_flash"] == 2
    assert LAUNCHES["attn_bwd_long"] == 2 and LAUNCHES["ls_residual"] == 0
    assert ft.backbone.blocks[0].attn.qkv.weight.grad is not None


def test_siglip2_probe_step_launches(dev):
    """One probe step of the benchmark's SigLIP2 SO400M/14 cell, at its
    published widths and 384 px, batch 4, as ``benchmark.run`` drives it:
    every block takes A, F at head width 72 and C, and fc1's GELU epilogue;
    D pools the 729 patch tokens once; LARS is one pair of launches; no B,
    E, SwiGLU gate, RoPE or LayerScale pass. The loss is finite."""
    import json
    from pathlib import Path

    from benchmark.program import Program
    from benchmark.weights import draw_batches, draw_weights
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    root = Path(__file__).resolve().parent.parent / "benchmark"
    cfg = json.loads((root / "configs" / "siglip2-so400m14-ep32.json")
                     .read_text())
    t = {**json.loads((root / "traffic" / "probe-b128-384px.json")
                      .read_text()), "batch": 4}
    W = draw_weights(cfg, 384, 5, dev, frozen_encoder=True)
    images, labels = draw_batches(cfg, t, 5, dev)
    prog = Program(cfg, t, W, dev)
    del W
    first = cfg["optimizer"]["schedule"]["start_step"]
    prog.step(first, images[0], labels[0])  # LARS's state is made here
    reset_launches()
    loss = prog.step(first + 1, images[1], labels[1])["loss"]
    assert dict(LAUNCHES) == _counts(ln_qkv_gemm=27, attn_flash=27,
                                     proj_residual_gemm=27,
                                     fc1_gelu_epilogue=27, ep_pool=1,
                                     lars_norms=1, lars_apply=1)
    assert bool(torch.isfinite(loss))


def test_flash_attention_on_split_heads(dev):
    """The JAX module's public function: pre-split (B,H,T,Dh) tensors are
    packed into the natural layout and go through kernel F; the backward is
    the plain recompute."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.flash_attn import (flash_attention,
                                             flash_attention_bwd_ref,
                                             flash_attention_ref)
    q, k, v, g = (_rand((2, 3, 300, 80), dev, seed=40 + i) for i in range(4))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_launches()
    out = flash_attention(*ins, 80 ** -0.5, 1.5)
    assert dict(LAUNCHES) == _counts(attn_flash=1)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, 80 ** -0.5, 1.5),
                               **TOL)
    out.backward(g)
    for t, r in zip(ins, flash_attention_bwd_ref(q, k, v, g, 80 ** -0.5, 1.5)):
        torch.testing.assert_close(t.grad, r, rtol=0, atol=0)


@pytest.mark.parametrize("B, T, H, Dh", [
    (2, 197, 12, 64), (3, 5, 2, 64), (1, 300, 1, 64), (2, 257, 16, 80),
    (3, 9, 8, 80), (1, 320, 2, 80)] + BWD_EDGES)
def test_attn_core_bwd(dev, B, T, H, Dh):
    """Kernel E against the plain backward, twice (it is deterministic), and
    through autograd. dq and dk sum T products of a bf16-rounded dL, so the
    absolute bound is taken at the output's largest magnitude."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.attn_fused import (attention_qkv_fused,
                                             attention_qkv_fused_bwd,
                                             attention_qkv_fused_bwd_ref)
    qkv = _rand((B, T, 3 * H * Dh), dev)
    g = _rand((B, T, H * Dh), dev, seed=1)
    ref = attention_qkv_fused_bwd_ref(qkv, g, H, Dh ** -0.5, 1.5)
    out = attention_qkv_fused_bwd(qkv, g, H, Dh ** -0.5, 1.5)
    scale = float(ref.float().abs().max())
    torch.testing.assert_close(out, ref, rtol=1e-2, atol=1e-2 * scale)
    torch.testing.assert_close(
        attention_qkv_fused_bwd(qkv, g, H, Dh ** -0.5, 1.5), out, rtol=0, atol=0)
    if T > 272:  # past kernel B's register tile: E alone
        return
    reset_launches()
    x = qkv.clone().requires_grad_(True)
    attention_qkv_fused(x, H, Dh ** -0.5, 1.5).backward(g)
    assert LAUNCHES["attn_core_bwd"] == 1 and LAUNCHES["attn_core"] == 1
    torch.testing.assert_close(x.grad, out, rtol=0, atol=0)


@pytest.mark.parametrize("B, T, D", [(2, 197, 768), (3, 7, 192), (8, 197, 768)])
def test_supercell_and_its_gemms(dev, B, T, D):
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.attn_block import attn_supercell, attn_supercell_ref
    x = _rand((B, T, D), dev, seed=1)
    args = (x, _rand((3 * D, D), dev, D ** -0.5, seed=2),
            _rand((3 * D,), dev, 0.02, torch.float32, seed=3),
            1 + _rand((D,), dev, 0.1, torch.float32, seed=4),
            _rand((D,), dev, 0.1, torch.float32, seed=5),
            _rand((D, D), dev, D ** -0.5, seed=6),
            _rand((D,), dev, 0.02, torch.float32, seed=7), D // 64, 0.125)
    reset_launches()
    out = attn_supercell(*args)
    assert dict(LAUNCHES) == _counts(ln_qkv_gemm=1, attn_core=1,
                                     proj_residual_gemm=1)
    torch.testing.assert_close(out, attn_supercell_ref(*args), **TOL)


@pytest.mark.parametrize("B, T, D", [
    (1, 5, 768), (3, 197, 768), (1, 100, 1024), (3, 257, 1024), (1, 64, 1280),
    (2, 257, 1280), (1, 1025, 1280), (2, 37, 64), (1, 128, 768),
    (8, 197, 768), (3, 197, 1024), (8, 197, 1024), (3, 257, 1280),
    (3, 1025, 1280), (1, 5, 1152), (3, 729, 1152), (128, 729, 1152)])
def test_gemm_kernels_at_every_width_and_ragged_m(dev, B, T, D):
    """Kernels A and C alone at the model widths (768, 1024, 1152 for SigLIP2
    with A's N = 3456, 1280; and K = 64), with
    M = B*T smaller than one 128-row panel, equal to one, and ragged past
    several: TMA zero-fills the rows it reads past M and drops the rows it
    would store there."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.attn_block import (ln_qkv, ln_qkv_ref, proj_residual,
                                             proj_residual_ref)
    x = _rand((B, T, D), dev, seed=60)
    a_args = (x, 1 + _rand((D,), dev, 0.1, torch.float32, seed=61),
              _rand((D,), dev, 0.1, torch.float32, seed=62),
              _rand((3 * D, D), dev, D ** -0.5, seed=63),
              _rand((3 * D,), dev, 0.02, torch.float32, seed=64), 1e-6)
    c_args = (_rand((B, T, D), dev, seed=65), _rand((D, D), dev, D ** -0.5, seed=66),
              _rand((D,), dev, 0.02, torch.float32, seed=67), x)
    reset_launches()
    qkv, out = ln_qkv(*a_args), proj_residual(*c_args)
    assert dict(LAUNCHES) == _counts(ln_qkv_gemm=1, proj_residual_gemm=1)
    torch.testing.assert_close(qkv, ln_qkv_ref(*a_args), **TOL)
    torch.testing.assert_close(out, proj_residual_ref(*c_args), **TOL)


def test_gemm_kernels_refuse_what_they_do_not_take(dev):
    from ep_tpu_torch.ops.attn_block import ln_qkv, proj_residual
    for D, match in ((96, "K % 64"), (1344, "K <= 1280")):
        x = _rand((1, 5, D), dev)
        with pytest.raises(NotImplementedError, match=match):
            ln_qkv(x, torch.ones(D, device=dev), torch.zeros(D, device=dev),
                   _rand((3 * D, D), dev), torch.zeros(3 * D, device=dev), 1e-6)
    with pytest.raises(NotImplementedError, match="K % 64"):
        proj_residual(_rand((1, 5, 96), dev), _rand((96, 96), dev),
                      torch.zeros(96, device=dev), _rand((1, 5, 96), dev))
    with pytest.raises(TypeError):
        proj_residual(_rand((1, 5, 64), dev, dtype=torch.float32),
                      _rand((64, 64), dev), torch.zeros(64, device=dev),
                      _rand((1, 5, 64), dev))


def _row_stats(x, eps=1e-6):
    """Kernel A's row statistics of x (B,T,D): (B*T, 2) f32 (mean, rstd)."""
    from ep_tpu_torch.ops._build import call, stream_ptr
    stats = torch.empty(x.shape[0] * x.shape[1], 2, device=x.device,
                        dtype=torch.float32)
    call("ep_ln_row_stats", x.data_ptr(), stats.data_ptr(),
         x.shape[0] * x.shape[1], x.shape[2], eps, stream_ptr(x))
    return stats


@pytest.mark.parametrize("B, T, D", [
    (2, 197, 768), (64, 197, 768), (3, 5, 768), (3, 257, 1024), (1, 1, 1024),
    (1, 1025, 1280), (3, 7, 1280), (2, 37, 64)])
def test_ln1_kernels(dev, B, T, D):
    """ln1_apply and ln1_bwd against the plain version (autograd over the f32
    LayerNorm) at the three model widths and K = 64, with M = B*T ragged,
    under one block's 8 rows and over a pass of the whole card; twice, bit
    for bit. xn and g + dx round to bf16 at the same points as the plain
    version, from statistics one f32 rounding apart; the f32 column sums
    run over the rows in another order. Kernel A's row statistics, which
    both read, within 1e-5 of the f32 mean and rsqrt(var + eps)."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.attn_block import ln1_backward, ln1_backward_ref
    x = _rand((B, T, D), dev, 2.0, seed=70) + 0.5
    gamma = 1 + _rand((D,), dev, 0.1, torch.float32, seed=71)
    beta = _rand((D,), dev, 0.1, torch.float32, seed=72)
    dxn, g = _rand((B, T, D), dev, seed=73), _rand((B, T, D), dev, seed=74)
    stats = _row_stats(x)
    xf = x.float().view(B * T, D)
    torch.testing.assert_close(stats[:, 0], xf.mean(-1), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        stats[:, 1], torch.rsqrt(xf.var(-1, unbiased=False) + 1e-6),
        rtol=1e-5, atol=1e-5)
    del xf
    reset_launches()
    got = ln1_backward(x, stats, gamma, beta, dxn, g, 1e-6)
    assert dict(LAUNCHES) == _counts(ln1_apply=1, ln1_bwd=1)
    again = ln1_backward(x, stats, gamma, beta, dxn, g, 1e-6)
    want = ln1_backward_ref(x, gamma, beta, dxn, g, 1e-6)
    for name, a, b, c in zip(("xn", "g + dx", "dgamma", "dbeta", "dbp"), got,
                             again, want):
        assert a.dtype == c.dtype and a.shape == c.shape, name
        assert torch.equal(a, b), f"{name}: two calls differ"
        scale = float(c.float().abs().max())
        tol = TOL["rtol"] if a.dtype == torch.bfloat16 else 1e-3
        torch.testing.assert_close(a, c, rtol=tol, atol=tol * scale, msg=name)


@pytest.mark.parametrize("shape", [
    (128, 261, 2 * 4096), (3, 16), (1000, 48), (7, 2 * 4104), (2, 5, 2 * 8)])
def test_swiglu_gate(dev, shape):
    """SwiGLU's gate kernel against the plain bf16 chain at DINOv2-g/14's
    probe shape (128 images of 261 tokens, H=4096), one vector a row, a row
    past the block's two vectors a thread, and 3-d input of a narrow width:
    equal bit for bit on at least 99.9% of the elements, and within one
    bf16 step on the rest (the sigmoid's exp may differ from PyTorch's in
    its last f32 bit, which moves a result lying on a rounding boundary);
    twice, bit for bit."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.swiglu import swiglu_gate, swiglu_gate_ref
    x12 = _rand(shape, dev, 3.0, seed=80)
    reset_launches()
    got = swiglu_gate(x12)
    assert dict(LAUNCHES) == _counts(swiglu_gate=1)
    assert torch.equal(got, swiglu_gate(x12))
    want = swiglu_gate_ref(x12)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    assert float((g == w).float().mean()) >= 0.999
    step = torch.exp2(torch.frexp(torch.maximum(g.abs(), w.abs()))[1] - 8.0)
    assert bool(((g - w).abs() <= step).all())


def test_swiglu_gate_refuses_what_it_cannot_take(dev):
    from ep_tpu_torch.ops.swiglu import swiglu_gate
    with pytest.raises(NotImplementedError, match="H % 8"):
        swiglu_gate(_rand((4, 2 * 12), dev))
    with pytest.raises(TypeError):
        swiglu_gate(_rand((4, 32), dev, dtype=torch.float32))


def test_swiglu_mlp_takes_the_kernel_without_a_gradient(dev):
    """``SwiGLUMlp`` on the card: the gate kernel under ``no_grad`` (a probed
    encoder), the plain chain where autograd needs the gradient."""
    from ep_tpu_torch.models.vit import SwiGLUMlp
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    mlp = SwiGLUMlp(64, 176, torch.bfloat16).to(dev)
    x = _rand((2, 9, 64), dev, seed=81)
    reset_launches()
    with torch.no_grad():
        mlp(x)
    assert dict(LAUNCHES) == _counts(swiglu_gate=1)
    mlp(x).float().sum().backward()
    assert LAUNCHES["swiglu_gate"] == 1 and mlp.w12.weight.grad is not None


@pytest.mark.parametrize("shape, gamma_dtype", [
    ((128 * 261, 1536), torch.bfloat16), ((8 * 789, 4096), torch.bfloat16),
    ((128 * 261, 1536), torch.float32), ((8 * 789, 4096), torch.float32),
    ((1000, 1536), torch.bfloat16), ((3, 1536), torch.float32),
    ((13, 8), torch.bfloat16), ((5, 1032), torch.float32),
    ((77, 2056), torch.bfloat16), ((9, 4088), torch.float32),
    ((2, 5, 4096), torch.bfloat16)])
def test_ls_residual(dev, shape, gamma_dtype):
    """LayerScale and the residual as one pass against the chain, bit for
    bit: at DINOv2-g/14's (128 images of 261 tokens, D=1536) and DINOv3
    ViT-7B/16's (8 of 789, D=4096) probe shapes with the stored bf16 gamma
    and an f32 one (rounded in the kernel), at ragged row counts, one vector
    a row (several rows a block), rows with idle threads (D=1032, 2056,
    4088) and 3-d input; twice, bit for bit; one launch; y left as it
    was."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.layerscale import ls_residual, ls_residual_ref
    x = _rand(shape, dev, 4.0, seed=83)
    y = _rand(shape, dev, 4.0, seed=84)
    gamma = (1.0 + _rand(shape[-1:], dev, 0.05, torch.float32, seed=85)).to(
        gamma_dtype)
    y0 = y.clone()
    reset_launches()
    got = ls_residual(x, y, gamma)
    assert dict(LAUNCHES) == _counts(ls_residual=1)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, ls_residual_ref(x, y, gamma))
    assert torch.equal(got, ls_residual(x, y, gamma))
    assert torch.equal(y, y0)


def test_ls_residual_refuses_what_it_cannot_take(dev):
    from ep_tpu_torch.ops.layerscale import ls_residual
    g = torch.ones(16, device=dev)
    with pytest.raises(NotImplementedError, match="D % 8"):
        ls_residual(_rand((4, 12), dev), _rand((4, 12), dev), g[:12])
    with pytest.raises(TypeError):
        ls_residual(_rand((4, 16), dev, dtype=torch.float32),
                    _rand((4, 16), dev), g)
    with pytest.raises(ValueError, match="contiguous"):
        ls_residual(_rand((16, 16), dev), _rand((16, 16), dev).t(), g)


def test_layerscale_block_takes_the_kernel_only_without_a_gradient(
        dev, monkeypatch):
    """A bf16 DINOv2-style block (LayerScale, SwiGLU) on the card under
    ``no_grad`` closes both halves with the kernel, bit for bit the chain;
    with an input that needs a gradient it keeps the chain, and the input's
    and the gammas' gradients are the chain's bit for bit."""
    import ep_tpu_torch.models.vit as pvit
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    torch.manual_seed(0)
    cfg = pvit.ViTConfig(embed_dim=128, depth=1, num_heads=2, init_values=1.0,
                         mlp_type="swiglu", dtype=torch.bfloat16)
    blk = pvit.Block(cfg).to(dev)
    with torch.no_grad():
        blk.ls1.gamma.normal_(1.0, 0.05)
        blk.ls2.gamma.normal_(1.0, 0.05)
    x = _rand((2, 261, 128), dev, seed=86)
    outs, grads = [], []
    for route in ("as chosen", "chain"):
        if route == "chain":
            monkeypatch.setattr(pvit, "takes_ls_kernel", lambda *a: False)
        reset_launches()
        with torch.no_grad():
            outs.append(blk(x))
        assert LAUNCHES["ls_residual"] == (2 if route == "as chosen" else 0)
        blk.zero_grad()
        xg = x.clone().requires_grad_(True)
        reset_launches()
        blk(xg).float().sum().backward()
        assert LAUNCHES["ls_residual"] == 0
        grads.append((xg.grad, blk.ls1.gamma.grad, blk.ls2.gamma.grad))
    assert torch.equal(*outs)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _bf16_steps(out, ref):
    """|out - ref| in bf16 steps of ref's value (8 significant bits), the
    step floored at that of ref's mean magnitude, where f32 sums in another
    order move a value near zero by more than its own step."""
    out, ref = out.float(), ref.float()
    floor = ref.abs().mean()
    step = torch.exp2(torch.floor(torch.log2(torch.maximum(ref.abs(), floor)))
                      - 7.0)
    return (out - ref).abs() / step


@pytest.mark.parametrize("rows, D, hidden, act", [
    (2 * 197, 768, 3072, "gelu"), (257, 1280, 5120, "gelu"),
    (5, 768, 3072, "gelu"), (729, 1152, 4304, "gelu_tanh")],
    ids=["vit-b", "vit-h", "ragged", "siglip2"])
def test_fc1_gelu_epilogue_against_the_old_route(dev, rows, D, hidden, act):
    """``Mlp`` under ``no_grad`` at ViT-B's, ViT-H's and SigLIP2's MLP widths
    (SigLIP2: hidden 4304, so fc2's K is no multiple of 64, with its tanh
    GELU at every precision): one epilogue call, and both its hidden tensor
    and its output (after fc2) no further from an f32 reference than the old
    route's (``F.linear``, then ``F.gelu(approximate="tanh")``) plus one
    bf16 step. The epilogue rounds the activation once, the old route twice;
    the share of hidden elements equal bit for bit is printed."""
    from ep_tpu_torch.models.vit import Mlp
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.fc1_gelu import fc1_gelu
    torch.manual_seed(D)
    mlp = Mlp(D, hidden, torch.bfloat16, act).to(dev).requires_grad_(False)
    x = _rand((1, rows, D), dev, seed=D)
    w1, b1 = mlp.fc1.weight.bfloat16(), mlp.fc1.bias.bfloat16()
    reset_launches()
    with torch.no_grad():
        out = mlp(x)
        assert dict(LAUNCHES) == _counts(fc1_gelu_epilogue=1)
        h = fc1_gelu(x, w1, b1)
        h_old = F.gelu(F.linear(x, w1, b1), approximate="tanh")
        out_old = mlp.fc2(h_old)
        h_ref = F.gelu(F.linear(x.float(), w1.float(), b1.float()),
                       approximate="tanh")
        out_ref = F.linear(h_ref, mlp.fc2.weight.bfloat16().float(),
                           mlp.fc2.bias.bfloat16().float())
    assert h.shape == h_old.shape and h.dtype == torch.bfloat16
    assert torch.equal(out, mlp.fc2(h))
    for got, old, ref in ((h, h_old, h_ref), (out, out_old, out_ref)):
        new_err = float(_bf16_steps(got, ref).max())
        old_err = float(_bf16_steps(old, ref).max())
        assert new_err <= old_err + 1, (new_err, old_err)
    same = float((h == h_old).float().mean())
    print(f"fc1_gelu ({rows}, {D} -> {hidden}): {same:.4f} of the hidden equal "
          "bit for bit to the old route's")


def test_vit_b_takes_the_epilogue_only_without_a_gradient(dev, monkeypatch):
    """A ViT-B/16 forward under ``no_grad`` takes the epilogue once a block;
    with an input that needs a gradient it keeps the old route, and the
    input's gradient is the old route's bit for bit."""
    import ep_tpu_torch.models.vit as pvit
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    torch.manual_seed(0)
    vit = pvit.VisionTransformer(pvit.ViTConfig()).to(dev).requires_grad_(False)
    x = _rand((2, 224, 224, 3), dev, dtype=torch.float32, seed=82)
    reset_launches()
    with torch.no_grad():
        vit(x)
    assert LAUNCHES["fc1_gelu_epilogue"] == 12
    grads = []
    for route in ("as chosen", "old"):
        if route == "old":
            monkeypatch.setattr(pvit, "takes_gelu_epilogue", lambda *a: False)
        xg = x.clone().requires_grad_(True)
        reset_launches()
        vit(xg).float().sum().backward()
        assert LAUNCHES["fc1_gelu_epilogue"] == 0
        grads.append(xg.grad)
    assert torch.equal(*grads)


# ViT-B/16-shaped leaves for the LARS kernel pair: (shape, group, gradient):
# the patch embedding, cls and position (rank 3), a block's weights, biases
# and LN (rank 1), a leaf without a gradient, one smaller than a chunk and
# not a multiple of 4, an empty one, and the head (its own group)
LARS_LEAVES = [((768, 3, 16, 16), 0, True), ((1, 1, 768), 0, True),
               ((1, 197, 768), 0, True), ((2304, 768), 0, True),
               ((2304,), 0, True), ((768,), 0, True), ((3072, 768), 0, True),
               ((3072,), 0, True), ((768, 3072), 0, True), ((1, 32, 768), 1, False),
               ((5, 7), 0, True), ((0, 8), 0, True), ((1000, 768), 1, True),
               ((1000,), 1, True)]


def _lars_params(dtype, dev, seed=90):
    """The leaves as parameters, one of them at a 4-byte offset (the
    kernels' one-at-a-time walk)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (shape, _, _) in enumerate(LARS_LEAVES):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.02)
        a = a.to(dev, dtype)
        if i == 10:  # (5, 7) at an offset
            a = torch.cat([a.new_zeros(2), a.reshape(-1)])[2:].view(shape)
        out.append(torch.nn.Parameter(a))
    return out


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16],
                         ids=["p_f32", "p_bf16"])
@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16],
                         ids=["mu_f32", "mu_bf16"])
@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_lars_kernel_pair_is_the_plain_step(dev, wd, mu_dtype, p_dtype, accum):
    """``LARS.step`` on the card (``lars_norms`` + ``lars_apply`` once a
    step) against the plain ``_update`` loop on the card, over 3 updates of
    ViT-B-shaped leaves in two parameter groups (the head's with another
    trust coefficient and momentum), and twice, bit for bit; and the gradient
    norm (one multi-tensor pass) within 1e-5 of the per-leaf sum on the last
    gradients.

    Tolerance: the pair sums each leaf's norms in another order than
    ``torch.linalg.vector_norm``, which moves the trust ratio by a few f32
    steps; every other operation rounds as the plain chain does. With p and
    mu kept in f32, each parameter's change and each momentum agree within
    1e-5 of themselves and of their leaf's largest magnitude, the change
    also within one f32 step of the parameter it is read off. Where either
    is kept in bf16, a value that the ratio's last bits moved across a
    rounding boundary differs by one bf16 step, and the next steps carry
    that step on (through mu, or through p in the weight decay and the
    norms): 2**-7 instead of 1e-5. A bf16 parameter equals the plain one bit
    for bit but on a thousandth of its elements (2 in a small leaf), and is
    within two bf16 steps of its start or its end, whichever is larger, on
    the rest (a step flipped at one update is carried to where the value
    has shrunk)."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.train.lars import LARS, RawUpdateOptimizer
    from ep_tpu_torch.train.steps import global_grad_norm

    class PlainLARS(LARS):
        _apply_updates = RawUpdateOptimizer._apply_updates

    def run(cls):
        ps = _lars_params(p_dtype, dev)
        groups = [{"params": [p for p, (_, k, _) in zip(ps, LARS_LEAVES) if k == 0]},
                  {"params": [p for p, (_, k, _) in zip(ps, LARS_LEAVES) if k == 1],
                   "trust_coefficient": 0.002, "momentum": 0.8}]
        opt = cls(groups, weight_decay=wd, mu_dtype=mu_dtype, accum_iter=accum)
        rng = np.random.default_rng(91)
        for step in range(3 * accum):
            for p, (shape, _, has_grad) in zip(ps, LARS_LEAVES):
                p.grad = torch.from_numpy(rng.standard_normal(shape).astype(
                    np.float32) * 1e-2).to(dev, p_dtype) if has_grad else None
            opt.step(1.6)
        torch.cuda.synchronize()
        return ps, opt

    reset_launches()
    got, opt = run(LARS)
    assert dict(LAUNCHES) == _counts(lars_norms=3, lars_apply=3)
    again, _ = run(LARS)
    ref, ref_opt = run(PlainLARS)
    assert LAUNCHES["lars_norms"] == LAUNCHES["lars_apply"] == 6
    grads = [p.grad for p in got if p.grad is not None]
    per_leaf = torch.sqrt(sum(g.float().square().sum() for g in grads))
    assert abs(float(global_grad_norm(grads) / per_leaf) - 1) <= 1e-5
    start = _lars_params(p_dtype, dev)
    tol = 1e-5 if p_dtype == mu_dtype == torch.float32 else 2 ** -7
    for i, (a, b, c, a0) in enumerate(zip(got, again, ref, start)):
        assert torch.equal(a, b), f"leaf {i}: two runs differ"
        mu, mu_ref = opt.state[a]["mu"], ref_opt.state[c]["mu"]
        assert mu.dtype == mu_ref.dtype == mu_dtype and mu.shape == a.shape
        pa, pc, p0 = a.detach().float(), c.detach().float(), a0.detach().float()
        if p_dtype == torch.float32:  # the change, read off an f32 parameter
            largest = float((pc - p0).abs().max()) if pc.numel() else 0.0
            p_max = float(pc.abs().max()) if pc.numel() else 0.0
            torch.testing.assert_close(
                pa - p0, pc - p0, rtol=tol, atol=tol * largest + 2 ** -22 * p_max,
                msg=lambda m: f"leaf {i}, p: {m}")
        elif pc.numel():
            assert int((pa != pc).sum()) <= max(2, pc.numel() // 1000), \
                f"leaf {i}, p"
            two_steps = 2 ** -6 * torch.maximum(p0.abs(), pc.abs())
            assert bool(((pa - pc).abs() <= two_steps).all()), f"leaf {i}, p"
        largest = float(mu_ref.float().abs().max()) if mu_ref.numel() else 0.0
        torch.testing.assert_close(mu.float(), mu_ref.float(), rtol=tol,
                                   atol=tol * largest,
                                   msg=lambda m: f"leaf {i}, mu: {m}")
    assert opt.param_groups[1]["count"] == ref_opt.param_groups[1]["count"] == 3


def test_lars_kernels_refuse_what_they_do_not_take(dev):
    from ep_tpu_torch.train.lars import LARS
    p = torch.nn.Parameter(torch.zeros(8, 8, device=dev, dtype=torch.float16))
    p.grad = torch.zeros_like(p)
    with pytest.raises(TypeError, match="float16"):
        LARS([p]).step(0.1)


def test_ln1_kernels_refuse_what_a_refuses(dev):
    from ep_tpu_torch.ops.attn_block import ln1_apply, ln1_bwd
    for D, match in ((96, "K % 64"), (1344, "K <= 1280")):
        x = _rand((1, 5, D), dev)
        stats = torch.zeros(5, 2, device=dev)
        ones, zeros = torch.ones(D, device=dev), torch.zeros(D, device=dev)
        with pytest.raises(NotImplementedError, match=match):
            ln1_apply(x, stats, ones, zeros)
        with pytest.raises(NotImplementedError, match=match):
            ln1_bwd(x, stats, ones, x, x)
    with pytest.raises(TypeError):
        ln1_bwd(_rand((1, 5, 64), dev, dtype=torch.float32),
                torch.zeros(5, 2, device=dev), torch.ones(64, device=dev),
                _rand((1, 5, 64), dev), _rand((1, 5, 64), dev))


@pytest.mark.parametrize("B, T, D, H", [(2, 197, 768, 12), (2, 257, 1280, 16)])
def test_supercell_gradients(dev, B, T, D, H):
    """The supercell's backward (A and B recomputed, E, cuBLAS products, LN1's
    gradient through ln1_apply and ln1_bwd) against autograd of its plain
    version on the card; the weights are f32
    masters as in fine-tuning. Each gradient within 2e-2 of its largest
    magnitude: the products round to bf16 at the same points, in another
    summation order."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.attn_block import attn_supercell, attn_supercell_ref
    ins = [_rand((B, T, D), dev, seed=11),
           _rand((3 * D, D), dev, D ** -0.5, torch.float32, seed=12),
           _rand((3 * D,), dev, 0.02, torch.float32, seed=13),
           1 + _rand((D,), dev, 0.1, torch.float32, seed=14),
           _rand((D,), dev, 0.1, torch.float32, seed=15),
           _rand((D, D), dev, D ** -0.5, torch.float32, seed=16),
           _rand((D,), dev, 0.02, torch.float32, seed=17)]
    g = _rand((B, T, D), dev, seed=18)
    grads = []
    for fn in (attn_supercell, attn_supercell_ref):
        xs = [t.clone().requires_grad_(True) for t in ins]
        reset_launches()
        fn(*xs, H, (D // H) ** -0.5).backward(g)
        grads.append([t.grad for t in xs])
        if fn is attn_supercell:
            assert dict(LAUNCHES) == _counts(ln_qkv_gemm=2, attn_core=2,
                                             proj_residual_gemm=1,
                                             attn_core_bwd=1, ln1_apply=1,
                                             ln1_bwd=1)
    for a, b in zip(*grads):
        assert a.dtype == b.dtype
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2 * scale)


@pytest.mark.parametrize("B, N, C, Q", [
    (4, 196, 768, 32), (3, 37, 128, 4), (2, 256, 1280, 32),
    (2, 1024, 1280, 32),  # ViT-H/14 at 448 px: a cluster of 16 blocks an image
    (128, 729, 1152, 32)])  # SigLIP2 SO400M/14 at 384 px, the cell's batch
def test_ep_pool_forward_and_grad(dev, B, N, C, Q):
    from ep_tpu_torch.ops.pool_attn import ep_pool_attend, ep_pool_attend_ref
    q = _rand((Q, C), dev, C ** -0.5, seed=8)
    x = _rand((B, N + 1, C), dev, seed=9)[:, 1:]
    v = _rand((B, N, Q, C // Q), dev, seed=10)
    outs, grads = [], []
    for fn in (ep_pool_attend, ep_pool_attend_ref):
        qg, vg = q.clone().requires_grad_(), v.clone().requires_grad_()
        out = fn(qg, x, vg)
        (out.float() ** 2).sum().backward()
        outs.append(out)
        grads.append((qg.grad, vg.grad))
    _close_in_steps(outs[0], outs[1])
    for a, b in zip(*grads):
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a, b, rtol=1e-2, atol=1e-2 * scale)


# Kernel D at the edges of its 64-token tiles (one token; one short of a
# tile, one tile, one past it; ViT-B/L's 196 and ViT-H's 256 tokens, split
# over clusters of 4; 448 px's 1024 over 16) and at every width and query
# count the paths give it (EP-4 on a 128-wide model, EP-32 at ViT-B, ViT-L
# and ViT-H), on the patch tokens past one prefix token ([CLS]); then
# ep_all's 197 tokens with no prefix, DINOv2-L's 256 past [CLS] and 4
# registers, DINOv2-g's width (cq 48) and SigLIP2's 729 with no prefix (cq
# 36).
POOL_EDGES = [(2, n, c, q, 1) for n in (1, 37, 63, 64, 65, 196, 256, 1024)
              for c, q in ((128, 4), (768, 32), (1024, 32), (1280, 32))] + [
                  (2, 197, 768, 32, 0), (2, 256, 1024, 32, 5),
                  (2, 256, 1536, 32, 1), (2, 729, 1152, 32, 0)]


@pytest.mark.parametrize("B, N, C, Q, prefix", POOL_EDGES)
def test_ep_pool_at_the_edges_of_its_tiles(dev, B, N, C, Q, prefix):
    """Kernel D against its plain version on the view x[:, prefix:], with the
    bound on the elements past one bf16 step, one launch a call, and two
    calls equal bit for bit (the cluster's partial sums are added in rank
    order, without atomics)."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.pool_attn import ep_pool_attend, ep_pool_attend_ref
    q = _rand((Q, C), dev, C ** -0.5, seed=40)
    x = _rand((B, N + prefix, C), dev, seed=41)[:, prefix:]
    v = _rand((B, N, Q, C // Q), dev, seed=42)
    reset_launches()
    out = ep_pool_attend(q, x, v)
    again = ep_pool_attend(q, x, v)
    assert dict(LAUNCHES) == _counts(ep_pool=2)
    assert torch.equal(out, again)
    _close_in_steps(out, ep_pool_attend_ref(q, x, v))


@pytest.mark.parametrize("N, C, Q, QC", [
    (196, 768, 32, 768), (256, 1280, 32, 1280), (1024, 1280, 32, 1280),
    (37, 128, 4, 128), (1025, 1280, 32, 1280), (100, 1280, 64, 1280),
    (70, 192, 12, 192)])
def test_ep_pool_tiling_is_the_kernels(dev, N, C, Q, QC):
    """ops/pool_attn.py's copy of kernel D's shared-memory layout is the
    kernel's own, and the card holds at least one cluster of the tiling."""
    from ep_tpu_torch.ops._build import query
    from ep_tpu_torch.ops.pool_attn import ep_pool_smem_bytes, ep_pool_tiling
    cluster, tiles = ep_pool_tiling(N, C, Q, QC)
    assert (query("ep_pool_smem_bytes", Q, QC, cluster, tiles)
            == ep_pool_smem_bytes(Q, QC, cluster, tiles))
    assert query("ep_pool_resident_clusters", Q, QC, cluster, tiles) >= 1


@pytest.mark.parametrize("B, N, C, Q, d_out", [
    (3, 37, 128, 8, 1), (3, 37, 128, 4, 2), (3, 37, 128, 4, 1),
    (2, 70, 192, 12, 1),
    (2, 196, 768, 32, 1), (2, 256, 1280, 32, 1), (2, 1024, 1280, 32, 1),
    (2, 196, 1024, 32, 1),
    # --d_out 2 at ViT-B and ViT-H: cq = 12 and 20
    (2, 196, 768, 32, 2), (2, 256, 1280, 32, 2),
    # N at the edges of G's 128-token panels, and past 16 of them
    (2, 1, 768, 32, 1), (2, 127, 768, 32, 1), (2, 128, 768, 32, 1),
    (2, 129, 768, 32, 1), (2, 1025, 1280, 32, 1), (2, 2100, 768, 32, 1),
    # Q of 4 (the bank padded to 8 rows), 33 (to 64) and 64; cq = 6
    (2, 196, 128, 4, 1), (2, 196, 528, 33, 1), (2, 196, 1280, 64, 1),
    (1, 9, 192, 32, 1)])
def test_ep_pool_proj_forward_and_grad(dev, B, N, C, Q, d_out):
    """Kernel G against its plain version at ViT-B, ViT-H (224 and 448 px) and
    ViT-L widths, at d_out 2, at the edges of its panels and of its query
    bank, and at small ragged shapes, on the patch-token view the model hands
    it, with the f32 master weight, with the bound on
    the elements past one bf16 step; a second call equal bit for bit (the
    cluster's partial sums are added in rank order, without atomics); the
    gradients are autograd through the plain version on both sides."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.pool_attn import (ep_pool_proj_attend,
                                            ep_pool_proj_attend_ref)
    q = _rand((Q, C), dev, C ** -0.5, seed=50)
    x = _rand((B, N + 1, C), dev, seed=51)[:, 1:]
    w = _rand((C // d_out, C), dev, C ** -0.5, torch.float32, seed=52)
    outs, grads = [], []
    for fn in (ep_pool_proj_attend, ep_pool_proj_attend_ref):
        qg, wg = q.clone().requires_grad_(), w.clone().requires_grad_()
        reset_launches()
        out = fn(qg, x, wg)
        assert LAUNCHES["ep_pool_proj"] == (fn is ep_pool_proj_attend)
        assert LAUNCHES["ep_pool"] == 0
        (out.float() ** 2).sum().backward()
        outs.append(out)
        grads.append((qg.grad, wg.grad))
    assert outs[0].shape == (B, Q, C // d_out // Q)
    assert torch.equal(ep_pool_proj_attend(q, x, w), outs[0])
    _close_in_steps(outs[0], outs[1])
    for a, b in zip(*grads):
        assert a.dtype == b.dtype
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a, b, rtol=1e-2, atol=1e-2 * scale)


@pytest.mark.parametrize("N, C, Q, QC", [
    (196, 768, 32, 768), (256, 1280, 32, 1280), (1024, 1280, 32, 1280),
    (196, 768, 32, 384), (256, 1280, 32, 640), (37, 128, 4, 128),
    (1025, 1280, 32, 1280), (2100, 768, 32, 768), (100, 1280, 64, 1280),
    (70, 528, 33, 528), (70, 192, 12, 192)])
def test_ep_pool_proj_tiling_is_the_kernels(dev, N, C, Q, QC):
    """ops/pool_attn.py's copy of kernel G's shared-memory layout is the
    kernel's own, and the card holds at least one cluster of the tiling."""
    from ep_tpu_torch.ops._build import query
    from ep_tpu_torch.ops.pool_attn import (ep_pool_proj_smem_bytes,
                                            ep_pool_proj_tiling)
    cluster, _ = ep_pool_proj_tiling(N, C, Q, QC)
    assert (query("ep_pool_proj_smem_bytes", Q, QC, cluster)
            == ep_pool_proj_smem_bytes(Q, QC, cluster))
    assert query("ep_pool_proj_resident_clusters", Q, QC, cluster) >= 1


def test_ep_head_fused_route_at_d_out_2(dev, monkeypatch):
    """EfficientProbing with --d_out 2 at ViT-B's width (cq = 12) and ViT-H's
    (cq = 20) takes kernel G with EP_TPU_EP_FUSED set, once and without
    calling the value projection, and agrees with the unfused route, with
    the bound on the elements past one bf16 step."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.poolings.ep import EfficientProbing
    for C, N in ((768, 196), (1280, 256)):
        torch.manual_seed(0)
        mod = EfficientProbing(C, num_queries=32, d_out=2).to(dev)
        assert mod.cq == C // 64
        x = _rand((4, N, C), dev, seed=54)
        unfused = mod(x)
        monkeypatch.setenv("EP_TPU_EP_FUSED", "1")
        calls = []
        hook = mod.v.register_forward_hook(lambda *_: calls.append(1))
        reset_launches()
        fused = mod(x)
        assert dict(LAUNCHES) == _counts(ep_pool_proj=1) and not calls
        hook.remove()
        monkeypatch.delenv("EP_TPU_EP_FUSED")
        assert fused.shape == (4, C // 2)
        _close_in_steps(fused, unfused)


def test_ep_head_routes(dev, monkeypatch):
    """EfficientProbing on the card: kernel D by default, kernel G (and no
    call of the value projection) with EP_TPU_EP_FUSED set; the two agree."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.poolings.ep import EfficientProbing
    torch.manual_seed(0)
    mod = EfficientProbing(768, num_queries=32).to(dev)
    x = _rand((4, 196, 768), dev, seed=53)
    reset_launches()
    unfused = mod(x)
    assert dict(LAUNCHES) == _counts(ep_pool=1)
    monkeypatch.setenv("EP_TPU_EP_FUSED", "1")
    calls = []
    mod.v.register_forward_hook(lambda *_: calls.append(1))
    reset_launches()
    fused = mod(x)
    assert dict(LAUNCHES) == _counts(ep_pool_proj=1) and not calls
    torch.testing.assert_close(fused, unfused, **TOL)
    fused.float().sum().backward()
    assert mod.v.weight.grad is not None and mod.cls_token.grad is not None


def test_model_at_448_px_goes_through_f(dev, monkeypatch):
    """A 2-block ViT-H-width model built at 224 px and fed 448 px images:
    the position embedding is interpolated, every block takes A, F and C, and
    the fused head takes G."""
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.models.assembly import (build_backbone_config,
                                              init_probe_model)
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    monkeypatch.setenv("EP_TPU_EP_FUSED", "1")
    cfg = TrainConfig(model="vit_huge_patch14", cls_features="ep",
                      ep_queries=32, nb_classes=10, image_size=224,
                      amp="bfloat16")
    model = init_probe_model(cfg, 0, build_backbone_config(cfg).replace(depth=2))
    model.eval()
    x = _rand((2, 448, 448, 3), dev, dtype=torch.float32, seed=54)
    reset_launches()
    with torch.no_grad():
        out = model(x)
    assert dict(LAUNCHES) == _counts(ln_qkv_gemm=2, attn_flash=2,
                                     proj_residual_gemm=2, ep_pool_proj=1,
                                     fc1_gelu_epilogue=2)
    assert out.shape == (2, 10) and torch.isfinite(out).all()


def test_kernels_refuse_what_they_do_not_take(dev):
    from ep_tpu_torch.ops.attn_fused import attention_qkv_fused
    with pytest.raises(TypeError):
        attention_qkv_fused(_rand((1, 5, 3 * 64), dev, dtype=torch.float32), 1,
                            0.125)
    from ep_tpu_torch.ops.attn_fused import attention_qkv_fused_bwd
    with pytest.raises(NotImplementedError, match="head width"):
        attention_qkv_fused(_rand((1, 5, 3 * 64), dev), 2, 0.125)
    with pytest.raises(NotImplementedError, match="head width 32"):
        attention_qkv_fused(_rand((1, 273, 3 * 64), dev), 2, 0.125)  # F's widths
    from ep_tpu_torch.ops.pool_attn import ep_pool_proj_attend
    # kernel G takes kernel D's widths (any cq; cq = 6 is a case of
    # test_ep_pool_proj_forward_and_grad; any Q, past 64 in groups) and
    # refuses the others: 65 queries of cq 2 are 130 columns
    with pytest.raises(NotImplementedError, match=r"Q\*cq % 8"):
        ep_pool_proj_attend(_rand((65, 192), dev), _rand((1, 9, 192), dev),
                            _rand((130, 192), dev))
    with pytest.raises(NotImplementedError, match=r"Q\*cq % 8"):
        ep_pool_proj_attend(_rand((4, 128), dev), _rand((1, 9, 128), dev),
                            _rand((12, 128), dev))
    with pytest.raises(ValueError, match="mix"):
        ep_pool_proj_attend(_rand((8, 128), dev), _rand((1, 9, 128), dev),
                            _rand((128, 128), dev).cpu())
    with pytest.raises(ValueError):
        attention_qkv_fused(_rand((1, 3 * 64, 5), dev).transpose(1, 2), 1, 0.125)
    with pytest.raises(NotImplementedError, match="head width 32"):
        attention_qkv_fused_bwd(_rand((1, 5, 3 * 64), dev),
                                _rand((1, 5, 64), dev), 2, 0.125)
    with pytest.raises(NotImplementedError, match="T=321"):
        attention_qkv_fused_bwd(_rand((1, 321, 3 * 80), dev),
                                _rand((1, 321, 80), dev), 1, 0.125)
    with pytest.raises(NotImplementedError, match="T=385"):
        attention_qkv_fused_bwd(_rand((1, 385, 3 * 64), dev),
                                _rand((1, 385, 64), dev), 1, 0.125)


def _mlp_args(B, T, D, DH, dev):
    x = _rand((B, T, D), dev, seed=21)
    x[0, T // 2] = 0.0  # an all-zero token row
    return (x, _rand((DH, D), dev, D ** -0.5, seed=22),
            _rand((DH,), dev, 0.02, torch.float32, seed=23),
            _rand((D, DH), dev, DH ** -0.5, seed=24),
            _rand((D,), dev, 0.02, torch.float32, seed=25),
            1 + _rand((D,), dev, 0.1, torch.float32, seed=26),
            _rand((D,), dev, 0.1, torch.float32, seed=27))


def _code_diff(a, b):
    """(share of int8 codes that differ, the largest difference)."""
    d = (a.int() - b.int()).abs()
    return float((d != 0).float().mean()), int(d.max())


@pytest.mark.parametrize("B, T, D, DH, stripes, tier", [
    (3, 7, 128, 512, 1, "resident"), (3, 7, 128, 512, 2, "resident"),
    (2, 197, 768, 3072, 1, "resident"), (2, 197, 1024, 4096, 8, "resident"),
    (1, 257, 1280, 5120, 8, "resident"), (1, 257, 1280, 5120, 8, "two_kernel")])
def test_mlp_int8_kernels(dev, B, T, D, DH, stripes, tier):
    """ln_quant, fc1 and fc2 (in the tier's bias order), each against its
    plain version on the same inputs. The s32 products are exact, so fc1 and
    fc2 repeat their plain versions' f32 arithmetic to the bit on the same
    codes. Only ln_quant's f32
    row statistics are summed in another order, which moves single codes of
    LN2's output across a rounding boundary: by at most 1, in under 1e-3 of
    them. Through the whole half such a code can move a hidden value by one
    bf16 step before the GELU, so the hidden codes are held to a share of 1e-2
    and the output to the kernels' usual tolerance where a token's LN codes and
    scale agree, and to 1e-2 of the largest output on the other tokens.
    Against the bf16 half the int8 half is approximate by design: held to
    the JAX package's kernel gate, mean |d| / mean |ref| <= 3e-2 and max |d|
    / max |ref| <= 0.6."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops import mlp_int8 as m
    x, w1, b1, w2, b2, g, be = _mlp_args(B, T, D, DH, dev)
    w1q, s1 = m.quantize_weight(w1)
    w2q, s2 = m.quantize_weight(w2)
    reset_launches()
    hq, sx = m.ln_quant(x, g, be, 1e-6)
    aq, sa = m.fc1(hq, sx, w1q, s1, b1, stripes)
    out = m.fc2(aq, sa, x, w2q, s2, b2, stripes, tier)
    assert dict(LAUNCHES) == _counts(mlp_int8_ln_quant=1, mlp_int8_fc1=1,
                                     mlp_int8_fc2=1)
    hq_r, sx_r = m.ln_quant_ref(x, g, be, 1e-6)
    share, worst = _code_diff(hq, hq_r)
    assert worst <= 1 and share < 1e-3, (share, worst)
    torch.testing.assert_close(sx, sx_r, rtol=1e-5, atol=0)
    assert not hq[0, T // 2].any() or float(be.abs().max()) > 0
    aq_r, sa_r = m.fc1_ref(hq, sx, w1q, s1, b1, stripes)
    assert _code_diff(aq, aq_r) == (0.0, 0)
    torch.testing.assert_close(sa, sa_r, rtol=0, atol=0)
    torch.testing.assert_close(
        out, m.fc2_ref(aq, sa, x, w2q, s2, b2, stripes, tier), rtol=0, atol=0)
    assert torch.isfinite(out).all()
    ref16 = m.mlp_bf16_ref(x, w1, b1, w2, b2, g, be, 1e-6).float()
    d = (out.float() - ref16).abs()
    assert float(d.mean() / ref16.abs().mean()) <= 3e-2
    assert float(d.max() / ref16.abs().max()) <= 0.6
    del ref16, d
    # the whole half from x
    ref = m.mlp_int8_ref(x, w1, b1, w2, b2, g, be, 1e-6, stripes, tier)
    got = m.mlp_int8_forward(x, w1, b1, w2, b2, g, be, 1e-6, stripes, tier)
    same = (hq == hq_r).all(-1) & (sx == sx_r).all(-1)
    torch.testing.assert_close(got[same], ref[same], **TOL)
    torch.testing.assert_close(got[~same], ref[~same], rtol=1e-2,
                               atol=1e-2 * float(ref.float().abs().max()))
    share, worst = _code_diff(aq, m.fc1_ref(hq_r, sx_r, w1q, s1, b1, stripes)[0])
    print(f"int8 codes B={B} T={T} D={D} S={stripes}: share differing "
          f"{share:.2e}, largest difference {worst}")
    assert share < 1e-2


@pytest.mark.parametrize("M, D", [
    (m, d) for m in (1, 111, 512 * 197)
    for d in (128, 384, 768, 1024, 1280, 1408, 2176)])
def test_ln_quant_at_every_width(dev, M, D):
    """ln_quant against its plain version at the widths of the models (and
    384, a row that half the lanes hold twice; 2176, past the 2048 columns a
    warp holds in registers): codes one step apart at most and in at most
    1e-3 of them (at least 2; the row statistics are summed in another order
    than torch's), scales to 1e-5; two calls equal bit for bit; a zero row
    with beta = 0 at the scale's floor with zero codes; and with gamma = 0,
    every h = beta an odd multiple of sx / 2, codes rounded half to even and
    scales equal to the plain version's."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops import mlp_int8 as m
    x = _rand((1, M, D), dev, seed=60)
    x[0, M // 2] = 0.0
    g = 1 + _rand((D,), dev, 0.1, torch.float32, seed=61)
    be = _rand((D,), dev, 0.1, torch.float32, seed=62)
    reset_launches()
    hq, sx = m.ln_quant(x, g, be, 1e-6)
    hq2, sx2 = m.ln_quant(x, g, be, 1e-6)
    assert dict(LAUNCHES) == _counts(mlp_int8_ln_quant=2)
    assert torch.equal(hq, hq2) and torch.equal(sx, sx2)
    hq_r, sx_r = m.ln_quant_ref(x, g, be, 1e-6)
    d = (hq.int() - hq_r.int()).abs()
    assert int(d.max()) <= 1 and int((d != 0).sum()) <= max(2, 1e-3 * d.numel())
    torch.testing.assert_close(sx, sx_r, rtol=1e-5, atol=0)
    zero = torch.zeros_like(g)
    hz, sz = m.ln_quant(x, g, zero, 1e-6)
    floor = torch.full((), 1e-8) / torch.full((), 127.0)
    assert float(sz[0, M // 2]) == float(floor) and not hz[0, M // 2].any()
    # every h = beta: odd multiples of 1/128 with max |h| = 127/64, so that
    # sx = 1/64 and every h / sx is a half
    beta = (torch.arange(D, device=dev, dtype=torch.float32) % 254 - 126.5) / 64
    beta[0] = 127 / 64
    hh, sh = m.ln_quant(x, zero, beta, 1e-6)
    hh_r, sh_r = m.ln_quant_ref(x, zero, beta, 1e-6)
    assert torch.equal(sh, sh_r) and float(sh.max()) == 1 / 64
    assert torch.equal(hh, hh_r)


@pytest.mark.parametrize("B, T, D, stripes", [
    (3, 37, 768, 1), (1, 100, 768, 1), (3, 37, 1280, 8), (1, 64, 1280, 8),
    (2, 197, 1024, 8), (1, 128, 768, 8), (1, 64, 768, 1), (1, 64, 1024, 8)])
def test_fc2_takes_the_tiers_bias_order(dev, B, T, D, stripes):
    """Kernel fc2 at both tiers against its plain version on the same codes,
    to the bit: x + (y + b2) at the resident tier, (x + y) + b2 at the
    two-kernel tier (the two differ), with 1 and 8 stripes, M ragged (111),
    under one 128-row panel (64, 100) and at one panel (128)."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops import mlp_int8 as m
    DH = 4 * D
    rng = np.random.default_rng(80)
    aq = torch.from_numpy(rng.integers(-127, 128, (B, T, DH), dtype=np.int8)).to(dev)
    sa = _rand((B, T, stripes), dev, 0.01, torch.float32, seed=81).abs() + 1e-3
    w2q, s2 = m.quantize_weight(_rand((D, DH), dev, DH ** -0.5, seed=82))
    x = _rand((B, T, D), dev, seed=83)
    b2 = _rand((D,), dev, 0.5, torch.float32, seed=84)
    outs = {}
    for tier in m.TIERS:
        reset_launches()
        outs[tier] = m.fc2(aq, sa, x, w2q, s2, b2, stripes, tier)
        assert dict(LAUNCHES) == _counts(mlp_int8_fc2=1)
        torch.testing.assert_close(
            outs[tier], m.fc2_ref(aq, sa, x, w2q, s2, b2, stripes, tier),
            rtol=0, atol=0)
    assert not torch.equal(*outs.values())


@pytest.mark.parametrize("B, T, D, stripes", [
    (1, 5, 768, 1), (3, 197, 768, 1), (1, 100, 1024, 8), (3, 257, 1024, 8),
    (1, 64, 1280, 8), (2, 257, 1280, 8), (1, 128, 768, 8), (2, 37, 128, 4),
    (1, 300, 640, 1), (3, 37, 768, 1), (3, 37, 1280, 8)])
def test_fc1_equals_its_plain_version_bit_for_bit(dev, B, T, D, stripes):
    """Kernel fc1 on random codes at the three model widths with 1 and 8
    stripes (clusters of 8, 2 and 1 blocks; tiles of 128 and 160 columns), M
    smaller than one 128-row panel, equal to one and ragged, with one token
    whose GELU outputs are all zero in the first stripe (zero codes and zero
    bias there), so that its scale is the 1e-8 floor: the s32 sums are exact
    and the f32 steps round as the plain version's, so codes and scales are
    equal."""
    from ep_tpu_torch.ops import mlp_int8 as m
    DH = 4 * D
    rng = np.random.default_rng(70)
    hq = torch.from_numpy(rng.integers(-127, 128, (B, T, D), dtype=np.int8)).to(dev)
    hq[0, T // 2] = 0
    sx = _rand((B, T, 1), dev, 0.01, torch.float32, seed=71).abs() + 1e-3
    w1q, s1 = m.quantize_weight(_rand((DH, D), dev, D ** -0.5, seed=72))
    b1 = _rand((DH,), dev, 0.1, torch.float32, seed=73)
    b1[:DH // stripes] = 0
    aq, sa = m.fc1(hq, sx, w1q, s1, b1, stripes)
    aq_r, sa_r = m.fc1_ref(hq, sx, w1q, s1, b1, stripes)
    assert _code_diff(aq, aq_r) == (0.0, 0)
    torch.testing.assert_close(sa, sa_r, rtol=0, atol=0)
    assert float(sa[0, T // 2, 0]) == float(
        torch.full((), 1e-8) / torch.full((), 127.0))
    assert not aq[0, T // 2, :DH // stripes].any()


def test_fc1_gelu_table_is_the_gelu_arithmetic(dev):
    """fc1 reads its GELU from a table (and closed forms outside its range);
    a kernel tries every finite bf16 value: each gives the bits of the
    kernels' op-by-op bf16 GELU (which the bit-equal codes of the test above
    hold to the plain version's)."""
    from ep_tpu_torch.ops import mlp_int8 as m
    assert m.gelu_table_mismatches(dev) == 0


def test_fc1_refuses_what_it_does_not_take(dev):
    from ep_tpu_torch.ops import mlp_int8 as m
    hq = torch.zeros(1, 5, 1024, device=dev, dtype=torch.int8)
    sx = torch.ones(1, 5, 1, device=dev)
    w1q = torch.zeros(4096, 1024, device=dev, dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="tiling"):
        m.fc1(hq, sx, w1q, torch.ones(4096, device=dev),
              torch.zeros(4096, device=dev), 1)  # one stripe of 4096 columns


def test_int8_model_launches(dev):
    """A 2-block int8 ViT: A, B, C and the three int8 kernels once a block,
    and the int8 features near the bf16 features of the same weights."""
    from ep_tpu_torch.models.vit import ViTConfig, VisionTransformer
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    torch.manual_seed(0)
    kw = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2)
    model = VisionTransformer(ViTConfig(int8_mlp=True, **kw)).to(dev)
    plain = VisionTransformer(ViTConfig(**kw)).to(dev)
    plain.load_state_dict(model.state_dict())
    x = _rand((3, 32, 32, 3), dev, dtype=torch.float32, seed=30)
    reset_launches()
    with torch.no_grad():
        feats = model(x, "pos")
        assert dict(LAUNCHES) == _counts(
            ln_qkv_gemm=2, attn_core=2, proj_residual_gemm=2,
            mlp_int8_ln_quant=2, mlp_int8_fc1=2, mlp_int8_fc2=2)
        ref = plain(x, "pos")
    assert dict(LAUNCHES)["mlp_int8_fc1"] == 2  # the bf16 model launched none
    rel = float((feats.float() - ref.float()).abs().mean()
                / ref.float().abs().mean())
    assert 0 < rel < 0.05


def test_int8_kernels_refuse_what_they_do_not_take(dev):
    from ep_tpu_torch.ops.mlp_int8 import mlp_int8_forward
    args = _mlp_args(2, 5, 128, 512, dev)
    with pytest.raises(NotImplementedError, match="128"):
        mlp_int8_forward(*args, 1e-6, 8)  # stripes of 64 columns
    with pytest.raises(TypeError):
        mlp_int8_forward(args[0].float(), *args[1:], 1e-6, 1)
    with pytest.raises(ValueError, match="mix"):
        mlp_int8_forward(args[0].cpu(), *args[1:], 1e-6, 1)


def test_init_probe_model_builds_on_the_card(dev):
    """Without ``device`` the model is built on the card, from the same CPU
    generator as with ``device="cpu"``: identical weights on both."""
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.models.assembly import (build_backbone_config,
                                              init_probe_model)
    cfg = TrainConfig(model="vit_tiny_patch16", cls_features="ep", ep_queries=4,
                      nb_classes=5, image_size=32)
    bcfg = build_backbone_config(cfg).replace(embed_dim=64, depth=1, num_heads=1)
    on_card = init_probe_model(cfg, 3, bcfg)
    on_cpu = init_probe_model(cfg, 3, bcfg, device="cpu")
    assert {p.device.type for p in on_card.parameters()} == {"cuda"}
    for (k, a), (_, b) in zip(on_card.state_dict().items(),
                              on_cpu.state_dict().items()):
        assert torch.equal(a.cpu(), b), k


def test_mlp_int8_fused_backward_is_the_bf16_half(dev):
    """On the card the forward runs the int8 kernels and the backward is
    autograd through the bf16 half: the same gradients as differentiating
    ``mlp_bf16_ref`` directly, for the same upstream gradient."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.mlp_int8 import mlp_bf16_ref, mlp_int8_fused
    args = _mlp_args(2, 7, 128, 512, dev)
    g = _rand((2, 7, 128), dev, seed=28)
    grads = []
    for fn in (mlp_int8_fused, mlp_bf16_ref):
        ins = [a.float().requires_grad_(True) if i else
               a.clone().requires_grad_(True) for i, a in enumerate(args)]
        reset_launches()
        out = fn(*ins, 1e-6)
        assert LAUNCHES["mlp_int8_fc1"] == (fn is mlp_int8_fused)
        grads.append(torch.autograd.grad(out, ins, g))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# More than 64 queries: --ep_queries 96, 128 and 768 at ViT-B's width (cq 8,
# 6 and 1), 1280 at ViT-H's (cq 1), 65 (a last group of one query; cq 16)
# and 128 at cq 10 (ViT-H, --ep_queries 128).
MANY_QUERIES = [(2, 196, 768, 96), (2, 196, 768, 128), (2, 196, 768, 768),
                (2, 256, 1280, 1280), (2, 196, 1040, 65), (2, 256, 1280, 128)]


@pytest.mark.parametrize("B, N, C, Q", MANY_QUERIES)
def test_ep_pool_takes_more_than_64_queries(dev, B, N, C, Q):
    """Kernel D past 64 queries: one launch for each group of at most 64,
    against its plain version on the patch-token view with the bound on the
    elements past one bf16 step, and two calls equal bit for bit."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.pool_attn import (ep_pool_attend, ep_pool_attend_ref,
                                            query_groups)
    q = _rand((Q, C), dev, C ** -0.5, seed=60)
    x = _rand((B, N + 1, C), dev, seed=61)[:, 1:]
    v = _rand((B, N, Q, C // Q), dev, seed=62)
    reset_launches()
    out = ep_pool_attend(q, x, v)
    assert dict(LAUNCHES) == _counts(ep_pool=len(query_groups(Q)))
    assert torch.equal(out, ep_pool_attend(q, x, v))
    _close_in_steps(out, ep_pool_attend_ref(q, x, v))


@pytest.mark.parametrize("B, N, C, Q", MANY_QUERIES)
def test_ep_pool_proj_takes_more_than_64_queries(dev, B, N, C, Q):
    """Kernel G past 64 queries: one launch for each group of at most 64 on
    its rows of W, against its plain version with the bound on the elements
    past one bf16 step, and two calls equal bit for bit."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.pool_attn import (ep_pool_proj_attend,
                                            ep_pool_proj_attend_ref,
                                            query_groups)
    q = _rand((Q, C), dev, C ** -0.5, seed=63)
    x = _rand((B, N + 1, C), dev, seed=64)[:, 1:]
    w = _rand((C, C), dev, C ** -0.5, torch.float32, seed=65)
    reset_launches()
    out = ep_pool_proj_attend(q, x, w)
    assert dict(LAUNCHES) == _counts(ep_pool_proj=len(query_groups(Q)))
    assert torch.equal(out, ep_pool_proj_attend(q, x, w))
    _close_in_steps(out, ep_pool_proj_attend_ref(q, x, w))


# The driver on the card: ViT-B's width at depth 2, 64 px images (16 patch
# tokens) of the fake dataset, EP-32, bf16, one epoch of 4 steps at batch
# 128. The CPU run of the same seed goes through the plain versions; both
# round to bf16 at the same points and sum in another order, so the losses
# of the log line agree within DRIVER_LOSS_TOL (absolute, plus the same
# share of the CPU's loss).
DRIVER_LOSS_TOL = 2e-2


def _driver_cfg(tmp_path, **kw):
    from ep_tpu_torch.configs import TrainConfig
    base = dict(dataset_name="fake", nb_classes=10, image_size=64,
                batch_size=128, model="vit_base_patch16", cls_features="ep",
                ep_queries=32, epochs=1, warmup_epochs=1, blr=0.1,
                num_workers=4, amp="bfloat16", seed=0,
                output_dir=str(tmp_path))
    base.update(kw)
    return TrainConfig(**base)


@pytest.fixture
def depth2(monkeypatch):
    import ep_tpu_torch.cli.linprobe as linprobe
    from ep_tpu_torch.models.assembly import build_backbone_config
    monkeypatch.setattr(linprobe, "build_backbone_config",
                        lambda cfg: build_backbone_config(cfg).replace(depth=2))


def _epoch_line(path):
    return [float(v) for v in (path / "training_log.txt").read_text()
            .splitlines()[10].split(", ")]


def test_driver_one_epoch_on_the_card_matches_cpu(dev, tmp_path, depth2):
    from ep_tpu_torch.cli.linprobe import main
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    reset_launches()
    main(_driver_cfg(tmp_path / "card", device="cuda"))
    launched = dict(LAUNCHES)
    main(_driver_cfg(tmp_path / "cpu", device="cpu"))
    # 4 train steps and 1 eval batch of 128, each a forward through 2 blocks;
    # LARS's pair once a train step
    assert launched == _counts(ln_qkv_gemm=10, attn_core=10,
                               proj_residual_gemm=10, ep_pool=5,
                               lars_norms=4, lars_apply=4,
                               fc1_gelu_epilogue=10)
    card, cpu = _epoch_line(tmp_path / "card"), _epoch_line(tmp_path / "cpu")
    assert card[0] == cpu[0] == 0
    for i in (1, 3):  # train loss, val loss
        assert abs(card[i] - cpu[i]) <= DRIVER_LOSS_TOL * (1 + abs(cpu[i]))


def test_driver_builds_on_the_card_by_default(dev, tmp_path, depth2):
    """Without --device cpu (the flag's default is the JAX package's "tpu")
    the driver trains on the card, through the kernels."""
    from ep_tpu_torch.cli.linprobe import main, run_device
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    assert run_device(TrainConfig()).type == "cuda"
    reset_launches()
    main(_driver_cfg(tmp_path))
    assert LAUNCHES["ep_pool"] == 5 and LAUNCHES["attn_core"] == 10


@pytest.mark.parametrize("flags", [dict(cache_features=True),
                                   dict(device_aug=True)],
                         ids=["cache_features", "device_aug"])
def test_driver_input_modes_on_the_card_match_cpu(dev, tmp_path, depth2,
                                                  flags):
    """--cache_features (the encoder over 4 train and 1 val batches, then a
    head-only epoch: kernel D 4 + 1 times, LARS's pair 4) and --device_aug
    (the crop on the card, drawn as on the CPU for the same step) against
    their CPU runs."""
    from ep_tpu_torch.cli.linprobe import main
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    reset_launches()
    main(_driver_cfg(tmp_path / "card", device="cuda", **flags))
    launched = dict(LAUNCHES)
    main(_driver_cfg(tmp_path / "cpu", device="cpu", **flags))
    assert launched == _counts(ln_qkv_gemm=10, attn_core=10,
                               proj_residual_gemm=10, ep_pool=5,
                               lars_norms=4, lars_apply=4,
                               fc1_gelu_epilogue=10)
    card, cpu = _epoch_line(tmp_path / "card"), _epoch_line(tmp_path / "cpu")
    assert card[0] == cpu[0] == 0
    for i in (1, 3):  # train loss, val loss
        assert abs(card[i] - cpu[i]) <= DRIVER_LOSS_TOL * (1 + abs(cpu[i]))


def test_extract_split_reads_each_batch_from_a_side_stream(dev):
    """The card's features reach the host through pinned memory on a side
    stream, one batch late: the same arrays as a blocking copy."""
    from ep_tpu_torch.train.feature_cache import extract_split

    class Loader:
        dataset = range(20)

        def __iter__(self):
            rng = np.random.default_rng(0)
            for b in range(3):
                x = rng.standard_normal((8, 6, 4)).astype(np.float32)
                valid = np.ones(8, np.float32)
                if b == 2:
                    valid[4:] = 0
                yield x, np.arange(8 * b, 8 * b + 8), valid

    def apply(x):
        return (x * 2).to(torch.bfloat16)[:, 1:]  # a view, as "pos" is

    feats, labels = extract_split(apply, Loader(), dev, "", "t")
    ref = np.concatenate([apply(torch.from_numpy(x)).float().numpy()[v > 0]
                          for x, _, v in Loader()])
    assert feats.dtype == np.float32 and feats.shape == (20, 5, 4)
    np.testing.assert_array_equal(feats, ref)
    np.testing.assert_array_equal(labels, np.arange(20))


def test_device_aug_draws_on_the_card_what_it_draws_on_the_cpu(dev):
    """The same step's crop on the card and on the CPU: the same boxes and
    flips. The card's products round their operands to bf16 (the CPU's
    widen them to f32), and a y-pass bf16 step is carried through the
    x-pass: every f32 output within 5e-2, at most 2e-2 of them past 1e-3,
    the mean |d| under 1e-4. A wrong box or flip moves most elements by
    tenths."""
    from ep_tpu_torch.data.device_aug import DeviceAug
    aug = DeviceAug(out_size=224, stage_size=256, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (16, 256, 256, 3), dtype=np.uint8))
    got = aug.train_fn(3, x.to(dev)).cpu()
    ref = aug.train_fn(3, x)
    assert got.shape == (16, 224, 224, 3)
    d = (got - ref).abs()
    assert float(d.max()) <= 5e-2 and int((d > 1e-3).sum()) <= 2e-2 * d.numel()
    assert float(d.mean()) <= 1e-4


def test_attention_backward_routes_by_shape(dev):
    """Up to kernel E's limit the autograd backward launches E; past it the
    tiled plain backward (counted as attn_bwd_long), which agrees with the
    CPU's run of the same function, and E is not launched."""
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    from ep_tpu_torch.ops.attn_fused import (attention_qkv_fused,
                                             attention_qkv_fused_bwd_long)
    for t, expect in ((384, dict(attn_flash=1, attn_core_bwd=1)),
                      (385, dict(attn_flash=1, attn_bwd_long=1))):
        qkv = _rand((2, t, 3 * 128), dev, seed=t).requires_grad_(True)
        g = _rand((2, t, 128), dev, seed=t + 1)
        reset_launches()
        attention_qkv_fused(qkv, 2, 0.125).backward(g)
        assert dict(LAUNCHES) == _counts(**expect)
    ref = attention_qkv_fused_bwd_long(qkv.detach().cpu(), g.cpu(), 2, 0.125)
    scale = float(ref.float().abs().max())
    torch.testing.assert_close(qkv.grad.cpu().float(), ref.float(), rtol=1e-2,
                               atol=1e-2 * scale)


def test_mae_decoder_runs_on_the_card(dev):
    """MAE at ViT-B's widths with its decoder (16 heads of width 32, which
    kernel B is not built for), depth cut to 2 and 2: the encoder launches A,
    B and C once a block, the decoder's plain route no attention kernel,
    every block's MLP (under ``no_grad``) fc1's GELU epilogue, and the loss
    agrees with the CPU's on the same masking noise."""
    from ep_tpu_torch.models.assembly import init_backbone
    from ep_tpu_torch.models.mae import (MaskedAutoencoderViT,
                                         mae_vit_base_patch16)
    from ep_tpu_torch.ops import LAUNCHES, reset_launches
    import dataclasses
    m = MaskedAutoencoderViT(dataclasses.replace(
        mae_vit_base_patch16(), depth=2, decoder_depth=2))
    init_backbone(m, torch.Generator().manual_seed(0))
    x = _rand((4, 224, 224, 3), "cpu", dtype=torch.float32, seed=1)
    noise = torch.rand(4, 196, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = m(x, 0.75, noise=noise)[0].item()
        m.to(dev)
        reset_launches()
        got = m(x.to(dev), 0.75, noise=noise)[0].item()
    assert dict(LAUNCHES) == _counts(ln_qkv_gemm=2, attn_core=2,
                                     proj_residual_gemm=2, fc1_gelu_epilogue=4)
    assert abs(got - ref) <= 2e-3 * abs(ref)


def test_shard_state_halves_the_backbone_on_the_card(dev):
    """``shard_state`` at model 2, in one process as rank 0 of the model
    group: a frozen ViT-B/16 on the card keeps its head-group and half
    slices as copies, and the card frees the whole tensors, so the bytes
    the live tensors requested fall by at least half of the blocks' four
    products. Requested bytes, not ``memory_allocated()``: the allocator
    rounds a tensor up to a block that the segments earlier tests left in
    its cache decide, so the allocated bytes freed depend on the tests'
    order; the requested bytes fall only as the whole tensors go."""
    from ep_tpu_torch.configs import TrainConfig
    from ep_tpu_torch.models.assembly import init_probe_model
    from ep_tpu_torch.parallel.mesh import Mesh
    from ep_tpu_torch.parallel.partition import shard_state
    from ep_tpu_torch.train.state import cast_frozen
    cfg = TrainConfig(model="vit_base_patch16", cls_features="ep",
                      ep_queries=32, nb_classes=1000, amp="bfloat16")
    model = init_probe_model(cfg, seed=0)
    cast_frozen(model, torch.bfloat16)
    blk = model.backbone.blocks[0]
    qkv, fc2 = blk.attn.qkv.weight.detach().cpu(), blk.mlp.fc2.weight.detach().cpu()
    whole = sum(p.numel() * p.element_size()
                for p in model.backbone.parameters())
    torch.cuda.synchronize()

    def requested():
        # the live tensors' own bytes: the allocator's blocks round them up,
        # by as much as 1 MiB a tensor, as the segments that earlier tests
        # left in its cache decide
        return torch.cuda.memory_stats()["requested_bytes.all.current"]

    before = requested()
    shard_state(model, Mesh(1, 2))
    freed = before - requested()
    held = sum(p.numel() * p.element_size() for p in model.backbone.parameters())
    products = 12 * 2 * (4 * 768 * 768 + 2 * 768 * 3072)  # qkv, proj, fc1, fc2
    assert held == whole - products // 2 - 12 * 2 * (3 * 768 + 3072) // 2
    # the whole tensors are freed: at least the bytes the cut drops
    assert freed >= whole - held - 2 ** 16, (freed, whole - held)
    assert 0.50 <= held / whole <= 0.51
    q, k = qkv[:384], qkv[768:768 + 384]
    torch.testing.assert_close(blk.attn.qkv.weight.cpu(),
                               torch.cat([q, k, qkv[1536:1536 + 384]]),
                               rtol=0, atol=0)
    torch.testing.assert_close(blk.mlp.fc2.weight.cpu(), fc2[:, :1536],
                               rtol=0, atol=0)
    for p in model.backbone.parameters():
        assert p.untyped_storage().nbytes() == p.numel() * p.element_size()
