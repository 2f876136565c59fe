"""The long-sequence slice of ep_tpu_torch against the JAX package, on the CPU:
position-embedding interpolation, the plain version that kernel F is held to
against the TPU's flash and row-tiled kernels (interpret mode), the routing
between kernels B and F, and a whole ProbeModel fed another image size than
it was built for.

Inputs come from numpy seeds and go through both sides. Tolerances: float32
at 1e-5, the suite's parity bar. In bfloat16 both sides round at the same
points and sum in f32 in another order, which can move a value across one
bf16 rounding boundary: two bf16 steps (2**-7) of the output's magnitude; a
whole model in bf16 within 3e-2 of its largest logit, as in
``test_torch_model.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ep_tpu.configs import TrainConfig
from ep_tpu.models.assembly import ProbeModel as FlaxProbeModel
from ep_tpu.models.vit import ViTConfig as FlaxViTConfig
from ep_tpu.ops.attn_fused_pallas import (_bwd_xla, _fwd_flash,
                                          _fwd_head_group_rowtile, _fwd_xla)
from ep_tpu.ops.flash_attn_pallas import flash_attention as jax_flash
from ep_tpu.utils import pos_embed as jax_pos_embed
from ep_tpu_torch.configs import TrainConfig as PortTrainConfig
from ep_tpu_torch.convert.from_flax import flax_to_torch
from ep_tpu_torch.models.assembly import ProbeModel, build_backbone_config
from ep_tpu_torch.ops import LAUNCHES, reset_launches
from ep_tpu_torch.ops.attn_block import attn_supercell, attn_supercell_ref
from ep_tpu_torch.ops.attn_fused import (BWD_MAX_T, CORE_MAX_T,
                                         attention_core, attention_qkv_fused,
                                         attention_qkv_fused_bwd_long,
                                         attention_qkv_fused_ref, attn_route,
                                         bwd_route)
from ep_tpu_torch.ops.flash_attn import (attn_flash, flash_attention,
                                         flash_attention_ref)
from ep_tpu_torch.utils import pos_embed

F32_TOL = 1e-5
BF16_RTOL = 2.0 ** -7
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    jd, td = DT[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _close(out_t: torch.Tensor, out_j, dtype: str):
    a = out_t.detach().float().numpy()
    b = np.asarray(jnp.asarray(out_j, jnp.float32))
    assert a.shape == b.shape
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_allclose(a, b, rtol=BF16_RTOL,
                                   atol=BF16_RTOL * float(np.abs(b).max()))


# --- position embedding --------------------------------------------------------

@pytest.mark.parametrize("old, new", [(16, 32), (14, 32), (32, 14), (2, 4),
                                      (4, 2)])
def test_interpolate_pos_embed_matches_jax(old, new):
    """Growing (no antialias) and shrinking (the kernel widened), with the
    [CLS] row kept: jax.image.resize's bicubic, not F.interpolate's."""
    D = 24
    pos = np.random.default_rng(old * 100 + new).standard_normal(
        (1, 1 + old * old, D)).astype(np.float32)
    out_j = jax_pos_embed.interpolate_pos_embed(jnp.asarray(pos), new * new, 1)
    out_t = pos_embed.interpolate_pos_embed(torch.from_numpy(pos), new * new, 1)
    assert out_t.shape == (1, 1 + new * new, D) and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_array_equal(out_t[:, 0].numpy(), pos[:, 0])


def test_interpolate_pos_embed_is_not_torchs_bicubic():
    """The trap the port avoids: torch's bicubic (a = -0.75, clamped edges)
    gives other numbers on the same grid."""
    pos = np.random.default_rng(3).standard_normal((1, 16, 8)).astype(np.float32)
    ours = pos_embed.interpolate_pos_embed(torch.from_numpy(pos), 64, 0)
    grid = torch.from_numpy(pos).reshape(1, 4, 4, 8).permute(0, 3, 1, 2)
    theirs = torch.nn.functional.interpolate(
        grid, size=(8, 8), mode="bicubic", align_corners=False)
    theirs = theirs.permute(0, 2, 3, 1).reshape(1, 64, 8)
    assert float((ours - theirs).abs().max()) > 1e-2


def test_interpolate_pos_embed_same_size_and_no_extra_tokens():
    pos = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 9, 8)).astype(np.float32))
    assert pos_embed.interpolate_pos_embed(pos, 9, 0) is pos
    out_j = jax_pos_embed.interpolate_pos_embed(jnp.asarray(pos.numpy()), 36, 0)
    np.testing.assert_allclose(
        pos_embed.interpolate_pos_embed(pos, 36, 0).numpy(), np.asarray(out_j),
        rtol=F32_TOL, atol=F32_TOL)


def test_sincos_helpers_match_jax_package():
    for dim, size, cls in ((16, 3, False), (32, 4, True)):
        np.testing.assert_array_equal(
            pos_embed.get_2d_sincos_pos_embed(dim, size, cls),
            jax_pos_embed.get_2d_sincos_pos_embed(dim, size, cls))


# --- kernel F's plain version against the TPU kernels ---------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh, T", [(64, 70), (80, 37), (80, 130)])
def test_flash_attention_matches_jax(dtype, Dh, T):
    """``flash_attention`` on pre-split (B,H,T,Dh) tensors, T no multiple of
    any tile, against the Pallas flash kernel in interpret mode."""
    B, H = 2, 2
    rng = np.random.default_rng(Dh + T)
    (q_j, q_t), (k_j, k_t), (v_j, v_t) = (
        _pair(rng.standard_normal((B, H, T, Dh)).astype(np.float32), dtype)
        for _ in range(3))
    scale = Dh ** -0.5
    out_j = jax_flash(q_j, k_j, v_j, scale, 1.5, True)
    out_t = flash_attention(q_t, k_t, v_t, scale, 1.5)
    assert out_t.dtype == DT[dtype][1]
    _close(out_t, out_j, dtype)
    torch.testing.assert_close(out_t, flash_attention_ref(q_t, k_t, v_t, scale,
                                                          1.5), rtol=0, atol=0)


def test_flash_attention_gradients_match_jax_vjp():
    """The recompute backward, against the JAX module's ``_bwd``."""
    B, H, T, Dh = 1, 2, 17, 8
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal((B, H, T, Dh)).astype(np.float32)
            for _ in range(4)]
    scale = Dh ** -0.5
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, scale, 1.5, True),
                     *map(jnp.asarray, arrs[:3]))
    grads_j = vjp(jnp.asarray(arrs[3]))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrs[:3]]
    flash_attention(*ins, scale, 1.5).backward(torch.from_numpy(arrs[3]))
    for t, gj in zip(ins, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj), rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh, T, H", [(64, 70, 3), (80, 130, 2)])
def test_long_route_plain_version_matches_fwd_flash(dtype, Dh, T, H):
    """The natural-layout function that ``attention_core`` routes long
    sequences to: its plain version against ``_fwd_flash`` (head split, then
    the flash kernel in interpret mode) and against ``_fwd_xla``."""
    B = 2
    qkv_j, qkv_t = _pair(np.random.default_rng(T).standard_normal(
        (B, T, 3 * H * Dh)).astype(np.float32), dtype)
    scale = Dh ** -0.5
    out_t = attention_core(qkv_t, H, scale, 1.0)
    assert out_t.shape == (B, T, H * Dh)
    _close(out_t, _fwd_flash(qkv_j, H, scale, 1.0, True), dtype)
    _close(out_t, _fwd_xla(qkv_j, H, scale, 1.0), dtype)
    torch.testing.assert_close(
        out_t, attention_qkv_fused_ref(qkv_t, H, scale, 1.0), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [130, 257])
def test_rowtile_route_matches_jax(dtype, T):
    """The row-tiled variant (H=8, head width 80; T=130 leaves 2 rows and
    T=257 one row past the last full 128-row tile)."""
    B, H, Dh = 1, 8, 80
    qkv_j, qkv_t = _pair(np.random.default_rng(T).standard_normal(
        (B, T, 3 * H * Dh)).astype(np.float32), dtype)
    scale = Dh ** -0.5
    out_j = _fwd_head_group_rowtile(qkv_j, H, scale, 1.5, True)
    out_t = attention_core(qkv_t, H, scale, 1.5, variant="rowtile")
    _close(out_t, out_j, dtype)


@pytest.mark.parametrize("T, Dh, H, variant, route", [
    (197, 64, 12, None, "core"),
    (257, 80, 16, None, "core"),
    (257, 80, 16, "rowtile", "flash"),
    (197, 64, 12, "rowtile", "core"),  # the knob is ignored at ViT-B
    (257, 80, 12, "rowtile", "core"),  # heads no multiple of 8: ignored
    (785, 64, 12, None, "flash"),
    (1025, 80, 16, None, "flash"),
    (1025, 80, 16, "rowtile", "flash"),
    (CORE_MAX_T, 80, 16, None, "core"),
    (CORE_MAX_T + 1, 64, 12, None, "flash"),
    (4097, 64, 12, None, "flash"),  # no T falls back
    # head width 128 (DINOv3): F at every T, B is not built for it
    (789, 128, 32, None, "flash"), (201, 128, 32, None, "flash"),
    (5, 128, 1, "rowtile", "flash"),
])
def test_attn_route(T, Dh, H, variant, route):
    assert attn_route(T, Dh, H, variant) == route


def test_variant_is_read_from_the_environment_per_call(monkeypatch):
    """``variant=None`` reads EP_TPU_ATTN_VARIANT on every call; on CPU
    tensors either route is the one plain version, and no kernel is counted."""
    qkv = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 9, 3 * 8 * 80)).astype(np.float32))
    reset_launches()
    plain = attention_core(qkv, 8, 0.1)
    monkeypatch.setenv("EP_TPU_ATTN_VARIANT", "rowtile")
    torch.testing.assert_close(attention_core(qkv, 8, 0.1), plain, rtol=0, atol=0)
    assert not any(LAUNCHES.values())


def test_attn_flash_takes_cuda_tensors_only():
    """The kernel's wrapper never runs a plain version: a CPU tensor is
    refused before any launch."""
    with pytest.raises(ValueError, match="CUDA"):
        attn_flash(torch.zeros(1, 5, 3 * 64, dtype=torch.bfloat16), 1, 0.125)


def test_long_sequence_backward_differentiates_on_cpu():
    """Past kernel E's limit the backward is the tiled plain version on every
    device, held to the JAX package's ``_bwd_xla``, which takes that case on
    the TPU; on the card kernel E's own entry refuses it."""
    rng = np.random.default_rng(1)
    T, H, Dh = BWD_MAX_T[64] + 1, 2, 64
    qkv = rng.standard_normal((1, T, 3 * H * Dh)).astype(np.float32)
    g = rng.standard_normal((1, T, H * Dh)).astype(np.float32)
    assert bwd_route(T, Dh) == "long"
    x = torch.from_numpy(qkv).requires_grad_(True)
    attention_qkv_fused(x, H, Dh ** -0.5).backward(torch.from_numpy(g))
    ref = _bwd_xla(jnp.asarray(qkv), jnp.asarray(g), H, Dh ** -0.5, 1.0)
    _close(x.grad, ref, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T, Dh, temperature", [
    (385, 64, 1.0), (385, 64, 1.5), (1025, 80, 1.0), (1025, 80, 1.5),
    (321, 80, 1.0), (200, 64, 1.0)])
def test_attention_bwd_long_matches_bwd_xla(dtype, T, Dh, temperature):
    """``attention_qkv_fused_bwd_long`` against ``_bwd_xla`` with the same
    cast points (f32 at 1e-5; bf16 within two bf16 steps), T past E's limits
    at both head widths and one inside (the function takes any T), 128 query
    rows a tile (T=1025: a last tile of one row)."""
    rng = np.random.default_rng(T + Dh)
    H = 2
    (qkv_j, qkv_t), (g_j, g_t) = (
        _pair(rng.standard_normal(shape).astype(np.float32), dtype)
        for shape in ((1, T, 3 * H * Dh), (1, T, H * Dh)))
    out = attention_qkv_fused_bwd_long(qkv_t, g_t, H, Dh ** -0.5, temperature)
    assert out.dtype == qkv_t.dtype
    _close(out, _bwd_xla(qkv_j, g_j, H, Dh ** -0.5, temperature), dtype)


@pytest.mark.parametrize("T, Dh, route", [
    (384, 64, "core"), (385, 64, "long"), (320, 80, "core"), (321, 80, "long"),
    (1025, 80, "long"), (5, 32, "long"), (385, 32, "long"), (5, 128, "long"),
    (789, 128, "long")])
def test_bwd_route(T, Dh, route):
    """Kernel E up to its limit at the head widths it is built for (64,
    80); every other width takes the tiled backward at every T, where E
    would raise on the card."""
    assert bwd_route(T, Dh) == route


def test_supercell_backward_at_long_t_takes_the_long_route():
    """The supercell's backward recomputes at T=1025 and takes the tiled
    backward: on the CPU its gradients equal the plain chain's autograd."""
    rng = np.random.default_rng(2)
    T, D, H = 1025, 128, 2
    x = torch.from_numpy(rng.standard_normal((1, T, D)).astype(np.float32))
    w = [torch.from_numpy((rng.standard_normal(s) * 0.05).astype(np.float32))
         for s in ((3 * D, D), (3 * D,), (D,), (D,), (D, D), (D,))]
    w[2] = w[2] + 1.0
    args = (H, (D // H) ** -0.5, 1.0, 1e-6)
    a = [t.clone().requires_grad_(True) for t in [x] + w]
    attn_supercell(*a, *args).sum().backward()
    b = [t.clone().requires_grad_(True) for t in [x] + w]
    attn_supercell_ref(*b, *args).sum().backward()
    for ta, tb in zip(a, b):
        torch.testing.assert_close(ta.grad, tb.grad, rtol=1e-4, atol=1e-5)


# --- a whole model at another image size -----------------------------------------

PATCH, B = 16, 4


def _cfg(img, amp):
    return TrainConfig(model="vit_tiny_patch16", cls_features="ep",
                       ep_queries=4, d_out=1, nb_classes=5, image_size=img,
                       amp=amp, batch_size=B, eff_batch_size=B)


def _models(built, amp, dtype):
    cfg = _cfg(built, amp)
    fm = FlaxProbeModel(FlaxViTConfig(
        img_size=built, patch_size=PATCH, embed_dim=64, depth=2, num_heads=2,
        dtype=DT[dtype][0], attn_impl="pallas"), cfg)
    variables = fm.init(jax.random.key(0), jnp.zeros((2, built, built, 3)),
                        train=True)
    pcfg = PortTrainConfig(**dataclasses.asdict(cfg))
    bcfg = build_backbone_config(pcfg).replace(embed_dim=64, depth=2,
                                               num_heads=2)
    tm = ProbeModel(bcfg, pcfg)
    params, buffers = flax_to_torch(
        jax.tree_util.tree_map(np.asarray, variables), device="cpu")
    tm.load_state_dict({**params, **buffers}, strict=True)
    return fm, variables, tm, bcfg


@pytest.mark.parametrize("built, fed, dtype", [
    (32, 64, "float32"),   # grid 2 -> 4: the interpolation grows
    (64, 32, "float32"),   # grid 4 -> 2: it shrinks, antialiased
    (32, 64, "bfloat16"),
    (64, 64, "float32"),   # a model built at the larger size interpolates nothing
])
def test_probe_model_at_another_image_size_matches_flax(monkeypatch, built,
                                                        fed, dtype):
    monkeypatch.setenv("EP_TPU_PALLAS_INTERPRET", "1")
    amp = "bfloat16" if dtype == "bfloat16" else "float32"
    fm, variables, tm, bcfg = _models(built, amp, dtype)
    assert bcfg.num_patches == (built // PATCH) ** 2
    assert tm.backbone.pos_embed.shape == (1, 1 + bcfg.num_patches, 64)
    x = np.random.default_rng(5).standard_normal((B, fed, fed, 3)).astype(
        np.float32)
    out_j = fm.apply(variables, jnp.asarray(x), train=False)
    tm.eval()
    out_t = tm(torch.from_numpy(x))
    a, b = out_t.detach().numpy(), np.asarray(out_j)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=3e-2 * np.abs(b).max())
    if built != fed:  # the position embedding mattered
        with torch.no_grad():
            tm.backbone.pos_embed.zero_()
        moved = (tm(torch.from_numpy(x)) - out_t).detach().abs().max()
        assert float(moved) > 1e-4


def test_backbone_config_at_448_px():
    """``image_size`` reaches the backbone and the head: ViT-H/14 at 448 px
    has a 32 x 32 grid, 1024 patches, and a (1, 1025, D) position embedding
    of its own."""
    cfg = PortTrainConfig(model="vit_huge_patch14", image_size=448,
                          cls_features="ep", ep_queries=32, amp="bfloat16")
    bcfg = build_backbone_config(cfg)
    assert (bcfg.img_size, bcfg.patch_size, bcfg.grid_size) == (448, 14, 32)
    assert bcfg.num_patches == 1024 and bcfg.embed_dim == 1280
    assert bcfg.num_heads == 16 and bcfg.depth == 32
    small = bcfg.replace(embed_dim=64, depth=1, num_heads=2)
    model = ProbeModel(small, dataclasses.replace(cfg, ep_queries=4))
    assert model.backbone.pos_embed.shape == (1, 1025, 64)
    assert attn_route(1025, 80, 16) == "flash"
