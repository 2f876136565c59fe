"""The int8 MLP half (``--int8_mlp``): ep_tpu's Pallas kernels in interpret
mode against ep_tpu_torch's plain versions, on the CPU.

Small sizes: D=64, DH=256, T odd, 2 blocks. Inputs come from a numpy seed and
go through both packages.

What it took to agree. The kernels compute the tanh-GELU on a bf16 array, and
JAX rounds to bf16 after every elementary operation with bf16 constants;
``F.gelu`` on bf16 rounds once, which moves single int8 codes, so the port's
plain version (``gelu_tanh_bf16``) follows the JAX order of operations. XLA
on the CPU, with its default ``xla_allow_excess_precision``, drops the
kernel's last rounding of the GELU output to bf16 (the cast back to f32 that
follows cancels it), which a compiled kernel does not do. So the JAX side is
compiled here with that option off (``_strict``), and then the two packages
agree to the last bits:

* f32 inputs: 1e-5 absolute and relative (measured 5e-7: the f32 LN
  statistics and the final sums run in another order);
* bf16 inputs: one bf16 step, 2**-7 relative (measured: equal);
* against XLA's default compilation the gap is the dropped rounding:
  5e-3 mean relative (measured 3.6e-3), ten times tighter than the 5e-2 that
  ``tests/test_ops.py`` allows between the int8 and the bf16 half.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ep_tpu.configs import TrainConfig as FlaxTrainConfig
from ep_tpu.models.assembly import ProbeModel as FlaxProbeModel
from ep_tpu.models.vit import (ViTConfig as FlaxViTConfig,
                               VisionTransformer as FlaxViT)
from ep_tpu.ops import mlp_int8_pallas as jx
from ep_tpu_torch.configs import TrainConfig
from ep_tpu_torch.convert.from_flax import flax_to_torch
from ep_tpu_torch.models.assembly import ProbeModel, build_backbone_config
from ep_tpu_torch.models.vit import (ViTConfig, VisionTransformer,
                                     int8_mlp_inactive_reason)
from ep_tpu_torch.ops import mlp_int8 as pt

B, T, D, DH = 2, 9, 64, 256
EPS = 1e-6
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ONE_BF16_STEP = 2.0 ** -7


def _strict(fn, *args):
    """``fn(*args)`` compiled without XLA's excess precision, so that every
    cast to bf16 the kernel asks for is a rounding."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _inputs(seed=0, zero_row=False):
    """x, then w1 (D,DH), b1, w2 (DH,D), b2, gamma, beta in the flax layout."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    x = f32(rng.standard_normal((B, T, D)))
    if zero_row:
        x[0, 3] = 0.0
    return (x, f32(rng.standard_normal((D, DH)) * 0.1),
            f32(rng.standard_normal(DH) * 0.05),
            f32(rng.standard_normal((DH, D)) * 0.1),
            f32(rng.standard_normal(D) * 0.05),
            f32(1 + 0.1 * rng.standard_normal(D)),
            f32(0.1 * rng.standard_normal(D)))


def _jax_args(arrs, dtype):
    return (jnp.asarray(arrs[0]).astype(DT[dtype][0]),
            *(jnp.asarray(a) for a in arrs[1:]))


def _torch_args(arrs, dtype):
    """The same arrays as tensors, weights in the ``nn.Linear`` layout."""
    x, w1, b1, w2, b2, g, be = (torch.from_numpy(a.copy()) for a in arrs)
    return (x.to(DT[dtype][1]), w1.t().contiguous(), b1, w2.t().contiguous(),
            b2, g, be)


def _assert_close(out_t, out_j, dtype):
    a = out_t.detach().float().numpy()
    b = np.asarray(out_j.astype(jnp.float32))
    assert a.shape == b.shape
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(a, b, rtol=ONE_BF16_STEP, atol=1e-6)


def test_quantize_weight_matches_jax():
    w = _inputs()[1]
    wq_j, s_j = jx.quantize_weight(jnp.asarray(w))
    wq_t, s_t = pt.quantize_weight(torch.from_numpy(w).t().contiguous())
    assert wq_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j).T)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j)[0], rtol=1e-7,
                               atol=0)
    # an all-zero channel keeps the floor as its scale and zero codes
    w0 = torch.from_numpy(w).t().contiguous()
    w0[5] = 0.0
    wq0, s0 = pt.quantize_weight(w0)
    assert float(s0[5]) == pytest.approx(1e-8) and not wq0[5].any()
    assert int(wq_t.abs().max()) == 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tier, stripes", [
    ("resident", 1), ("resident", 2), ("two_kernel", 2)])
def test_mlp_int8_ref_matches_pallas_interpret(dtype, tier, stripes):
    arrs = _inputs(zero_row=True)
    if tier == "resident":
        fn = lambda *a: jx.mlp_int8_fused(*a, EPS, True, stripes)  # noqa: E731
    else:
        fn = lambda *a: jx._fwd_two_kernel(*a, EPS, True, stripes)  # noqa: E731
    jargs = _jax_args(arrs, dtype)
    out_t = pt.mlp_int8_ref(*_torch_args(arrs, dtype), EPS, stripes, tier)
    assert out_t.dtype == DT[dtype][1]
    _assert_close(out_t, _strict(fn, *jargs), dtype)
    if stripes != 1:
        return
    # XLA's default compilation drops the GELU's last rounding to bf16
    loose = np.asarray(fn(*jargs).astype(jnp.float32))
    gap = np.abs(out_t.float().numpy() - loose).mean() / np.abs(loose).mean()
    assert gap < 5e-3, gap


def test_int8_codes_match_the_fc1_kernel():
    """aq and sa, the tensors that pass between the two halves, against
    ``_kernel_fc1`` run on its own: equal codes, scales at 1e-6."""
    import functools
    from jax.experimental import pallas as pl
    arrs = _inputs(seed=1)
    x, w1, b1, _, _, g, be = _jax_args(arrs, "float32")
    S = 2
    w1q, s1 = jx.quantize_weight(w1)

    def fc1(x, w1q, s1, b1, g, be):
        full = lambda shape: pl.BlockSpec(shape, lambda b: (0,) * len(shape))  # noqa: E731
        row = lambda n: pl.BlockSpec((1, T, n), lambda b: (b, 0, 0))  # noqa: E731
        return pl.pallas_call(
            functools.partial(jx._kernel_fc1, eps=EPS, nstripes=S), grid=(B,),
            in_specs=[row(D), full((D, DH)), full((1, DH)), full((1, DH)),
                      full((1, D)), full((1, D))],
            out_specs=[row(DH), row(S)],
            out_shape=[jax.ShapeDtypeStruct((B, T, DH), jnp.int8),
                       jax.ShapeDtypeStruct((B, T, S), jnp.float32)],
            interpret=True)(x, w1q, s1, b1.reshape(1, DH), g.reshape(1, D),
                            be.reshape(1, D))

    aq_j, sa_j = _strict(fc1, x, w1q, s1, b1, g, be)
    xt, w1t, b1t, _, _, gt, bet = _torch_args(arrs, "float32")
    aq_t, sa_t = pt.fc1_ref(*pt.ln_quant_ref(xt, gt, bet, EPS),
                            *pt.quantize_weight(w1t), b1t, S)
    assert aq_t.dtype == torch.int8 and aq_t.shape == (B, T, DH)
    np.testing.assert_array_equal(aq_t.numpy(), np.asarray(aq_j))
    np.testing.assert_allclose(sa_t.numpy(), np.asarray(sa_j), rtol=1e-6)


def _fc2_pallas(aq, sa, x, w2q, s2, b2, stripes):
    """``_kernel_fc2``, the two-kernel tier's second kernel, run on its own in
    interpret mode on the given codes and scales."""
    import functools
    from jax.experimental import pallas as pl
    full = lambda shape: pl.BlockSpec(shape, lambda b: (0,) * len(shape))  # noqa: E731
    row = lambda n: pl.BlockSpec((1, T, n), lambda b: (b, 0, 0))  # noqa: E731
    return pl.pallas_call(
        functools.partial(jx._kernel_fc2, nstripes=stripes), grid=(B,),
        in_specs=[row(DH), row(stripes), row(D), full((DH, D)), full((1, D)),
                  full((1, D))],
        out_specs=row(D), out_shape=jax.ShapeDtypeStruct((B, T, D), x.dtype),
        interpret=True)(aq, sa, x, w2q, s2, b2)


def _fc2_inputs(seed, stripes, exact):
    """Random int8 codes aq, scales sa and s2, f32 x and b2. With ``exact``
    every scale is a power of two, so each stripe's dequantised sum and
    their total are exact in f32 and the bias and residual are the only
    additions that round."""
    rng = np.random.default_rng(seed)
    aq = rng.integers(-127, 128, (B, T, DH), dtype=np.int8)
    w2q = rng.integers(-127, 128, (DH, D), dtype=np.int8)  # the flax layout
    if exact:
        sa = 2.0 ** rng.integers(-12, -6, (B, T, stripes))
        s2 = 2.0 ** rng.integers(-9, -5, (1, D))
    else:
        sa = np.abs(rng.standard_normal((B, T, stripes))) * 0.01 + 1e-3
        s2 = np.abs(rng.standard_normal((1, D))) * 0.002 + 1e-4
    x = rng.standard_normal((B, T, D))
    b2 = rng.standard_normal((1, D)) * 0.5
    return aq, sa.astype(np.float32), x.astype(np.float32), w2q, \
        s2.astype(np.float32), b2.astype(np.float32)


def _fc2_port(arrs, stripes, tier):
    aq, sa, x, w2q, s2, b2 = (torch.from_numpy(a) for a in arrs)
    return pt.fc2_ref(aq, sa, x, w2q.t().contiguous(), s2[0], b2[0], stripes,
                      tier).numpy()


@pytest.mark.parametrize("stripes", [1, 2])
def test_fc2_bias_order_is_the_two_kernel_tiers(stripes):
    """``fc2_ref`` at the two-kernel tier against ``_kernel_fc2`` in interpret
    mode on the same codes and scales, in f32: ``(x + y) + b2``. With scales
    that are powers of two the products are exact and the two agree bit for
    bit, where the resident order ``x + (y + b2)`` differs. With other scales
    XLA on the CPU contracts ``x + acc * scale`` into one fused multiply-add,
    which rounds once where the port (and its kernel) round twice: the gap
    measured at most 1.7 * 2**-23 of |x| + |out| + |b2| elementwise (16
    draws), held here to 2**-21 of it."""
    arrs = _fc2_inputs(3, stripes, exact=True)
    out_j = np.asarray(_strict(lambda *a: _fc2_pallas(*a, stripes),
                               *(jnp.asarray(a) for a in arrs)))
    np.testing.assert_array_equal(_fc2_port(arrs, stripes, "two_kernel"), out_j)
    assert (_fc2_port(arrs, stripes, "resident") != out_j).sum() > 10
    arrs = _fc2_inputs(4, stripes, exact=False)
    out_j = np.asarray(_strict(lambda *a: _fc2_pallas(*a, stripes),
                               *(jnp.asarray(a) for a in arrs)))
    gap = np.abs(_fc2_port(arrs, stripes, "two_kernel") - out_j)
    assert (gap <= 2.0 ** -21 * (np.abs(arrs[2]) + np.abs(out_j)
                                 + np.abs(arrs[5]))).all()


@pytest.mark.parametrize("stripes", [1, 2])
def test_fc2_bias_order_is_the_resident_tiers(stripes):
    """The resident counterpart: the whole ``_kernel`` in interpret mode
    against the port's plain chain at the resident tier, f32, on inputs that
    make the scales of the second product powers of two (a hidden column at
    the head of each stripe with zero weights and bias 127/16, whose GELU is
    itself and the stripe's largest, so sa = 2**-4; a hidden row of W2 at
    127/128, each output channel's largest, so s2 = 2**-7). Then only the
    bias and the residual round and ``x + (y + b2)`` agrees bit for bit, where
    the two-kernel order differs."""
    x, w1, b1, w2, b2, g, be = _inputs(seed=1)
    heads = np.arange(stripes) * (DH // stripes)
    w1[:, heads] = 0.0
    b1[heads] = 127.0 / 16
    w2[0, :] = 127.0 / 128
    b2 = (b2 * 10).astype(np.float32)
    arrs = (x, w1, b1, w2, b2, g, be)
    out_j = np.asarray(_strict(
        lambda *a: jx.mlp_int8_fused(*a, EPS, True, stripes),
        *_jax_args(arrs, "float32")))
    targs = _torch_args(arrs, "float32")
    hq, sx = pt.ln_quant_ref(targs[0], targs[5], targs[6], EPS)
    _, sa = pt.fc1_ref(hq, sx, *pt.quantize_weight(targs[1]), targs[2], stripes)
    assert bool((sa == 2.0 ** -4).all())
    assert bool((pt.quantize_weight(targs[3])[1] == 2.0 ** -7).all())
    out = pt.mlp_int8_ref(*targs, EPS, stripes, "resident").numpy()
    np.testing.assert_array_equal(out, out_j)
    other = pt.mlp_int8_ref(*targs, EPS, stripes, "two_kernel").numpy()
    assert (other != out_j).sum() > 10


def test_fc2_takes_the_two_tiers_only():
    arrs = [torch.from_numpy(a) for a in _fc2_inputs(5, 1, exact=True)]
    aq, sa, x, w2q, s2, b2 = arrs
    args = (aq, sa, x, w2q.t().contiguous(), s2[0], b2[0], 1)
    for tier in pt.TIERS:
        assert pt.fc2(*args, tier=tier).shape == x.shape
    with pytest.raises(ValueError, match="tier"):
        pt.fc2(*args, tier="fallback")
    with pytest.raises(ValueError, match="tier"):
        pt.fc2_ref(*args, "striped")


def test_all_zero_token_row_stays_finite():
    arrs = list(_inputs())
    arrs[0][:] = 0.0  # every row: h = beta, and with beta = 0 the 1e-8 floor
    arrs[6][:] = 0.0
    for dtype in ("float32", "bfloat16"):
        targs = _torch_args(arrs, dtype)
        out = pt.mlp_int8_ref(*targs, EPS, 1)
        assert torch.isfinite(out).all()
        hq, sx = pt.ln_quant_ref(targs[0], targs[5], targs[6], EPS)
        assert not hq.any() and float(sx.max()) == pytest.approx(1e-8 / 127)
        _assert_close(out, _strict(
            lambda *a: jx.mlp_int8_fused(*a, EPS, True), *_jax_args(arrs, dtype)),
            dtype)


SHAPES = [(t, d, 4 * d) for t in (197, 257) for d in (768, 1024, 1280)] + [
    (1025, 1280, 5120), (1025, 768, 3072), (197, 1536, 6144),
    (257, 1664, 8192), (9, 64, 256), (197, 768, 3000)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_matches_jax(shape):
    assert pt.plan(*shape) == jx.plan(*shape)


def test_plan_at_the_published_shapes_and_fallback_raises():
    assert pt.plan(197, 768, 3072) == ("resident", 1)
    assert pt.plan(197, 1024, 4096) == ("resident", 8)
    assert pt.plan(257, 1280, 5120) == ("two_kernel", 8)
    fallbacks = [s for s in SHAPES if jx.plan(*s) == ("fallback",)]
    assert fallbacks
    t, d, dh = fallbacks[0]
    with pytest.raises(NotImplementedError, match="bf16 half"):
        pt.stripes_for(t, d, dh)
    with pytest.raises(NotImplementedError, match="bf16 half"):
        pt.mlp_int8_fused(torch.zeros(1, t, d), torch.zeros(dh, d),
                          torch.zeros(dh), torch.zeros(d, dh), torch.zeros(d),
                          torch.ones(d), torch.zeros(d))


def test_fused_takes_the_plans_stripes_and_the_plain_version_on_cpu():
    targs = _torch_args(_inputs(), "float32")
    assert pt.plan(T, D, DH) == ("resident", 1)
    torch.testing.assert_close(pt.mlp_int8_fused(*targs, EPS),
                               pt.mlp_int8_ref(*targs, EPS, 1), rtol=0, atol=0)


def test_gelu_tanh_bf16_rounds_like_jax():
    """Every normal bf16 value in [-20, 20]: the op-by-op bf16 GELU equals
    ``jax.nn.gelu`` on the bf16 array, apart from values where the two
    libraries' f32 tanh straddle a bf16 rounding boundary (measured: none)."""
    bits = torch.arange(0, 65536, dtype=torch.int32).to(torch.int16)
    a = bits.view(torch.bfloat16)
    mag = a.float().abs()
    a = a[torch.isfinite(mag) & (mag <= 20) & (mag >= 1e-30)]
    out_j = np.asarray(jax.nn.gelu(
        jnp.asarray(a.float().numpy()).astype(jnp.bfloat16),
        approximate=True).astype(jnp.float32))
    out_t = pt.gelu_tanh_bf16(a).float().numpy()
    assert (out_t != out_j).mean() < 1e-3
    np.testing.assert_allclose(out_t, out_j, rtol=ONE_BF16_STEP, atol=1e-30)
    with pytest.raises(TypeError):
        pt.gelu_tanh_bf16(a.float())


def test_backward_is_the_bf16_half():
    """Gradients of (out**2).sum() w.r.t. x, w1, w2 (and the rest) against
    jax.grad through the JAX package's custom VJP, f32 at 1e-5."""
    arrs = _inputs(seed=2)
    grads_j = _strict(jax.grad(
        lambda *a: (jx.mlp_int8_fused(*a, EPS, True) ** 2).sum(),
        argnums=tuple(range(7))), *_jax_args(arrs, "float32"))
    targs = [t.requires_grad_(True) for t in _torch_args(arrs, "float32")]
    (pt.mlp_int8_fused(*targs, EPS) ** 2).sum().backward()
    for i, (t, gj) in enumerate(zip(targs, grads_j)):
        gj = np.asarray(gj)
        if i in (1, 3):  # the port's weights are (out, in)
            gj = gj.T
        scale = max(1.0, float(np.abs(gj).max()))
        np.testing.assert_allclose(t.grad.numpy(), gj, rtol=1e-5,
                                   atol=1e-5 * scale)
    # only the gradients asked for are computed
    x = targs[0].detach().requires_grad_(True)
    frozen = [t.detach() for t in targs[1:]]
    (pt.mlp_int8_fused(x, *frozen, EPS) ** 2).sum().backward()
    torch.testing.assert_close(x.grad, targs[0].grad, rtol=1e-6, atol=1e-6)


def test_mlp_bf16_ref_matches_jax():
    arrs = _inputs(seed=3)
    for dtype in ("float32", "bfloat16"):
        out_j = jx._ref_forward(*_jax_args(arrs, dtype), EPS)
        out_t = pt.mlp_bf16_ref(*_torch_args(arrs, dtype), EPS)
        a, b = out_t.float().numpy(), np.asarray(out_j.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        else:  # products and the GELU round at other places in bf16
            np.testing.assert_allclose(a, b, rtol=0, atol=3e-2 * np.abs(b).max())


# --- the backbone and the ProbeModel with int8_mlp=True -----------------------

IMG = 32


def _assert_model_close(a, b, dtype, logits=False):
    """A whole model with int8 halves cannot be held to 1e-5 even in f32:
    the attention halves of the two packages differ in the last bits, and
    where that carries a value of LN2's output or of the GELU across a
    rounding boundary one int8 code moves by one, which shifts a token's
    outputs by a quantisation step (measured: 1.5% of the elements, up to
    2.4e-3 at outputs of magnitude 3). So in f32: at least 95% of the
    features within 1e-5 (not asked of logits: the EP pool and BN over 4
    images spread a moved code over every logit), every element within 1e-2
    of the largest magnitude, and a mean relative error under 1e-3 for
    features and 5e-3 for logits (measured 1.3e-5 and 1.0e-3), fifty and ten
    times tighter than the gap allowed between the int8 and the bf16 half. In
    bf16 the same 3e-2 of the largest magnitude as the bf16 model's parity
    test."""
    print(f"int8 model parity {dtype}: max|d| {np.abs(a - b).max():.3e}, "
          f"mean rel {np.abs(a - b).mean() / np.abs(b).mean():.3e}, within "
          f"1e-5: {np.isclose(a, b, rtol=1e-5, atol=1e-5).mean():.4f}")
    if dtype == "float32":
        assert logits or np.isclose(a, b, rtol=1e-5, atol=1e-5).mean() >= 0.95
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-2 * np.abs(b).max())
        assert np.abs(a - b).mean() / np.abs(b).mean() < (
            5e-3 if logits else 1e-3)
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=3e-2 * np.abs(b).max())


def _images(n=4, seed=0):
    return np.random.default_rng(seed).standard_normal((n, IMG, IMG, 3),
                                                       np.float32)


def _flax_vit_cfg(dtype, int8=True, **kw):
    return FlaxViTConfig(img_size=IMG, patch_size=8, embed_dim=64, depth=2,
                         num_heads=2, dtype=DT[dtype][0], attn_impl="pallas",
                         int8_mlp=int8, **kw)


def _port_vit_cfg(dtype, int8=True, **kw):
    return ViTConfig(img_size=IMG, patch_size=8, embed_dim=64, depth=2,
                     num_heads=2, dtype=DT[dtype][1], int8_mlp=int8, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backbone_int8_matches_flax(monkeypatch, dtype):
    monkeypatch.setenv("EP_TPU_PALLAS_INTERPRET", "1")
    fm = FlaxViT(_flax_vit_cfg(dtype))
    x = _images()
    variables = fm.init(jax.random.key(0), jnp.zeros((2, IMG, IMG, 3)), "pos")
    out_j = _strict(lambda v, a: fm.apply(v, a, "pos")[0], variables,
                    jnp.asarray(x))
    params, _ = flax_to_torch(
        {"params": {"backbone": jax.tree_util.tree_map(
            np.asarray, variables["params"])}}, device="cpu")
    state = {k.removeprefix("backbone."): v for k, v in params.items()}
    outs = {}
    for int8 in (True, False):
        tm = VisionTransformer(_port_vit_cfg(dtype, int8))
        tm.load_state_dict(state, strict=True)  # the same parameter tree
        with torch.no_grad():
            outs[int8] = tm(torch.from_numpy(x), "pos")
    a = outs[True].float().numpy()
    _assert_model_close(a, np.asarray(out_j.astype(jnp.float32)), dtype)
    # opt-in and approximate: the int8 features stay near the bf16 features
    ref = outs[False].float().numpy()
    assert np.abs(a - ref).mean() / np.abs(ref).mean() < 0.05
    assert not np.array_equal(a, ref)


@pytest.mark.parametrize("dtype, train", [
    ("float32", False), ("float32", True), ("bfloat16", False)])
def test_probe_model_int8_matches_flax(monkeypatch, dtype, train):
    monkeypatch.setenv("EP_TPU_PALLAS_INTERPRET", "1")
    kw = dict(model="vit_tiny_patch16", cls_features="ep", ep_queries=4,
              d_out=1, nb_classes=5, image_size=IMG, amp=dtype, batch_size=4,
              eff_batch_size=4, int8_mlp=True)
    cfg_j, cfg_t = FlaxTrainConfig(**kw), TrainConfig(**kw)
    fm = FlaxProbeModel(_flax_vit_cfg(dtype), cfg_j)
    x = _images()
    variables = fm.init(jax.random.key(0), jnp.zeros((2, IMG, IMG, 3)),
                        train=True)
    bcfg = build_backbone_config(cfg_t).replace(embed_dim=64, depth=2,
                                                num_heads=2, patch_size=8)
    assert bcfg.int8_mlp and int8_mlp_inactive_reason(bcfg) is None
    tm = ProbeModel(bcfg, cfg_t)
    params, buffers = flax_to_torch(
        jax.tree_util.tree_map(np.asarray, variables), device="cpu")
    tm.load_state_dict({**params, **buffers}, strict=True)
    tm.train(train)
    out_t = tm(torch.from_numpy(x))
    if train:
        out_j = _strict(lambda v, a: fm.apply(
            v, a, train=True, mutable=["batch_stats"])[0], variables,
            jnp.asarray(x))
    else:
        out_j = _strict(lambda v, a: fm.apply(v, a, train=False), variables,
                        jnp.asarray(x))
    a, b = out_t.detach().numpy(), np.asarray(out_j)
    assert a.dtype == np.float32 and a.shape == b.shape
    _assert_model_close(a, b, dtype, logits=True)


@pytest.mark.parametrize("policy", ["none", "attn_out", "attn_fc1", "dots"])
def test_int8_block_under_remat(policy):
    """The int8 branch sits inside the rematerialised block: every policy
    gives the gradients of the block without remat."""
    x = torch.from_numpy(_images(2, seed=4))
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        cfg = _port_vit_cfg("float32", scan_blocks=True, remat_blocks=remat,
                            remat_policy=policy)
        tm = VisionTransformer(cfg)
        (tm(x, "gap") ** 2).sum().backward()
        grads.append({k: p.grad for k, p in tm.named_parameters()})
    for k, gr in grads[0].items():
        torch.testing.assert_close(grads[1][k], gr, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("D, DH, stripes, tiling", [
    (768, 3072, 1, (128, 3, 8)), (1024, 4096, 8, (128, 2, 2)),
    (1280, 5120, 8, (160, 2, 2)), (128, 512, 1, (128, 2, 2)),
    (128, 512, 2, (128, 2, 1)), (128, 512, 4, (128, 1, 1)),
    (768, 3072, 8, (128, 3, 1)), (256, 1024, 1, (128, 2, 4)),
    (640, 2560, 1, (160, 2, 8)), (128, 896, 1, (128, 1, 7))])
def test_fc1_takes_the_plans_stripes(D, DH, stripes, tiling):
    """What kernel fc1 accepts after its redesign: a stripe that splits into
    at most 8 blocks of 384, 320, 256 or 128 columns, which covers
    every stripe count :func:`plan` gives at the published widths. The tiling
    is (tile width, tiles a block, blocks a cluster) and spans the stripe."""
    pt._check_shapes(D, DH, stripes)
    bn, tiles, cluster = pt.fc1_tiling(DH // stripes)
    assert (bn, tiles, cluster) == tiling
    assert bn * tiles * cluster == DH // stripes and cluster <= 8


@pytest.mark.parametrize("D, DH, stripes, check", [
    (768, 3072, 48, "shapes"), (192, 768, 1, "shapes"), (768, 3000, 1, "shapes"),
    (1024, 4096, 1, "tiling"), (1408, 1408, 1, "tiling"),
    (1280, 5120, 1, "tiling")])
def test_fc1_refuses_other_stripes(D, DH, stripes, check):
    """A K that is no multiple of 128 bytes or a stripe that is no multiple of
    128 columns fails the int8 kernels' common check; a stripe wider than 8
    blocks hold (4096 and 5120 columns in one stripe) or of 11 x 128 columns
    fails fc1's tiling. Both raise NotImplementedError."""
    with pytest.raises(NotImplementedError):
        if check == "shapes":
            pt._check_shapes(D, DH, stripes)
        else:
            pt._check_shapes(D, DH, stripes)
            pt.fc1_tiling(DH // stripes)


@pytest.mark.parametrize("D", [128, 384, 768, 1024, 1280, 1408, 2048, 2176,
                               8192, pt.LN_QUANT_MAX_D])
def test_ln_quant_takes_every_width_of_128(D):
    """Kernel ln_quant holds a row in registers up to 2048 columns and stages
    a wider one in shared memory, up to half of a block's."""
    pt.check_ln_quant_width(D)


@pytest.mark.parametrize("D", [64, 200, 1000, pt.LN_QUANT_MAX_D + 128])
def test_ln_quant_refuses_other_widths(D):
    with pytest.raises(NotImplementedError, match="ln_quant"):
        pt.check_ln_quant_width(D)


def test_int8_mlp_inactive_reason():
    assert int8_mlp_inactive_reason(ViTConfig()) is None
    assert int8_mlp_inactive_reason(ViTConfig(int8_mlp=True)) is None
    assert "mlp_type" in int8_mlp_inactive_reason(
        ViTConfig(int8_mlp=True, mlp_type="swiglu"))
    fields = {f.name for f in dataclasses.fields(ViTConfig)}
    assert "int8_mlp" in fields
