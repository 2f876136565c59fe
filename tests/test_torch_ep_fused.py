"""The fused EP projection of ep_tpu_torch (``ep_pool_proj_attend``, the opt-in
route behind EP_TPU_EP_FUSED) against the JAX package, on the CPU: its plain
version and gradients against the Pallas kernel in interpret mode and the XLA
composition, the ``EfficientProbing`` module with the variable set on both
sides, weight conversion across the routes, and a 3-step probe trajectory of
a small long-sequence model with the fused route.

Inputs come from numpy seeds and go through both sides. Tolerances: float32
at 1e-5, the suite's parity bar (absolute floor 1e-6 for trained parameters
that pass near zero); bfloat16 within two bf16 steps (2**-7) of the output's
magnitude, since both sides round at the same points and differ in the order
of their f32 sums.
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
from ep_tpu.ops.pool_attn_pallas import (ep_pool_proj_attend as jax_proj,
                                         ep_pool_proj_attend_xla)
from ep_tpu.parallel import mesh as M
from ep_tpu.poolings.ep import EfficientProbing as FlaxEP
from ep_tpu.train import lars as jax_lars
from ep_tpu.train import schedule as jax_schedule
from ep_tpu.train import steps as jax_steps
from ep_tpu.train.state import create_train_state
from ep_tpu_torch.configs import TrainConfig as PortTrainConfig
from ep_tpu_torch.convert.from_flax import flax_to_torch
from ep_tpu_torch.models.assembly import ProbeModel, build_backbone_config
from ep_tpu_torch.ops import LAUNCHES, reset_launches
from ep_tpu_torch.ops.pool_attn import (ep_pool_attend_ref, ep_pool_proj_attend,
                                        ep_pool_proj_attend_ref)
from ep_tpu_torch.poolings.ep import EfficientProbing
from ep_tpu_torch.train import schedule
from ep_tpu_torch.train.lars import LARS
from ep_tpu_torch.train.state import freeze
from ep_tpu_torch.train.steps import make_train_step

F32_TOL = 1e-5
BF16_RTOL = 2.0 ** -7
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(dtype, seed, B=3, N=37, C=128, Q=4, d_out=1):
    """q_scaled (Q,C), tokens (B,N,C), w in the flax layout (C, QC), as numpy
    and as (jax, torch) pairs; torch's w is nn.Linear's (QC, C)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Q, C)).astype(np.float32) * C ** -0.5
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    w = rng.standard_normal((C, C // d_out)).astype(np.float32) * C ** -0.5
    jd, td = DT[dtype]
    jax_side = [jnp.asarray(a, jd) for a in (q, x, w)]
    torch_side = [torch.from_numpy(a).to(td) for a in (q, x, w.T.copy())]
    return jax_side, torch_side


def _close(out_t, out_j, dtype):
    a = out_t.detach().float().numpy()
    b = np.asarray(jnp.asarray(out_j, jnp.float32))
    assert a.shape == b.shape
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_allclose(a, b, rtol=BF16_RTOL,
                                   atol=BF16_RTOL * float(np.abs(b).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    dict(),                              # unaligned N and B
    dict(B=8, N=17, d_out=2),            # QC = C / 2
    dict(B=2, N=70, C=64, Q=8),          # N past one 64-token tile
])
def test_ep_pool_proj_attend_matches_jax(dtype, shape):
    (q_j, x_j, w_j), (q_t, x_t, w_t) = _inputs(dtype, 11, **shape)
    out_t = ep_pool_proj_attend(q_t, x_t, w_t)
    Q = q_t.shape[0]
    assert out_t.shape == (x_t.shape[0], Q, w_t.shape[0] // Q)
    assert out_t.dtype == DT[dtype][1]
    _close(out_t, jax_proj(q_j, x_j, w_j, True), dtype)
    _close(out_t, ep_pool_proj_attend_xla(q_j, x_j, w_j), dtype)
    torch.testing.assert_close(out_t, ep_pool_proj_attend_ref(q_t, x_t, w_t),
                               rtol=0, atol=0)


def test_ep_pool_proj_plain_is_projection_then_pool():
    """v = x @ W^T in the tokens' dtype, then the plain pool of kernel D."""
    _, (q, x, w) = _inputs("bfloat16", 12)
    v = (x.float() @ w.float().t()).to(x.dtype)
    ref = ep_pool_attend_ref(q, x, v.reshape(3, 37, 4, 32))
    torch.testing.assert_close(ep_pool_proj_attend_ref(q, x, w), ref,
                               rtol=BF16_RTOL, atol=BF16_RTOL)


def test_ep_pool_proj_attend_gradients_match_jax_vjp():
    """Gradients of all three inputs against the kernel's custom VJP
    (interpret mode) and against autograd of the XLA composition."""
    (q_j, x_j, w_j), (q_t, x_t, w_t) = _inputs("float32", 13, B=2, N=17, C=64)
    g = np.random.default_rng(14).standard_normal((2, 4, 16)).astype(np.float32)
    ins = [t.clone().requires_grad_(True) for t in (q_t, x_t, w_t)]
    ep_pool_proj_attend(*ins).backward(torch.from_numpy(g))
    for fn in (lambda q, x, w: jax_proj(q, x, w, True), ep_pool_proj_attend_xla):
        _, vjp = jax.vjp(fn, q_j, x_j, w_j)
        gq, gx, gw = vjp(jnp.asarray(g))
        for t, gj in zip(ins, (gq, gx, gw.T)):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj),
                                       rtol=F32_TOL, atol=F32_TOL)


def test_master_weight_gets_a_gradient_of_its_own_dtype():
    """The head keeps W in f32 while the tokens are bf16 (probing in bf16):
    the plain version casts inside, and W's gradient comes back in f32."""
    _, (q, x, w) = _inputs("bfloat16", 15)
    w32 = w.float().requires_grad_(True)
    out = ep_pool_proj_attend(q, x, w32)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert w32.grad.dtype == torch.float32 and torch.isfinite(w32.grad).all()


# --- the module ------------------------------------------------------------------

def _ep_modules(dtype, C=128, Q=4, d_out=1, qkv_bias=False):
    flax_mod = FlaxEP(dim=C, num_queries=Q, d_out=d_out, qkv_bias=qkv_bias,
                      dtype=DT[dtype][0], use_pallas=True)
    x = np.random.default_rng(16).standard_normal((5, 37, C)).astype(np.float32)
    params = flax_mod.init(jax.random.key(0), jnp.asarray(x))
    mod = EfficientProbing(C, qkv_bias=qkv_bias, num_queries=Q, d_out=d_out,
                           dtype=DT[dtype][1])
    state, _ = flax_to_torch(jax.tree_util.tree_map(np.asarray, params),
                             device="cpu")
    mod.load_state_dict(state, strict=True)
    return flax_mod, params, mod, x


@pytest.mark.parametrize("dtype, d_out", [("float32", 1), ("bfloat16", 1),
                                          ("float32", 2)])
def test_ep_module_fused_route_matches_flax(monkeypatch, dtype, d_out):
    """EfficientProbing with EP_TPU_EP_FUSED=1 on both sides (the flax module
    takes its fused kernel in interpret mode), same weights through
    ``flax_to_torch``; and the fused route equals the unfused one, whose
    parameters it shares."""
    flax_mod, params, mod, x = _ep_modules(dtype, d_out=d_out)
    xt = torch.from_numpy(x).to(DT[dtype][1])
    unfused = mod(xt)
    monkeypatch.setenv("EP_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("EP_TPU_EP_FUSED", "1")
    calls = []
    mod.v.register_forward_hook(lambda *_: calls.append(1))
    out_t = mod(xt)
    out_j = flax_mod.apply(params, jnp.asarray(x, DT[dtype][0]))
    assert not calls, "the fused route must not call self.v"
    assert out_t.shape == (5, 128 // d_out)
    _close(out_t, out_j, dtype)
    _close(out_t, unfused.detach().float().numpy(), dtype)
    assert set(mod.state_dict()) == {"cls_token", "v.weight"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ep_module_fused_route_at_d_out_2_matches_flax(monkeypatch, dtype):
    """``--d_out 2`` at ViT-B's width with 32 queries: cq = 12, a width kernel
    G takes like any other. EfficientProbing with EP_TPU_EP_FUSED=1 on both
    sides (the flax module's fused kernel in interpret mode), the same weights
    through ``flax_to_torch``."""
    flax_mod, params, mod, x = _ep_modules(dtype, C=768, Q=32, d_out=2)
    assert mod.cq == 12
    xt = torch.from_numpy(x).to(DT[dtype][1])
    monkeypatch.setenv("EP_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("EP_TPU_EP_FUSED", "1")
    out_t = mod(xt)
    out_j = flax_mod.apply(params, jnp.asarray(x, DT[dtype][0]))
    assert out_t.shape == (5, 384)
    _close(out_t, out_j, dtype)


@pytest.mark.parametrize("dtype, fused", [("float32", False),
                                          ("bfloat16", False),
                                          ("float32", True)])
def test_ep_module_at_128_queries_matches_flax(monkeypatch, dtype, fused):
    """``--ep_queries 128`` at ViT-B's width (cq = 6): past the 64 queries one
    launch of kernel D or G takes, the port runs groups of 64 on the card;
    the module on the CPU (the plain versions) against the flax module (its
    kernels in interpret mode), on both routes, with the same weights."""
    flax_mod, params, mod, x = _ep_modules(dtype, C=768, Q=128)
    assert mod.cq == 6
    monkeypatch.setenv("EP_TPU_PALLAS_INTERPRET", "1")
    if fused:
        monkeypatch.setenv("EP_TPU_EP_FUSED", "1")
    out_t = mod(torch.from_numpy(x).to(DT[dtype][1]))
    out_j = flax_mod.apply(params, jnp.asarray(x, DT[dtype][0]))
    assert out_t.shape == (5, 768)
    _close(out_t, out_j, dtype)


def test_fused_route_with_bias_raises(monkeypatch):
    """The fused kernel has no bias. The JAX package prints a line and runs
    the unfused route; the port raises."""
    _, _, mod, x = _ep_modules("float32", qkv_bias=True)
    xt = torch.from_numpy(x)
    assert mod(xt).shape == (5, 128)  # unfused: fine
    monkeypatch.setenv("EP_TPU_EP_FUSED", "1")
    with pytest.raises(ValueError, match="qkv_bias=True"):
        mod(xt)


def test_fused_route_is_read_per_call_and_counts_no_kernel_on_cpu(monkeypatch):
    _, _, mod, x = _ep_modules("float32")
    xt = torch.from_numpy(x)
    reset_launches()
    monkeypatch.setenv("EP_TPU_EP_FUSED", "1")
    a = mod(xt)
    monkeypatch.delenv("EP_TPU_EP_FUSED")
    b = mod(xt)
    torch.testing.assert_close(a, b, rtol=F32_TOL, atol=F32_TOL)
    assert not any(LAUNCHES.values())


# --- a whole model: conversion and a trajectory ---------------------------------------

IMG, PATCH, B, C, STEPS_PER_EPOCH = 64, 8, 16, 5, 2  # 8 x 8 patches, T = 65


def _cfg(img=IMG):
    return TrainConfig(model="vit_tiny_patch16", cls_features="ep",
                       ep_queries=4, d_out=1, nb_classes=C, image_size=img,
                       amp="float32", batch_size=B, eff_batch_size=B,
                       epochs=4, warmup_epochs=1, lr=2.0, min_lr=0.0)


def _flax_model(cfg, img=IMG):
    fcfg = FlaxViTConfig(img_size=img, patch_size=PATCH, embed_dim=64, depth=2,
                         num_heads=2, dtype=jnp.float32, attn_impl="xla")
    fm = FlaxProbeModel(fcfg, cfg)
    variables = fm.init(jax.random.key(0), jnp.zeros((2, img, img, 3)),
                        train=True)
    return fm, jax.tree_util.tree_map(np.asarray, variables)


def _port_model(cfg, variables):
    pcfg = PortTrainConfig(**dataclasses.asdict(cfg))
    bcfg = build_backbone_config(pcfg).replace(embed_dim=64, depth=2,
                                               num_heads=2, patch_size=PATCH)
    model = ProbeModel(bcfg, pcfg)
    params, buffers = flax_to_torch(variables, device="cpu")
    model.load_state_dict({**params, **buffers}, strict=True)
    return model, pcfg


def _data(n_steps, img=IMG, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, size=(n_steps, B)).astype(np.int32)
    means = rng.standard_normal((C, 1, 1, 3)).astype(np.float32)
    imgs = means[labels] + 0.5 * rng.standard_normal(
        (n_steps, B, img, img, 3)).astype(np.float32)
    return imgs, labels


@pytest.mark.parametrize("fused", [False, True])
def test_conversion_at_another_image_size_and_route(monkeypatch, fused):
    """No new parameter exists: a model built at 32 px (a (1, 17, D)
    ``pos_embed``) converts, is fed 64 px images, and computes what the flax
    model computes, with the unfused and with the fused EP route."""
    monkeypatch.setenv("EP_TPU_PALLAS_INTERPRET", "1")
    if fused:
        monkeypatch.setenv("EP_TPU_EP_FUSED", "1")
    cfg = _cfg(32)
    fm, variables = _flax_model(cfg, 32)
    model, _ = _port_model(cfg, variables)
    assert model.backbone.pos_embed.shape == (1, 17, 64)
    assert model.head.pool.v.weight.shape == (64, 64)
    x = _data(1)[0][0][:4]
    out_j = fm.apply(variables, jnp.asarray(x), train=False)
    out_t = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=F32_TOL, atol=F32_TOL)


def test_fused_probe_trajectory_matches_jax(mesh8, monkeypatch):
    """Three LARS steps of probe training at T=65 with the fused EP route on
    both sides: losses, head parameters and BN statistics at 1e-5."""
    monkeypatch.setenv("EP_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("EP_TPU_EP_FUSED", "1")
    cfg = _cfg()
    fm, variables = _flax_model(cfg)
    imgs, labels = _data(3)

    tx = jax_lars.build_optimizer("lars", 0.0)
    state = create_train_state(variables, tx, finetuning=False)
    step = jax_steps.make_train_step(
        fm, tx, jax_schedule.make_lr_fn(cfg, STEPS_PER_EPOCH), mesh8)
    with M.use_mesh(mesh8):
        losses_j = []
        for i in range(3):
            state, m = step(state, M.shard_batch(imgs[i], mesh8),
                            M.shard_batch(labels[i], mesh8))
            losses_j.append(float(m["loss"]))
    head_j = jax.tree_util.tree_map(np.asarray, state.trainable["head"])
    bn_j = jax.tree_util.tree_map(np.asarray, state.batch_stats["head"]["bn"])

    model, pcfg = _port_model(cfg, variables)
    calls = []
    model.head.pool.v.register_forward_hook(lambda *_: calls.append(1))
    opt = LARS(freeze(model, cfg.finetuning), weight_decay=0.0)
    train_step = make_train_step(
        model, opt, schedule.make_lr_fn(pcfg, STEPS_PER_EPOCH))
    losses_t = [float(train_step(i, torch.from_numpy(imgs[i]),
                                 torch.from_numpy(labels[i]).long())["loss"])
                for i in range(3)]
    assert not calls, "the fused route must not call the value projection"

    np.testing.assert_allclose(losses_t, losses_j, rtol=F32_TOL, atol=F32_TOL)
    pairs = [
        (model.head.pool.cls_token, head_j["pool"]["cls_token"]),
        (model.head.pool.v.weight, head_j["pool"]["v"]["kernel"].T),
        (model.head.fc.weight, head_j["fc"]["kernel"].T),
        (model.head.fc.bias, head_j["fc"]["bias"]),
        (model.head.bn.running_mean, bn_j["mean"]),
        (model.head.bn.running_var, bn_j["var"]),
    ]
    for t, j in pairs:
        np.testing.assert_allclose(t.detach().numpy(), j, rtol=F32_TOL,
                                   atol=1e-6)
    assert not np.allclose(head_j["pool"]["v"]["kernel"],
                           variables["params"]["head"]["pool"]["v"]["kernel"])
