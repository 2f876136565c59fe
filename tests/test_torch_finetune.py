"""The fine-tuning slice of ep_tpu_torch against the JAX package, on the CPU.

The attention backward (the plain version of kernel E, with ``_bwd_kernel``'s
cast points), the head-width-80 forward, the attention supercell's VJP, the
whole fine-tuning ProbeModel's gradients, a 3-step fine-tuning trajectory, the
remat policies and LARS with bf16 momentum. The JAX side runs its Pallas
kernels in interpret mode. Small sizes: head width 64 (H=2, T=5) reaches
``_bwd_kernel``; head width 80 with 8 heads (T=9) reaches ``_fwd_head_group``
and ``_bwd_head_group``; the models are D=64, depth 2, 4 EP queries.

Tolerances: float32 at 1e-5 (the suite's parity bar), gradients relative to
each tensor's largest magnitude since a gradient sums over the batch. In
bfloat16 both sides round at the same points; the f32 sums run in another
order, which can move a value across one bf16 rounding boundary, and a
rounding of dL taken once feeds a sum over T keys, so bf16 outputs agree
within two bf16 steps (2**-7) of their largest magnitude.
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
from ep_tpu.ops.attn_block_pallas import attn_supercell as jax_supercell
from ep_tpu.ops.attn_fused_pallas import attention_qkv_fused as jax_attn
from ep_tpu.parallel import mesh as M
from ep_tpu.train import lars as jax_lars
from ep_tpu.train import schedule as jax_schedule
from ep_tpu.train import steps as jax_steps
from ep_tpu.train.state import create_train_state
from ep_tpu_torch.configs import TrainConfig as PortTrainConfig
from ep_tpu_torch.convert.from_flax import flax_to_torch
from ep_tpu_torch.models.assembly import ProbeModel, build_backbone_config
from ep_tpu_torch.ops.attn_block import (attn_supercell, layer_norm_ref,
                                         ln1_backward_ref)
from ep_tpu_torch.ops.attn_fused import (attention_qkv_fused,
                                         attention_qkv_fused_bwd_ref)
from ep_tpu_torch.train import schedule
from ep_tpu_torch.train.lars import LARS
from ep_tpu_torch.train.state import freeze
from ep_tpu_torch.train.steps import cross_entropy, make_train_step

F32_TOL = 1e-5
BF16_RTOL = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
IMG, B, C = 32, 8, 5


def _pair(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _close(out_t: torch.Tensor, out_j, dtype: str, name: str = ""):
    a = out_t.detach().float().numpy()
    b = np.asarray(jnp.asarray(out_j, jnp.float32))
    assert a.shape == b.shape, (name, a.shape, b.shape)
    tol = F32_TOL if dtype == "float32" else BF16_RTOL
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * float(np.abs(b).max()),
                               err_msg=name)


# ---- attention core ---------------------------------------------------------

ATTN_SHAPES = {64: (2, 5, 2), 80: (2, 9, 8)}  # head width -> (B, T, H)


@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_backward_matches_jax(dtype, dh):
    b, t, h = ATTN_SHAPES[dh]
    rng = np.random.default_rng(10 + dh)
    qkv_j, qkv_t = _pair(rng.standard_normal((b, t, 3 * h * dh), np.float32),
                         dtype)
    g_j, g_t = _pair(rng.standard_normal((b, t, h * dh), np.float32), dtype)
    scale = dh ** -0.5
    _, vjp = jax.vjp(lambda x: jax_attn(x, h, scale, 1.5, True), qkv_j)
    (dqkv_j,) = vjp(g_j)
    qkv_t.requires_grad_(True)
    attention_qkv_fused(qkv_t, h, scale, 1.5).backward(g_t)
    assert qkv_t.grad.dtype == DTYPES[dtype][1]
    _close(qkv_t.grad, dqkv_j, dtype)
    # autograd's backward is the plain version of kernel E, exactly
    torch.testing.assert_close(
        qkv_t.grad, attention_qkv_fused_bwd_ref(qkv_t.detach(), g_t, h, scale,
                                                1.5), rtol=0, atol=0)


@pytest.mark.parametrize("dh, t", [(64, 1), (64, 64), (64, 65), (80, 1),
                                   (80, 65)])
def test_attention_backward_matches_jax_at_tile_edges(dh, t):
    """The plain backward that kernel E is held to, against the JAX package's
    Pallas backward in interpret mode at the edges of E's 64-row tiles (one
    row, one tile, one row past it), f32."""
    h = ATTN_SHAPES[dh][2]
    rng = np.random.default_rng(20 + t)
    qkv_j, qkv_t = _pair(rng.standard_normal((1, t, 3 * h * dh), np.float32),
                         "float32")
    g_j, g_t = _pair(rng.standard_normal((1, t, h * dh), np.float32), "float32")
    _, vjp = jax.vjp(lambda x: jax_attn(x, h, dh ** -0.5, 1.5, True), qkv_j)
    _close(attention_qkv_fused_bwd_ref(qkv_t, g_t, h, dh ** -0.5, 1.5),
           vjp(g_j)[0], "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_head_width_80_matches_jax(dtype):
    b, t, h = ATTN_SHAPES[80]
    rng = np.random.default_rng(3)
    qkv_j, qkv_t = _pair(rng.standard_normal((b, t, 3 * h * 80), np.float32),
                         dtype)
    out_t = attention_qkv_fused(qkv_t, h, 80 ** -0.5)
    _close(out_t, jax_attn(qkv_j, h, 80 ** -0.5, 1.0, True), dtype)


# ---- attention supercell ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_supercell_vjp_matches_jax(dtype):
    Bc, T, H, D = 2, 5, 2, 64
    rng = np.random.default_rng(4)
    x = rng.standard_normal((Bc, T, D), np.float32)
    w_qkv = rng.standard_normal((D, 3 * D), np.float32) * D ** -0.5
    b_qkv = rng.standard_normal(3 * D, np.float32) * 0.02
    gamma = 1 + 0.1 * rng.standard_normal(D, np.float32)
    beta = 0.1 * rng.standard_normal(D, np.float32)
    w_proj = rng.standard_normal((D, D), np.float32) * D ** -0.5
    b_proj = rng.standard_normal(D, np.float32) * 0.02
    g = rng.standard_normal((Bc, T, D), np.float32)
    scale = (D // H) ** -0.5
    x_j, x_t = _pair(x, dtype)
    g_j, g_t = _pair(g, dtype)
    weights = (w_qkv, b_qkv, gamma, beta, w_proj, b_proj)
    _, vjp = jax.vjp(lambda *a: jax_supercell(*a, H, scale, 1.0, 1e-6, True),
                     x_j, *map(jnp.asarray, weights))
    grads_j = vjp(g_j)
    # the port keeps the weights f32 in the nn.Linear (out, in) layout
    ins = [x_t] + [torch.from_numpy(w.T.copy() if w.ndim == 2 else w)
                   for w in weights]
    ins = [t.requires_grad_(True) for t in ins]
    attn_supercell(*ins, H, scale, 1.0, 1e-6).backward(g_t)
    names = ("x", "w_qkv", "b_qkv", "gamma", "beta", "w_proj", "b_proj")
    for name, t, gj in zip(names, ins, grads_j):
        assert t.grad.dtype == t.dtype, name
        gj = np.asarray(jnp.asarray(gj, jnp.float32))
        _close(t.grad, gj.T if gj.ndim == 2 else gj, dtype, name)


# ---- LN1's backward (the plain version of kernels ln1_apply and ln1_bwd) ----

@pytest.mark.parametrize("B, T", [(3, 7), (1, 197)])  # rows not a multiple of 8
@pytest.mark.parametrize("D", [64, 768, 1280])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln1_backward_ref_matches_autograd(dtype, D, B, T):
    """``ln1_backward_ref`` is autograd over ``layer_norm_ref``, bit for bit,
    with the residual's sum and the sum of g; and the closed form that the
    card's kernels compute, in float64 with their cast points
    (bf16(g + bf16(dx)), dx = rstd * (dy - mean(dy) - xhat * mean(dy *
    xhat)), dy = dxn * gamma), agrees with it."""
    rng = np.random.default_rng(D + T)
    td = DTYPES[dtype][1]
    x, dxn, g = (torch.from_numpy(rng.standard_normal((B, T, D), np.float32)
                                  * s + m).to(td)
                 for s, m in ((2.0, 0.5), (1.0, 0.0), (1.0, 0.0)))
    gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(D, np.float32))
    beta = torch.from_numpy(0.1 * rng.standard_normal(D, np.float32))
    xn, dx, dgamma, dbeta, dbp = ln1_backward_ref(x, gamma, beta, dxn, g, 1e-6)

    ln_in = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    ref_xn = layer_norm_ref(*ln_in, 1e-6)
    ref = torch.autograd.grad(ref_xn, ln_in, dxn)
    assert xn.dtype == dx.dtype == td and not xn.requires_grad
    for got, want in zip((xn, dx, dgamma, dbeta, dbp),
                         (ref_xn.detach(), g + ref[0], ref[1], ref[2],
                          g.float().sum((0, 1)))):
        assert torch.equal(got, want)

    x64, dxn64, g64 = x.double(), dxn.double(), g.double()
    mu = x64.mean(-1, keepdim=True)
    rstd = ((x64 - mu) ** 2).mean(-1, keepdim=True).add(1e-6).rsqrt()
    xh = (x64 - mu) * rstd
    dy = dxn64 * gamma.double()
    dx64 = rstd * (dy - dy.mean(-1, keepdim=True)
                   - xh * (dy * xh).mean(-1, keepdim=True))
    closed = (g64 + dx64.to(td).double()).to(td)
    for name, got, want in (
            ("xn", xn, (xh * gamma.double() + beta.double()).to(td)),
            ("g + dx", dx, closed), ("dgamma", dgamma, (dxn64 * xh).sum((0, 1))),
            ("dbeta", dbeta, dxn64.sum((0, 1))), ("dbp", dbp, g64.sum((0, 1)))):
        _close(got, want.float().numpy(), dtype, name)


# ---- the whole fine-tuning model --------------------------------------------

def _cfg(amp="float32", **kw):
    return TrainConfig(**{**dict(
        model="vit_tiny_patch16", cls_features="ep", ep_queries=4, d_out=1,
        nb_classes=C, image_size=IMG, amp=amp, batch_size=B,
        eff_batch_size=B, finetuning=True, epochs=4, warmup_epochs=1,
        lr=2.0, min_lr=0.0), **kw})


def _p(cfg):
    """The same configuration as the port's own ``TrainConfig``."""
    return PortTrainConfig(**dataclasses.asdict(cfg))


def _flax(cfg, dtype, attn_impl):
    bcfg = FlaxViTConfig(img_size=IMG, patch_size=16, embed_dim=64, depth=2,
                         num_heads=2, dtype=DTYPES[dtype][0],
                         attn_impl=attn_impl)
    model = FlaxProbeModel(bcfg, cfg)
    variables = model.init(jax.random.key(0), jnp.zeros((2, IMG, IMG, 3)),
                           train=True)
    return model, jax.tree_util.tree_map(np.asarray, variables)


def _port(cfg, variables):
    cfg = _p(cfg)
    bcfg = build_backbone_config(cfg).replace(embed_dim=64, depth=2,
                                              num_heads=2)
    model = ProbeModel(bcfg, cfg)
    params, buffers = flax_to_torch(variables, device="cpu")
    model.load_state_dict({**params, **buffers}, strict=True)
    return model


def _data(n_steps, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, size=(n_steps, B)).astype(np.int32)
    means = rng.standard_normal((C, 1, 1, 3)).astype(np.float32)
    imgs = means[labels] + 0.5 * rng.standard_normal(
        (n_steps, B, IMG, IMG, 3)).astype(np.float32)
    return imgs, labels


def _port_grads(model, imgs, labels):
    model.train()
    model.zero_grad(set_to_none=True)
    loss = cross_entropy(model(torch.from_numpy(imgs)),
                         torch.from_numpy(labels).long()).mean()
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_finetune_model_grads_match_flax(monkeypatch, dtype):
    """Every parameter's gradient, backbone included, through the kernel path
    of the flax model (supercell and EP kernels in interpret mode)."""
    monkeypatch.setenv("EP_TPU_PALLAS_INTERPRET", "1")
    cfg = _cfg(amp=dtype)
    fm, variables = _flax(cfg, dtype, "pallas")
    imgs, labels = _data(1)

    def loss_fn(params):
        logits, _ = fm.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             jnp.asarray(imgs[0]), train=True,
                             mutable=["batch_stats"])
        return jax_steps.cross_entropy(logits, jnp.asarray(labels[0])).mean()

    loss_j, grads_j = jax.value_and_grad(loss_fn)(variables["params"])
    grads_j, _ = flax_to_torch({"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), grads_j)}, device="cpu")
    loss_t, grads_t = _port_grads(_port(cfg, variables), imgs[0], labels[0])
    assert grads_t.keys() == grads_j.keys()
    assert any(k.startswith("backbone.blocks.0.") for k in grads_t)
    # Each gradient is compared at its own largest magnitude, floored at a
    # fraction of the model's largest: the last fc2 bias has a gradient that
    # is zero in exact arithmetic (a shift of every token, which the EP
    # softmax and BN cancel), so only rounding noise is left to compare. In
    # bf16 a few products round where flax rounds twice (test_torch_model.py)
    # and the difference propagates back through two blocks: 5e-2 of that
    # scale, and each gradient that is not noise points the same way.
    tol, floor, loss_tol = ((F32_TOL, 1e-3, F32_TOL) if dtype == "float32"
                            else (5e-2, 2e-2, 3e-2))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=loss_tol)
    top = max(float(g.abs().max()) for g in grads_j.values())
    for k, g in grads_t.items():
        a, b = g.float().numpy().ravel(), grads_j[k].numpy().ravel()
        own = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=tol if dtype == "float32" else 0,
                                   atol=tol * max(own, floor * top), err_msg=k)
        if own >= floor * top:
            assert a @ b >= 0.99 * np.linalg.norm(a) * np.linalg.norm(b), k


def test_finetune_trajectory_matches_jax(mesh8):
    """3 fine-tuning steps with ep_tpu's jitted step on the 8-device CPU mesh
    and with the port's step, from the same weights and batches: losses,
    every parameter and the BN running statistics."""
    cfg = _cfg()
    fmodel, variables = _flax(cfg, "float32", "xla")
    imgs, labels = _data(3)
    tx = jax_lars.build_optimizer("lars", 0.0)
    state = create_train_state(variables, tx, finetuning=True)
    step = jax_steps.make_train_step(
        fmodel, tx, jax_schedule.make_lr_fn(cfg, 2), mesh8)
    with M.use_mesh(mesh8):
        losses_j = []
        for i in range(3):
            state, m = step(state, M.shard_batch(imgs[i], mesh8),
                            M.shard_batch(labels[i], mesh8))
            losses_j.append(float(m["loss"]))
    params_j, buffers_j = flax_to_torch(jax.tree_util.tree_map(
        np.asarray, {"params": state.trainable,
                     "batch_stats": state.batch_stats}), device="cpu")

    model = _port(cfg, variables)
    opt = LARS(freeze(model, cfg.finetuning), weight_decay=0.0)
    train_step = make_train_step(model, opt, schedule.make_lr_fn(_p(cfg), 2))
    losses_t = [float(train_step(i, torch.from_numpy(imgs[i]),
                                 torch.from_numpy(labels[i]).long())["loss"])
                for i in range(3)]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5, atol=1e-5)
    state_t = model.state_dict()
    for k, v in {**params_j, **buffers_j}.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(state_t[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    moved = variables["params"]["backbone"]["blocks_0"]["attn"]["qkv"]["kernel"]
    assert not np.allclose(params_j["backbone.blocks.0.attn.qkv.weight"].numpy(),
                           moved.T)


# ---- remat ------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["none", "attn_out", "attn_fc1", "dots"])
def test_remat_policies_match_no_remat(policy):
    cfg = _cfg()
    _, variables = _flax(cfg, "float32", "xla")
    imgs, labels = _data(1, seed=1)
    _, ref = _port_grads(_port(cfg, variables), imgs[0], labels[0])
    remat = _cfg(scan_blocks=True, remat_blocks=True, remat_policy=policy)
    model = _port(remat, variables)
    assert all(blk.remat is not None for blk in model.backbone.blocks)
    _, grads = _port_grads(model, imgs[0], labels[0])
    for k, g in grads.items():
        torch.testing.assert_close(g, ref[k], rtol=1e-6, atol=1e-7, msg=k)


@pytest.mark.parametrize("kw, err", [
    (dict(remat_blocks=True), "requires scan_blocks"),
    (dict(remat_blocks=True, scan_blocks=True, remat_policy="everything"),
     "unknown remat_policy"),
])
def test_remat_flags_checked(kw, err):
    cfg = _cfg(**kw)
    with pytest.raises(ValueError, match=err):
        ProbeModel(build_backbone_config(_p(cfg)).replace(
            embed_dim=64, depth=1, num_heads=2), _p(cfg))


# ---- LARS with bf16 momentum ------------------------------------------------

def test_lars_bf16_momentum_matches_jax():
    rng = np.random.default_rng(6)
    shapes = [(6, 4), (4,), (2, 3, 5)]
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = jax_lars.scaled_lars(weight_decay=0.05, mu_dtype=jnp.bfloat16)
    st = tx.init([jnp.asarray(p) for p in ps])
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in ps]
    opt = LARS(tp, weight_decay=0.05, mu_dtype=torch.bfloat16)
    for _ in range(4):
        gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        upd, st = tx.update([jnp.asarray(g) for g in gs], st,
                            [jnp.asarray(p) for p in ps])
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        for (p, mu), u, carried in zip(opt.raw_updates(), upd, st.mu):
            # this step's update is f32; only the carried buffer rounds
            assert mu.dtype == torch.float32
            np.testing.assert_allclose(mu.numpy(), np.asarray(u), rtol=1e-5,
                                       atol=1e-6)
            kept = opt.state[p]["mu"]
            assert kept.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                kept.float().numpy(), np.asarray(carried.astype(jnp.float32)))
