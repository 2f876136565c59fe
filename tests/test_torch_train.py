"""ep_tpu_torch's optimizer, schedule and train step against the JAX package.

The trajectory test trains the same small ProbeModel (D=64, 2 heads, depth 2,
32 px, 4 EP queries, 5 classes, float32) for 3 steps with ep_tpu's jitted
step on the 8-device CPU mesh and with the port's step, from the same
weights and batches, and compares losses, head parameters and the BN running
statistics.

Tolerances: float32 at 1e-5 relative (the suite's parity bar), with an
absolute floor of 1e-6 for parameters that pass near zero.
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
from ep_tpu.parallel import mesh as M
from ep_tpu.train import lars as jax_lars
from ep_tpu.train import schedule as jax_schedule
from ep_tpu.train import steps as jax_steps
from ep_tpu.train.state import create_train_state
from ep_tpu_torch.configs import TrainConfig as PortTrainConfig
from ep_tpu_torch.convert.from_flax import flax_to_torch
from ep_tpu_torch.models.assembly import ProbeModel, build_backbone_config
from ep_tpu_torch.train import schedule
from ep_tpu_torch.train.lars import LARS
from ep_tpu_torch.train.state import cast_frozen, freeze, split_params
from ep_tpu_torch.train.steps import (cross_entropy, make_eval_step,
                                      make_train_step, topk_correct)

IMG, B, C, STEPS_PER_EPOCH = 32, 16, 5, 2


def _cfg():
    return TrainConfig(model="vit_tiny_patch16", cls_features="ep",
                       ep_queries=4, d_out=1, nb_classes=C, image_size=IMG,
                       amp="float32", batch_size=B, eff_batch_size=B,
                       epochs=4, warmup_epochs=1, lr=2.0, min_lr=0.0)


def _p(cfg):
    """The same configuration as the port's own ``TrainConfig``."""
    return PortTrainConfig(**dataclasses.asdict(cfg))


def _data(n_steps, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, size=(n_steps, B)).astype(np.int32)
    means = rng.standard_normal((C, 1, 1, 3)).astype(np.float32)
    imgs = means[labels] + 0.5 * rng.standard_normal(
        (n_steps, B, IMG, IMG, 3)).astype(np.float32)
    return imgs, labels


def test_train_trajectory_matches_jax(mesh8):
    cfg = _cfg()
    fcfg = FlaxViTConfig(img_size=IMG, patch_size=16, embed_dim=64, depth=2,
                         num_heads=2, dtype=jnp.float32, attn_impl="xla")
    fmodel = FlaxProbeModel(fcfg, cfg)
    variables = fmodel.init(jax.random.key(0), jnp.zeros((2, IMG, IMG, 3)),
                            train=True)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    imgs, labels = _data(3)

    # JAX: the jitted step over the 8-device data mesh
    tx = jax_lars.build_optimizer("lars", 0.0)
    state = create_train_state(variables, tx, finetuning=False)
    step = jax_steps.make_train_step(
        fmodel, tx, jax_schedule.make_lr_fn(cfg, STEPS_PER_EPOCH), mesh8)
    with M.use_mesh(mesh8):
        losses_j = []
        for i in range(3):
            state, m = step(state, M.shard_batch(imgs[i], mesh8),
                            M.shard_batch(labels[i], mesh8))
            losses_j.append(float(m["loss"]))
    head_j = jax.tree_util.tree_map(np.asarray, state.trainable["head"])
    bn_j = jax.tree_util.tree_map(np.asarray, state.batch_stats["head"]["bn"])

    # port
    bcfg = build_backbone_config(_p(cfg)).replace(embed_dim=64, depth=2,
                                              num_heads=2)
    model = ProbeModel(bcfg, _p(cfg))
    params, buffers = flax_to_torch(variables, device="cpu")
    model.load_state_dict({**params, **buffers})
    opt = LARS(freeze(model, cfg.finetuning), weight_decay=0.0)
    train_step = make_train_step(
        model, opt, schedule.make_lr_fn(_p(cfg), STEPS_PER_EPOCH))
    losses_t = []
    for i in range(3):
        m = train_step(i, torch.from_numpy(imgs[i]),
                       torch.from_numpy(labels[i]).long())
        losses_t.append(float(m["loss"]))
        assert set(m) == {"loss", "acc1", "acc5", "lr", "grad_norm"}

    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5, atol=1e-5)
    pairs = [
        (model.head.pool.cls_token, head_j["pool"]["cls_token"]),
        (model.head.pool.v.weight, head_j["pool"]["v"]["kernel"].T),
        (model.head.fc.weight, head_j["fc"]["kernel"].T),
        (model.head.fc.bias, head_j["fc"]["bias"]),
        (model.head.bn.running_mean, bn_j["mean"]),
        (model.head.bn.running_var, bn_j["var"]),
    ]
    for t, j in pairs:
        np.testing.assert_allclose(t.detach().numpy(), j, rtol=1e-5, atol=1e-6)
    # the trajectory moved the head (lr is 0 only at step 0)
    assert not np.allclose(head_j["fc"]["bias"],
                           variables["params"]["head"]["fc"]["bias"])


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_lars_matches_jax(wd):
    rng = np.random.default_rng(1)
    shapes = [(6, 4), (4,), (2, 3, 5)]
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = jax_lars.scaled_lars(weight_decay=wd)
    st = tx.init([jnp.asarray(p) for p in ps])
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in ps]
    opt = LARS(tp, weight_decay=wd)
    for _ in range(3):
        gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        upd, st = tx.update([jnp.asarray(g) for g in gs], st,
                            [jnp.asarray(p) for p in ps])
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        raw = opt.raw_updates()
        for (p, mu), u in zip(raw, upd):
            np.testing.assert_allclose(mu.numpy(), np.asarray(u), rtol=1e-5,
                                       atol=1e-6)
    # zero parameters: the trust ratio falls back to 1
    z = torch.nn.Parameter(torch.zeros(3, 3))
    z.grad = torch.ones(3, 3)
    (_, mu), = LARS([z]).raw_updates()
    torch.testing.assert_close(mu, torch.ones(3, 3))


def test_schedule_matches_jax():
    cfg = TrainConfig(blr=0.1, eff_batch_size=512, min_lr=1e-4, epochs=90,
                      warmup_epochs=10)
    fj = jax_schedule.make_lr_fn(cfg, 1000)
    ft = schedule.make_lr_fn(_p(cfg), 1000)
    for s in (0, 1, 999, 5000, 10_000, 10_001, 45_000, 89_999):
        assert ft(s) == pytest.approx(float(fj(s)), rel=1e-6, abs=1e-12)
    assert ft(0) == 0.0
    assert schedule.resolve_lr(_p(cfg)) == jax_schedule.resolve_lr(cfg) == 0.2


def test_loss_and_topk_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((8, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 8)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    lj, yj = jnp.asarray(logits), jnp.asarray(labels.astype(np.int32))
    np.testing.assert_allclose(cross_entropy(lt, yt).numpy(),
                               np.asarray(jax_steps.cross_entropy(lj, yj)),
                               rtol=1e-5, atol=1e-6)
    for k in (1, 5, 10):
        np.testing.assert_array_equal(
            topk_correct(lt, yt, k).numpy(),
            np.asarray(jax_steps.topk_correct(lj, yj, k)))


def test_freeze_cast_and_eval_step():
    cfg = PortTrainConfig(model="vit_tiny_patch16", cls_features="ep",
                      ep_queries=4, nb_classes=C, image_size=IMG,
                      amp="bfloat16")
    model = ProbeModel(build_backbone_config(cfg).replace(
        embed_dim=64, depth=1, num_heads=2), cfg)
    trainable = freeze(model, cfg.finetuning)
    cast_frozen(model, torch.bfloat16)
    tr, fr = split_params(model, cfg.finetuning)
    assert set(tr) == {"head.pool.cls_token", "head.pool.v.weight",
                       "head.fc.weight", "head.fc.bias"}
    assert all(p.requires_grad and p.dtype == torch.float32 for p in trainable)
    assert all(not p.requires_grad and p.dtype == torch.bfloat16
               for p in fr.values())
    imgs, labels = _data(1, seed=3)
    valid = torch.ones(B)
    valid[-3:] = 0
    sums, preds = make_eval_step(model)(torch.from_numpy(imgs[0]),
                                        torch.from_numpy(labels[0]).long(),
                                        valid)
    assert float(sums["count"]) == B - 3 and preds.shape == (B,)
    assert 0.0 <= float(sums["acc1_sum"]) <= 100.0 * (B - 3)


@pytest.mark.parametrize("shape", [(8, 16), (4, 5, 16), (2, 3, 4, 16)])
def test_batchnorm_over_the_last_axis_matches_flax(shape):
    """The port's TorchBatchNorm normalises the last axis over all the others
    at any rank, as the flax TorchBatchNorm does: two training steps, then an
    eval step, with the running statistics compared after each (their Bessel
    count is the product of the reduced axes)."""
    from ep_tpu.poolings.batchnorm import TorchBatchNorm as FlaxBN
    from ep_tpu_torch.poolings.batchnorm import TorchBatchNorm
    rng = np.random.default_rng(7)
    xs = [(rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
          for _ in range(3)]
    fbn = FlaxBN(momentum=0.9, epsilon=1e-6, use_bias=False, use_scale=False)
    variables = fbn.init(jax.random.key(0), jnp.asarray(xs[0]))
    tbn = TorchBatchNorm(16, momentum=0.9, epsilon=1e-6)
    for i, x in enumerate(xs):
        train = i < 2
        tbn.train(train)
        out_t = tbn(torch.from_numpy(x))
        if train:
            out_j, upd = fbn.apply(variables, jnp.asarray(x),
                                   mutable=["batch_stats"])
            variables = {**variables, **upd}
        else:
            out_j = fbn.clone(use_running_average=True).apply(
                variables, jnp.asarray(x))
        assert out_t.shape == shape
        np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                                   rtol=1e-5, atol=1e-5)
        stats = variables["batch_stats"]
        np.testing.assert_allclose(tbn.running_mean.numpy(),
                                   np.asarray(stats["mean"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(tbn.running_var.numpy(),
                                   np.asarray(stats["var"]), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_lars_updates_a_parameter_outside_the_graph(wd):
    """A trainable parameter that gets no gradient is updated with a zero
    gradient, as optax updates every leaf: its momentum decays, and a 2-D
    parameter gets the weight decay scaled by the trust ratio."""
    rng = np.random.default_rng(3)
    shapes = [(6, 4), (4,), (3, 5)]
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = jax_lars.scaled_lars(weight_decay=wd)
    st = tx.init([jnp.asarray(p) for p in ps])
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in ps]
    opt = LARS(tp, weight_decay=wd)
    for step in range(3):
        gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        if step:  # the third parameter leaves the graph after step 0
            gs[2] = np.zeros(shapes[2], np.float32)
        upd, st = tx.update([jnp.asarray(g) for g in gs], st,
                            [jnp.asarray(p) for p in ps])
        ps = [p - 0.5 * np.asarray(u) for p, u in zip(ps, upd)]
        for i, (p, g) in enumerate(zip(tp, gs)):
            p.grad = None if (step and i == 2) else torch.from_numpy(g)
        opt.step(0.5)
        for p, ref in zip(tp, ps):
            np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-5,
                                       atol=1e-6)
    assert not torch.equal(opt.state[tp[2]]["mu"], torch.zeros(3, 5))
